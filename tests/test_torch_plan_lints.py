"""Port parity for the plan lints (``repro_torch.analysis``): on the same
manifest, the golden ones and the reference tests' deliberately broken
edits of them, the port's ``lint_plan`` gives the reference's findings
(rule, severity, location, message, hint and data, in order), its report
text and its exit code. Every comparison is exact.
"""
import copy
import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (one intra-op thread a worker)

from repro.analysis import format_findings as j_format_findings
from repro.analysis import gate as j_gate
from repro.analysis import lint_plan as j_lint_plan
from repro.core.policy import DEFAULT_POLICY as J_DEFAULT_POLICY
from repro.engine import ExecutionPlan as JExecutionPlan
from repro.engine import compile_plan as j_compile_plan
from repro.models import mnist_fc as jfc
from repro_torch.analysis import (ERROR, INFO, Finding, errors, findings_to_json,
                                  format_findings, gate, lint_plan, lint_plan_file, waive)
from repro_torch.core.policy import DEFAULT_POLICY
from repro_torch.engine import ExecutionPlan, compile_plan
from repro_torch.interop import from_jax_tree

GOLDEN = Path(__file__).resolve().parents[1] / "benchmarks" / "golden_plans"
GOLDENS = sorted(p.name for p in GOLDEN.glob("*_*.json") if p.name != "collectives.json")


def _both(d: dict):
    """The same manifest dict loaded by the port and by the reference."""
    return ExecutionPlan.from_json(copy.deepcopy(d)), JExecutionPlan.from_json(copy.deepcopy(d))


def _assert_same_findings(plan, j_plan, **kw):
    got, want = lint_plan(plan, **kw), j_lint_plan(j_plan, **kw)
    assert findings_to_json(got) == [f.to_json() for f in want]
    assert format_findings(got, title="t") == j_format_findings(want, title="t")
    assert gate(got) == j_gate(want)
    return got


def _golden(name):
    return json.loads((GOLDEN / name).read_text())


def _row(d, backend):
    return [r for r in d["layers"] if r["backend"] == backend][0]


@pytest.mark.parametrize("name", GOLDENS)
def test_goldens_lint_as_the_reference_and_clean(name):
    findings = _assert_same_findings(*_both(_golden(name)))
    assert errors(findings) == []
    plan, _ = lint_plan_file(str(GOLDEN / name))
    assert plan.lint() == findings


def test_boundary_reshard_is_informational_on_goldens():
    findings = lint_plan(ExecutionPlan.load(GOLDEN / "mnist_fc_det.json"))
    hits = [f for f in findings if f.rule == "plan.boundary_reshard"]
    assert hits and all(f.severity == INFO for f in hits)
    assert gate(findings) == 0


def _dense_fallthrough(d):
    row = _row(d, "packed")
    row["backend"], row["reason"] = "dense", "cannot pack: K % 32 != 0 (K=30)"
    return "plan.dense_fallthrough", {}


def _contraction_shard(d):
    _row(d, "packed")["sharding"] = ["model", None]
    return "plan.word_lane_split", {}


def _uneven_word_split(d):
    row = _row(d, "xnor")
    row["sharding"] = ["model", None]
    words = row["shape"][-2] // 32
    return "plan.word_lane_split", {"axis_sizes": {"model": 3 if words % 3 else words + 1}}


def _even_word_split(d):
    _row(d, "xnor")["sharding"] = ["model", None]
    return None, {"axis_sizes": {"model": 2}}


def _conv_folded(d):
    _row(d, "xnor_conv")["sharding"] = [None, None, "model", None]
    return "plan.word_lane_split", {}


def _unknown_axis(d):
    _row(d, "packed")["sharding"] = [None, "modle"]
    return "plan.unknown_axis", {}


def _known_odd_axis(d):
    _row(d, "packed")["sharding"] = [None, "modle"]
    return None, {"mesh_axes": ("data", "model", "modle")}


def _unknown_replica_axis(d):
    d["replica_axis"] = "ensemble"
    return "plan.unknown_axis", {}


def _replica_collision(d):
    d["replica_axis"] = "model"
    return "plan.replica_axis_collision", {}


def _no_replica_collision(d):
    d["replica_axis"] = "data"
    return None, {}


def _boundaries_resolved(d):
    return None, {"axis_sizes": {"model": 1}}


@pytest.mark.parametrize("golden,edit", [
    ("mnist_fc_det.json", _dense_fallthrough), ("mnist_fc_det.json", _contraction_shard),
    ("mnist_fc_xnor.json", _uneven_word_split), ("mnist_fc_xnor.json", _even_word_split),
    ("vgg16_cifar10_xnor.json", _conv_folded), ("mnist_fc_det.json", _unknown_axis),
    ("mnist_fc_det.json", _known_odd_axis), ("mnist_fc_stoch.json", _unknown_replica_axis),
    ("mnist_fc_stoch.json", _replica_collision), ("mnist_fc_stoch.json", _no_replica_collision),
    ("vgg16_cifar10_stoch.json", _replica_collision),
    ("vgg16_cifar10_det.json", _boundaries_resolved),
], ids=lambda v: getattr(v, "__name__", v))
def test_edited_manifests_lint_as_the_reference(golden, edit):
    """The reference tests' broken manifests (``tests/test_analysis.py``):
    the rule that must fire fires, at the same rows, with the same text."""
    d = _golden(golden)
    rule, kw = edit(d)
    findings = _assert_same_findings(*_both(d), **kw)
    fired = {f.rule for f in findings if f.severity == ERROR}
    assert fired == ({rule} if rule else set())


def test_fallthrough_from_a_real_compile_lints_as_the_reference():
    """A policy-selected K % 32 != 0 layer compiles to a dense fallthrough
    that both lints gate on."""
    tree = jfc.init(jax.random.key(0), hidden=(30, 64))
    carried = from_jax_tree(jax.tree_util.tree_map(np.asarray, tree["params"]), device="cpu")
    with pytest.warns(UserWarning, match="cannot use a binary backend"):
        plan = compile_plan(carried, DEFAULT_POLICY, "det")
    j_plan = j_compile_plan(tree["params"], J_DEFAULT_POLICY, "det", warn=False)
    assert plan.to_json() == j_plan.to_json()
    findings = _assert_same_findings(plan, j_plan)
    assert {f.rule for f in errors(findings)} == {"plan.dense_fallthrough"}
    assert plan.fallthroughs() and gate(findings) == 1


def test_waive_drops_a_rule_and_findings_round_trip():
    d = _golden("mnist_fc_det.json")
    _dense_fallthrough(d)
    findings = lint_plan(ExecutionPlan.from_json(d))
    assert gate(waive(findings, ["plan.dense_fallthrough"])) == 0
    assert [Finding.from_json(f) for f in findings_to_json(findings)] == findings
    with pytest.raises(ValueError, match="severity"):
        Finding(rule="x", severity="fatal", where="w", message="m")
    assert "no findings" in format_findings([])


def test_lint_reads_no_tensor():
    """A manifest lints with no parameter tree and no kernel: only the plan."""
    plan = ExecutionPlan.load(GOLDEN / "vgg16_cifar10_xnor.json")
    assert all(not isinstance(v, torch.Tensor) for a in plan.layers for v in vars(a).values())
    assert lint_plan(plan) == plan.lint()
