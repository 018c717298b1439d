"""Carrying reference trees into the port, and the port's import isolation.

``from_jax_tree`` keys serving leaves on their class name: the reference's
``XnorLinear``, ``XnorConv`` and ``PackedConv`` all have ``packed`` and
``k`` like ``PackedLinear``, but their word layouts differ, so each must
land on its own port class (with ``ksize``/``c_in`` where it has them), and
any other class must raise. The port must import neither ``jax`` nor the
reference package: a subprocess imports every ``repro_torch`` module with
both made unimportable.
"""
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (one intra-op thread a worker)

from repro.engine import compile_plan as j_compile_plan
from repro.launch.train import make_paper_policy as j_make_paper_policy
from repro.models import mnist_fc as jfc
from repro.models import vgg as jvgg
from repro_torch.engine.plan import tree_leaves_with_path
from repro_torch.interop import from_jax_tree
from repro_torch.models.layers import PackedConv, PackedLinear, XnorConv, XnorLinear

SRC = Path(__file__).resolve().parents[1] / "src"


def _carry_and_compare(packed):
    """Carries a reference packed tree across and checks every serving leaf
    kept its class (by name), words, scale and geometry."""
    port = from_jax_tree(jax.tree_util.tree_map(np.asarray, packed), device="cpu")
    ref_leaves = jax.tree_util.tree_leaves(
        packed, is_leaf=lambda x: hasattr(x, "packed"))
    port_leaves = [leaf for _, leaf in tree_leaves_with_path(port)]
    assert len(ref_leaves) == len(port_leaves)
    kinds = {}
    for r, p in zip(ref_leaves, port_leaves):
        if not hasattr(r, "packed"):
            assert isinstance(p, torch.Tensor)
            np.testing.assert_array_equal(p.numpy(), np.asarray(r))
            continue
        assert type(p).__name__ == type(r).__name__
        np.testing.assert_array_equal(p.packed.numpy(), np.asarray(r.packed))
        np.testing.assert_array_equal(p.scale.numpy(), np.asarray(r.scale))
        assert p.k == r.k and p.master_shape == tuple(r.master_shape)
        if hasattr(r, "ksize"):
            assert (p.ksize, p.c_in) == (tuple(r.ksize), r.c_in)
        kinds[type(p)] = kinds.get(type(p), 0) + 1
    return kinds


def test_mnist_xnor_tree_carries_xnor_linear_leaves():
    tree = jfc.init(jax.random.key(0), hidden=(128, 128, 128))
    packed = j_compile_plan(tree["params"], j_make_paper_policy(4), "xnor").pack(
        tree["params"])
    assert _carry_and_compare(packed) == {XnorLinear: 2}


@pytest.mark.parametrize("mode,kinds", [
    ("xnor", {XnorConv: 11, XnorLinear: 1}),
    ("stoch", {PackedConv: 12, PackedLinear: 1}),
])
def test_vgg_trees_carry_conv_leaves(mode, kinds):
    tree = jvgg.init(jax.random.key(0), width_mult=0.125)
    packed = j_compile_plan(tree["params"], j_make_paper_policy(3), mode).pack(
        tree["params"], key=jax.random.key(1))
    assert _carry_and_compare(packed) == kinds


def test_unknown_leaf_class_raises():
    """Before the repair any object with ``packed`` and ``k`` became a
    PackedLinear; now only the four known classes are carried."""
    Leaf = type("BinaryEmbedding", (), dict(
        packed=np.zeros((1, 4), np.int32), scale=None, k=32))
    with pytest.raises(TypeError, match="BinaryEmbedding"):
        from_jax_tree({"a": [Leaf()]}, device="cpu")
    with pytest.raises(TypeError, match="object"):
        from_jax_tree({"a": object()}, device="cpu")


_ISOLATION = """
import importlib, pkgutil, sys
sys.modules["jax"] = None          # `import jax` now raises ImportError
sys.modules["repro"] = None
import repro_torch
names = ["repro_torch"] + [m.name for m in pkgutil.walk_packages(
    repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
loaded = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "repro")
          and sys.modules[m] is not None]
assert not loaded, loaded
print(" ".join(names))
"""

#: Modules the LM slice added; the walk must reach each of them.
_LM_SLICE = ("repro_torch.obs.trace", "repro_torch.obs.metrics", "repro_torch.obs.__main__",
             "repro_torch.configs.base", "repro_torch.configs.starcoder2_3b",
             "repro_torch.configs.jamba_1_5_large", "repro_torch.models.attention",
             "repro_torch.models.mlp", "repro_torch.models.transformer",
             "repro_torch.serve.batcher", "repro_torch.serve.engine",
             "repro_torch.serve.prefix_cache")


def test_port_imports_no_jax_and_no_reference():
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", _ISOLATION], env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    names = out.stdout.split()
    assert len(names) >= 30                       # every module was imported
    assert set(_LM_SLICE) <= set(names)
