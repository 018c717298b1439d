"""Fault tolerance of the port's training: the reference's
``TestCheckpointManager``, ``TestCrashRecovery`` and ``TestDataPipeline``
(``tests/test_fault_tolerance.py``) on the port, and checkpoints across the
two packages: a checkpoint the reference writes restores in the port, and
the reverse, leaf for leaf, the PRNG key included, and the restored states
take the same next step."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (one intra-op thread a worker)

from repro.checkpoint.manager import CheckpointManager as JCheckpointManager
from repro.core import binarize as JB
from repro.core.policy import BinarizePolicy as JBinarizePolicy
from repro.models import mnist_fc as jfc
from repro.optim import schedules as JS
from repro.optim.sgd import sgd_momentum as j_sgd_momentum
from repro.train import steps as JST
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.core import binarize as B
from repro_torch.core import prng
from repro_torch.core.policy import BinarizePolicy
from repro_torch.data import pipeline, synthetic as syn
from repro_torch.engine.plan import tree_leaves_with_path
from repro_torch.ft.failures import FailureInjector, InjectedFailure
from repro_torch.interop import from_jax_train_state
from repro_torch.models import mnist_fc
from repro_torch.optim import schedules
from repro_torch.optim.sgd import sgd_momentum
from repro_torch.train import steps as ST
from repro_torch.train.trainer import Trainer, TrainerConfig

PATTERNS = dict(include=(r".*kernel$",), exclude=(r"layers/0/kernel",))
POLICY = BinarizePolicy(**PATTERNS)


def _state_and_step(mode="det", seed=0):
    tree = mnist_fc.init(torch.Generator().manual_seed(seed), hidden=(32, 32), device="cpu")
    opt = sgd_momentum(schedules.constant(0.05))
    step = ST.make_train_step(ST.make_classifier_loss(mnist_fc.apply), opt, mode, POLICY,
                              has_model_state=True)
    state = ST.init_train_state(tree["params"], opt, seed=seed, model_state=tree["state"])
    return state, step


def _batch_fn(spec):
    def fn(step):
        x, y = syn.train_batch(spec, step, device="cpu")
        return {"x": x, "y": y}
    return fn


def _assert_trees_equal(a, b):
    la, lb = list(tree_leaves_with_path(a)), list(tree_leaves_with_path(b))
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (path, x), (_, y) in zip(la, lb):
        if isinstance(x, prng.Key):
            assert x == y, path
        else:
            assert x.dtype == y.dtype and torch.equal(x, y), path


class TestCheckpointManager:
    def test_roundtrip_exact(self, tmp_path):
        state, _ = _state_and_step()
        mgr = CheckpointManager(str(tmp_path), async_save=False)
        mgr.save(7, state)
        _assert_trees_equal(state, mgr.restore(state))
        assert mgr.read_meta()["step"] == 7

    def test_bf16_leaves_roundtrip(self, tmp_path):
        t = {"mu": torch.randn(5, 3).to(torch.bfloat16), "step": torch.tensor(3, dtype=torch.int32)}
        mgr = CheckpointManager(str(tmp_path), async_save=False)
        mgr.save(1, t)
        _assert_trees_equal(t, mgr.restore(t))

    def test_keep_k_gc(self, tmp_path):
        state, _ = _state_and_step()
        mgr = CheckpointManager(str(tmp_path), keep=2, async_save=False)
        for s in (1, 2, 3, 4):
            mgr.save(s, state)
        assert mgr.all_steps() == [3, 4]

    def test_uncommitted_ignored(self, tmp_path):
        state, _ = _state_and_step()
        mgr = CheckpointManager(str(tmp_path), async_save=False)
        mgr.save(1, state)
        # a crash mid-write: a directory without the COMMITTED marker
        os.makedirs(tmp_path / "step_0000000002")
        assert mgr.latest_step() == 1

    def test_async_save(self, tmp_path):
        state, _ = _state_and_step()
        mgr = CheckpointManager(str(tmp_path), async_save=True)
        mgr.save(5, state)
        mgr.wait()
        assert mgr.latest_step() == 5

    def test_shape_mismatch_fails_loudly(self, tmp_path):
        state, _ = _state_and_step()
        mgr = CheckpointManager(str(tmp_path), async_save=False)
        mgr.save(1, state)
        bad, _ = _state_and_step()
        bad["params"]["layers"][0]["kernel"] = torch.zeros(7, 7)
        with pytest.raises(ValueError):
            mgr.restore(bad)
        bad["params"]["layers"][0]["extra"] = torch.zeros(1)
        with pytest.raises(KeyError):
            mgr.restore(bad)

    def test_no_checkpoint(self, tmp_path):
        state, _ = _state_and_step()
        with pytest.raises(FileNotFoundError):
            CheckpointManager(str(tmp_path)).restore(state)


class TestCrashRecovery:
    def test_recovery_is_bit_exact(self, tmp_path):
        """A crash + restore reproduces the uninterrupted trajectory, because
        batches and step randomness are pure functions of the step index."""
        spec = syn.SyntheticSpec("mnist", batch_size=32, n_train=640)

        def run(fail_at, ckdir, mode):
            state, step = _state_and_step(mode)
            trainer = Trainer(
                TrainerConfig(total_steps=30, checkpoint_dir=str(ckdir), checkpoint_every=10,
                              log_every=1, async_checkpoint=False),
                step, _batch_fn(spec), state, failure_injector=FailureInjector(fail_at))
            trainer.run()
            return trainer

        for mode in ("det", "stoch"):
            t_clean = run((), tmp_path / f"clean_{mode}", mode)
            t_crash = run((17, 23), tmp_path / f"crash_{mode}", mode)
            assert t_crash.recoveries == 2
            _assert_trees_equal(t_clean.ckpt.restore(t_clean.state),
                                t_crash.ckpt.restore(t_crash.state))
            _assert_trees_equal(t_clean.state, t_crash.state)
            # the crash run re-logs the replayed steps: every step's last
            # entry equals the clean run's, and so does each replayed entry
            clean = {h["step"]: h["loss"] for h in t_clean.history}
            assert len(clean) == 30 and len(t_crash.history) == 30 + 7 + 3
            for h in t_crash.history:
                assert h["loss"] == clean[h["step"]], h["step"]

    def test_recovery_budget(self, tmp_path):
        spec = syn.SyntheticSpec("mnist", batch_size=32, n_train=640)
        state, step = _state_and_step()
        trainer = Trainer(
            TrainerConfig(total_steps=10, checkpoint_dir=str(tmp_path), max_recoveries=2,
                          async_checkpoint=False),
            step, _batch_fn(spec), state, failure_injector=FailureInjector((3, 3, 3, 3)))
        # the failure at step 3 fires once per arming; a single entry recovers
        trainer.run()
        assert trainer.recoveries == 1

    def test_budget_exhausted(self, tmp_path):
        spec = syn.SyntheticSpec("mnist", batch_size=8, n_train=640)
        state, step = _state_and_step()

        class Always(FailureInjector):
            def check(self, step):
                raise InjectedFailure("always")

        trainer = Trainer(TrainerConfig(total_steps=3, checkpoint_dir=str(tmp_path),
                                        max_recoveries=2, async_checkpoint=False),
                          step, _batch_fn(spec), state, failure_injector=Always())
        with pytest.raises(RuntimeError, match="budget"):
            trainer.run()


class TestDataPipeline:
    @pytest.mark.parametrize("kind", ["mnist", "cifar"])
    def test_batches_are_step_pure(self, kind):
        spec = syn.SyntheticSpec(kind, batch_size=4, seed=2, n_train=1000)
        a, ya = syn.train_batch(spec, 42, device="cpu")
        b, yb = syn.train_batch(spec, 42, device="cpu")
        assert torch.equal(a, b) and torch.equal(ya, yb)
        assert not torch.equal(a, syn.train_batch(spec, 43, device="cpu")[0])
        held = syn.eval_batch(spec, device="cpu")[0]
        assert held.shape == a.shape and not torch.equal(held, a)
        assert spec.steps_per_epoch == 250

    def test_prefetcher_order_and_close(self):
        pf = pipeline.Prefetcher(lambda i: i * i, start_step=3, depth=2)
        it = iter(pf)
        fetched = [next(it) for _ in range(4)]
        pf.close()
        assert fetched == [(3, 9), (4, 16), (5, 25), (6, 36)]

    def test_prefetcher_surfaces_errors(self):
        def fn(i):
            if i == 1:
                raise ValueError("bad batch")
            return i

        pf = pipeline.Prefetcher(fn)
        assert next(pf) == (0, 0)
        with pytest.raises(ValueError, match="bad batch"):
            next(pf)
        pf.close()

    def test_host_slice(self):
        s = pipeline.host_slice(64, process_index=2, process_count=8)
        assert (s.start, s.stop) == (16, 24)
        assert pipeline.host_slice(64) == slice(0, 64)

    def test_skip_ahead(self):
        assert pipeline.skip_ahead(10, 15) == 15
        assert pipeline.skip_ahead(10, 5) == 10
        assert pipeline.skip_ahead(0, 10**9, max_skip=100) == 100

    def test_labels_in_range(self):
        spec = syn.SyntheticSpec("mnist", batch_size=16, n_train=100)
        x, y = syn.train_batch(spec, 0, device="cpu")
        assert x.shape == (16, 784) and y.shape == (16,)
        assert bool((y >= 0).all() and (y < 10).all())
        assert bool((x >= 0).all() and (x <= 1).all())


def test_failure_injector_fires_once():
    inj = FailureInjector((2,))
    inj.check(1)
    with pytest.raises(InjectedFailure):
        inj.check(2)
    inj.check(2)


# ---------------------------------------------------------------------------
# checkpoints across the two packages
# ---------------------------------------------------------------------------

def _both_states(mode="stoch"):
    """The reference's train state and the port's copy of it, with their
    steps (compression on, so every kind of leaf is there)."""
    tree = jfc.init(jax.random.key(4), hidden=(32, 32))
    jpol = JBinarizePolicy(**PATTERNS)
    jopt = j_sgd_momentum(JS.constant(0.05))
    jstep = jax.jit(JST.make_train_step(JST.make_classifier_loss(jfc.apply), jopt, mode, jpol,
                                        has_model_state=True, use_compression=True))
    jstate = JST.init_train_state(tree["params"], jopt, seed=11, model_state=tree["state"],
                                  use_compression=True)
    x = np.random.default_rng(0).uniform(0, 1, (8, 784)).astype(np.float32)
    y = np.random.default_rng(1).integers(0, 10, 8).astype(np.int32)
    jstate, _ = jstep(jstate, {"x": jnp.asarray(x), "y": jnp.asarray(y)})   # step 1
    opt = sgd_momentum(schedules.constant(0.05))
    step = ST.make_train_step(ST.make_classifier_loss(mnist_fc.apply), opt, mode, POLICY,
                              has_model_state=True, use_compression=True)
    template = from_jax_train_state(jax.tree_util.tree_map(np.asarray, {
        k: (jax.random.key_data(v) if k == "key" else v) for k, v in jstate.items()}),
        device="cpu")
    return jstate, jstep, template, step, (x, y)


def _next_binarized(jstate, state, mode="stoch"):
    """Both packages' binarized weights for the step each state is at."""
    jpol = JBinarizePolicy(**PATTERNS)
    jwb = JB.binarize_tree(jstate["params"], mode, jpol,
                           jax.random.fold_in(jstate["key"], jstate["step"]))
    wb = B.binarize_tree(state["params"], mode, POLICY,
                         prng.fold_in(state["key"], int(state["step"])))
    for (path, a), (_, b) in zip(jax.tree_util.tree_leaves_with_path(jwb),
                                 tree_leaves_with_path(wb)):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=JB._path_str(path))


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    jstate, _, template, step, (x, y) = _both_states()
    JCheckpointManager(str(tmp_path), async_save=False).save(1, jstate)
    restored = CheckpointManager(str(tmp_path)).restore(template)
    assert restored["key"] == prng.Key(*np.asarray(jax.random.key_data(jstate["key"])).tolist())
    assert restored["step"].dtype == torch.int32 and int(restored["step"]) == 1
    for (path, a), (p2, b) in zip(jax.tree_util.tree_leaves_with_path(
            {k: v for k, v in jstate.items() if k != "key"}),
            tree_leaves_with_path({k: v for k, v in restored.items() if k != "key"})):
        assert JB._path_str(path) == p2
        np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=p2)
    _next_binarized(jstate, restored)
    s2, m = step(restored, {"x": torch.from_numpy(x), "y": torch.from_numpy(y)})
    assert int(s2["step"]) == 2 and np.isfinite(float(m["loss"]))


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    jstate, jstep, template, _, (x, y) = _both_states()
    CheckpointManager(str(tmp_path), async_save=False).save(1, template)
    restored = JCheckpointManager(str(tmp_path)).restore(jstate)
    for a, b in zip(jax.tree_util.tree_leaves(jstate), jax.tree_util.tree_leaves(restored)):
        if jax.dtypes.issubdtype(a.dtype, jax.dtypes.prng_key):
            a, b = jax.random.key_data(a), jax.random.key_data(b)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(b), np.asarray(a))
    _next_binarized(restored, template)
    s2, _ = jstep(restored, {"x": jnp.asarray(x), "y": jnp.asarray(y)})
    assert int(s2["step"]) == 2


def test_bf16_leaves_cross_both_ways(tmp_path):
    """A bf16 leaf (a bf16 momentum slot): the reference's checkpoint
    restores in the port bit for bit, and the port's (stored as f32) in the
    reference."""
    vals = np.random.default_rng(0).normal(size=(6, 5)).astype(np.float32)
    jtree = {"mu": jnp.asarray(vals, jnp.bfloat16), "step": jnp.zeros((), jnp.int32)}
    tree = {"mu": torch.from_numpy(vals).to(torch.bfloat16),
            "step": torch.zeros((), dtype=torch.int32)}
    JCheckpointManager(str(tmp_path / "ref"), async_save=False).save(1, jtree)
    got = CheckpointManager(str(tmp_path / "ref")).restore(tree)
    assert got["mu"].dtype == torch.bfloat16
    np.testing.assert_array_equal(got["mu"].float().numpy(),
                                  np.asarray(jtree["mu"].astype(jnp.float32)))
    CheckpointManager(str(tmp_path / "port"), async_save=False).save(1, tree)
    back = JCheckpointManager(str(tmp_path / "port")).restore(jtree)
    assert back["mu"].dtype == jnp.bfloat16
    np.testing.assert_array_equal(np.asarray(back["mu"].astype(jnp.float32)),
                                  tree["mu"].float().numpy())
