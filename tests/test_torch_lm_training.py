"""The port's Alg.-1 training of the LM families against the reference's,
on the CPU at the SMOKE configs.

* The threefry twin's nonzero-``minval`` uniforms (one rounding of
  ``floats * (hi - lo) + lo``, as XLA's contracted FMA) equal
  ``jax.random.uniform`` bit for bit, and ``prng.normal`` is within
  ``NORMAL_ATOL`` of ``jax.random.normal`` (its ``log1p`` is not XLA's).
* ``data.synthetic.lm_tokens`` equals the reference's token for token over
  200 steps, at the CLI's (8, 129, 49152) and at a SMOKE vocab.
* One train step, det and stoch, of a dense, an MoE, an SSM, a hybrid and
  both frontend architectures, from the reference's train state carried
  across (``interop.from_jax_train_state``) and the same batch, gives the
  reference's loss, ``xent``, ``lb_loss`` and new masters within rtol 1e-4
  / atol 2e-5, the tolerance of the reference's ``tests/test_training.py``.
  The momentum (from zero, the step's grads) holds rtol 1e-4 and atol 2e-5
  + ``GRAD_TOL`` x the leaf's largest |grad|: neither package's f32 grads
  are closer than that to the step computed in f64 (the port's, checked
  here for both): +-1 weights scale every projection's output by ~sqrt(K),
  the attention softmax saturates, and its backward cancels. Three steps
  with microbatches, 1-bit compression and AdamW with its cosine schedule
  hold the same; remat ``full`` and ``dots`` give the grads of ``none``
  bit for bit.
* The CLI trains an LM and a frontend architecture on the CPU, and an LM
  train state with AdamW's slots goes through checkpoints both ways.
"""
import dataclasses
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (one intra-op thread a worker)

from repro.checkpoint.manager import CheckpointManager as JCheckpointManager
from repro.configs import base as jcb
from repro.core import packing as JP
from repro.core.policy import DEFAULT_POLICY as J_POLICY
from repro.data import synthetic as jsyn
from repro.kernels import ops as jops
from repro.launch import train as jtrain
from repro.models import frontends as JF
from repro.models import transformer as JT
from repro.optim import schedules as JS
from repro.optim.sgd import adamw as j_adamw
from repro.optim.sgd import sgd_momentum as j_sgd_momentum
from repro.train import steps as JST
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import base as cb
from repro_torch.core import packing, prng
from repro_torch.core.policy import DEFAULT_POLICY
from repro_torch.data import synthetic as syn
from repro_torch.engine.plan import tree_leaves_with_path, tree_map
from repro_torch.interop import from_jax_train_state, from_jax_tree
from repro_torch.kernels import ops
from repro_torch.optim import schedules
from repro_torch.optim.sgd import adamw, sgd_momentum
from repro_torch.train import steps as ST

TOL = dict(rtol=1e-4, atol=2e-5)
# Measured on these SMOKE steps: each package's f32 grads within 4.7e-3 x the
# leaf's largest |grad| of the f64 step, and within 2.6e-3 of each other.
GRAD_TOL = 1e-2
# the fraction of a leaf's elements whose sign may flip under 1-bit
# compression or AdamW's early steps (measured: at most 0.18%)
MAX_FLIPS = 5e-3
# prng.normal against jax.random.normal: the same uniforms and XLA's erfinv
# polynomial, but torch's log1p, so ~1% of the values differ by a few f32
# ulps; at most 4.8e-7 measured over 3 x 204,800 draws.
NORMAL_ATOL = 1e-6
NORMAL_MAX_DIFFERING = 0.015
ARCHS = ("starcoder2_3b", "moonshot_v1_16b_a3b", "mamba2_130m", "jamba_1_5_large",
         "musicgen_large", "internvl2_76b")
BATCH, SEQ, LR = 4, 16, 3e-3


# ---------------------------------------------------------------------------
# the threefry twin's uniform with a nonzero minval, and its normal
# ---------------------------------------------------------------------------

MINVALS = {"1e-6": 1e-6, "nextafter(-1,0)": float(np.nextafter(np.float32(-1), np.float32(0))),
           "tiny": float(np.finfo(np.float32).tiny)}


@pytest.mark.parametrize("seed", [0, 2**31 + 3])
@pytest.mark.parametrize("minval", list(MINVALS))
def test_uniform_with_minval_matches_reference_bit_for_bit(minval, seed):
    lo, shape = MINVALS[minval], (400, 512)
    got = prng.uniform(prng.key(seed), shape, minval=lo)
    want = np.asarray(jax.random.uniform(jax.random.key(seed), shape, jnp.float32, lo, 1.0))
    np.testing.assert_array_equal(got.numpy(), want)


def test_uniform_rounds_the_scale_and_shift_once():
    """The smallest separating input: at minval 1e-6 a product rounded to f32
    before the add differs from the reference's FMA in the last ulp; the
    twin's single rounding does not."""
    k, shape, lo = prng.key(0), (400, 512), 1e-6
    floats = prng.uniform(k, shape)
    lo32 = torch.tensor(lo, dtype=torch.float32)
    twice = torch.maximum(lo32, floats * (1.0 - lo32) + lo32)
    want = np.asarray(jax.random.uniform(jax.random.key(0), shape, jnp.float32, lo, 1.0))
    assert int((twice.numpy() != want).sum()) > 0
    np.testing.assert_array_equal(prng.uniform(k, shape, minval=lo).numpy(), want)


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 3])
def test_normal_matches_reference_within_tolerance(seed):
    shape = (400, 512)
    got = prng.normal(prng.key(seed), shape).numpy()
    want = np.asarray(jax.random.normal(jax.random.key(seed), shape, jnp.float32))
    differing = int((got != want).sum())
    print(f"seed {seed}: {differing} of {got.size} differ, largest by "
          f"{np.abs(got - want).max():.3g}")
    np.testing.assert_allclose(got, want, rtol=0, atol=NORMAL_ATOL)
    assert differing <= NORMAL_MAX_DIFFERING * got.size


# ---------------------------------------------------------------------------
# the synthetic token stream
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("vocab", [49152, 512])
def test_lm_tokens_match_reference(vocab):
    jspec = jsyn.SyntheticSpec("lm", n_train=1 << 30, batch_size=8, seq_len=128,
                               vocab_size=vocab, seed=3)
    spec = syn.SyntheticSpec("lm", batch_size=8, seed=3, seq_len=128, vocab_size=vocab)
    jtok = jax.jit(lambda s: jsyn.lm_tokens(jspec, s))
    for step in range(200):
        got = syn.lm_tokens(spec, step, device="cpu")
        assert got.dtype == torch.int32 and got.shape == (8, 129)
        np.testing.assert_array_equal(got.numpy(), np.asarray(jtok(step)), err_msg=f"step {step}")
    assert torch.equal(syn.train_batch(spec, 5, device="cpu"), syn.lm_tokens(spec, 5, device="cpu"))
    assert torch.equal(syn.eval_batch(spec, device="cpu"),
                       torch.from_numpy(np.asarray(jsyn.eval_batch(jspec))))


# ---------------------------------------------------------------------------
# train steps against the reference's
# ---------------------------------------------------------------------------

def _numpy_state(jstate):
    return jax.tree_util.tree_map(np.asarray, {
        k: (jax.random.key_data(v) if k == "key" else v) for k, v in jstate.items()})


def _jleaves(tree):
    from repro.core import binarize as JB

    return [(JB._path_str(p), a) for p, a in jax.tree_util.tree_leaves_with_path(tree)]


def _close(got, want, what, grad_tol=0.0):
    """Every leaf of the port tree within rtol 1e-4 / atol 2e-5 (+ ``grad_tol``
    x the leaf's largest |value|) of the reference's."""
    got = list(tree_leaves_with_path(got))
    assert [p for p, _ in got] == [p for p, _ in want], what
    for (path, g), (_, a) in zip(got, want):
        a = np.asarray(a, np.float64)
        np.testing.assert_allclose(g.detach().double().numpy(), a, rtol=TOL["rtol"],
                                   atol=TOL["atol"] + grad_tol * float(np.abs(a).max()),
                                   err_msg=f"{what} {path}")


class _States:
    """The reference's SMOKE masters per arch and its batches, built once."""

    def __init__(self):
        self._masters, self._batches, self._jsteps = {}, {}, {}

    def jstep(self, arch, mode, optimizer, microbatches, compress):
        """(optimizer, jitted train step) of the reference, compiled once a
        configuration."""
        key = (arch, mode, optimizer, microbatches, compress)
        if key not in self._jsteps:
            jcfg = self.masters(arch)[0]
            jopt = (j_adamw(JS.cosine(LR, 2, 3)) if optimizer == "adamw"
                    else j_sgd_momentum(JS.constant(LR)))
            self._jsteps[key] = (jopt, jax.jit(JST.make_train_step(
                JST.make_lm_loss(jcfg), jopt, mode, J_POLICY, microbatches=microbatches,
                use_compression=compress)))
        return self._jsteps[key]

    def masters(self, arch):
        if arch not in self._masters:
            jcfg = jcb.get_config(arch, smoke=True)
            self._masters[arch] = (jcfg, cb.get_config(arch, smoke=True),
                                   JT.init_lm(jcfg, jax.random.key(0)))
        return self._masters[arch]

    def batch(self, arch, step=0):
        """(reference batch, port batch): tokens from the reference's stream,
        or for a frontend arch its stub's bf16 embeddings and labels."""
        if (arch, step) not in self._batches:
            jcfg, _, _ = self.masters(arch)
            spec = jsyn.SyntheticSpec("lm", n_train=1 << 30, batch_size=BATCH, seq_len=SEQ,
                                      vocab_size=jcfg.vocab_size, seed=step)
            toks = jsyn.lm_tokens(spec, step)
            if jcfg.frontend:
                emb = JF.STUBS[jcfg.frontend](jax.random.key(11 + step), BATCH, SEQ, jcfg.d_model)
                jb = {"tokens": emb, "labels": toks[:, 1:]}
            else:
                jb = {"tokens": toks}
            self._batches[(arch, step)] = (jb, from_jax_tree(jb, device="cpu"))
        return self._batches[(arch, step)]


@pytest.fixture(scope="module")
def states():
    return _States()


def _steps(states, arch, mode, *, n_steps=1, optimizer="sgd", microbatches=1, compress=False):
    """Runs ``n_steps`` of the reference's step and, before each, carries its
    state across and runs the port's step from it on the same batch: each
    step is held from equal states (two runs' grads differ in f32, and a
    master near zero would binarize differently). Yields (reference state
    before, after, metrics, port state after, metrics) a step."""
    jcfg, cfg, jparams = states.masters(arch)
    jopt, jstep = states.jstep(arch, mode, optimizer, microbatches, compress)
    opt = (adamw(schedules.cosine(LR, 2, 3)) if optimizer == "adamw"
           else sgd_momentum(schedules.constant(LR)))
    step = ST.make_train_step(ST.make_lm_loss(cfg), opt, mode, DEFAULT_POLICY,
                              microbatches=microbatches, use_compression=compress)
    jstate = JST.init_train_state(jparams, jopt, seed=5, use_compression=compress)
    for i in range(n_steps):
        jb, b = states.batch(arch, i)
        state = from_jax_train_state(_numpy_state(jstate), device="cpu")
        jnew, jm = jstep(jstate, jb)
        new, m = step(state, b)
        yield jstate, jnew, jm, new, m
        jstate = jnew


def _close_up_to_flips(got, want, tol, what, max_flips):
    """``got`` within ``tol`` of ``want`` elementwise, except for at most
    ``max_flips`` of the elements (a fraction; one in a smaller leaf), each within twice the
    leaf's largest |want|: a sign-compressed grad, or an early AdamW step
    (``m / sqrt(v)`` ~ sign(g)), flips where g is within the grads' f32
    error of 0, and the flip carries into the momentum and the masters."""
    tol = np.broadcast_to(tol, want.shape)
    diff = np.abs(got - want)
    flips = int((diff > tol).sum())
    assert flips <= (max(1.0, max_flips * got.size) if max_flips else 0), (
        f"{what}: {flips} of {got.size} elements differ, by up to {diff.max():.3g} "
        f"(tolerance {tol.max():.3g})")
    assert (diff <= tol + 2 * np.abs(want).max()).all(), f"{what}: {diff.max():.3g} off"
    return flips


def _hold_step(jold, jstate, jm, state, m, slots=("mu",), max_flips=0.0,
               metrics=("loss", "xent", "lb_loss")):
    """Loss, ``xent`` and ``lb_loss`` within ``TOL``; each master leaf's
    update within ``TOL`` + ``GRAD_TOL`` x its largest update (the update
    carries the grads' error); the optimizer slots within ``TOL`` +
    ``GRAD_TOL`` x their largest |value|; up to ``max_flips`` of a leaf's
    updates and slots may flip sign (:func:`_close_up_to_flips`)."""
    for name in metrics:
        np.testing.assert_allclose(float(m[name]), float(jm[name]), **TOL, err_msg=name)
    old = dict(_jleaves(jold["params"]))
    flips = 0
    for (path, g), (_, a) in zip(tree_leaves_with_path(state["params"]),
                                 _jleaves(jstate["params"])):
        before = np.asarray(old[path], np.float64)
        want = np.asarray(a, np.float64) - before
        tol = TOL["atol"] + GRAD_TOL * float(np.abs(want).max())
        flips += _close_up_to_flips(g.double().numpy() - before, want, tol, f"params {path}",
                                    max_flips)
    for slot in slots:
        for (path, g), (_, a) in zip(tree_leaves_with_path(state["opt"][slot]),
                                     _jleaves(jstate["opt"][slot])):
            a = np.asarray(a, np.float64)
            tol = TOL["atol"] + TOL["rtol"] * np.abs(a) + GRAD_TOL * float(np.abs(a).max())
            flips += _close_up_to_flips(g.double().numpy(), a, tol, f"{slot} {path}",
                                        max_flips)
    assert int(state["step"]) == int(jstate["step"])
    return flips


@pytest.mark.parametrize("mode", ["det", "stoch"])
@pytest.mark.parametrize("arch", ARCHS)
def test_one_step_matches_reference(states, arch, mode):
    (jold, jstate, jm, state, m), = _steps(states, arch, mode)
    _hold_step(jold, jstate, jm, state, m)
    # the basis of GRAD_TOL: the same step's grads in f64 (the port's, from
    # the same masters, batch and key); both packages' f32 grads are the
    # momentum of their step
    _, cfg, jparams = states.masters(arch)
    f64 = lambda t: t.double() if t.is_floating_point() else t  # noqa: E731
    _, batch = states.batch(arch)
    _, g64 = ST.binarized_value_and_grad(
        ST.make_lm_loss(dataclasses.replace(cfg, dtype="float64")),
        tree_map(f64, from_jax_tree(jparams, device="cpu")), tree_map(f64, batch), mode=mode,
        policy=DEFAULT_POLICY, key=prng.fold_in(prng.key(5), 0))
    for who, grads in (("port", list(tree_leaves_with_path(state["opt"]["mu"]))),
                       ("reference", _jleaves(jstate["opt"]["mu"]))):
        for (path, g), (_, want) in zip(grads, tree_leaves_with_path(g64)):
            g = g.double().numpy() if isinstance(g, torch.Tensor) else np.asarray(g, np.float64)
            err, scale = np.abs(g - want.numpy()).max(), float(want.abs().max())
            assert err <= TOL["atol"] + GRAD_TOL * scale, (who, path, err, scale)
    assert float(m["loss"]) > 0 and (float(m["lb_loss"]) > 0) == bool(
        states.masters(arch)[1].n_experts)
    clipped = [float(t.abs().max()) for p, t in tree_leaves_with_path(state["params"])
               if DEFAULT_POLICY.selects(p)]
    assert clipped and max(clipped) <= 1.0


@pytest.mark.parametrize("arch,mode,kw", [
    ("starcoder2_3b", "det", dict(microbatches=4)),
    ("moonshot_v1_16b_a3b", "stoch", dict(microbatches=4)),
    ("starcoder2_3b", "stoch", dict(compress=True)),
    ("starcoder2_3b", "det", dict(optimizer="adamw")),
    ("musicgen_large", "stoch", dict(optimizer="adamw", compress=True)),
])
def test_three_steps_match_reference(states, arch, mode, kw):
    """Each of three steps from the reference's state: microbatches, 1-bit
    compression (its residual ``err`` too) and AdamW under its cosine
    schedule; sign-compressed grads and AdamW's early steps may flip the
    sign of up to ``MAX_FLIPS`` of a leaf's elements."""
    max_flips = MAX_FLIPS if (kw.get("compress") or kw.get("optimizer")) else 0.0
    flips = 0
    for jold, jstate, jm, state, m in _steps(states, arch, mode, n_steps=3, **kw):
        flips += _hold_step(jold, jstate, jm, state, m, max_flips=max_flips,
                            slots=("m", "v") if kw.get("optimizer") else ("mu",))
        if kw.get("compress"):
            for (path, g), (_, a) in zip(tree_leaves_with_path(state["err"]),
                                         _jleaves(jstate["err"])):
                a = np.asarray(a, np.float64)
                flips += _close_up_to_flips(
                    g.double().numpy(), a,
                    TOL["atol"] + TOL["rtol"] * np.abs(a) + GRAD_TOL * float(np.abs(a).max()),
                    f"err {path}", max_flips)
    print(f"{arch} {mode} {kw}: {flips} sign flips over the three steps")


def test_microbatches_match_the_whole_batch(states):
    """A dense arch's step over 4 microbatches is its step over the whole
    batch: the mean of the microbatch losses and grads (equal-sized
    microbatches; ``xent`` is the last microbatch's, as the reference
    reports it), held as a step against the whole batch's."""
    (jold, _, _, one, m1), = _steps(states, "starcoder2_3b", "det")
    (_, _, _, four, m4), = _steps(states, "starcoder2_3b", "det", microbatches=4)
    as_ref = {k: tree_map(lambda t: t.numpy(), one[k]) for k in ("params", "opt")}
    _hold_step(jold, dict(as_ref, step=one["step"]), m1, four, m4, metrics=("loss",))


@pytest.mark.parametrize("arch", ["starcoder2_3b", "moonshot_v1_16b_a3b", "mamba2_130m",
                                  "jamba_1_5_large"])
def test_remat_changes_no_grad(states, arch):
    """Checkpointing each layer (``full``) or keeping only its matrix
    products (``dots``) gives the grads of no remat, bit for bit."""
    _, cfg, jparams = states.masters(arch)
    params = from_jax_tree(jparams, device="cpu")
    _, batch = states.batch(arch)
    grads = {}
    for remat in ("none", "full", "dots"):
        c = dataclasses.replace(cfg, remat=remat)
        (loss, _), g = ST.binarized_value_and_grad(ST.make_lm_loss(c), params, batch,
                                                   mode="stoch", policy=DEFAULT_POLICY,
                                                   key=prng.key(3))
        grads[remat] = (loss, g)
    for remat in ("full", "dots"):
        assert torch.equal(grads[remat][0], grads["none"][0])
        for (path, a), (_, b) in zip(tree_leaves_with_path(grads[remat][1]),
                                     tree_leaves_with_path(grads["none"][1])):
            assert torch.equal(a, b), (remat, path)


# ---------------------------------------------------------------------------
# the CLI, checkpoints, and the small leftovers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["starcoder2_3b", "musicgen-large"])
def test_cli_trains_lm_archs_on_cpu(tmp_path, capsys, arch):
    """The CLI prints the reference's parameter line and its ``done:`` line,
    recovers from an injected failure, and trains an LM state with AdamW;
    without ``--device cpu`` and a card it raises."""
    from repro_torch.launch import train

    jtrain.build_lm(jcb.canonical_arch(arch), SimpleNamespace(
        smoke=True, seed=0, binarize="det", lr=3e-3, optimizer="sgd", steps=3,
        microbatches=1, compress=False, batch=8, seq=128))
    want = capsys.readouterr().out.splitlines()[0]
    trainer = train.main(["--arch", arch, "--smoke", "--device", "cpu", "--steps", "3",
                          "--ckpt-dir", str(tmp_path), "--ckpt-every", "1", "--fail-at", "2",
                          "--optimizer", "adamw"])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == want
    assert out[1].startswith("done: ") and "recoveries=1" in out[1]
    assert int(trainer.state["step"]) == 3 and set(trainer.state["opt"]) == {"m", "v"}
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA"):
            train.main(["--arch", arch, "--smoke", "--steps", "1"])


def test_lm_state_with_adamw_slots_checkpoints_both_ways(states, tmp_path):
    """An LM train state with AdamW's slots: the reference's checkpoint
    restores in the port, and the port's in the reference, leaf for leaf."""
    _, _, jparams = states.masters("moonshot_v1_16b_a3b")
    jopt = j_adamw(JS.cosine(LR, 2, 3))
    jstate = JST.init_train_state(jparams, jopt, seed=5, use_compression=True)
    state = from_jax_train_state(_numpy_state(jstate), device="cpu")
    assert set(state["opt"]) == {"m", "v"} and "err" in state
    JCheckpointManager(str(tmp_path / "ref"), async_save=False).save(4, jstate)
    restored = CheckpointManager(str(tmp_path / "ref")).restore(state)
    for (path, a), (_, b) in zip(tree_leaves_with_path(restored), tree_leaves_with_path(state)):
        assert (a == b) if isinstance(a, prng.Key) else torch.equal(a, b), path
    CheckpointManager(str(tmp_path / "port"), async_save=False).save(4, state)
    back = JCheckpointManager(str(tmp_path / "port")).restore(jstate)
    for (path, a), (_, b) in zip(_jleaves(back), _jleaves(jstate)):
        np.testing.assert_array_equal(np.asarray(jax.random.key_data(a) if path == "key" else a),
                                      np.asarray(jax.random.key_data(b) if path == "key" else b))


@pytest.mark.parametrize("shape,dtype_bytes", [((4096, 4096), 2), ((100, 7), 4), ((33,), 2),
                                               ((64, 3, 5), 1)])
def test_compression_ratio_matches_reference(shape, dtype_bytes):
    assert packing.compression_ratio(shape, dtype_bytes) == JP.compression_ratio(shape,
                                                                                 dtype_bytes)


@pytest.mark.parametrize("shape", [(64, 8), (70, 5), (5, 3, 2)])
def test_pack_master_weights_matches_reference(shape):
    w = np.where(np.random.default_rng(0).uniform(size=shape) < 0.5, -1.0, 1.0)
    w = w.astype(np.float32)
    np.testing.assert_array_equal(ops.pack_master_weights(torch.from_numpy(w)).numpy(),
                                  np.asarray(jops.pack_master_weights(jnp.asarray(w))))
