"""The port's Alg.-1 training against the reference's, and a mirror of the
reference's training tests (``tests/test_training.py``).

Parity: from the same params, batch and key (the reference's train state
carried across with ``interop.from_jax_train_state``), one port step of
mnist_fc (hidden (64, 64)) and VGG-16 (width 0.125), det and stoch, uses
the reference's binarized weights bit for bit, and gives its loss, grads,
updated masters, momentum and batch-norm running stats within

* mnist_fc: rtol 1e-4 and atol 1e-4 x the largest |value| of the tree
  (the differences measured here stay under 5e-6 of it);
* VGG-16: rtol 1e-3 and atol 1e-3 x the largest |value| of the tree (the
  differences measured here stay under 2.6e-4 of it, at 2 images a
  microbatch). The reference's XLA CPU convs are the less exact side:
  ``test_one_step_matches_reference`` holds its f32 grads within 1e-3 of
  an f64 run of the port's step, and the port's f32 grads closer still;
  training-mode batch norm over a small batch amplifies the f32 sum order
  of the deep layers.

The learning tests run the port on its own synthetic data (the same
distribution as the reference's, not the same numbers).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (one intra-op thread a worker)

from repro.core import binarize as JB
from repro.launch.train import make_paper_policy as j_make_paper_policy
from repro.models import mnist_fc as jfc
from repro.models import vgg as jvgg
from repro.models.layers import batch_norm as j_batch_norm
from repro.optim import compression as jcomp
from repro.optim import schedules as JS
from repro.optim.sgd import sgd_momentum as j_sgd_momentum
from repro.train import steps as JST
from repro_torch.core import binarize as B
from repro_torch.core import prng
from repro_torch.core.policy import NONE_POLICY, BinarizePolicy, make_paper_policy
from repro_torch.data import synthetic as syn
from repro_torch.engine.plan import tree_leaves_with_path, tree_map
from repro_torch.interop import from_jax_train_state, from_jax_tree
from repro_torch.models import mnist_fc, vgg
from repro_torch.models.layers import apply_linear, batch_norm
from repro_torch.optim import compression, schedules
from repro_torch.optim.sgd import adamw, clip_by_global_norm, global_norm, sgd_momentum
from repro_torch.train import steps as ST
from repro_torch.train.losses import softmax_xent

TOL = {"mnist_fc": 1e-4, "vgg16_cifar10": 1e-3}
# BNN convention: first and last (classifier) layers stay full precision.
POLICY = BinarizePolicy(include=(r".*kernel$",),
                        exclude=(r"layers/0/kernel", r"layers/2/kernel"))


def _numpy_state(jstate):
    """A reference train state with numpy leaves, ``key`` as its key data."""
    return jax.tree_util.tree_map(np.asarray, {
        k: (jax.random.key_data(v) if k == "key" else v) for k, v in jstate.items()})


def _setup(arch, mode, *, microbatches=1, use_compression=False, seed=0, grad_clip=None,
           compute_dtype=None):
    """(reference step, reference state, port step, port state, batch as
    numpy, policy pair) for one arch, from the same reference init."""
    if arch == "mnist_fc":
        tree = jfc.init(jax.random.key(seed), hidden=(64, 64))
        japply, apply = jfc.apply, mnist_fc.apply
        x = np.random.default_rng(seed + 1).uniform(0, 1, (8, 784)).astype(np.float32)
    else:
        tree = jvgg.init(jax.random.key(seed), width_mult=0.125)
        japply, apply = jvgg.apply, vgg.apply
        x = np.random.default_rng(seed + 1).uniform(0, 1, (4, 32, 32, 3)).astype(np.float32)
    y = np.random.default_rng(seed + 2).integers(0, 10, x.shape[0]).astype(np.int32)
    jpol, pol = j_make_paper_policy(3), make_paper_policy(3)
    kw = dict(has_model_state=True, microbatches=microbatches,
              use_compression=use_compression, grad_clip=grad_clip)
    jopt = j_sgd_momentum(JS.constant(0.05), momentum=0.9)
    jstate = JST.init_train_state(tree["params"], jopt, seed=seed + 3,
                                  model_state=tree["state"], use_compression=use_compression)
    jstep = jax.jit(JST.make_train_step(
        JST.make_classifier_loss(japply), jopt, mode, jpol, **kw,
        compute_dtype=None if compute_dtype is None else jnp.bfloat16))
    opt = sgd_momentum(schedules.constant(0.05), momentum=0.9)
    step = ST.make_train_step(ST.make_classifier_loss(apply), opt, mode, pol, **kw,
                              compute_dtype=compute_dtype)
    state = from_jax_train_state(_numpy_state(jstate), device="cpu")
    return jstep, jstate, step, state, (x, y), (jpol, pol), (japply, apply)


def _close_trees(got, want, tol, what):
    """Every leaf of the port tree within rtol ``tol`` and atol ``tol`` x the
    largest |value| of the reference tree."""
    want = [(p, np.asarray(a, np.float64)) for p, a in want]
    scale = max(float(np.abs(a).max()) for _, a in want)
    got = list(tree_leaves_with_path(got))
    assert [p for p, _ in got] == [p for p, _ in want], what
    for (path, g), (_, a) in zip(got, want):
        np.testing.assert_allclose(g.detach().double().numpy(), a, rtol=tol, atol=tol * scale,
                                   err_msg=f"{what} {path}")


def _jleaves(tree):
    return [(JB._path_str(p), a) for p, a in jax.tree_util.tree_leaves_with_path(tree)]


@pytest.mark.parametrize("arch", ["mnist_fc", "vgg16_cifar10"])
@pytest.mark.parametrize("mode", ["det", "stoch"])
def test_one_step_matches_reference(arch, mode):
    jstep, jstate, step, state, (x, y), (jpol, pol), (_, apply) = _setup(arch, mode)
    tol = TOL[arch]
    # Alg. 1 (1): the binarized weights at the step key, bit for bit
    jwb = JB.binarize_tree(jstate["params"], mode, jpol,
                           jax.random.fold_in(jstate["key"], jstate["step"]))
    key = prng.fold_in(state["key"], int(state["step"]))
    wb = B.binarize_tree(state["params"], mode, pol, key)
    for (path, a), (_, b) in zip(_jleaves(jwb), tree_leaves_with_path(wb)):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=path)
    # Alg. 1 (2)-(3): the whole step; from zero momentum the new momentum
    # is the step's gradient (0.9 * 0 + g), so the reference's grads are
    # its opt/mu
    batch = {"x": torch.from_numpy(x), "y": torch.from_numpy(y)}
    js1, jm = jstep(jstate, {"x": jnp.asarray(x), "y": jnp.asarray(y)})
    (loss, _), grads = ST.binarized_value_and_grad(
        ST.make_classifier_loss(apply), state["params"], batch, mode=mode, policy=pol,
        key=key, model_state=state["model_state"])
    np.testing.assert_allclose(float(loss), float(jm["loss"]), rtol=tol)
    _close_trees(grads, _jleaves(js1["opt"]["mu"]), tol, "grads")
    if arch == "vgg16_cifar10":
        # the basis of VGG's tolerance: against the port's step in f64, the
        # reference's f32 grads stay within it and the port's are closer
        f64 = tree_map(lambda t: t.to(torch.float64), {"p": state["params"],
                                                      "s": state["model_state"]})
        (_, _), g64 = ST.binarized_value_and_grad(
            ST.make_classifier_loss(apply), f64["p"], {"x": batch["x"].double(), "y": batch["y"]},
            mode=mode, policy=pol, key=key, model_state=f64["s"])
        g64 = [t.numpy() for _, t in tree_leaves_with_path(g64)]
        scale = max(float(np.abs(g).max()) for g in g64)
        ref_err, port_err = (max(float(np.abs(np.asarray(a, np.float64) - g).max())
                                 for a, g in zip(leaves, g64)) for leaves in (
            [a for _, a in _jleaves(js1["opt"]["mu"])],
            [t.double().numpy() for _, t in tree_leaves_with_path(grads)]))
        print(f"{mode}: against f64, the reference's f32 grads {ref_err / scale:.3g} and the "
              f"port's {port_err / scale:.3g} of the largest grad, {scale:.4g}")
        assert ref_err <= tol * scale and port_err < ref_err
    s1, m = step(state, batch)
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=tol)
    for name in ("params", "opt", "model_state"):
        _close_trees(s1[name], _jleaves(js1[name]), tol, name)
    assert int(s1["step"]) == int(js1["step"]) == 1 and s1["key"] == state["key"]
    assert float(s1["params"]["layers" if arch == "mnist_fc" else "fc"][1]["kernel"]
                 .abs().max()) <= 1.0


@pytest.mark.parametrize("arch,mode,mb,comp,clip", [
    ("mnist_fc", "det", 2, False, None), ("mnist_fc", "stoch", 1, True, None),
    ("mnist_fc", "det", 2, True, None), ("vgg16_cifar10", "det", 2, False, None),
    ("mnist_fc", "stoch", 1, False, 0.5)])
def test_microbatches_compression_and_clipping_match_reference(arch, mode, mb, comp, clip):
    jstep, jstate, step, state, (x, y), _, _ = _setup(arch, mode, microbatches=mb,
                                                      use_compression=comp, grad_clip=clip)
    js1, jm = jstep(jstate, {"x": jnp.asarray(x), "y": jnp.asarray(y)})
    s1, m = step(state, {"x": torch.from_numpy(x), "y": torch.from_numpy(y)})
    tol = TOL[arch]
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=tol)
    if clip is not None:
        np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]), rtol=tol)
        assert float(jm["grad_norm"]) > clip            # the clip bites
    for name in ("params", "opt", "model_state") + (("err",) if comp else ()):
        _close_trees(s1[name], _jleaves(js1[name]), tol, name)


def test_bf16_compute_matches_reference():
    """``compute_dtype=bf16``: the binarized tree is cast to bf16 for the
    forward and backward (+-1 exactly; the full-precision leaves rounded),
    the masters stay f32. Held at rtol 1e-2 / atol 1e-2 x the tree's
    largest value (bf16's 8-bit mantissa on the full-precision layers)."""
    jstep, jstate, step, state, (x, y), _, _ = _setup("mnist_fc", "det",
                                                      compute_dtype=torch.bfloat16)
    js1, jm = jstep(jstate, {"x": jnp.asarray(x), "y": jnp.asarray(y)})
    s1, m = step(state, {"x": torch.from_numpy(x), "y": torch.from_numpy(y)})
    assert all(t.dtype == torch.float32 for _, t in tree_leaves_with_path(s1["params"]))
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-2)
    for name in ("params", "opt", "model_state"):
        _close_trees(s1[name], _jleaves(js1[name]), 1e-2, name)


def test_two_steps_track_the_reference():
    """Step 2 binarizes masters the two packages updated separately: the
    signs that differ are counted (a master within ~1e-8 of 0 may binarize
    either way) and the losses held within mnist_fc's tolerance."""
    jstep, jstate, step, state, (x, y), (jpol, pol), _ = _setup("mnist_fc", "det")
    jb, b = {"x": jnp.asarray(x), "y": jnp.asarray(y)}, {"x": torch.from_numpy(x),
                                                       "y": torch.from_numpy(y)}
    for _ in range(2):
        jstate, jm = jstep(jstate, jb)
        state, m = step(state, b)
    flips = sum(int((np.asarray(a) != c.numpy()).sum()) for (path, a), (_, c) in zip(
        _jleaves(JB.binarize_tree(jstate["params"], "det", jpol)),
        tree_leaves_with_path(B.binarize_tree(state["params"], "det", pol)))
        if pol.selects(path))
    assert flips == 0
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-4)


def test_ste_forward_is_the_binarized_weight_and_backward_the_identity():
    w = torch.randn(64, 40, generator=torch.Generator().manual_seed(0))
    w[0, :4] = torch.tensor([2.0 ** -149, -(2.0 ** -149), 0.0, 2.0 ** -126])
    k = prng.key(7)
    jk = jax.random.key(7)
    for mode, key, jkey in (("det", None, None), ("stoch", k, jk)):
        wm = w.clone().requires_grad_(True)
        wb = B.binarize(wm, mode, key)
        np.testing.assert_array_equal(wb.detach().numpy(),
                                      np.asarray(JB.binarize(jnp.asarray(w.numpy()), mode, jkey)))
        g = torch.randn(64, 40, generator=torch.Generator().manual_seed(1))
        (gw,) = torch.autograd.grad(wb, wm, g)
        assert torch.equal(gw, g)
    assert B.binarize(w, "none") is w
    with pytest.raises(ValueError, match="PRNG key"):
        B.binarize(w, "stoch")


def test_tree_binarize_and_clip_match_reference():
    """Paths, selection and the stochastic key split over the selected
    leaves (in tree order) are the reference's: the same +-1 leaves."""
    tree = jfc.init(jax.random.key(2), hidden=(96, 64, 64))
    params = from_jax_tree(jax.tree_util.tree_map(np.asarray, tree["params"]), device="cpu")
    pol, jpol = make_paper_policy(4), j_make_paper_policy(4)
    for mode in ("det", "stoch"):
        want = JB.binarize_tree(tree["params"], mode, jpol, jax.random.key(9))
        got = B.binarize_tree(params, mode, pol, prng.key(9))
        for (path, a), (_, b) in zip(_jleaves(want), tree_leaves_with_path(got)):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=path)
    big = jax.tree_util.tree_map(lambda a: a * 3.0, tree["params"])
    want = JB.clip_tree(big, jpol)
    got = B.clip_tree(from_jax_tree(jax.tree_util.tree_map(np.asarray, big), device="cpu"), pol)
    for (path, a), (_, b) in zip(_jleaves(want), tree_leaves_with_path(got)):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=path)
    assert B.binarize_tree(params, "none", pol) is params


@pytest.mark.parametrize("axes,shape", [((0,), (8, 48)), ((0, 1, 2), (2, 5, 6, 16))])
def test_training_batch_norm_matches_reference(axes, shape):
    rng = np.random.default_rng(sum(shape))
    x = rng.normal(1.0, 2.0, shape).astype(np.float32)
    c = shape[-1]
    vecs = [rng.uniform(0.5, 1.5, c), rng.normal(0, 0.1, c), rng.normal(0, 0.5, c),
            rng.uniform(0.5, 4.0, c)]
    vecs = [v.astype(np.float32) for v in vecs]
    want = j_batch_norm(jnp.asarray(x), *map(jnp.asarray, vecs), training=True, axes=axes)
    xt = torch.from_numpy(x).requires_grad_(True)
    got = batch_norm(xt, *map(torch.from_numpy, vecs), training=True, axes=axes)
    for a, b in zip(want, got):
        np.testing.assert_allclose(b.detach().numpy(), np.asarray(a), rtol=1e-5, atol=1e-5)
    assert not got[1].requires_grad and not got[2].requires_grad
    jg = jax.grad(lambda v: jnp.sum(jnp.sin(j_batch_norm(v, *map(jnp.asarray, vecs),
                                                         training=True, axes=axes)[0])))(
        jnp.asarray(x))
    (g,) = torch.autograd.grad(torch.sum(torch.sin(got[0])), xt)
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("arch", ["mnist_fc", "vgg16_cifar10"])
def test_training_forward_returns_the_new_state(arch):
    """``apply(training=True)`` returns (logits, new_state) like the
    reference's; eval mode returns the logits alone (the serving call)."""
    if arch == "mnist_fc":
        tree = jfc.init(jax.random.key(1), hidden=(64, 64))
        jmod, mod = jfc, mnist_fc
        x = np.random.default_rng(1).uniform(0, 1, (6, 784)).astype(np.float32)
    else:
        tree = jvgg.init(jax.random.key(1), width_mult=0.125)
        jmod, mod = jvgg, vgg
        x = np.random.default_rng(1).uniform(0, 1, (4, 32, 32, 3)).astype(np.float32)
    jlogits, jnew = jmod.apply(tree["params"], tree["state"], jnp.asarray(x), training=True)
    port = from_jax_tree(jax.tree_util.tree_map(np.asarray, tree), device="cpu")
    logits, new = mod.apply(port["params"], port["state"], torch.from_numpy(x), training=True)
    tol = TOL[arch]
    _close_trees(new, _jleaves(jnew), tol, "new_state")
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits), rtol=tol,
                               atol=tol * float(np.abs(np.asarray(jlogits)).max()))
    assert isinstance(mod.apply(port["params"], port["state"], torch.from_numpy(x)),
                      torch.Tensor)


def test_schedules_match_reference():
    steps = [0, 1, 9, 10, 55, 199, 2000]
    for jsched, sched in ((JS.paper_eq4(1e-3, 10), schedules.paper_eq4(1e-3, 10)),
                          (JS.constant(0.05), schedules.constant(0.05)),
                          (JS.cosine(0.1, 20, 200), schedules.cosine(0.1, 20, 200))):
        for s in steps:
            want = float(jsched(jnp.asarray(s, jnp.int32)))
            got = sched(torch.tensor(s, dtype=torch.int32))
            assert got.dtype == torch.float32 and got.ndim == 0
            np.testing.assert_allclose(float(got), want, rtol=2e-6)


def test_compression_signs_a_negative_subnormal_as_the_reference():
    """The reference reads g + e = -2^-149 as -0 and signs it +1."""
    g = np.array([1.0, -2.0, 0.0, 3.0, -(2.0 ** -149), -(2.0 ** -127), 2.0 ** -126, -0.0],
                 np.float32)
    jsign, jscale, jerr = jcomp.compress(jnp.asarray(g), jnp.zeros(8))
    sign, scale, err = compression.compress(torch.from_numpy(g), torch.zeros(8))
    np.testing.assert_array_equal(sign.numpy(), np.asarray(jsign))
    assert sign.dtype == torch.int8
    np.testing.assert_allclose(float(scale), float(jscale), rtol=1e-7)
    np.testing.assert_allclose(err.numpy(), np.asarray(jerr), rtol=1e-6)


# ---------------------------------------------------------------------------
# the reference's tests/test_training.py, on the port
# ---------------------------------------------------------------------------

def _learn_setup(mode, hidden=(64, 64), batch=64, use_compression=False,
                 momentum_dtype=None):
    tree = mnist_fc.init(torch.Generator().manual_seed(0), hidden=hidden, device="cpu")
    opt = sgd_momentum(schedules.constant(0.05), momentum=0.9,
                       momentum_dtype=momentum_dtype)
    step = ST.make_train_step(ST.make_classifier_loss(mnist_fc.apply), opt, mode,
                              POLICY if mode != "none" else NONE_POLICY,
                              has_model_state=True, use_compression=use_compression)
    state = ST.init_train_state(tree["params"], opt, model_state=tree["state"],
                                use_compression=use_compression)
    spec = syn.SyntheticSpec("mnist", batch_size=batch, n_train=6000)
    return step, state, spec


def _batch(spec, i):
    x, y = syn.train_batch(spec, i, device="cpu")
    return {"x": x, "y": y}


@pytest.mark.parametrize("mode", ["none", "det", "stoch"])
def test_learns_synthetic_mnist(mode):
    """The paper's core claim at unit scale: binarized (det and stoch) nets
    train to high accuracy, tracking the unregularized net."""
    step, state, spec = _learn_setup(mode)
    for i in range(150):
        state, _ = step(state, _batch(spec, i))
    params, model_state = state["params"], state["model_state"]
    if mode != "none":  # inference runs on binarized weights (Alg. 1)
        params = B.binarize_tree(params, "det", POLICY)
    if mode == "stoch":  # BN stats were accumulated under random sign draws
        cal = [syn.train_batch(spec, 10_000 + j, device="cpu")[0] for j in range(20)]
        model_state = ST.recalibrate_bn(mnist_fc.apply, params, model_state, cal)
    x, y = syn.eval_batch(spec, device="cpu")
    _, acc = ST.make_eval_fn(mnist_fc.apply)(params, model_state, x, y)
    assert float(acc) > 0.9, f"{mode}: accuracy {float(acc)}"


def test_masters_clipped_and_binary_values_used():
    step, state, spec = _learn_setup("det")
    state, _ = step(state, _batch(spec, 0))
    assert float(state["params"]["layers"][1]["kernel"].abs().max()) <= 1.0  # Alg. 1 step 4


def test_eq4_schedule_closed_form():
    sched = schedules.paper_eq4(1e-3, steps_per_epoch=10)
    # eta[E] = eta0 * 0.01 ** (E(E+1)/200)
    for epoch in (0, 1, 5, 20):
        got = float(sched(torch.tensor(epoch * 10, dtype=torch.int32)))
        np.testing.assert_allclose(got, 1e-3 * 0.01 ** (epoch * (epoch + 1) / 200), rtol=1e-5)


def test_eq4_monotone_decay():
    sched = schedules.paper_eq4(1e-3, steps_per_epoch=5)
    vals = [float(sched(torch.tensor(s, dtype=torch.int32))) for s in range(0, 100, 5)]
    assert all(a >= b for a, b in zip(vals, vals[1:]))
    assert vals[0] == pytest.approx(1e-3)


def test_microbatch_equals_full_batch():
    """Gradient accumulation reproduces the large-batch step on a
    batch-norm-free net, whose loss is mean-decomposable across microbatches
    (batch norm genuinely differs under accumulation: per-microbatch
    statistics)."""
    g = torch.Generator().manual_seed(0)
    params = {"w1": torch.randn(32, 48, generator=g) * 0.2,
              "w2": torch.randn(48, 10, generator=g) * 0.2}
    pol = BinarizePolicy(include=(r"w1",), exclude=())

    def loss_fn(p, batch):
        h = torch.relu(apply_linear(p["w1"], batch["x"]))
        return softmax_xent(apply_linear(p["w2"], h), batch["y"]), {}

    batch = {"x": torch.randn(8, 32, generator=g), "y": torch.randint(0, 10, (8,), generator=g)}
    opt = sgd_momentum(schedules.constant(0.05), momentum=0.9)
    outs = []
    for mb in (1, 4):
        step = ST.make_train_step(loss_fn, opt, "det", pol, microbatches=mb)
        s, _ = step(ST.init_train_state({k: v.clone() for k, v in params.items()}, opt), batch)
        outs.append(s["params"])
    for k in params:
        np.testing.assert_allclose(outs[0][k].numpy(), outs[1][k].numpy(), rtol=1e-4, atol=2e-5)


class TestCompression:
    def test_error_feedback_identity(self):
        """decompressed + error == corrected gradient (lossless bookkeeping)."""
        g = torch.randn(256, generator=torch.Generator().manual_seed(0))
        e = torch.randn(256, generator=torch.Generator().manual_seed(1)) * 0.1
        sign, scale, new_err = compression.compress(g, e)
        recon = compression.decompress(sign, scale)
        np.testing.assert_allclose((recon + new_err).numpy(), (g + e).numpy(), rtol=1e-5,
                                   atol=1e-6)

    def test_sign_bits(self):
        sign, _, _ = compression.compress(torch.tensor([1.0, -2.0, 0.0, 3.0]), torch.zeros(4))
        assert sign.tolist() == [1, -1, 1, 1] and sign.dtype == torch.int8

    def test_compressed_bytes_16x(self):
        cb = compression.compressed_bytes({"w": torch.zeros(1024, 1024)})
        assert 1024 * 1024 * 2 / cb > 15.0

    def test_training_with_compression_learns(self):
        step, state, spec = _learn_setup("det", use_compression=True)
        losses = []
        for i in range(80):
            state, m = step(state, _batch(spec, i))
            losses.append(float(m["loss"]))
        assert np.mean(losses[-10:]) < 0.5 * np.mean(losses[:10])


class TestOptimizers:
    def test_sgd_momentum_matches_manual(self):
        opt = sgd_momentum(schedules.constant(0.1), momentum=0.9)
        p = {"w": torch.tensor([1.0, -1.0])}
        s = opt.init(p)
        g = {"w": torch.tensor([0.5, 0.5])}
        p1, s1 = opt.update(g, s, p, torch.tensor(0, dtype=torch.int32))
        np.testing.assert_allclose(p1["w"].numpy(), [0.95, -1.05])
        p2, _ = opt.update(g, s1, p1, torch.tensor(1, dtype=torch.int32))
        # mu = 0.9*0.5 + 0.5 = 0.95; p = 0.95 - 0.1*0.95
        np.testing.assert_allclose(p2["w"].numpy(), [0.855, -1.145], rtol=1e-6)
        assert torch.equal(p["w"], torch.tensor([1.0, -1.0]))   # functional

    def test_adamw_step_direction(self):
        opt = adamw(schedules.constant(1e-2))
        p = {"w": torch.ones(8)}
        p1, _ = opt.update({"w": torch.ones(8)}, opt.init(p), p,
                           torch.tensor(0, dtype=torch.int32))
        assert bool((p1["w"] < 1.0).all())

    def test_global_norm_clip(self):
        g = {"a": torch.full((4,), 3.0), "b": torch.full((4,), 4.0)}
        clipped, norm = clip_by_global_norm(g, 1.0)
        np.testing.assert_allclose(float(norm), 10.0)
        np.testing.assert_allclose(float(global_norm(clipped)), 1.0, rtol=1e-4)


def test_bf16_momentum_learns():
    """A bf16 momentum slot does not break convergence."""
    step, state, spec = _learn_setup("det", momentum_dtype=torch.bfloat16)
    assert state["opt"]["mu"]["layers"][0]["kernel"].dtype == torch.bfloat16
    losses = []
    for i in range(120):
        state, m = step(state, _batch(spec, i))
        losses.append(float(m["loss"]))
    assert np.mean(losses[-10:]) < 0.3 * np.mean(losses[:10])


def test_launch_train_on_cpu(tmp_path, capsys):
    """The CLI trains both nets at the smoke widths on the CPU, through a
    failure and its recovery; asking for CUDA without a card raises."""
    from repro_torch.launch import train

    train.main(["--arch", "mnist_fc", "--binarize", "stoch", "--device", "cpu", "--smoke",
                "--steps", "20", "--ckpt-dir", str(tmp_path), "--ckpt-every", "5",
                "--fail-at", "7", "--history-out", str(tmp_path / "h.json")])
    out = capsys.readouterr().out
    assert "mnist_fc stoch on cpu: 20 steps" in out and "recoveries=1" in out
    assert (tmp_path / "h.json").is_file()
    train.main(["--arch", "vgg16_cifar10", "--binarize", "det", "--device", "cpu",
                "--smoke", "--steps", "2", "--ckpt-dir", str(tmp_path)])
    assert "vgg16_cifar10 det on cpu: 2 steps" in capsys.readouterr().out
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA"):
            train.build_paper_model("mnist_fc", smoke=True)


def test_forward_and_backward_run_in_full_f32():
    """Inside a step TF32 is off for cuBLAS and cuDNN and cuDNN is
    deterministic, in the forward and when autograd runs the backward
    (which reads the flags then); the global flags are restored after."""
    flags = (torch.backends.cuda.matmul, "allow_tf32"), (torch.backends.cudnn, "allow_tf32"), \
        (torch.backends.cudnn, "deterministic")
    saved = [getattr(o, n) for o, n in flags]
    torch.backends.cudnn.allow_tf32 = True
    seen = []

    def now():
        return tuple(getattr(o, n) for o, n in flags)

    def loss_fn(p, batch):
        h = apply_linear(p["w"], batch["x"])
        seen.append(("forward", now()))
        h.register_hook(lambda g: seen.append(("backward", now())))
        return h.square().mean(), {}

    try:
        before = now()
        ST.binarized_value_and_grad(loss_fn, {"w": torch.randn(8, 4)}, {"x": torch.randn(2, 8)},
                                    mode="det", policy=BinarizePolicy(include=("w",)), key=None)
        assert seen == [("forward", (False, False, True)), ("backward", (False, False, True))]
        assert now() == before
    finally:
        for (o, n), v in zip(flags, saved):
            setattr(o, n, v)

