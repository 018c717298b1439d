"""The threefry twin (``repro_torch.core.prng``) against ``jax.random``, and
the stochastic packs it feeds against the reference's, bit for bit.

The reference runs jax's defaults (32-bit keys, partitionable threefry), and
its stochastic words are drawn outside any kernel, so the twin must give
the same uint32 words at the same key: key data, ``fold_in``, ``split``,
``bits`` and ``uniform`` are compared exactly over seeds (up to 2^32 - 1),
shapes (rank 1 to 3, non-multiples of 32) and fold/split chains. Then
``plan.pack`` in ``stoch`` mode, from the same master weights and the same
seed, must give the reference's packed words: mnist_fc on both of the
reference's draw shapes (the 32-padded (Kp, N) where it cuts a tiny shape
over, the 256-block-padded shape otherwise) and VGG-16 at the smoke width.
No words are handed across in these tests.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import vgg16_cifar10 as JC
from repro.core.binarize import BinarizeMode as JMode
from repro.engine import BINARIZED_DENSE as J_BINARIZED_DENSE
from repro.engine import compile_plan as j_compile_plan
from repro.engine import registry as jregistry
from repro.kernels import ops as jops
from repro.launch.train import make_paper_policy as j_make_paper_policy
from repro.models import mnist_fc as jfc
from repro.models import vgg as jvgg
from repro_torch.core import prng
from repro_torch.core.binarize import BinarizeMode
from repro_torch.core.policy import make_paper_policy
from repro_torch.engine import backends, compile_plan, registry
from repro_torch.engine.plan import tree_leaves_with_path
from repro_torch.interop import from_jax_tree
from repro_torch.kernels import ops
from repro_torch.models import mnist_fc, vgg
from repro_torch.models.layers import PackedConv, PackedLinear

from test_torch_mnist_fc import _images, _jax_model
from test_torch_vgg import _images as _cifar_images
from test_torch_vgg import _jax_vgg

F32_TOL = dict(rtol=1e-4, atol=1e-3)   # the det tolerance of the port's parity tests
SEEDS = [0, 1, 12345, 2**31 + 5, 2**32 - 1]
SHAPES = [(7,), (1000,), (3, 5, 11), (33, 100), (256, 512)]


def _data(k):
    """Key data as a tuple of Python ints."""
    return tuple(int(v) for v in np.asarray(jax.random.key_data(k)).astype(np.int64))


def _twin(k: prng.Key):
    return (k.k0, k.k1)


@pytest.mark.parametrize("seed", SEEDS + [-3])
def test_key_matches_reference(seed):
    assert _twin(prng.key(seed)) == _data(jax.random.key(seed))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("data", [0, 3, 62, 2**31 + 1])
def test_fold_in_matches_reference(seed, data):
    assert _twin(prng.fold_in(prng.key(seed), data)) == _data(
        jax.random.fold_in(jax.random.key(seed), data))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("n", [1, 2, 5])
def test_split_matches_reference(seed, n):
    got = [_twin(k) for k in prng.split(prng.key(seed), n)]
    want = [tuple(int(v) for v in row) for row in
            np.asarray(jax.random.key_data(jax.random.split(jax.random.key(seed), n)))
            .astype(np.int64)]
    assert got == want


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", SHAPES)
def test_bits_match_reference(seed, shape):
    got = prng.bits(prng.key(seed), shape)
    want = np.asarray(jax.random.bits(jax.random.key(seed), shape, jnp.uint32))
    assert got.dtype == torch.int32 and tuple(got.shape) == shape
    np.testing.assert_array_equal(got.numpy(), want.view(np.int32))


def test_bits_past_one_chunk_match_reference():
    """A leaf of three whole chunks of ``WORDS_CHUNK`` indices and a ragged
    fourth: every chunk's counters start where the last one ended. Both
    routes: the host's (numpy uint32) and the card's (int64 torch ops that
    end in int32 bit patterns, run here on the CPU tensors)."""
    chunk = prng.WORDS_CHUNK["cpu"]
    shape = (5, 3 * chunk // 5 + 300)
    n = shape[0] * shape[1]
    assert 3 * chunk < n < 4 * chunk
    k = prng.fold_in(prng.key(2**31 + 5), 11)
    jk = jax.random.fold_in(jax.random.key(2**31 + 5), 11)
    want = np.asarray(jax.random.bits(jk, shape, jnp.uint32)).view(np.int32)
    np.testing.assert_array_equal(prng.bits(k, shape).numpy(), want)
    device_route = prng._device_words(k, n, torch.device("cpu"))
    assert device_route.dtype == torch.int32
    np.testing.assert_array_equal(device_route.numpy(), want.reshape(-1))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", SHAPES)
def test_uniform_matches_reference(seed, shape):
    got = prng.uniform(prng.key(seed), shape)
    want = np.asarray(jax.random.uniform(jax.random.key(seed), shape, jnp.float32))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    assert float(got.min()) >= 0.0 and float(got.max()) < 1.0


@pytest.mark.parametrize("seed", [1, 2**31 + 5])
@pytest.mark.parametrize("chain", [
    (("fold", 4), ("split", 1, 0)),                 # a 2-D packed leaf's key
    (("fold", 17),),                                # a packed conv leaf's key
    (("split", 3, 2), ("fold", 9), ("split", 2, 1), ("fold", 2**31)),
])
def test_fold_split_chains_match_reference(seed, chain):
    k, jk = prng.key(seed), jax.random.key(seed)
    for step in chain:
        if step[0] == "fold":
            k, jk = prng.fold_in(k, step[1]), jax.random.fold_in(jk, step[1])
        else:
            _, n, i = step
            k, jk = prng.split(k, n)[i], jax.random.split(jk, n)[i]
    assert _twin(k) == _data(jk)
    np.testing.assert_array_equal(
        prng.bits(k, (40, 3)).numpy(),
        np.asarray(jax.random.bits(jk, (40, 3), jnp.uint32)).view(np.int32))


@pytest.mark.parametrize("k,n", [(64, 64), (33, 7), (288, 288), (300, 100), (512, 96)])
def test_stoch_binarize_and_pack_matches_reference_ops(k, n):
    """Both of the reference's draw shapes: (64, 64), (33, 7) and (300, 100)
    take its tiny cut (words over the 32-padded rows), (288, 288) and
    (512, 96) its 256-block-padded draw, which is wider than the leaf."""
    w = np.random.default_rng(k + n).normal(0.0, 0.7, (k, n)).astype(np.float32)
    got = ops.binarize_and_pack(torch.from_numpy(w), prng.key(k * n), stochastic=True)
    want = np.asarray(jops.binarize_and_pack(jnp.asarray(w), jax.random.key(k * n),
                                             stochastic=True))
    np.testing.assert_array_equal(got.numpy(), want)


def test_stoch_pack_needs_a_key():
    with pytest.raises(ValueError, match="key"):
        ops.binarize_and_pack(torch.zeros(64, 8), stochastic=True)


def _carried(tree):
    return from_jax_tree(jax.tree_util.tree_map(np.asarray, tree), device="cpu")


@pytest.mark.parametrize("hidden", [(64,) * 3, (256,) * 3, (288,) * 3])
def test_mnist_stoch_plan_pack_matches_reference_words(hidden):
    """(64,)x3 draws over (Kp, N) (the reference's tiny cut); (256,)x3 and
    (288,)x3 over the 256-block-padded shape, which at 288 is (512, 512)."""
    tree = jfc.init(jax.random.key(0), hidden=hidden)
    jpacked = j_compile_plan(tree["params"], j_make_paper_policy(4), "stoch").pack(
        tree["params"], key=jax.random.key(1))
    master = _carried(tree["params"])
    packed = compile_plan(master, make_paper_policy(4), "stoch").pack(
        master, key=prng.key(1))
    for i in (1, 2):
        got, want = packed["layers"][i]["kernel"], jpacked["layers"][i]["kernel"]
        assert isinstance(got, PackedLinear) and got.k == want.k
        np.testing.assert_array_equal(got.packed.numpy(), np.asarray(want.packed))


def test_vgg_stoch_plan_pack_matches_reference_words():
    """Every PackedConv (words over the flat kh*kw*C axis, key folded with
    the leaf index) and the PackedLinear (folded, then split) at width 0.125."""
    tree = jvgg.init(jax.random.key(0), width_mult=JC.SMOKE_WIDTH_MULT)
    jpacked = j_compile_plan(tree["params"], j_make_paper_policy(3), "stoch").pack(
        tree["params"], key=jax.random.key(5))
    master = _carried(tree["params"])
    packed = compile_plan(master, make_paper_policy(3), "stoch").pack(
        master, key=prng.key(5))
    kinds = {}
    for (path, got), want in zip(tree_leaves_with_path(packed),
                                 jax.tree_util.tree_leaves(
                                     jpacked, is_leaf=lambda x: hasattr(x, "packed"))):
        if isinstance(got, torch.Tensor):
            continue
        kinds[type(got)] = kinds.get(type(got), 0) + 1
        assert type(got).__name__ == type(want).__name__, path
        np.testing.assert_array_equal(got.packed.numpy(), np.asarray(want.packed),
                                      err_msg=path)
    assert kinds == {PackedConv: 12, PackedLinear: 1}


def test_vgg_stoch_binarized_dense_values_match_reference():
    """The binarized_dense backend in stoch mode draws uniform floats from the
    leaf's folded key (Eq. 2); its +-1 * scale values equal the reference's.
    No stoch plan of the paper's policy assigns it, so each conv leaf goes
    through the backend's pack transform directly."""
    tree = jvgg.init(jax.random.key(2), width_mult=JC.SMOKE_WIDTH_MULT)
    plan = j_compile_plan(tree["params"], j_make_paper_policy(3), "stoch")
    leaves = dict(tree_leaves_with_path(tree["params"]))
    n = 0
    for row in plan.layers:
        if row.backend != "packed_conv":
            continue
        leaf = leaves[row.path]
        jlc = jregistry.LeafContext(path=row.path, index=row.index, shape=tuple(row.shape),
                                    is_conv=True, selected=True, xnor_selected=False,
                                    mode="stoch")
        want = J_BINARIZED_DENSE.pack(
            jlc, leaf, jregistry.PackContext(weight_mode=JMode.STOCHASTIC,
                                             key=jax.random.key(3)))
        lc = registry.LeafContext(path=row.path, index=row.index, shape=tuple(row.shape),
                                  is_conv=True, selected=True, xnor_selected=False,
                                  mode="stoch")
        got = backends.BINARIZED_DENSE.pack(
            lc, torch.from_numpy(np.array(leaf)),
            registry.PackContext(weight_mode=BinarizeMode.STOCHASTIC, key=prng.key(3)))
        # the signs are the draw's and must be equal; the per-channel scale
        # is a mean summed in another order (rtol 1e-6, as the det pack test)
        np.testing.assert_array_equal(np.sign(got.numpy()), np.sign(np.asarray(want)),
                                      err_msg=row.path)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, err_msg=row.path)
        n += 1
    assert n == 12


def test_mnist_stoch_forward_matches_reference():
    """The port packs its own stochastic words from the carried master
    weights and the same seed; its logits equal the reference's."""
    tree = _jax_model(1)
    jpacked = j_compile_plan(tree["params"], j_make_paper_policy(4), "stoch").pack(
        tree["params"], key=jax.random.key(7))
    x = _images(2)
    want = np.asarray(jfc.apply(jpacked, tree["state"], jnp.asarray(x), training=False)[0])
    master = _carried(tree["params"])
    packed = compile_plan(master, make_paper_policy(4), "stoch").pack(
        master, key=prng.key(7))
    got = mnist_fc.apply(packed, _carried(tree["state"]), torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, **F32_TOL)


def test_vgg_stoch_forward_matches_reference():
    tree = _jax_vgg(1)
    jpacked = j_compile_plan(tree["params"], j_make_paper_policy(3), "stoch").pack(
        tree["params"], key=jax.random.key(7))
    x = _cifar_images(2)
    want = np.asarray(jvgg.apply(jpacked, tree["state"], jnp.asarray(x), training=False)[0])
    master = _carried(tree["params"])
    packed = compile_plan(master, make_paper_policy(3), "stoch").pack(
        master, key=prng.key(7))
    got = vgg.apply(packed, _carried(tree["state"]), torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, **F32_TOL)


def test_words_follow_the_device_of_the_call():
    """The words are computed on the device asked for (here the CPU) and do
    not depend on it: int64 arithmetic masked to 32 bits is exact anywhere."""
    k = prng.fold_in(prng.key(9), 3)
    a = prng.bits(k, (40, 70), device="cpu")
    b = prng.bits(k, (40 * 70,), device=torch.device("cpu")).reshape(40, 70)
    assert a.device.type == "cpu" and torch.equal(a, b)
