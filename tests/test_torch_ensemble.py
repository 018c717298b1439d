"""Port parity for the stochastic K-replica ensemble (``repro_torch.stoch``):
a K = 1 ensemble is the single-sample pack and forward bit for bit; K = 3
replicas drawn from the same master weights (``interop.from_jax_tree``) at
the same key hold the reference's ``sample_replicas`` words; the stats of
the same logits equal the reference's ``ensemble_stats`` (mean and
variance within f32 rtol = atol = 1e-6, agreement exactly); the whole
forward holds the reference's within rtol = atol = 1e-5 (the tolerance of
the reference's own ``tests/test_stoch_ensemble.py``); and the serve's
``--ensemble`` / ``--abstain-threshold`` flags run on the CPU.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (one intra-op thread a worker)

from repro.engine import compile_plan as j_compile_plan
from repro.launch.train import make_paper_policy as j_make_paper_policy
from repro.stoch import ensemble_forward as j_ensemble_forward
from repro.stoch import ensemble_stats as j_ensemble_stats
from repro.stoch import sample_replicas as j_sample_replicas
from repro_torch.core import prng
from repro_torch.core.policy import make_paper_policy
from repro_torch.engine import compile_plan
from repro_torch.engine.plan import tree_leaves_with_path
from repro_torch.launch import serve
from repro_torch.models import mnist_fc, vgg
from repro_torch.models.layers import PackedConv, PackedLinear
from repro_torch.stoch import (EnsembleStats, ReplicaSet, ensemble_forward, ensemble_stats,
                               replica_key, sample_replicas)

from test_torch_plan_manifest import _assert_packs_equal, _n_fc, _small

ENSEMBLE_TOL = dict(rtol=1e-5, atol=1e-5)
STATS_TOL = dict(rtol=1e-6, atol=1e-6)
ARCHS = ["mnist_fc", "vgg16_cifar10"]


def _images(arch, seed, batch=4):
    shape = (batch, 784) if arch == "mnist_fc" else (batch, 32, 32, 3)
    return np.random.default_rng(seed).uniform(0, 1, shape).astype(np.float32)


def _port(arch, k, seed=5):
    """(port ReplicaSet, reference ReplicaSet, carried state, reference
    tree, reference model) from the same master weights at key(seed)."""
    tree, carried, jmodel = _small(arch)
    n_fc = _n_fc(arch)
    plan = compile_plan(carried["params"], make_paper_policy(n_fc), "stoch")
    j_plan = j_compile_plan(tree["params"], j_make_paper_policy(n_fc), "stoch")
    rs = sample_replicas(carried["params"], plan, prng.key(seed), k)
    j_rs = j_sample_replicas(tree["params"], j_plan, jax.random.key(seed), k)
    return rs, j_rs, carried["state"], tree, jmodel


def _model(arch):
    return mnist_fc if arch == "mnist_fc" else vgg


@pytest.fixture(scope="module")
def k3_replicas():
    """``_port(arch, 3)`` per arch, drawn once for the tests that read the
    same K = 3 replicas (none of them modifies a tree)."""
    cache = {}

    def get(arch):
        if arch not in cache:
            cache[arch] = _port(arch, 3)
        return cache[arch]

    return get


@pytest.mark.parametrize("arch", ARCHS)
def test_k1_is_the_single_sample_pack_and_forward(arch):
    _, carried, _ = _small(arch)
    plan = compile_plan(carried["params"], make_paper_policy(_n_fc(arch)), "stoch")
    rs = sample_replicas(carried["params"], plan, prng.key(3), 1)
    single = plan.pack(carried["params"], key=prng.key(3))
    _assert_packs_equal(rs.base, single)
    _assert_packs_equal(rs.merge_replica(0), single)
    x = torch.from_numpy(_images(arch, 2))
    model = _model(arch)

    def fn(t):
        return model.apply(t, carried["state"], x)

    es = ensemble_forward(rs, fn)
    assert isinstance(es, EnsembleStats)
    assert torch.equal(es.mean_logits, fn(single))
    assert torch.equal(es.variance, torch.zeros(4)) and torch.equal(es.agreement, torch.ones(4))
    assert torch.equal(ensemble_forward(rs, fn, stats=False), fn(single)[None])


@pytest.mark.parametrize("arch", ARCHS)
def test_replica_words_equal_the_reference(k3_replicas, arch):
    rs, j_rs, _, _, _ = k3_replicas(arch)
    assert isinstance(rs, ReplicaSet) and rs.k == j_rs.k == 3
    assert rs.paths == j_rs.paths and set(rs.stacked) == set(j_rs.stacked)
    assert rs.paths == tuple(a.path for a in rs.plan.stochastic_rows())
    for path in rs.paths:
        node, j_node = rs.stacked[path], j_rs.stacked[path]
        assert type(node).__name__ == type(j_node).__name__
        assert type(node) in (PackedLinear, PackedConv)
        assert node.packed.shape[0] == 3
        np.testing.assert_array_equal(node.packed.numpy(), np.asarray(j_node.packed),
                                      err_msg=path)
        np.testing.assert_allclose(node.scale.numpy(), np.asarray(j_node.scale), rtol=1e-6,
                                   atol=0, err_msg=path)
    # replicas are distinct samples; replica 0 is the base
    words = rs.stacked[rs.paths[0]].packed
    assert not torch.equal(words[0], words[1]) and not torch.equal(words[1], words[2])
    assert torch.equal(rs.merge_replica(0)[rs.paths[0].split("/")[0]][int(
        rs.paths[0].split("/")[1])]["kernel"].packed, words[0])
    assert rs.tree_nbytes() == j_rs.tree_nbytes()


def test_replica_key_is_the_twin_of_the_reference():
    key = prng.key(11)
    assert replica_key(key, 0) is key
    np.testing.assert_array_equal(
        prng.bits(replica_key(key, 2), (4, 8)).numpy().view(np.uint32),
        np.asarray(jax.random.bits(jax.random.fold_in(jax.random.key(11), 2), (4, 8))))


@pytest.mark.parametrize("k,batch,v", [(1, 4, 10), (3, 4, 10), (8, 5, 7)])
def test_stats_equal_the_reference_on_the_same_logits(k, batch, v):
    rng = np.random.default_rng(k * batch)
    logits = rng.normal(size=(k, batch, v)).astype(np.float32)
    logits[:, 0] = logits[0, 0]                        # a unanimous row
    got = ensemble_stats(torch.from_numpy(logits))
    want = j_ensemble_stats(jnp.asarray(logits))
    np.testing.assert_allclose(got.mean_logits.numpy(), np.asarray(want.mean_logits),
                               **STATS_TOL)
    np.testing.assert_allclose(got.variance.numpy(), np.asarray(want.variance), **STATS_TOL)
    np.testing.assert_array_equal(got.agreement.numpy(), np.asarray(want.agreement))
    assert got.agreement[0] == 1.0
    assert got.mean_logits.shape == (batch, v) and got.variance.shape == (batch,)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_the_reference(k3_replicas, arch):
    rs, j_rs, state, tree, jmodel = k3_replicas(arch)
    x = _images(arch, 6)
    want = j_ensemble_forward(j_rs, lambda t: jmodel.apply(t, tree["state"], jnp.asarray(x),
                                                           training=False)[0])
    model = _model(arch)
    got = ensemble_forward(rs, lambda t: model.apply(t, state, torch.from_numpy(x)))
    np.testing.assert_allclose(got.mean_logits.numpy(), np.asarray(want.mean_logits),
                               **ENSEMBLE_TOL)
    np.testing.assert_allclose(got.variance.numpy(), np.asarray(want.variance), **ENSEMBLE_TOL)
    np.testing.assert_array_equal(got.agreement.numpy(), np.asarray(want.agreement))


def test_merge_replica_gives_each_replica_and_shares_the_rest(k3_replicas):
    rs, _, _, _, _ = k3_replicas("vgg16_cifar10")
    trees = [rs.merge_replica(r) for r in range(3)]
    stoch = set(rs.paths)
    for r, tree in enumerate(trees):
        for path, leaf in tree_leaves_with_path(tree):
            if path in stoch:
                assert torch.equal(leaf.packed, rs.stacked[path].packed[r])
            else:
                assert leaf is dict(tree_leaves_with_path(rs.base))[path]
    with pytest.raises(IndexError):
        rs.merge_replica(3)


@pytest.mark.parametrize("mode,k,err,match", [
    ("stoch", 0, ValueError, "k must be >= 1"),
    ("det", 2, ValueError, "needs a stochastic plan"),
    ("xnor", 2, ValueError, "needs a stochastic plan"),
])
def test_sample_replicas_rejects_what_the_reference_rejects(mode, k, err, match):
    tree, carried, _ = _small("mnist_fc")
    plan = compile_plan(carried["params"], make_paper_policy(4), mode)
    with pytest.raises(err, match=match):
        sample_replicas(carried["params"], plan, prng.key(0), k)
    with pytest.raises(err, match=match):
        j_sample_replicas(tree["params"], j_compile_plan(tree["params"], j_make_paper_policy(4),
                                                         mode), jax.random.key(0), k)


def test_serve_ensemble_flags_on_cpu(capsys):
    res = serve.main(["--arch", "mnist_fc", "--binarize", "stoch", "--ensemble", "4",
                      "--abstain-threshold", "0.6", "--device", "cpu", "--smoke",
                      "--requests", "10"])
    out = capsys.readouterr().out
    assert "ensemble K=4 (stoch)" in out and "mean vote agreement" in out
    assert f"abstained {res.abstained}/10 at threshold 0.6" in out
    assert len(res.agreement) == 10 and res.replicas.k == 4
    assert res.abstained == sum(a < 0.6 for a in res.agreement)
    assert 0.0 <= res.min_agreement <= res.mean_agreement <= 1.0
    assert res.plan.replica_axis == "data"
    assert res.packed_bytes == res.replicas.tree_nbytes()
    # the serve's replicas are the K-replica sample of its plan at key(seed + 1)
    tree, _, _, _ = serve.build_model("mnist_fc", 0, device="cpu", smoke=True)
    again = sample_replicas(tree["params"], res.plan, prng.key(1), 4)
    for path in res.replicas.paths:
        assert torch.equal(res.replicas.stacked[path].packed, again.stacked[path].packed)


def test_serve_k1_is_the_single_sample_serve():
    one = serve.serve_classifier(arch="vgg16_cifar10", binarize="stoch", ensemble=1,
                                 device="cpu", smoke=True, requests=4)
    assert one.replicas is None and one.agreement is None and one.abstained is None
    tree, apply_fn, _, n_fc = serve.build_model("vgg16_cifar10", 0, device="cpu", smoke=True)
    rs = sample_replicas(tree["params"], one.plan, prng.key(1), 1)
    es = ensemble_forward(rs, lambda t: apply_fn(t, one.state, one.last_x))
    assert torch.equal(es.mean_logits, one.last_logits)


@pytest.mark.parametrize("argv,match", [
    (["--binarize", "det", "--ensemble", "3"], "--binarize stoch"),
    (["--binarize", "xnor", "--ensemble", "2"], "--binarize stoch"),
])
def test_serve_ensemble_needs_a_stochastic_plan(argv, match):
    with pytest.raises(SystemExit, match=match):
        serve.main(["--arch", "mnist_fc", "--device", "cpu", "--smoke"] + argv)
