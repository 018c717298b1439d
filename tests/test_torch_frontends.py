"""The frontend families (musicgen-large: audio frames, internvl2-76b: image
patches) against the reference on the CPU at their SMOKE configs.

* ``models.frontends``' stub embeddings equal the reference's bf16 values
  at the same key (``prng.normal`` is within a few f32 ulps of
  ``jax.random.normal``, below bf16's rounding).
* From embeddings in place of tokens, ``forward``, ``prefill`` (logits and
  cache) and ``decode_step`` hold rtol 1e-4 / atol 1e-4 in f32 against the
  reference's, on the masters and packed det (the SMOKE configs are f32).
* ``ServeEngine`` takes a frontend config as the reference's does, and its
  greedy stream equals the reference's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jcb
from repro.core.policy import DEFAULT_POLICY as J_POLICY
from repro.engine import compile_plan as j_compile_plan
from repro.models import frontends as JF
from repro.models import transformer as JT
from repro.serve import ServeEngine as JServeEngine
from repro_torch.configs import base as cb
from repro_torch.core import prng
from repro_torch.core.policy import DEFAULT_POLICY
from repro_torch.engine import compile_plan
from repro_torch.interop import from_jax_tree
from repro_torch.models import frontends as F
from repro_torch.models import transformer as T
from repro_torch.serve import ServeEngine

ARCHS = ("musicgen_large", "internvl2_76b")
TOL = dict(rtol=1e-4, atol=1e-4)


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _t(x):
    return x.detach().to(torch.float32).numpy()


@pytest.fixture(scope="module")
def models():
    """arch -> (jcfg, cfg, reference masters, port masters, reference det
    tree, port det tree)."""
    out = {}
    for arch in ARCHS:
        jcfg, cfg = jcb.get_config(arch, smoke=True), cb.get_config(arch, smoke=True)
        jp = JT.init_lm(jcfg, jax.random.key(0))
        mp = from_jax_tree(jp, device="cpu")
        jdet = j_compile_plan(jp, J_POLICY, "det").pack(jp)
        det = compile_plan(mp, DEFAULT_POLICY, "det").pack(mp)
        out[arch] = (jcfg, cfg, jp, mp, jdet, det)
    return out


@pytest.mark.parametrize("kind", ["frames", "patch"])
@pytest.mark.parametrize("seed", [0, 3])
def test_stub_embeddings_equal_the_reference(kind, seed):
    got = F.STUBS[kind](prng.key(seed), 8, 128, 256)
    want = JF.STUBS[kind](jax.random.key(seed), 8, 128, 256)
    assert got.dtype == torch.bfloat16 and got.shape == (8, 128, 256)
    np.testing.assert_array_equal(_t(got), _np(want))
    f32 = F.STUBS[kind](prng.key(seed), 2, 4, 8, dtype=torch.float32, device="cpu")
    assert f32.dtype == torch.float32 and f32.device.type == "cpu"
    np.testing.assert_array_equal(
        f32.numpy(), np.asarray(JF.STUBS[kind](jax.random.key(seed), 2, 4, 8, jnp.float32)))


def _embeds(cfg, jcfg, batch, seq, seed=1):
    """(reference embeddings, port embeddings): the stub's, at one key."""
    j = JF.STUBS[jcfg.frontend](jax.random.key(seed), batch, seq, jcfg.d_model)
    return j, F.STUBS[cfg.frontend](prng.key(seed), batch, seq, cfg.d_model)


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_prefill_decode_from_embeddings_match_reference(models, arch, packed):
    jcfg, cfg, jp, mp, jdet, det = models[arch]
    jtree, tree = (jdet, det) if packed else (jp, mp)
    jx, x = _embeds(cfg, jcfg, 2, 12)
    want, _ = jax.jit(JT.forward, static_argnums=0)(jcfg, jtree, jx)
    got, aux = T.forward(cfg, tree, x)
    assert got.shape == (2, 12, cfg.vocab_size) and float(aux["lb_loss"]) == 0.0
    np.testing.assert_allclose(_t(got), _np(want), **TOL)
    jlg, jcache = JT.prefill(jcfg, jtree, jx[:, :8], max_len=12)
    lg, cache = T.prefill(cfg, tree, x[:, :8], max_len=12)
    np.testing.assert_allclose(_t(lg), _np(jlg), **TOL)
    for name in jcache:
        np.testing.assert_allclose(_t(cache[name]), _np(jcache[name]), **TOL, err_msg=name)
    for i in range(8, 11):
        jlg, jcache = JT.decode_step(jcfg, jtree, jcache, jx[:, i:i + 1])
        lg, cache = T.decode_step(cfg, tree, cache, x[:, i:i + 1])
        np.testing.assert_allclose(_t(lg), _np(jlg), **TOL, err_msg=f"decode {i}")
    # the last decode's logits are the forward's at that position
    np.testing.assert_allclose(_t(lg), _t(got[:, 10]), **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_engine_takes_a_frontend_config(models, arch):
    """The engine serves the frontend's backbone on token prompts (its
    embedding table), as the reference's engine does: greedy streams equal
    the reference's."""
    jcfg, cfg, _, _, jdet, det = models[arch]
    prompts = np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 6)).astype(np.int32)
    want = JServeEngine(jcfg, jdet).generate(jnp.asarray(prompts), max_new=4)
    got = ServeEngine(cfg, det).generate(torch.from_numpy(prompts), max_new=4)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
