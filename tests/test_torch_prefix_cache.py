"""The port's prefix cache (``serve.prefix_cache``, a copy of the reference's
holding CPU torch tensors) against the reference's, operation for operation.

Both caches see the same geometry, the same puts (bf16 cache rows and
logits, as the full-width serve stores them: the reference's as numpy
``ml_dtypes.bfloat16`` arrays, the port's as CPU ``torch.bfloat16``
tensors of the same bits) and the same lookups. Keys, lookup lengths, LRU
order, entry-count and byte eviction, ``nbytes`` and ``stats()`` must be
equal, and a hit must return the rows that were put, bit for bit.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (one intra-op thread a worker)

from repro.serve.prefix_cache import PrefixCache as JPrefixCache
from repro_torch.serve import PrefixCache, PrefixEntry

N_LAYERS, KV, HD, CTX, VOCAB = 2, 2, 8, 12, 64


def _rows(seed):
    """(port rows, reference rows, port logits, reference logits): a batch-1
    bf16 cache snapshot and its first-token logits, the same bits."""
    rng = np.random.default_rng(seed)
    k = rng.standard_normal((N_LAYERS, 1, CTX, KV, HD)).astype(np.float32)
    v = rng.standard_normal((N_LAYERS, 1, CTX, KV, HD)).astype(np.float32)
    pos = np.array([seed % CTX], np.int32)
    lg = rng.standard_normal((1, VOCAB)).astype(np.float32)
    port = {"k": torch.from_numpy(k).to(torch.bfloat16),
            "v": torch.from_numpy(v).to(torch.bfloat16), "pos": torch.from_numpy(pos)}
    ref = {"k": np.asarray(jnp.asarray(k, jnp.bfloat16)),
           "v": np.asarray(jnp.asarray(v, jnp.bfloat16)), "pos": pos}
    return port, ref, torch.from_numpy(lg).to(torch.bfloat16), np.asarray(
        jnp.asarray(lg, jnp.bfloat16))


def _bits(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.view(torch.int16).numpy() if a.dtype == torch.bfloat16 else a.numpy()
    return a.view(np.int16) if a.dtype.itemsize == 2 else a


def _same_entry(got, want):
    length, entry = got
    jlength, jentry = want
    assert length == jlength == entry.length == jentry.length
    assert isinstance(entry, PrefixEntry) and entry.nbytes == jentry.nbytes
    for name in jentry.cache:
        assert entry.cache[name].device.type == "cpu"
        assert np.array_equal(_bits(entry.cache[name]), _bits(jentry.cache[name])), name
    assert (entry.logits is None) == (jentry.logits is None)
    if entry.logits is not None:
        assert np.array_equal(_bits(entry.logits), _bits(jentry.logits))


def _pair(**kw):
    pc, jpc = PrefixCache(**kw), JPrefixCache(**kw)
    for c in (pc, jpc):
        c.bind_geometry("engine:dense:64:8:4:3")
    return pc, jpc


def _put(pc, jpc, prefix, seed, full=False):
    port, ref, lg, jlg = _rows(seed)
    pc.put(prefix, port, logits=lg if full else None)
    jpc.put(prefix, ref, logits=jlg if full else None)


def _same_state(pc, jpc):
    assert pc.stats() == jpc.stats()
    assert list(pc._entries) == list(jpc._entries)
    assert pc.nbytes == jpc.nbytes and len(pc) == len(jpc)


def test_keys_equal_the_reference():
    pc, jpc = _pair()
    for toks in ([1, 2, 3], np.arange(8), np.array([7, 0, 7], np.int64), []):
        assert pc._key(toks) == jpc._key(toks)
    pc.bind_geometry("other")
    jpc.bind_geometry("other")
    assert pc._key([1, 2]) == jpc._key([1, 2])
    assert PrefixCache()._key([1, 2]) == JPrefixCache()._key([1, 2])


@pytest.mark.parametrize("chunk", [1, 3, 4, 8])
def test_lookup_lengths_equal_the_reference(chunk):
    """Partial snapshots at every chunk boundary of one prompt, a full one
    of another: each lookup finds the same length and the same rows."""
    pc, jpc = _pair()
    prompt = np.arange(10, 18, dtype=np.int32)
    for i, n in enumerate(range(chunk, 8, chunk)):
        _put(pc, jpc, prompt[:n], i)
    other = np.arange(40, 48, dtype=np.int32)
    _put(pc, jpc, other, 9, full=True)
    for probe in (prompt, other, np.r_[prompt[:5], [0, 0, 0]].astype(np.int32),
                  np.zeros(8, np.int32)):
        got, want = pc.lookup(probe, chunk), jpc.lookup(probe, chunk)
        assert (got is None) == (want is None)
        if got is not None:
            _same_entry(got, want)
        _same_state(pc, jpc)


def test_lru_and_entry_eviction_equal_the_reference():
    pc, jpc = _pair(max_entries=3)
    for i in range(3):
        _put(pc, jpc, [i] * 4, i)
    assert pc.lookup([0] * 4, 4) is not None and jpc.lookup([0] * 4, 4) is not None
    _put(pc, jpc, [9] * 4, 9)                      # evicts [1]*4, the least recent
    _same_state(pc, jpc)
    assert pc.lookup([1] * 4, 4) is None and jpc.lookup([1] * 4, 4) is None
    _put(pc, jpc, [2] * 4, 5, full=True)           # refresh in place
    _same_state(pc, jpc)
    _same_entry(pc.lookup([2] * 4, 4), jpc.lookup([2] * 4, 4))
    assert pc.evictions == 1


def test_byte_eviction_equals_the_reference():
    one = PrefixEntry(4, _rows(0)[0]).nbytes
    pc, jpc = _pair(max_bytes=3 * one + 10)
    for i in range(6):
        _put(pc, jpc, [i] * 4, i)
        _same_state(pc, jpc)
    assert len(pc) == 3 and pc.evictions == 3
    # a single entry larger than the budget stays (the reference keeps one)
    small_pc, small_jpc = _pair(max_bytes=1)
    _put(small_pc, small_jpc, [1], 1)
    _same_state(small_pc, small_jpc)
    assert len(small_pc) == 1


def test_geometry_rebind_drops_entries_as_the_reference():
    pc, jpc = _pair()
    for i in range(3):
        _put(pc, jpc, [i, i], i)
    for c in (pc, jpc):
        c.bind_geometry("engine:dense:64:8:4:3")     # the same geometry: kept
    _same_state(pc, jpc)
    assert len(pc) == 3
    for c in (pc, jpc):
        c.bind_geometry("engine:dense:64:8:4:5")     # another chunk size: dropped
    _same_state(pc, jpc)
    assert len(pc) == 0 and pc.evictions == 3


def test_random_operation_sequence_equals_the_reference():
    """A seeded sequence of puts (partial and full), lookups at several
    chunk sizes and rebinds, through both caches in step."""
    rng = np.random.default_rng(5)
    pc, jpc = _pair(max_entries=5, max_bytes=4 * PrefixEntry(4, _rows(0)[0]).nbytes)
    for step in range(120):
        op = rng.integers(0, 10)
        toks = rng.integers(0, 3, int(rng.integers(1, 7))).astype(np.int32)
        if op < 5:
            _put(pc, jpc, toks, step, full=bool(rng.integers(0, 2)))
        elif op < 9:
            chunk = int(rng.integers(1, 5))
            got, want = pc.lookup(toks, chunk), jpc.lookup(toks, chunk)
            assert (got is None) == (want is None)
            if got is not None:
                _same_entry(got, want)
        else:
            geometry = f"g{rng.integers(0, 2)}"
            pc.bind_geometry(geometry)
            jpc.bind_geometry(geometry)
        _same_state(pc, jpc)
    assert pc.hits > 0 and pc.misses > 0 and pc.evictions > 0


def test_put_copies_device_rows_to_the_host():
    """``put`` keeps CPU tensors of whatever it is given (capture_slot hands
    it CPU tensors already; arrays are taken as they are)."""
    pc = PrefixCache()
    pc.put([1, 2], {"k": np.ones((1, 2), np.float32), "pos": torch.tensor([2])},
           logits=torch.zeros((1, 3)))
    entry = pc.lookup([1, 2], 2)[1]
    assert all(isinstance(t, torch.Tensor) and t.device.type == "cpu"
               for t in list(entry.cache.values()) + [entry.logits])
    assert entry.nbytes == 8 + 8 + 12
