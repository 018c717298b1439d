"""Prefix KV cache: reuse prefill work across requests sharing a prompt
prefix (the multi-tenant system-prompt case), a copy of the reference's
``repro/serve/prefix_cache.py`` holding torch tensors.

Entries are batch-1 cache snapshots, one row of every decode-cache entry
along its slot axis (``models.transformer.cache_extract``), captured at
chunk boundaries during chunked prefill and spliced back into a live slot
with ``cache_insert``. A snapshot taken after ``L`` prompt tokens is a pure
function of those tokens (and the weights and geometry), so splicing it
lets the engine skip the first ``L // chunk`` prefill chunks; a full-prompt
snapshot also stores the first-token logits, making the hit a zero-chunk
prefill. Snapshots are CPU tensors (numpy has no bf16), so ``nbytes``
counts what the reference's numpy snapshots of the same rows count.

Keying: sha256 over the raw int32 prefix-token bytes, salted with a
geometry string (model identity, prompt_len, context geometry, chunk size)
bound on first use: a cache reused against a different engine or chunking
drops its entries instead of serving stale state. Chunk size is part of
the key because chunked and whole-prompt prefills agree only to ulp order.

Eviction is LRU over an ``OrderedDict`` with an entry-count and a byte
budget; evictions, hits, misses and tokens skipped are exposed by
``stats()`` and folded into the serving metrics by ``stream_serve``.
"""
from __future__ import annotations

import collections
import dataclasses
import hashlib
from typing import Optional

import numpy as np
import torch


def _host(a) -> torch.Tensor:
    """``a`` (a tensor on any device, or an array) as a CPU tensor."""
    return torch.as_tensor(a).detach().cpu()


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


@dataclasses.dataclass
class PrefixEntry:
    """One cached prefix: ``length`` prompt tokens' worth of batch-1 cache
    rows (CPU tensors, keyed like the decode cache), plus the first-token
    logits when the snapshot covers a full prompt."""

    length: int
    cache: dict                               # name -> CPU tensor, batch-1 slot rows
    logits: Optional[torch.Tensor] = None     # (1, V) only for full prompts

    @property
    def nbytes(self) -> int:
        n = sum(_nbytes(t) for t in self.cache.values())
        if self.logits is not None:
            n += _nbytes(self.logits)
        return n


class PrefixCache:
    """LRU prompt-prefix -> cache-snapshot store (host side).

    ``max_entries`` / ``max_bytes`` bound the store (evicting the least
    recently used); ``store_partial=False`` keeps only full-prompt
    snapshots (cheaper capture, no partial-prefix hits)."""

    def __init__(self, max_entries: int = 64, max_bytes: Optional[int] = None,
                 store_partial: bool = True):
        self.max_entries = int(max_entries)
        self.max_bytes = max_bytes
        self.store_partial = bool(store_partial)
        self._entries: collections.OrderedDict[str, PrefixEntry] = collections.OrderedDict()
        self._geometry: Optional[str] = None
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.tokens_skipped = 0

    # -- keying -----------------------------------------------------------

    def bind_geometry(self, geometry: str) -> None:
        """Salts the key with the serving geometry; a geometry change (new
        engine, prompt_len, context or chunk size) drops every entry, since
        they describe caches of another shape or numerics."""
        if self._geometry == geometry:
            return
        if self._geometry is not None and self._entries:
            self.evictions += len(self._entries)
            self._entries.clear()
        self._geometry = geometry

    def _key(self, tokens) -> str:
        h = hashlib.sha256((self._geometry or "").encode())
        h.update(np.ascontiguousarray(tokens, np.int32).tobytes())
        return h.hexdigest()

    # -- store ------------------------------------------------------------

    @property
    def nbytes(self) -> int:
        return sum(e.nbytes for e in self._entries.values())

    def __len__(self) -> int:
        return len(self._entries)

    def put(self, prefix, cache_rows: dict, logits=None) -> None:
        """Stores a snapshot of ``len(prefix)`` prefilled tokens, its
        tensors copied to the host; an existing key is refreshed in place."""
        prefix = np.asarray(prefix, np.int32)
        entry = PrefixEntry(length=int(prefix.shape[0]),
                            cache={k: _host(v) for k, v in cache_rows.items()},
                            logits=None if logits is None else _host(logits))
        key = self._key(prefix)
        self._entries[key] = entry
        self._entries.move_to_end(key)
        self._evict()

    def lookup(self, prompt, chunk_len: int):
        """The longest stored prefix of ``prompt`` at a chunk-aligned
        length (the full prompt first). Returns ``(length, PrefixEntry)``
        or None; counts one hit or miss a call."""
        p = np.asarray(prompt, np.int32)
        n = int(p.shape[0])
        lengths = [n] + [length for length in range(n - (n % chunk_len or chunk_len), 0,
                                                     -chunk_len)
                         if length < n]
        for length in lengths:
            entry = self._entries.get(self._key(p[:length]))
            if entry is not None:
                self._entries.move_to_end(self._key(p[:length]))
                self.hits += 1
                self.tokens_skipped += length
                return length, entry
        self.misses += 1
        return None

    def _evict(self) -> None:
        while len(self._entries) > self.max_entries:
            self._entries.popitem(last=False)
            self.evictions += 1
        if self.max_bytes is not None:
            while len(self._entries) > 1 and self.nbytes > self.max_bytes:
                self._entries.popitem(last=False)
                self.evictions += 1

    def stats(self) -> dict:
        return {"entries": len(self._entries), "bytes": self.nbytes, "hits": self.hits,
                "misses": self.misses, "evictions": self.evictions,
                "tokens_skipped": self.tokens_skipped}
