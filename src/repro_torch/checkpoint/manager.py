"""Checkpoint manager: atomic, asynchronous, keep-k, resume-from-latest, in
the reference's format, so a checkpoint either package writes restores in
the other.

Format: one ``step_<N:010d>/arrays.npz`` per checkpoint (leaves keyed by
their tree path, ``params/layers/1/kernel``) plus ``meta.json``; a
``COMMITTED`` marker file is written last, so a crash mid-write never
leaves a checkpoint ``latest_step`` would pick up (atomicity via marker +
directory rename). A ``core.prng.Key`` is stored as the reference stores
its ``key_data``, a uint32 array of shape (2,); a bf16 tensor as f32 (exact
both ways; the reader casts back to the template's dtype). An optional
background thread makes ``save`` non-blocking, so checkpoint I/O overlaps
training.

Restore takes a *template* tree (the state the run started from) and
returns it with leaf values replaced, on the template leaves' devices and
dtypes; a missing leaf or a shape mismatch fails loudly.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.core import prng
from repro_torch.engine.plan import tree_leaves_with_path, tree_unflatten

_MARKER = "COMMITTED"


def to_host(v) -> np.ndarray:
    """A state leaf as the array the checkpoint stores."""
    if isinstance(v, prng.Key):
        return np.array([v.k0, v.k1], dtype=np.uint32)
    t = v.detach()
    if t.dtype == torch.bfloat16:
        t = t.to(torch.float32)
    return np.array(t.cpu().numpy(), copy=True)


def from_host(arr: np.ndarray, template):
    """The stored array as a leaf like ``template`` (a Key or a tensor)."""
    if isinstance(template, prng.Key):
        k0, k1 = np.asarray(arr).astype(np.uint32).tolist()
        return prng.Key(int(k0), int(k1))
    if template.dtype == torch.bfloat16 and arr.dtype.itemsize == 2 and arr.dtype.kind != "f":
        # the reference's bf16 (ml_dtypes, or raw 2-byte records): its bit patterns
        bits = torch.from_numpy(np.ascontiguousarray(arr).view(np.int16))
        return bits.view(torch.bfloat16).to(template.device)
    return torch.from_numpy(np.array(arr, copy=True)).to(template.device, template.dtype)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3, async_save: bool = True):
        self.directory = directory
        self.keep = keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        os.makedirs(directory, exist_ok=True)

    # -- write --------------------------------------------------------------
    def save(self, step: int, tree: Any, metadata: Optional[dict] = None,
             block: bool = False) -> None:
        # Copy to host memory synchronously (cheap), write in the background.
        host = {path: to_host(v) for path, v in tree_leaves_with_path(tree)}
        meta = dict(metadata or {}, step=int(step), time=time.time(), n_leaves=len(host))
        self.wait()  # one in-flight save at a time
        if self.async_save and not block:
            self._thread = threading.Thread(target=self._write, args=(step, host, meta),
                                            daemon=True)
            self._thread.start()
        else:
            self._write(step, host, meta)

    def _write(self, step: int, host: dict, meta: dict) -> None:
        final = os.path.join(self.directory, f"step_{step:010d}")
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        np.savez(os.path.join(tmp, "arrays.npz"), **host)
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump(meta, f)
        with open(os.path.join(tmp, _MARKER), "w") as f:
            f.write("ok")
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        self._gc()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[: -self.keep] if self.keep > 0 else []:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:010d}"), ignore_errors=True)

    # -- read ---------------------------------------------------------------
    def all_steps(self) -> list[int]:
        out = []
        for name in sorted(os.listdir(self.directory)):
            full = os.path.join(self.directory, name)
            if (name.startswith("step_") and not name.endswith(".tmp")
                    and os.path.exists(os.path.join(full, _MARKER))):
                out.append(int(name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, template: Any, step: Optional[int] = None) -> Any:
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint in {self.directory}")
        path = os.path.join(self.directory, f"step_{step:010d}", "arrays.npz")
        leaves = []
        with np.load(path) as data:
            for key, leaf in tree_leaves_with_path(template):
                if key not in data:
                    raise KeyError(f"checkpoint missing leaf {key}")
                arr = data[key]
                if not isinstance(leaf, prng.Key) and tuple(arr.shape) != tuple(leaf.shape):
                    raise ValueError(f"shape mismatch for {key}: ckpt {arr.shape} vs "
                                     f"template {tuple(leaf.shape)}")
                leaves.append(from_host(arr, leaf))
        return tree_unflatten(template, leaves)

    def read_meta(self, step: Optional[int] = None) -> dict:
        step = self.latest_step() if step is None else step
        with open(os.path.join(self.directory, f"step_{step:010d}", "meta.json")) as f:
            return json.load(f)
