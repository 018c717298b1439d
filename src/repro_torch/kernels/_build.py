"""Builds the CUDA sources in ``csrc/`` into one shared library and loads it.

Route: ``nvcc`` into a library with a plain C interface, loaded with
``ctypes`` (no PyTorch headers, so a build takes seconds). Each source is
compiled to an object in its own ``nvcc`` process, all started together,
and the objects are linked into ``build/kernels/libbnn_kernels_<hash>.so``
at the root of the checkout; the hash covers the sources and flags, so an
edited source never loads a stale library. The first CUDA call builds; a
failed build raises. ``kernel_device`` is every wrapper's device rule: CPU
tensors take the plain version, CUDA tensors the kernel, anything else
raises.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("binarize_pack.cu", "binary_matmul.cu", "sign_pack.cu", "xnor_matmul.cu",
           "patch_pack.cu", "errors.cu")
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ARCH_FLAGS + ("-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                           "-Xptxas", "-v")


def nvcc_path() -> str:
    """The toolkit's nvcc: ``$CUDA_HOME/bin/nvcc``, else /usr/local/cuda's,
    else the one on PATH."""
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise FileNotFoundError(
            f"nvcc not found (looked in {cand} and on PATH): the CUDA kernels "
            f"need the CUDA toolkit to build")
    return found


def _digest(nvcc: str) -> str:
    h = hashlib.sha256(" ".join((nvcc,) + NVCC_FLAGS).encode())
    for name in sorted(p.name for p in CSRC.iterdir()):
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def build_library(build_dir: Path = BUILD_DIR) -> Path:
    """Compiles every source (in parallel) and links the shared library,
    unless a library built from the same sources and flags exists. Returns
    its path. The compiler's report (``-Xptxas -v``: registers, shared
    memory, spills) is kept beside it as ``<lib>.log``."""
    nvcc = nvcc_path()
    tag = _digest(nvcc)
    lib = build_dir / f"libbnn_kernels_{tag}.so"
    if lib.is_file():
        return lib
    build_dir.mkdir(parents=True, exist_ok=True)
    pid = os.getpid()
    objs = [build_dir / f"{Path(s).stem}_{tag}_{pid}.o" for s in SOURCES]
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", str(CSRC / s), "-o", str(o)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True)
             for s, o in zip(SOURCES, objs)]
    logs = [p.communicate()[0] for p in procs]
    failed = [(s, p.returncode, log) for s, p, log in zip(SOURCES, procs, logs)
              if p.returncode != 0]
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(
            f"--- {s} (exit {rc})\n{log}" for s, rc, log in failed))
    tmp = build_dir / f"{lib.name}.{pid}.tmp"
    link = subprocess.run([nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp),
                           *map(str, objs)], capture_output=True, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed (exit {link.returncode}):\n"
                           f"{link.stdout}{link.stderr}")
    (build_dir / f"{lib.name}.log").write_text("".join(logs))
    os.replace(tmp, lib)
    for o in objs:
        o.unlink()
    return lib


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use, with every entry
    point's argument and result types declared."""
    lib = ctypes.CDLL(str(build_library()))
    vp, i64, i32, u32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_uint32
    lib.bnn_binarize_pack.argtypes = [vp, vp, vp, i64, i64, i32, i32, u32, vp]
    lib.bnn_binarize_pack.restype = i32
    lib.bnn_binary_matmul.argtypes = [vp, vp, vp, vp, i64, i64, i64, i32, vp]
    lib.bnn_binary_matmul.restype = i32
    lib.bnn_binary_matmul_batched.argtypes = [vp, vp, vp, vp, i64, i64, i64, i64, i32, vp]
    lib.bnn_binary_matmul_batched.restype = i32
    lib.bnn_sign_pack.argtypes = [vp] * 6 + [ctypes.c_float, vp, i64, i64, i32, vp]
    lib.bnn_sign_pack.restype = i32
    lib.bnn_bn_sign.argtypes = [vp] * 6 + [ctypes.c_float, vp, i64, i64, vp]
    lib.bnn_bn_sign.restype = i32
    lib.bnn_xnor_matmul.argtypes = [vp] * 5 + [i64] * 3 + [i32, vp, vp]
    lib.bnn_xnor_matmul.restype = i32
    lib.bnn_patch_pack.argtypes = [vp, vp] + [i64] * 6 + [i32] * 12 + [vp]
    lib.bnn_patch_pack.restype = i32
    lib.bnn_error_string.argtypes = [i32]
    lib.bnn_error_string.restype = ctypes.c_char_p
    return lib


def kernel_device(name: str, tensors) -> str:
    """The device type the tensors share: ``cpu`` (plain version) or
    ``cuda`` (kernel, on the current device, contiguous); raises otherwise."""
    dev = tensors[0].device
    if any(t.device != dev for t in tensors):
        raise ValueError(f"{name}: inputs must share a device")
    if dev.type == "cpu":
        return "cpu"
    if dev.type != "cuda":
        raise ValueError(f"{name} runs on cpu or cuda tensors, not {dev}")
    if dev.index != torch.cuda.current_device():
        raise ValueError(f"{name}: inputs are on {dev}, the current device is "
                         f"cuda:{torch.cuda.current_device()}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name} needs contiguous inputs")
    return "cuda"


def stream(device: torch.device) -> int:
    """The raw handle of PyTorch's current stream on ``device`` (a CUDA
    device with an index, as a tensor's is). The private call is the one
    Triton's launcher uses: ``torch.cuda.current_stream(device).cuda_stream``
    builds a Stream object and costs microseconds a launch."""
    return torch._C._cuda_getCurrentRawStream(device.index)


def check(code: int, what: str) -> None:
    """Raises if a kernel entry point returned a CUDA error."""
    if code != 0:
        msg = library().bnn_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
