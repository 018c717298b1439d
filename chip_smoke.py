#!/usr/bin/env python3
"""Builds and drives the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each on its own lines of output; any failure exits non-zero:

1. the card's name and power limit, as nvidia-smi reports them;
2. build the CUDA kernels from ``src/repro_torch/kernels/csrc`` (timed);
3. K1 binarize + bitpack against its plain version, det and stoch with the
   same words, at 2048x2048 and ragged shapes: the words must be equal;
4. K2 packed-weight matmul against its plain version, f32 and bf16, with
   and without scale, at M in {4, 256} x 2048 x 2048 and a ragged shape,
   within rtol 1e-4 / atol 1e-3 (f32: only the order of the f32 sum
   differs) or 3e-2 (bf16);
5. serve full-width mnist_fc (784-2048x3-10) in det and stoch through
   ``repro_torch.launch.serve.serve_classifier``, 4 slots, 64 requests
   after one untimed warm-up batch, with every launch counter set to 0 just before and read just after:
   2 K1 launches per pack and 2 K2 launches per batch; the served packed
   words and logits are held against the plain versions;
6. time each kernel at the path shapes with CUDA events, beside its plain
   version, a library call where one computes the same function, and the
   least time the card could take.

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

# H100 SXM data sheet (700 W): HBM3 bandwidth and the f32 rate of the CUDA
# cores (the non-tensor-core f32 peak), and the dense bf16 tensor-core rate.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOP_PER_S = 67e12
PEAK_BF16_FLOP_PER_S = 989e12

F32_TOL = dict(rtol=1e-4, atol=1e-3)
BF16_TOL = dict(rtol=3e-2, atol=3e-2)
L2_FLUSH_BYTES = 256 << 20     # > the 50 MB L2, to time pack-time calls cold


def bound(nbytes: float, flops: float, peak_flops: float) -> tuple[float, str]:
    """(least ms the card could take, what bounds it)."""
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, flops / peak_flops
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.kernels import _build
    from repro_torch.kernels.binary_matmul import binary_matmul, binary_matmul_plain
    from repro_torch.kernels.ops import random_words
    from repro_torch.kernels.stoch_binarize import binarize_pack, binarize_pack_plain
    from repro_torch.core.packing import unpack_bits
    from repro_torch.engine.plan import tree_map
    from repro_torch.launch.serve import serve_classifier
    from repro_torch.models import mnist_fc

    torch.backends.cuda.matmul.allow_tf32 = False    # f32 references in full f32
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    # 1. the card
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print("== card (name, power limit)")
    print(smi)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}, {torch.cuda.device_count()} device(s)")

    # 2. build
    t0 = time.perf_counter()
    lib_path = _build.build_library()
    _build.library()
    print(f"== build: {lib_path.name} in {time.perf_counter() - t0:.1f}s")
    for line in (lib_path.parent / f"{lib_path.name}.log").read_text().splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print("  ptxas:", line.strip())

    g = torch.Generator(device=dev).manual_seed(1234)
    errs: dict[str, float] = {}

    # 3. K1 against its plain version
    print("== K1 binarize_pack vs plain (exact)")
    for (k, n), dtype in [((2048, 2048), torch.float32), ((784, 2048), torch.float32),
                          ((784, 2048), torch.bfloat16), ((100, 300), torch.float32)]:
        w = torch.randn(k, n, generator=g, device=dev) * 0.7
        w[0], w[1], w[2], w[3, :7] = 1.0, -1.0, -0.0, float("nan")   # endpoints
        w[4] = torch.rand(n, generator=g, device=dev) + 1.0           # all-positive column
        w = w.to(dtype)
        bits = random_words((k, n), g, dev)
        top = torch.arange(k * 3, device=dev, dtype=torch.int32).reshape(k, 3) % 128
        bits[:, :3] = -1 - top                   # uint32 words >= 2^32 - 128
        for stoch in (False, True):
            mode = "stoch" if stoch else "det"
            got = binarize_pack(w, bits if stoch else None, stochastic=stoch)
            want = binarize_pack_plain(w, bits if stoch else None, stochastic=stoch)
            torch.cuda.synchronize()
            tag = f"{mode} {k}x{n} {str(dtype)[6:]}"
            print(f"  {tag}: words {tuple(got.shape)}, mismatched "
                  f"{int((got != want).sum())}")
            if not torch.equal(got, want):
                raise AssertionError(f"K1 {tag} differs from its plain version")
            errs[f"k1_{mode}"] = 0.0

    # 4. K2 against its plain version
    print("== K2 binary_matmul vs plain")
    for m, k, n in [(4, 2048, 2048), (256, 2048, 2048), (5, 100, 300)]:
        x32 = torch.randn(m, k, generator=g, device=dev)
        wp = binarize_pack(torch.randn(k, n, generator=g, device=dev), stochastic=False)
        scale = torch.rand(n, generator=g, device=dev) + 0.5
        for dtype, tol in ((torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)):
            x = x32.to(dtype)
            for s in (None, scale):
                got = binary_matmul(x, wp, s)
                want = binary_matmul_plain(x, wp, s)
                torch.cuda.synchronize()
                err = (got - want).abs().max().item()
                tag = (f"{m}x{k}x{n} {str(dtype)[6:]} "
                       f"{'scaled' if s is not None else 'unscaled'}")
                print(f"  {tag}: max_abs_err {err:.3e} (|want| max "
                      f"{want.abs().max().item():.3e})")
                torch.testing.assert_close(got, want, **tol, msg=f"K2 {tag}")
                if m == 4 and dtype == torch.float32 and s is not None:
                    errs["k2"] = err

    # 5. the main path: serve full-width mnist_fc, det and stoch
    launches: dict[str, int] = {}
    for mode in ("det", "stoch"):
        print(f"== serve mnist_fc 784-2048x3-10, --binarize {mode}, 4 slots, 64 requests")
        binarize_pack.launches = 0
        binary_matmul.launches = 0
        res = serve_classifier(arch="mnist_fc", binarize=mode, slots=4, requests=64,
                               seed=0, device="cuda")
        k1, k2 = binarize_pack.launches, binary_matmul.launches
        n_batches = len(res.batch_seconds) + res.warmup
        print(f"  launches: binarize_pack {k1}, binary_matmul {k2} over {n_batches} "
              f"batches ({res.warmup} untimed warm-up); {res.img_per_s:.1f} img/s, {res.ms_per_batch:.4f} ms/batch "
              f"median, packed {res.packed_bytes} B vs {res.dense_bytes} B bf16 dense")
        if k1 != 2 or k2 != 2 * n_batches:
            raise AssertionError(f"{mode}: expected 2 K1 and {2 * n_batches} K2 launches")
        launches[f"k1_{mode}"] = k1
        launches["k2"] = launches.get("k2", 0) + k2
        # the served words against the plain pack of the same master weights
        # and words (same seeds, drawn in the same order)
        master = mnist_fc.init(torch.Generator(device=dev).manual_seed(0), device=dev)
        gw = torch.Generator(device=dev).manual_seed(1)
        for i in (1, 2):
            w = master["params"]["layers"][i]["kernel"]
            bits = random_words(w.shape, gw, dev) if mode == "stoch" else None
            want = binarize_pack_plain(w, bits, stochastic=mode == "stoch")
            if not torch.equal(res.params["layers"][i]["kernel"].packed, want):
                raise AssertionError(f"{mode}: served layers/{i} words differ from plain")
        # the served logits against the plain forward on the CPU
        logits = res.last_logits
        if logits.shape != (4, 10) or not torch.isfinite(logits).all():
            raise AssertionError(f"{mode}: bad logits {tuple(logits.shape)}")
        to_cpu = (lambda t: t.to("cpu"))
        ref = mnist_fc.apply(tree_map(to_cpu, res.params), tree_map(to_cpu, res.state),
                             res.last_x.cpu())
        err = (logits.cpu() - ref).abs().max().item()
        print(f"  served words == plain pack; logits vs plain CPU forward: "
              f"max_abs_err {err:.3e}")
        torch.testing.assert_close(logits.cpu(), ref, **F32_TOL)

    # 6. timing at the path shapes
    print("== timing (CUDA events; K1 cold: L2 flushed before each call, as at "
          "pack time; K2 warm: back-to-back, as per batch)")
    flush_buf = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device=dev)

    def time_cold(fn, iters=20) -> float:
        for _ in range(3):
            fn()
        times = []
        for _ in range(iters):
            flush_buf.zero_()
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        return statistics.median(times)

    def time_warm(fn, iters=200) -> float:
        for _ in range(10):
            fn()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(iters):
            fn()
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / iters

    kernels = []
    k, n = 2048, 2048
    w = torch.randn(k, n, generator=g, device=dev) * 0.7
    bits = random_words((k, n), g, dev)
    for mode in ("det", "stoch"):
        st = mode == "stoch"
        b_ = bits if st else None
        ms = time_cold(lambda: binarize_pack(w, b_, stochastic=st))
        plain_ms = time_cold(lambda: binarize_pack_plain(w, b_, stochastic=st))
        nbytes = k * n * 4 * (2 if st else 1) + (k // 32) * n * 4
        bms, by = bound(nbytes, 0, PEAK_F32_FLOP_PER_S)
        print(f"  K1 {mode} {k}x{n} f32: kernel_ms {ms:.4f}, plain_ms {plain_ms:.4f}, "
              f"library_ms none, bound_ms {bms:.4f} ({by}, {nbytes} B)")
        kernels.append({
            "name": f"binarize_pack ({mode})", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/binarize_pack.cu",
            "replaces": ("src/repro/kernels/stoch_binarize.py:118" if st
                         else "src/repro/kernels/stoch_binarize.py:98"),
            "launches": launches[f"k1_{mode}"], "max_abs_err": errs[f"k1_{mode}"],
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
            "library_ms": None})

    wk = torch.randn(k, n, generator=g, device=dev)
    wp = binarize_pack(wk, stochastic=False)
    scale = wk.abs().mean(dim=0)
    w_pm1 = unpack_bits(wp)                      # the library call's operand
    w_pm1_bf16 = w_pm1.to(torch.bfloat16)
    for m in (4, 256):
        x32 = torch.randn(m, k, generator=g, device=dev)
        for dtype in (torch.float32, torch.bfloat16):
            x = x32.to(dtype)
            ms = time_warm(lambda: binary_matmul(x, wp, scale))
            plain_ms = time_warm(lambda: binary_matmul_plain(x, wp, scale))
            wl = w_pm1 if dtype == torch.float32 else w_pm1_bf16
            lib_ms = time_warm(lambda: (x @ wl).float() * scale)
            esize = 4 if dtype == torch.float32 else 2
            nbytes = m * k * esize + (k // 32) * n * 4 + n * 4 + m * n * 4
            peak = PEAK_F32_FLOP_PER_S if dtype == torch.float32 else PEAK_BF16_FLOP_PER_S
            bms, by = bound(nbytes, 2.0 * m * k * n, peak)
            print(f"  K2 scaled {m}x{k}x{n} {str(dtype)[6:]}: kernel_ms {ms:.4f}, "
                  f"plain_ms {plain_ms:.4f}, library_ms {lib_ms:.4f} (torch.matmul on "
                  f"unpacked +-1 times scale), bound_ms {bms:.4f} ({by})")
            if m == 4 and dtype == torch.float32:   # the serving path's shape
                kernels.append({
                    "name": "binary_matmul (scaled, f32, M=4)", "route": "cuda",
                    "source": "src/repro_torch/kernels/csrc/binary_matmul.cu",
                    "replaces": "src/repro/kernels/binary_matmul.py:125",
                    "launches": launches["k2"], "max_abs_err": errs["k2"],
                    "ms": ms, "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
                    "library_ms": lib_ms})

    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
