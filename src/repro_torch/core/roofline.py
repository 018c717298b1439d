"""Peak rates of the card the port targets, for roofline projections.

NVIDIA H100 SXM data sheet (700 W): HBM3 bandwidth, the f32 rate of the
CUDA cores (the non-tensor-core f32 peak) and the dense bf16 tensor-core
rate. A card set below 700 W runs slower under load, so a projection from
these numbers is a floor, never a measurement.
"""
from __future__ import annotations

HBM_BW = 3.35e12                # B/s
PEAK_FLOPS_F32 = 67e12          # FLOP/s
PEAK_FLOPS_BF16 = 989e12        # FLOP/s
