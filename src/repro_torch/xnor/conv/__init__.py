"""XNOR-popcount binary 2-D convolution engine (the paper's CIFAR-10 path).

Lowers convolution onto the fully-binary matmul in ``repro_torch.xnor``: K5
sign-binarizes and bitpacks im2col patches along the kh*kw*C contraction
axis (per-tap word layout), the dot runs on K4, and an exact additive
correction restores zero-padding semantics at SAME borders.

Modules
  packing   geometry, per-tap weight layout, border correction, bytes
  kernel    K5 wrapper (fused patch extraction + sign + bitpack)
  ref       plain torch versions (exact integer ground truth)
  ops       ``sign_and_pack_patches`` and ``xnor_conv2d``
"""
