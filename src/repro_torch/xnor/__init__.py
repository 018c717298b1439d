"""Fully-binary XNOR-popcount engine: binary weights and sign-packed
activations, so the dot product is integer bit arithmetic.

Modules
  packing   activation bitpacking along the contraction (last) axis, popcount
  kernel    K3 (sign + bitpack) and K4 (XNOR-popcount matmul) wrappers
  ref       plain torch versions (exact integer ground truth)
  ops       public wrappers: leading-dim flattening, word-count checks
  conv/     binary 2-D convolution lowered onto K4, with K5 patch packing
"""
