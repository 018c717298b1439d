"""PyTorch/CUDA port of the ``repro`` BNN package for NVIDIA Hopper.

Slice 1 serves the paper's MNIST FC net (784 -> 2048x3 -> 10) with
deterministic (Eq. 1) and stochastic (Eq. 2-3) binarized weights. The
packed-weight layers run two hand-written CUDA C++ kernels
(``kernels/csrc``): a fused binarize + bitpack and a matmul against
bitpacked weights. The package imports ``torch`` and ``numpy`` only; its
module tree mirrors ``repro`` so every module has a reference twin there.
"""
