"""PyTorch/CUDA port of the ``repro`` BNN package for NVIDIA Hopper.

It serves the paper's two nets, the MNIST FC net (784 -> 2048x3 -> 10) and
VGG-16 on CIFAR-10, with deterministic (Eq. 1) or stochastic (Eq. 2-3)
binary weights, and fully binary (``xnor``: binary weights and
activations). Five hand-written CUDA C++ kernels (``kernels/csrc``) do the
binary work: binarize + bitpack of weights (K1), the packed-weight matmul
(K2), sign + bitpack of activations (K3), the XNOR-popcount matmul (K4) and
im2col patch packing (K5). The package imports ``torch`` and ``numpy``
only; its module tree mirrors ``repro`` so every module has a reference
twin there.
"""
