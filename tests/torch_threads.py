"""Every port test module imports this: torch on one intra-op thread.

The tests run in several worker processes at once (pytest-xdist), each with
JAX's thread pool and torch's. torch's default, one thread a core in every
worker, oversubscribes the CPU several times over, and the workers' OpenMP
barriers then wait on each other: six of the port's serving files took
2.3x as long as with one thread each (320 s against 137 s, six workers on
eight cores). The setting is per process, so it holds for every test a
worker runs, the JAX package's included (which do not use torch).
"""
import torch

torch.set_num_threads(1)
