"""The paper's permutation-invariant FC network for MNIST (784-2048x3-10)."""
HIDDEN = (2048, 2048, 2048)
SMOKE_HIDDEN = (128, 128)
BATCH_SIZE = 4          # the paper's batch (fixed by its FPGA's resource budget)
# The paper's training recipe (section III-A):
LEARNING_RATE = 1e-3    # eta[0]
MOMENTUM = 0.9
EPOCHS = 200
