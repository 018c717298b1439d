"""VGG-16 for CIFAR-10 (the paper's CNN benchmark)."""
WIDTH_MULT = 1.0
SMOKE_WIDTH_MULT = 0.125
BATCH_SIZE = 4          # the paper's batch
# The paper's training recipe (section III-A):
LEARNING_RATE = 1e-3    # eta[0]
MOMENTUM = 0.9
EPOCHS = 200
