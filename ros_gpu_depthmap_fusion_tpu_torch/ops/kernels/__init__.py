"""Hand-written Hopper CUDA kernels (``csrc/``), one module per kernel:
the wrapper, its plain PyTorch twin and its launch counter."""
