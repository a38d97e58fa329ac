"""Device op set, one module per JAX-package counterpart; the hand-written
CUDA kernels and their plain twins live in :mod:`.kernels`."""
