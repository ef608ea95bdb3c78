"""Hand-written Pallas kernels (the Triton route) and their wrappers."""
