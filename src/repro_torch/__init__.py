"""PyTorch + CUDA port of the Crystal SSB engine (``repro``) for one
NVIDIA H100.  Imports torch and numpy, never jax or ``repro``."""
