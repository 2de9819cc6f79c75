"""PyTorch + CUDA port of the Crystal SSB engine (``repro``) for one
NVIDIA H100, and of the LM scaffold's serving path.  Imports torch and
numpy, never jax or ``repro``."""
