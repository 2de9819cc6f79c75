"""paligemma-3b [vlm] — SigLIP + Gemma backbone [arXiv:2407.07726; hf].

18L d_model=2048 8H (GQA kv=1) d_ff=16384 vocab=257216.  The vision frontend
is a STUB per assignment: ``input_specs()`` provides precomputed patch
embeddings occupying the first ``n_frontend_tokens`` sequence positions.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="paligemma-3b",
    family="vlm",
    n_layers=18,
    d_model=2048,
    n_heads=8,
    n_kv_heads=1,
    head_dim=256,
    d_ff=16384,
    vocab_size=257216,
    activation="geglu",
    tie_embeddings=True,
    rope_theta=10_000.0,
    frontend="vision_patches",
    n_frontend_tokens=256,
    train_microbatches=4,
    citation="arXiv:2407.07726",
))
