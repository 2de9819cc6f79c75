"""qwen2.5-3b [dense] — GQA with QKV bias [hf:Qwen/Qwen2.5-3B].

36L d_model=2048 16H (GQA kv=2) d_ff=11008 vocab=151936, tied embeddings.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen2.5-3b",
    family="dense",
    n_layers=36,
    d_model=2048,
    n_heads=16,
    n_kv_heads=2,
    d_ff=11008,
    vocab_size=151936,
    qkv_bias=True,
    tie_embeddings=True,
    activation="swiglu",
    rope_theta=1_000_000.0,
    train_microbatches=2,
    citation="hf:Qwen/Qwen2.5-0.5B",
))
