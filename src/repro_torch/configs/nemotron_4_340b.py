"""nemotron-4-340b [dense] — GQA, squared-ReLU FFN [arXiv:2402.16819].

96L d_model=18432 96H (GQA kv=8, head_dim=192) d_ff=73728 vocab=256000.
Non-gated FFN with squared-ReLU activation (Nemotron family).
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="nemotron-4-340b",
    family="dense",
    n_layers=96,
    d_model=18432,
    n_heads=96,
    n_kv_heads=8,
    head_dim=192,
    d_ff=73728,
    vocab_size=256000,
    activation="squared_relu",
    rope_theta=10_000.0,
    train_microbatches=16,
    citation="arXiv:2402.16819",
))
