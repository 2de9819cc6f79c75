"""qwen3-moe-30b-a3b [moe] — 128 experts top-8 [hf:Qwen/Qwen3-30B-A3B].

48L d_model=2048 32H (GQA kv=4, head_dim=128, QK-norm) expert d_ff=768
vocab=151936.  No shared experts; top-k gate weights renormalized.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,
    head_dim=128,
    d_ff=768,
    vocab_size=151936,
    n_experts=128,
    n_shared_experts=0,
    moe_top_k=8,
    moe_d_ff=768,
    shared_d_ff=0,
    moe_renormalize=True,
    qk_norm=True,
    activation="swiglu",
    rope_theta=1_000_000.0,
    train_microbatches=4,
    citation="hf:Qwen/Qwen3-30B-A3B",
))
