"""zamba2-1.2b [hybrid] — Mamba2 backbone + shared attention blocks
[arXiv:2411.15242; hf].

38L d_model=2048; a single SHARED attention+FFN block (32H, kv=32,
d_ff=8192) is applied every 6 layers (6 slots); vocab=32000, ssm_state=64.
expand=2 -> d_inner=4096 -> 64 SSD heads of dim 64.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="zamba2-1.2b",
    family="hybrid",
    n_layers=38,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    head_dim=64,
    d_ff=8192,
    vocab_size=32000,
    ssm_state=64,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_groups=1,
    ssm_conv_width=4,
    ssm_chunk=256,
    attn_every=6,
    shared_attn=True,
    activation="gelu",
    tie_embeddings=True,
    citation="arXiv:2411.15242",
))
