"""mamba2-2.7b [ssm] — SSD (state-space duality) [arXiv:2405.21060].

64L d_model=2560 (attention-free) vocab=50280 (padded to 50432), ssm_state=128.
expand=2 -> d_inner=5120, head_dim=64 -> 80 SSD heads, 1 B/C group.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="mamba2-2.7b",
    family="ssm",
    n_layers=64,
    d_model=2560,
    n_heads=1,          # unused (attention-free)
    n_kv_heads=1,
    d_ff=0,
    vocab_size=50432,  # 50280 padded to /256 (Megatron-style TP vocab padding)
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_groups=1,
    ssm_conv_width=4,
    ssm_chunk=256,
    tie_embeddings=True,
    train_microbatches=2,
    citation="arXiv:2405.21060",
))
