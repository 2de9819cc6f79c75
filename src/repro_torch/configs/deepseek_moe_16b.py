"""deepseek-moe-16b [moe] — fine-grained MoE, 2 shared + 64 routed top-6
[arXiv:2401.06066; hf].

28L d_model=2048 16H (MHA kv=16) expert d_ff=1408 vocab=102400.
Shared-expert hidden = 2 x 1408 (two shared experts fused into one FFN).
DeepSeekMoE does not renormalize the selected top-k gate weights.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="deepseek-moe-16b",
    family="moe",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab_size=102400,
    n_experts=64,
    n_shared_experts=2,
    moe_top_k=6,
    moe_d_ff=1408,
    shared_d_ff=2816,
    moe_renormalize=False,
    activation="swiglu",
    rope_theta=10_000.0,
    train_microbatches=2,
    citation="arXiv:2401.06066",
))
