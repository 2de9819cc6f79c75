"""Config system: model configs, input-shape configs, and the arch registry.

Every architecture is a ``ModelConfig`` instance registered under its
public id (``--arch <id>``).  Shapes are the four input-shape sets.  The
port's own copy of the reference's configs: the same fields, defaults,
registry and values.
"""
from __future__ import annotations

import dataclasses
import importlib
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

# ---------------------------------------------------------------------------
# Model config
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // n_heads

    # --- MoE ---
    n_experts: int = 0
    n_shared_experts: int = 0
    moe_top_k: int = 0
    moe_d_ff: int = 0            # per-expert hidden dim (fine-grained MoE)
    shared_d_ff: int = 0         # hidden dim of the shared-expert FFN
    moe_capacity_factor: float = 1.25
    moe_renormalize: bool = True

    # --- SSM (Mamba2 / SSD) ---
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_groups: int = 1
    ssm_conv_width: int = 4
    ssm_chunk: int = 256

    # --- hybrid (zamba2-style shared attention blocks) ---
    attn_every: int = 0          # apply the shared attn block every k layers
    shared_attn: bool = False    # one set of attn params reused at every slot

    # --- activation / misc ---
    activation: str = "swiglu"   # swiglu | geglu | squared_relu | gelu
    qkv_bias: bool = False
    qk_norm: bool = False
    tie_embeddings: bool = False
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-6

    # --- encoder/decoder (whisper) ---
    is_encoder_decoder: bool = False
    n_encoder_layers: int = 0
    encoder_len: int = 1500      # stub audio frames per sample

    # --- modality frontend stub ---
    frontend: Optional[str] = None  # None | "vision_patches" | "audio_frames"
    n_frontend_tokens: int = 0      # vlm: image patch positions at seq start

    # --- numerics / execution ---
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    remat: bool = True
    train_microbatches: int = 1   # gradient-accumulation factor for train_4k
    attn_chunk: int = 1024        # kv-chunk size for flash-style attention
    attn_chunk_threshold: int = 2048  # use chunked attention when S exceeds
    sp_attention: bool = False    # shard q-positions over "model" in attn
                                  # (context parallelism — the fix for archs
                                  # whose head counts don't divide the TP axis)
    kv_cache_dtype: str = ""      # "" = compute dtype; "int8" = quantized KV
                                  # with per-(b,h,s) scales (halves decode
                                  # cache bytes)

    citation: str = ""

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def is_subquadratic(self) -> bool:
        """True if the arch can decode a 500k context (SSM / hybrid state)."""
        return self.family in ("ssm", "hybrid")

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # ---- parameter count (for MODEL_FLOPS = 6*N*D roofline bookkeeping) ----
    def param_count(self, active_only: bool = False) -> int:
        """Analytic parameter count; active_only counts top-k experts only."""
        d, dh = self.d_model, self.resolved_head_dim
        attn_one = (
            d * self.n_heads * dh            # q
            + 2 * d * self.n_kv_heads * dh   # k, v
            + self.n_heads * dh * d          # o
        )
        ffn_gate = 2 if self.activation in ("swiglu", "geglu") else 1
        total = 0
        if self.family in ("dense", "vlm"):
            per_layer = attn_one + (ffn_gate + 1) * d * self.d_ff + 2 * d
            total = self.n_layers * per_layer
        elif self.family == "moe":
            n_eff = self.moe_top_k if active_only else self.n_experts
            expert = (ffn_gate + 1) * d * self.moe_d_ff
            shared = (ffn_gate + 1) * d * self.shared_d_ff if self.n_shared_experts else 0
            router = d * self.n_experts
            per_layer = attn_one + n_eff * expert + shared + router + 2 * d
            total = self.n_layers * per_layer
        elif self.family == "ssm":
            di, N, H = self.d_inner, self.ssm_state, self.ssm_heads
            in_proj = d * (2 * di + 2 * self.ssm_groups * N + H)
            per_layer = in_proj + di * d + di + 2 * H + 2 * d
            total = self.n_layers * per_layer
        elif self.family == "hybrid":
            di, N, H = self.d_inner, self.ssm_state, self.ssm_heads
            in_proj = d * (2 * di + 2 * self.ssm_groups * N + H)
            mamba_layer = in_proj + di * d + di + 2 * H + 2 * d
            n_slots = self.n_layers // max(self.attn_every, 1)
            attn_block = attn_one + (ffn_gate + 1) * d * self.d_ff + 2 * d
            n_attn_param_sets = 1 if self.shared_attn else n_slots
            total = self.n_layers * mamba_layer + n_attn_param_sets * attn_block
        elif self.family == "audio":
            per_layer = attn_one + (ffn_gate + 1) * d * self.d_ff + 2 * d
            dec_layer = per_layer + attn_one + d  # + cross attention
            total = self.n_encoder_layers * per_layer + self.n_layers * dec_layer
        embed = self.vocab_size * d
        total += embed if self.tie_embeddings else 2 * embed
        return int(total)


# ---------------------------------------------------------------------------
# Input shapes (assigned; seq_len x global_batch)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    kind: str          # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524_288, 1),
}


def cell_is_runnable(cfg: ModelConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """Whether (arch x shape) is a runnable cell, else the skip reason."""
    if shape.name == "long_500k" and not cfg.is_subquadratic:
        return False, "SKIP(full-attention): 524k decode needs sub-quadratic attention"
    return True, ""


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

ARCH_IDS = [
    "paligemma-3b",
    "mamba2-2.7b",
    "deepseek-moe-16b",
    "qwen3-moe-30b-a3b",
    "nemotron-4-340b",
    "qwen2-0.5b",
    "mistral-nemo-12b",
    "qwen2.5-3b",
    "zamba2-1.2b",
    "whisper-medium",
]

_REGISTRY: Dict[str, ModelConfig] = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    if name not in _REGISTRY:
        mod = name.replace("-", "_").replace(".", "_")
        importlib.import_module(f"repro_torch.configs.{mod}")
    return _REGISTRY[name]


def all_configs() -> Dict[str, ModelConfig]:
    for name in ARCH_IDS:
        get_config(name)
    return dict(_REGISTRY)


def smoke_config(name: str) -> ModelConfig:
    """A reduced same-family config for CPU smoke tests."""
    cfg = get_config(name)
    kw: Dict[str, Any] = dict(
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=max(1, min(cfg.n_kv_heads, 2)),
        head_dim=16,
        d_ff=128,
        vocab_size=503,
        param_dtype="float32",
        compute_dtype="float32",
        train_microbatches=1,
        encoder_len=12,
        attn_chunk=16,
        attn_chunk_threshold=32,
        ssm_chunk=8,
    )
    if cfg.family == "moe":
        # generous capacity so smoke tests see no capacity drops (drop
        # behaviour is unit-tested separately at the production factor)
        kw.update(n_experts=8, moe_top_k=2, moe_d_ff=32,
                  shared_d_ff=64 if cfg.n_shared_experts else 0,
                  moe_capacity_factor=8.0)
    if cfg.family in ("ssm", "hybrid"):
        kw.update(ssm_state=16, ssm_head_dim=8, attn_every=cfg.attn_every and 2)
    if cfg.family == "audio":
        kw.update(n_encoder_layers=2)
    if cfg.family == "vlm":
        kw.update(n_frontend_tokens=8)
    return cfg.replace(**kw)
