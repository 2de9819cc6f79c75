"""whisper-medium [audio] — encoder-decoder, conv frontend STUB
[arXiv:2212.04356].

24L encoder + 24L decoder, d_model=1024 16H (MHA kv=16) d_ff=4096
vocab=51865 (padded to 51968).  The conv frontend is a stub per assignment: ``input_specs()``
provides precomputed frame embeddings (1500 frames / sample).
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="whisper-medium",
    family="audio",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab_size=51968,  # 51865 padded to /256 (Megatron-style TP vocab padding)
    activation="gelu",
    tie_embeddings=True,
    is_encoder_decoder=True,
    n_encoder_layers=24,
    encoder_len=1500,
    frontend="audio_frames",
    rope_theta=10_000.0,
    train_microbatches=2,
    citation="arXiv:2212.04356",
))
