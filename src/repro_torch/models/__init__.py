"""The LM scaffold's model families in PyTorch: shared layers, Mamba-2,
MoE, the decoder-only LM, the Whisper-style encoder-decoder, and ``api``,
one functional interface over all 10 architectures."""
