"""Whisper-large-v3 backbone: encoder-decoder [arXiv:2212.04356].

32L decoder (+32L encoder) d_model=1280 20H (MHA) d_ff=5120 vocab=51866.
The mel-spectrogram + conv frontend is a STUB per spec: input_specs supplies
precomputed frame embeddings (B, 1500, d_model). Full attention enc-dec —
long_500k skipped. gelu MLP (non-gated).
"""

from repro_torch.common.config import ArchConfig, AttentionKind, Frontend

CONFIG = ArchConfig(
    name="whisper-large-v3",
    family="audio",
    source="arXiv:2212.04356",
    n_layers=32,
    d_model=1280,
    n_heads=20,
    n_kv_heads=20,
    head_dim=64,
    d_ff=5120,
    vocab_size=51_866,
    attention=AttentionKind.FULL,
    enc_dec=True,
    n_encoder_layers=32,
    encoder_ctx=1500,
    frontend=Frontend.AUDIO,
    activation="gelu",
    microbatches=8,
)
