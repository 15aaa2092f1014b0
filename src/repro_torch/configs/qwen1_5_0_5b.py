"""Qwen1.5-0.5B: small dense LM with QKV bias [hf:Qwen/Qwen1.5-0.5B].

24L d_model=1024 16H (kv=16 — MHA) d_ff=2816 vocab=151936. Full attention —
long_500k skipped.
"""

from repro_torch.common.config import ArchConfig, AttentionKind

CONFIG = ArchConfig(
    name="qwen1.5-0.5b",
    family="dense",
    source="hf:Qwen/Qwen1.5-0.5B",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    head_dim=64,
    d_ff=2816,
    vocab_size=151_936,
    attention=AttentionKind.FULL,
    qkv_bias=True,
    activation="silu",
    rope_theta=1_000_000.0,
    microbatches=8,
)
