"""Jamba-1.5-Large: hybrid Mamba+attention MoE, 398B total [arXiv:2403.19887].

72L d_model=8192 64H (GQA kv=8) d_ff=24576, attention:mamba 1:7 interleave,
MoE 16 experts top-2 every other layer. Hybrid => long_500k RUNS (Mamba state
+ 9 attention layers' KV, sharded).
Adafactor + FSDP: 398B params exceed per-chip HBM under AdamW at 256 chips.
"""

from repro_torch.common.config import ArchConfig, AttentionKind

CONFIG = ArchConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    source="arXiv:2403.19887",
    n_layers=72,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=24576,
    vocab_size=65_536,
    attention=AttentionKind.FULL,
    mixer_pattern="jamba",
    attn_every=8,
    attn_offset=4,
    moe_period=2,
    n_experts=16,
    moe_top_k=2,
    ssm_state=128,
    mamba_expand=2,
    mamba_headdim=64,
    activation="silu",
    optimizer="adafactor",
    param_dtype="bfloat16",
    fsdp=True,
    microbatches=8,
)
