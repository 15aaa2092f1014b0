"""Mixtral-8x7B: sparse MoE with sliding-window attention [arXiv:2401.04088].

32L d_model=4096 32H (GQA kv=8) d_ff=14336, 8 experts top-2, SWA window 4096.
SWA => long_500k RUNS with a ring KV cache. FSDP: 47B total params.
"""

from repro_torch.common.config import ArchConfig, AttentionKind

CONFIG = ArchConfig(
    name="mixtral-8x7b",
    family="moe",
    source="arXiv:2401.04088",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=32_000,
    attention=AttentionKind.SWA,
    window=4096,
    moe_period=1,
    n_experts=8,
    moe_top_k=2,
    activation="silu",
    rope_theta=1_000_000.0,
    fsdp=True,
    microbatches=8,
)
