"""Minitron-4B: width-pruned Nemotron-4 dense LM [arXiv:2407.14679].

32L d_model=3072 24H (GQA kv=8) d_ff=9216 vocab=256000. Full attention —
long_500k is skipped (DESIGN.md §5).
"""

from repro_torch.common.config import ArchConfig, AttentionKind

CONFIG = ArchConfig(
    name="minitron-4b",
    family="dense",
    source="arXiv:2407.14679",
    n_layers=32,
    d_model=3072,
    n_heads=24,
    n_kv_heads=8,
    head_dim=128,
    d_ff=9216,
    vocab_size=256_000,
    attention=AttentionKind.FULL,
    activation="silu",
    rope_theta=10_000.0,
    microbatches=8,
)
