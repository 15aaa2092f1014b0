"""Mamba2-2.7B: attention-free SSM with state-space duality [arXiv:2405.21060].

64L d_model=2560, d_inner=5120 (expand 2), headdim 64 => 80 SSD heads,
ssm_state=128, vocab=50280. Attention-free => long_500k RUNS (O(1) state).
The paper-under-reproduction's relation/negative machinery is inapplicable
to this family (DESIGN.md §5) — arch implemented without it.
"""

from repro_torch.common.config import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-2.7b",
    family="ssm",
    source="arXiv:2405.21060",
    n_layers=64,
    d_model=2560,
    n_heads=1,  # unused (attention-free)
    n_kv_heads=1,
    head_dim=2560,
    d_ff=0,
    vocab_size=50_280,
    mixer_pattern="mamba",
    ssm_state=128,
    mamba_expand=2,
    mamba_headdim=64,
    activation="silu",
    tie_embeddings=True,
    microbatches=8,
)
