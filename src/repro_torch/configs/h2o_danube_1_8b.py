"""H2O-Danube-1.8B: llama/mistral-mix dense LM with SWA [arXiv:2401.16818].

24L d_model=2560 32H (GQA kv=8) d_ff=6912 vocab=32000, sliding window 4096.
SWA => long_500k RUNS with a ring KV cache.
"""

from repro_torch.common.config import ArchConfig, AttentionKind

CONFIG = ArchConfig(
    name="h2o-danube-1.8b",
    family="dense",
    source="arXiv:2401.16818",
    n_layers=24,
    d_model=2560,
    n_heads=32,
    n_kv_heads=8,
    head_dim=80,
    d_ff=6912,
    vocab_size=32_000,
    attention=AttentionKind.SWA,
    window=4096,
    activation="silu",
    microbatches=8,
)
