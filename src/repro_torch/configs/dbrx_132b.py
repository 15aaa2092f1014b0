"""DBRX: fine-grained MoE, 132B total / 36B active [hf:databricks/dbrx-base].

40L d_model=6144 48H (GQA kv=8) d_ff=10752, 16 experts top-4. Full attention
— long_500k skipped. Adafactor + FSDP for the 132B footprint.
"""

from repro_torch.common.config import ArchConfig, AttentionKind

CONFIG = ArchConfig(
    name="dbrx-132b",
    family="moe",
    source="hf:databricks/dbrx-base",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=10752,
    vocab_size=100_352,
    attention=AttentionKind.FULL,
    moe_period=1,
    n_experts=16,
    moe_top_k=4,
    activation="silu",
    rope_theta=500_000.0,
    optimizer="adafactor",
    param_dtype="bfloat16",
    fsdp=True,
    microbatches=16,
)
