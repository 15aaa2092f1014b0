"""MiniCPM3-4B: dense LM with Multi-head Latent Attention [hf:openbmb/MiniCPM3-4B].

62L d_model=2560 40H d_ff=6400 vocab=73448, MLA (q_lora=768, kv_lora=256,
rope_head_dim=32 per the model card). Full attention — long_500k skipped;
the MLA absorbed decode keeps the cache tiny (c_kv + k_rope only).
"""

from repro_torch.common.config import ArchConfig, AttentionKind

CONFIG = ArchConfig(
    name="minicpm3-4b",
    family="dense",
    source="hf:openbmb/MiniCPM3-4B",
    n_layers=62,
    d_model=2560,
    n_heads=40,
    n_kv_heads=40,
    head_dim=64,
    d_ff=6400,
    vocab_size=73_448,
    attention=AttentionKind.MLA,
    q_lora_rank=768,
    kv_lora_rank=256,
    rope_head_dim=32,
    activation="silu",
    microbatches=16,
)
