"""LLaVA-NeXT (Mistral-7B backbone) [hf:llava-hf/llava-v1.6-mistral-7b-hf].

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=32000. The ViT vision tower
+ projector is a STUB per spec: input_specs supplies anyres patch embeddings
(B, n_frontend_tokens, d_model) that overwrite the leading token positions.
Full attention — long_500k skipped.
"""

from repro_torch.common.config import ArchConfig, AttentionKind, Frontend

CONFIG = ArchConfig(
    name="llava-next-mistral-7b",
    family="vlm",
    source="hf:llava-hf/llava-v1.6-mistral-7b-hf",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=32_000,
    attention=AttentionKind.FULL,
    frontend=Frontend.VISION,
    n_frontend_tokens=2880,  # anyres: 5 tiles x 576 patches
    activation="silu",
    rope_theta=1_000_000.0,
    microbatches=16,
)
