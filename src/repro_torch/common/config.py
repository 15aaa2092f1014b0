"""Configurations of the port: copies of the JAX package's common/config.py
(same fields, same defaults, same derived counts).

``ArchConfig`` describes one architecture of the LM zoo (``configs/``),
``InputShape`` one of the zoo's assigned input shapes, and ``KGEConfig`` the
paper's KGE training core. All are plain frozen dataclasses.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, replace
from typing import Tuple


class AttentionKind(str, enum.Enum):
    FULL = "full"
    SWA = "swa"  # sliding-window
    MLA = "mla"  # multi-head latent attention (DeepSeek/MiniCPM3 style)


class MixerKind(str, enum.Enum):
    ATTN = "attn"
    MAMBA = "mamba"


class FFNKind(str, enum.Enum):
    DENSE = "dense"
    MOE = "moe"


class Frontend(str, enum.Enum):
    NONE = "none"
    AUDIO = "audio"  # precomputed mel/conv frame embeddings (stub per spec)
    VISION = "vision"  # precomputed ViT patch embeddings (stub per spec)


@dataclass(frozen=True)
class InputShape:
    """One of the four assigned (seq_len, global_batch) input shapes."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # 'train' | 'prefill' | 'decode'

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}


@dataclass(frozen=True)
class ArchConfig:
    """A transformer-family architecture from the assigned pool."""

    name: str
    family: str  # dense | moe | ssm | hybrid | audio | vlm
    source: str  # citation bracket from the assignment

    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int

    # attention
    attention: AttentionKind = AttentionKind.FULL
    window: int = 0  # SWA window (0 = unused)
    qkv_bias: bool = False
    head_dim: int = 0  # 0 => d_model // n_heads
    rope_theta: float = 10_000.0
    # MLA
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    rope_head_dim: int = 64

    # layer pattern
    mixer_pattern: str = "attn"  # attn | mamba | jamba (1 attn per 8)
    attn_every: int = 8  # for jamba pattern: layer i is ATTN iff i % attn_every == attn_offset
    attn_offset: int = 4

    # FFN / MoE
    moe_period: int = 0  # 0 = dense everywhere; 1 = MoE everywhere; 2 = alternate
    n_experts: int = 0
    moe_top_k: int = 0
    capacity_factor: float = 1.25

    # SSM (Mamba2 / SSD)
    ssm_state: int = 128
    mamba_expand: int = 2
    mamba_headdim: int = 64
    conv_width: int = 4

    # encoder-decoder (whisper)
    enc_dec: bool = False
    n_encoder_layers: int = 0
    encoder_ctx: int = 0

    # modality frontend (stub per spec)
    frontend: Frontend = Frontend.NONE
    n_frontend_tokens: int = 0

    # numerics / memory policy
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    activation: str = "silu"  # silu (gated) | gelu (whisper)
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    optimizer: str = "adamw"  # adamw | adafactor (giants)
    remat: bool = True
    scan_layers: bool = True
    fsdp: bool = False  # ZeRO-3 style: weights also sharded over 'data'
    microbatches: int = 1  # gradient-accumulation steps per train_step
    # 'tp': Megatron tensor-parallel over 'model' (default).
    # 'dp': pure (ZeRO-3) data parallelism — batch sharded over EVERY mesh
    #       axis, weights fully sharded and gathered per use. The right mode
    #       for small-d_model models where 16-way TP wastes MXU tiles and
    #       drowns in resharding collectives (see EXPERIMENTS.md §Perf).
    parallel: str = "tp"
    ce_chunk: int = 0  # chunked cross-entropy vocab tile (0 = full logits)

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    # ---- layer pattern helpers -------------------------------------------
    def mixer_of(self, layer: int) -> MixerKind:
        if self.mixer_pattern == "attn":
            return MixerKind.ATTN
        if self.mixer_pattern == "mamba":
            return MixerKind.MAMBA
        if self.mixer_pattern == "jamba":
            return (
                MixerKind.ATTN
                if layer % self.attn_every == self.attn_offset
                else MixerKind.MAMBA
            )
        raise ValueError(self.mixer_pattern)

    def ffn_of(self, layer: int) -> FFNKind:
        if self.moe_period == 0:
            return FFNKind.DENSE
        if layer % self.moe_period == self.moe_period - 1 or self.moe_period == 1:
            return FFNKind.MOE
        return FFNKind.DENSE

    @property
    def n_attn_layers(self) -> int:
        return sum(self.mixer_of(i) == MixerKind.ATTN for i in range(self.n_layers))

    @property
    def n_mamba_layers(self) -> int:
        return self.n_layers - self.n_attn_layers

    @property
    def n_moe_layers(self) -> int:
        return sum(self.ffn_of(i) == FFNKind.MOE for i in range(self.n_layers))

    @property
    def d_inner(self) -> int:  # mamba inner dim
        return self.mamba_expand * self.d_model

    @property
    def n_mamba_heads(self) -> int:
        return self.d_inner // self.mamba_headdim

    # ---- parameter accounting (for roofline MODEL_FLOPS) -----------------
    def param_count(self) -> int:
        return self._params(active_only=False)

    def active_param_count(self) -> int:
        return self._params(active_only=True)

    def _params(self, active_only: bool) -> int:
        d, dff = self.d_model, self.d_ff
        hd, nh, nkv = self.head_dim, self.n_heads, self.n_kv_heads
        total = self.vocab_size * d  # input embedding
        if not self.tie_embeddings:
            total += self.vocab_size * d
        gated = self.activation == "silu"

        def attn_params() -> int:
            if self.attention == AttentionKind.MLA:
                q = d * self.q_lora_rank + self.q_lora_rank * nh * (hd + self.rope_head_dim)
                kv = d * (self.kv_lora_rank + self.rope_head_dim) + self.kv_lora_rank * nh * (
                    hd + hd
                )
                o = nh * hd * d
                return q + kv + o
            return d * (nh * hd) + 2 * d * (nkv * hd) + (nh * hd) * d

        def dense_ffn() -> int:
            return (3 if gated else 2) * d * dff

        def moe_ffn() -> int:
            e = self.moe_top_k if active_only else self.n_experts
            router = d * self.n_experts
            return router + e * (3 if gated else 2) * d * dff

        def mamba_params() -> int:
            di, ds = self.d_inner, self.ssm_state
            in_proj = d * (2 * di + 2 * ds + self.n_mamba_heads)
            conv = self.conv_width * (di + 2 * ds)
            out = di * d
            return in_proj + conv + out + self.n_mamba_heads  # + A/D per head

        for i in range(self.n_layers):
            if self.mixer_of(i) == MixerKind.ATTN:
                total += attn_params()
            else:
                total += mamba_params()
            total += dense_ffn() if self.ffn_of(i) == FFNKind.DENSE else moe_ffn()
            total += 2 * d  # norms
        if self.enc_dec:
            for _ in range(self.n_encoder_layers):
                total += attn_params() + dense_ffn() + 2 * d
            # cross-attention in each decoder layer
            total += self.n_layers * attn_params()
        return total

    def model_flops(self, shape: InputShape) -> float:
        """6 * N_active * D tokens (training); 2 * N_active * D (inference)."""
        n = self.active_param_count()
        mult = 6.0 if shape.kind == "train" else 2.0
        tokens = shape.global_batch * (1 if shape.kind == "decode" else shape.seq_len)
        return mult * n * tokens

    # ---- smoke-test reduction --------------------------------------------
    def reduced(self) -> "ArchConfig":
        """Reduced same-family variant for CPU smoke tests (spec: 2 layers,
        d_model<=512, <=4 experts)."""
        d = min(self.d_model, 256)
        nh = max(2, min(self.n_heads, 4))
        nkv = max(1, min(self.n_kv_heads, nh))
        changes = dict(
            n_layers=2,
            d_model=d,
            n_heads=nh,
            n_kv_heads=nkv,
            head_dim=d // nh,
            d_ff=min(self.d_ff, 512),
            vocab_size=min(self.vocab_size, 1024),
            window=min(self.window, 64) if self.window else 0,
            q_lora_rank=min(self.q_lora_rank, 64) if self.q_lora_rank else 0,
            kv_lora_rank=min(self.kv_lora_rank, 32) if self.kv_lora_rank else 0,
            rope_head_dim=min(self.rope_head_dim, d // nh),
            n_experts=min(self.n_experts, 4) if self.n_experts else 0,
            moe_top_k=min(self.moe_top_k, 2) if self.moe_top_k else 0,
            ssm_state=min(self.ssm_state, 16),
            mamba_headdim=min(self.mamba_headdim, 32),
            n_encoder_layers=2 if self.enc_dec else 0,
            encoder_ctx=min(self.encoder_ctx, 32) if self.enc_dec else 0,
            n_frontend_tokens=min(self.n_frontend_tokens, 16)
            if self.n_frontend_tokens
            else 0,
            attn_every=2,  # keep hybrid character in 2 layers: 1 mamba + 1 attn
            attn_offset=1,
            moe_period=self.moe_period if self.moe_period in (0, 1) else 2,
            scan_layers=False,
            remat=False,
        )
        return replace(self, **changes)

    def supports_shape(self, shape: InputShape) -> Tuple[bool, str]:
        """Whether this (arch, shape) pair is runnable; reason if not."""
        if shape.name == "long_500k":
            subquadratic = self.mixer_pattern in ("mamba", "jamba") or (
                self.attention == AttentionKind.SWA and self.window > 0
            )
            if not subquadratic:
                return False, "full-attention arch: 500k decode requires sub-quadratic attention (see DESIGN.md §5)"
        return True, ""


@dataclass(frozen=True)
class KGEConfig:
    """Configuration for the paper's KGE training core."""

    name: str = "kge"
    model: str = "transe_l2"  # transe_l1 transe_l2 transr distmult complex rescal rotate
    n_entities: int = 14_951
    n_relations: int = 1_345
    dim: int = 400
    # TransR / RESCAL relation-projection dim
    rel_dim: int = 0  # 0 => dim

    # loss
    loss: str = "logistic"  # logistic | ranking
    gamma: float = 12.0  # margin (ranking) / RotatE self-adversarial scale
    regularization: float = 2e-6

    # mini-batch / negative sampling (paper T1/T2)
    batch_size: int = 1024
    neg_sample_size: int = 256  # k
    neg_group_size: int = 0  # g; 0 => = batch_size (paper: g up to b)
    neg_deg_ratio: float = 0.5  # fraction of degree-based (in-batch) negatives
    corrupt_both: bool = True  # corrupt head and tail

    # distribution (paper T3/T4/T6)
    n_parts: int = 16  # graph partitions == data-axis size
    remote_capacity: int = 256  # R: max remote entity rows pulled per step
    rel_parts: int = 16  # relation partitions == compute units
    partitioner: str = "metis"  # metis | random
    overlap_update: bool = True  # paper T5: deferred entity update

    # optimizer (DGL-KE uses sparse Adagrad)
    lr: float = 0.1
    optimizer: str = "sparse_adagrad"

    dtype: str = "float32"
    comm_dtype: str = "float32"  # KVStore wire format

    def __post_init__(self):
        if self.rel_dim == 0:
            object.__setattr__(self, "rel_dim", self.dim)
        if self.neg_group_size == 0:
            object.__setattr__(self, "neg_group_size", self.batch_size)

    @property
    def n_neg_groups(self) -> int:
        return max(1, self.batch_size // self.neg_group_size)

    def batch_bytes_naive(self) -> int:
        """O(b*d*(k+1)) words — independent corruption (paper §3)."""
        return 4 * self.batch_size * self.dim * (self.neg_sample_size + 1)

    def batch_bytes_joint(self) -> int:
        """O(b*d + b*k*d/g) words — joint negative sampling (paper §3.3)."""
        b, d, k, g = self.batch_size, self.dim, self.neg_sample_size, self.neg_group_size
        return 4 * (3 * b * d + (b // g) * k * d)
