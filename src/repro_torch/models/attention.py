"""Attention mixers of the LM zoo: GQA / MHA, full or sliding-window, with
an optional QKV bias, MLA (Multi-head Latent Attention, MiniCPM3), and
the cross-attention of an encoder-decoder (Whisper).

A port of the JAX package's models/attention.py. Paths:
  * ``attention_train``: full sequence. By default query-chunked
    (``_sdpa_chunked``, the (T, S) scores of one chunk at a time); with
    ``use_flash=True`` on causal self-attention it calls ``flash_attention``,
    the hand-written kernel on the card (csrc/flash_attention.cu) and its
    plain version on the CPU. The JAX package takes that route only under a
    mesh (shard_map) and otherwise falls back to the chunked one; the port
    has no mesh, so ``use_flash`` alone picks it (ROADMAP Queue C). With
    ``kv_src`` (B, S, D) it is cross-attention: k and v from ``kv_src``, no
    rope, no mask, always the chunked route, as JAX's flash branch needs
    ``causal and kv_src is None``. A non-causal self-attention (the
    encoder) keeps its rope and takes the chunked route too.
  * ``attention_decode``: one token against a KV cache; SWA uses a ring
    cache of ``window`` slots. The port writes the cache in place where JAX
    returns an updated copy (Queue C). ``cross_attention_decode``: one
    token against the cross cache (``xk``/``xv`` of ``cache_defs(...,
    cross_len)``), every key valid, no rope.

MLA takes JAX's routes: ``_mla_train`` (the low-rank q and kv projections
with their rmsnorms, rope on the rope parts, ``wkv_b`` into k_nope and v,
the one rope head of k broadcast to every head) always through the chunked
``_sdpa_chunked`` with a q/k head dim of ``hd + rd`` and a v head dim of
``hd``: JAX returns before its flash branch, so ``use_flash`` launches no
kernel here either. ``_mla_decode`` is the absorbed form: the cache holds
only the latent ``c_kv`` (kv_lora_rank) and the shared ``k_rope``
(rope_head_dim) a token, and the scores are ``(q_nope . W_uk) . c_kv +
q_rope . k_rope`` in f32, scaled after the sum.

Matmuls follow JAX's type promotion (``layers.matmul``): an f32 bias or
residual turns the following products to f32.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.common.config import ArchConfig, AttentionKind
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.models.layers import ParamDef, matmul, rmsnorm, rope, torch_dtype

Params = Dict[str, torch.Tensor]

def _window(cfg: ArchConfig) -> int:
    return cfg.window if cfg.attention == AttentionKind.SWA else 0


# =========================================================================== defs
def attn_defs(cfg: ArchConfig, cross: bool = False) -> Dict[str, ParamDef]:
    """One layer's projections; ``cross`` (a decoder's cross-attention)
    takes the GQA / MHA ones whatever the config's kind, as JAX's does."""
    d, hd, H, Hkv = cfg.d_model, cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    if cfg.attention == AttentionKind.MLA and not cross:
        qr, kvr, rd = cfg.q_lora_rank, cfg.kv_lora_rank, cfg.rope_head_dim
        return {
            "wq_a": ParamDef((d, qr), init="fan_in"),
            "q_norm": ParamDef((qr,), init="ones"),
            "wq_b": ParamDef((qr, H * (hd + rd)), init="fan_in"),
            "wkv_a": ParamDef((d, kvr + rd), init="fan_in"),
            "kv_norm": ParamDef((kvr,), init="ones"),
            "wkv_b": ParamDef((kvr, H * 2 * hd), init="fan_in"),
            "wo": ParamDef((H * hd, d), init="fan_in"),
        }
    out = {
        "wq": ParamDef((d, H * hd), init="fan_in"),
        "wk": ParamDef((d, Hkv * hd), init="fan_in"),
        "wv": ParamDef((d, Hkv * hd), init="fan_in"),
        "wo": ParamDef((H * hd, d), init="fan_in"),
    }
    if cfg.qkv_bias:
        out["bq"] = ParamDef((H * hd,), init="zeros")
        out["bk"] = ParamDef((Hkv * hd,), init="zeros")
        out["bv"] = ParamDef((Hkv * hd,), init="zeros")
    return out


# ====================================================================== core math
def _sdpa_chunked(q, k, v, causal: bool, window: int, q_offset: int,
                  chunk: int = 512) -> torch.Tensor:
    """q (B, T, H, dh), k and v (B, S, Hkv, dh), 512 queries at a time.

    As in JAX: q is scaled before the dot, scores and softmax are f32, and
    the probabilities are stored in q's type before the f32 P @ V product.
    """
    B, T, H, dh = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    g = H // Hkv
    scale = dh ** -0.5
    qg = q.reshape(B, T, Hkv, g, dh)
    kpos = torch.arange(S, device=q.device)
    kf, vf = k.float(), v.float()

    def on_chunk(qc, qpos):
        s = torch.einsum("bthgd,bshd->bthgs", (qc * scale).float(), kf)
        mask = torch.ones((qpos.shape[0], S), dtype=torch.bool, device=q.device)
        if causal:
            mask &= kpos[None, :] <= (qpos[:, None] + q_offset)
        if window > 0:
            mask &= kpos[None, :] > (qpos[:, None] + q_offset - window)
        s = torch.where(mask[None, :, None, None, :], s, -1e30)
        m = s.amax(dim=-1, keepdim=True)
        e = torch.exp(s - m)
        p = (e / e.sum(dim=-1, keepdim=True)).to(q.dtype)
        return torch.einsum("bthgs,bshd->bthgd", p.float(), vf)

    chunk = min(chunk, T)
    if T % chunk != 0:
        chunk = T  # odd sizes: single chunk
    pos = torch.arange(T, device=q.device)
    out = torch.cat([on_chunk(qg[:, c:c + chunk], pos[c:c + chunk])
                     for c in range(0, T, chunk)], dim=1)
    return out.reshape(B, T, H, v.shape[-1]).to(q.dtype)


# ================================================================== GQA train path
def attention_train(params: Params, x: torch.Tensor, cfg: ArchConfig,
                    causal: bool = True, q_offset: int = 0,
                    kv_src: Optional[torch.Tensor] = None,
                    use_flash: bool = False) -> torch.Tensor:
    """Attention of x (B, T, D) to itself, or to ``kv_src`` (B, S, D).
    ``use_flash`` routes causal GQA self-attention through
    ``flash_attention``; MLA, the non-causal encoder and cross-attention
    take the chunked route whatever it says, as JAX's do."""
    if cfg.attention == AttentionKind.MLA and kv_src is None:
        return _mla_train(params, x, cfg, causal)
    B, T, _ = x.shape
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    src = x if kv_src is None else kv_src
    S = src.shape[1]
    q = matmul(x, params["wq"]).reshape(B, T, H, hd)
    k = matmul(src, params["wk"]).reshape(B, S, Hkv, hd)
    v = matmul(src, params["wv"]).reshape(B, S, Hkv, hd)
    if "bq" in params:
        q = q + params["bq"].reshape(H, hd)
        k = k + params["bk"].reshape(Hkv, hd)
        v = v + params["bv"].reshape(Hkv, hd)
    if kv_src is None:  # self-attention: rope
        q = rope(q, torch.arange(T, device=x.device) + q_offset, cfg.rope_theta)
        k = rope(k, torch.arange(S, device=x.device), cfg.rope_theta)
    window = _window(cfg)
    causal = causal and kv_src is None
    if use_flash and causal:
        o = flash_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                            causal=True, window=window, q_offset=q_offset)
        o = o.transpose(1, 2)
    else:
        o = _sdpa_chunked(q, k, v, causal=causal, window=window, q_offset=q_offset)
    return matmul(o.reshape(B, T, H * hd), params["wo"])


def _mla_split(params: Params, x: torch.Tensor, cfg: ArchConfig):
    """(q_nope (B, T, H, hd), q_rope (B, T, H, rd), c_kv (B, T, kvr),
    k_rope (B, T, 1, rd)) of x: JAX's ``_mla_split``."""
    B, T, _ = x.shape
    H, hd, rd, kvr = cfg.n_heads, cfg.head_dim, cfg.rope_head_dim, cfg.kv_lora_rank
    cq = rmsnorm(matmul(x, params["wq_a"]), params["q_norm"], cfg.norm_eps)
    qall = matmul(cq, params["wq_b"]).reshape(B, T, H, hd + rd)
    kv_a = matmul(x, params["wkv_a"])  # (B, T, kvr + rd)
    c_kv = rmsnorm(kv_a[..., :kvr], params["kv_norm"], cfg.norm_eps)
    return qall[..., :hd], qall[..., hd:], c_kv, kv_a[..., kvr:].reshape(B, T, 1, rd)


def _mla_train(params: Params, x: torch.Tensor, cfg: ArchConfig, causal: bool
               ) -> torch.Tensor:
    B, T, _ = x.shape
    H, hd, rd = cfg.n_heads, cfg.head_dim, cfg.rope_head_dim
    q_nope, q_rope, c_kv, k_rope = _mla_split(params, x, cfg)
    pos = torch.arange(T, device=x.device)
    q_rope = rope(q_rope, pos, cfg.rope_theta)
    k_rope = rope(k_rope, pos, cfg.rope_theta)
    kv = matmul(c_kv, params["wkv_b"]).reshape(B, T, H, 2 * hd)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([kv[..., :hd], k_rope.expand(B, T, H, rd)], dim=-1)
    o = _sdpa_chunked(q, k, kv[..., hd:], causal=causal, window=0, q_offset=0)
    return matmul(o.reshape(B, T, H * hd), params["wo"])


# ================================================================== decode path
def cache_defs(cfg: ArchConfig, batch: int, seq: int, cross_len: int = 0
               ) -> Dict[str, ParamDef]:
    """The decode cache of one attention layer, in the config's dtype: for
    MLA the latent ``c_kv`` and the shared ``k_rope`` of ``seq`` tokens;
    else k and v, a ring of ``window`` slots for SWA, else ``seq`` slots,
    and with ``cross_len`` the cross cache ``xk``/``xv`` of that many
    encoder positions."""
    dt = torch_dtype(cfg.dtype)
    if cfg.attention == AttentionKind.MLA:
        return {
            "c_kv": ParamDef((batch, seq, cfg.kv_lora_rank), init="zeros", dtype=dt),
            "k_rope": ParamDef((batch, seq, cfg.rope_head_dim), init="zeros", dtype=dt),
        }
    Hkv, hd = cfg.n_kv_heads, cfg.head_dim
    W = _window(cfg)
    S = min(seq, W) if W else seq
    out = {
        "k": ParamDef((batch, S, Hkv, hd), init="zeros", dtype=dt),
        "v": ParamDef((batch, S, Hkv, hd), init="zeros", dtype=dt),
    }
    if cross_len:
        out["xk"] = ParamDef((batch, cross_len, Hkv, hd), init="zeros", dtype=dt)
        out["xv"] = ParamDef((batch, cross_len, Hkv, hd), init="zeros", dtype=dt)
    return out


def attention_decode(params: Params, x1: torch.Tensor, cache: Dict[str, torch.Tensor],
                     index: int, cfg: ArchConfig
                     ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x1 (B, 1, D) at position ``index``; writes this token's k and v into
    ``cache`` in place and returns (y, cache)."""
    index = int(index)
    if cfg.attention == AttentionKind.MLA:
        return _mla_decode(params, x1, cache, index, cfg)
    B = x1.shape[0]
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = matmul(x1, params["wq"]).reshape(B, 1, H, hd)
    k1 = matmul(x1, params["wk"]).reshape(B, 1, Hkv, hd)
    v1 = matmul(x1, params["wv"]).reshape(B, 1, Hkv, hd)
    if "bq" in params:
        q = q + params["bq"].reshape(H, hd)
        k1 = k1 + params["bk"].reshape(Hkv, hd)
        v1 = v1 + params["bv"].reshape(Hkv, hd)
    posv = torch.full((1,), index, dtype=torch.int32, device=x1.device)
    q = rope(q, posv, cfg.rope_theta)
    k1 = rope(k1, posv, cfg.rope_theta)

    k, v = cache["k"], cache["v"]
    S = k.shape[1]
    window = _window(cfg)
    ring = bool(window) and S == window
    slot = index % S if ring else index
    k[:, slot] = k1[:, 0].to(k.dtype)
    v[:, slot] = v1[:, 0].to(v.dtype)
    sl = torch.arange(S, device=x1.device)
    if ring:
        kpos = index - ((index - sl) % S)  # latest pos <= index congruent to slot
        valid = (kpos >= 0) & (kpos > index - window)
    else:
        valid = sl <= index
        if window:
            valid &= sl > index - window
    o = _decode_sdpa(q, k, v, valid)
    return matmul(o.reshape(B, 1, H * hd), params["wo"]), cache


def _decode_sdpa(q, k, v, valid):
    B, _, H, hd = q.shape
    Hkv = k.shape[2]
    qg = q.reshape(B, Hkv, H // Hkv, hd)
    s = torch.einsum("bhgd,bshd->bhgs", qg.float() * hd ** -0.5, k.float())
    s = torch.where(valid[None, None, None, :], s, -1e30)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgs,bshd->bhgd", p, v.float())
    return o.reshape(B, 1, H, hd).to(q.dtype)


def cross_attention_decode(params: Params, x1: torch.Tensor,
                           cache: Dict[str, torch.Tensor], cfg: ArchConfig
                           ) -> torch.Tensor:
    """x1 (B, 1, D) against the whole cross cache (``xk``/``xv``, every key
    valid): q with no rope and no bias, as JAX's ``cross_attention_decode``.
    The cache is read, never written."""
    B = x1.shape[0]
    H, hd = cfg.n_heads, cfg.head_dim
    q = matmul(x1, params["wq"]).reshape(B, 1, H, hd)
    valid = torch.ones(cache["xk"].shape[1], dtype=torch.bool, device=x1.device)
    o = _decode_sdpa(q, cache["xk"], cache["xv"], valid)
    return matmul(o.reshape(B, 1, H * hd), params["wo"])


def _einsum(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``torch.einsum`` with JAX's type promotion (as ``layers.matmul``)."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return torch.einsum(eq, a.to(dt), b.to(dt))


def _mla_decode(params: Params, x1: torch.Tensor, cache: Dict[str, torch.Tensor],
                index: int, cfg: ArchConfig
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """JAX's absorbed MLA decode: writes this token's latent and rope key
    into the cache in place; scores ``(q_nope . W_uk) . c_kv + q_rope .
    k_rope`` in f32, scaled by ``(hd + rd) ** -0.5`` after the sum; the
    softmax-weighted latents times ``W_uv``, in f32, cast to x1's type."""
    B = x1.shape[0]
    H, hd, rd, kvr = cfg.n_heads, cfg.head_dim, cfg.rope_head_dim, cfg.kv_lora_rank
    q_nope, q_rope, c_kv1, k_rope1 = _mla_split(params, x1, cfg)
    posv = torch.full((1,), index, dtype=torch.int32, device=x1.device)
    q_rope = rope(q_rope, posv, cfg.rope_theta)  # (B, 1, H, rd)
    k_rope1 = rope(k_rope1, posv, cfg.rope_theta)  # (B, 1, 1, rd)
    ck, kr = cache["c_kv"], cache["k_rope"]
    ck[:, index] = c_kv1[:, 0].to(ck.dtype)
    kr[:, index] = k_rope1[:, 0, 0].to(kr.dtype)
    wkv = params["wkv_b"].reshape(kvr, H, 2 * hd)
    w_uk, w_uv = wkv[:, :, :hd], wkv[:, :, hd:]  # (kvr, H, hd) each
    qt = _einsum("bhd,khd->bhk", q_nope[:, 0], w_uk)  # the activations' type
    ckf = ck.float()
    s = torch.einsum("bhk,bsk->bhs", qt.float(), ckf)
    s = s + torch.einsum("bhd,bsd->bhs", q_rope[:, 0].float(), kr.float())
    s = s * (hd + rd) ** -0.5
    valid = torch.arange(ck.shape[1], device=x1.device) <= index
    p = torch.softmax(torch.where(valid[None, None, :], s, -1e30), dim=-1)
    lat = torch.einsum("bhs,bsk->bhk", p, ckf)  # (B, H, kvr)
    o = _einsum("bhk,khd->bhd", lat, w_uv).to(x1.dtype)  # (B, H, hd)
    return matmul(o.reshape(B, 1, H * hd), params["wo"]), cache
