"""Plain PyTorch attention: the CPU path of ``flash_attention`` and the
kernel's oracle on the card (csrc/flash_attention.cu).

The same function as the JAX package's kernels/flash_attention/ref.py, with
the masking of its Pallas kernel (flash_attention.py:65-87): masked scores
are -1e30, masked probabilities 0 and the output ``acc / max(l, 1e-30)``,
so a query row with no valid key gives 0 where the JAX oracle's -inf
softmax gives NaN. Keys past S do not exist here, so nothing is padded.
Scores, softmax and the P @ V product are f32 for f32 and bf16 inputs; the
output takes q's type.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30


def _mask(T: int, S: int, causal: bool, window: int, q_offset: int, device):
    qpos = torch.arange(T, device=device)[:, None] + q_offset
    kpos = torch.arange(S, device=device)[None, :]
    mask = torch.ones((T, S), dtype=torch.bool, device=device)
    if causal:
        mask &= kpos <= qpos
    if window > 0:
        mask &= kpos > qpos - window
    return mask


def attention_ref(q, k, v, causal=True, window=0, q_offset=0, scale=None):
    """(..., T, dh) x (..., S, dh) -> (..., T, dh); leading dims broadcast."""
    T, dh = q.shape[-2:]
    S = k.shape[-2]
    scale = scale if scale is not None else dh ** -0.5
    mask = _mask(T, S, causal, window, q_offset, q.device)
    s = (q.float() @ k.float().transpose(-1, -2)) * scale
    s = torch.where(mask, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    return ((p @ v.float()) / l.clamp_min(1e-30)).to(q.dtype)


def mha_ref(q, k, v, causal=True, window=0, q_offset=0):
    """(B, H, T, dh) x (B, Hkv, S, dh): query head h reads kv head
    h // (H // Hkv), as JAX's reshape (B, Hkv, g, T, dh). One (batch, kv
    head) at a time, so the (g, T, S) scores of one group are the largest
    temporary."""
    B, H, T, dh = q.shape
    Hkv = k.shape[1]
    g = H // Hkv
    qq = q.reshape(B, Hkv, g, T, dh)
    out = torch.empty_like(qq)
    for b in range(B):
        for h in range(Hkv):
            out[b, h] = attention_ref(qq[b, h], k[b, h], v[b, h], causal=causal,
                                      window=window, q_offset=q_offset)
    return out.reshape(B, H, T, dh)
