"""The error budget of 3xTF32, the split both f32 tensor-core kernels use
(csrc/flash_attention.cu's flash_kernel_f32, csrc/ssd_scan.cu), emulated
in torch on the CPU.

Every operand x of a product is split as the kernels split it:
hi = tf32(x), lo = tf32(x - hi), with tf32 the rounding of ``cvt.rna.tf32.f32``
(to 10 mantissa bits, to nearest, ties away from zero), and a.b is taken as
a_lo.b_hi + a_hi.b_lo + a_hi.b_hi with f32 sums. The emulation runs the
chained forms the kernels compute: the online softmax over key tiles of 64
(p = 2^(s c - m c)), and the chunked SSD scan at chunk 64 with the Gram
matrix, the intra-chunk product, C . state and the state update each in
3xTF32. Both are held to the JAX package's references and to the port's
plain versions at the gates the card holds: 2e-5 x max(1, max|plain|), and
1e-4 against ``ssd_ref``. A single TF32 product, the control, misses the
same gates. Nothing on the port's path imports this emulation.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ref import mha_ref as jax_mha_ref
from repro.kernels.ssd_scan.ref import ssd_ref as jax_ssd_ref
from repro_torch.kernels.flash_attention.ref import NEG_INF, attention_ref, mha_ref
from repro_torch.kernels.ssd_scan.ref import ssd_chunked_batched

torch.set_num_threads(2)
GATE = 2e-5
REF_GATE = 1e-4
KEYS = 64  # flash_kernel_f32's key tile
CHUNK = 64  # ssd_scan.cu's chunk


def tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32 as cvt.rna.tf32.f32 does (f32 bits + 2^12, low 13
    bits cleared: ties away from zero)."""
    bits = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    bits = (bits + 0x1000) & 0xFFFFE000
    bits = torch.where(bits >= 1 << 31, bits - (1 << 32), bits)
    return bits.to(torch.int32).view(torch.float32)


def mm3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b in 3xTF32 with f32 sums."""
    ah, bh = tf32(a), tf32(b)
    al, bl = tf32(a - ah), tf32(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def mm1(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b with each operand rounded to TF32 once: the control."""
    return tf32(a) @ tf32(b)


def flash_emulated(q, k, v, causal, window, q_offset, mm=mm3):
    """flash_kernel_f32's arithmetic on (B, H, T, dh) x (B, Hkv, S, dh)."""
    B, H, T, dh = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    k = k.repeat_interleave(H // Hkv, dim=1)
    v = v.repeat_interleave(H // Hkv, dim=1)
    c = torch.tensor(dh ** -0.5 * 1.4426950408889634, dtype=torch.float32)
    qpos = torch.arange(T)[:, None] + q_offset
    m = torch.full((B, H, T, 1), NEG_INF)
    l = torch.zeros(B, H, T, 1)
    acc = torch.zeros(B, H, T, dh)
    for j0 in range(0, S, KEYS):
        kpos = torch.arange(j0, min(j0 + KEYS, S))[None, :]
        ok = torch.ones(T, kpos.shape[1], dtype=torch.bool)
        if causal:
            ok &= kpos <= qpos
        if window > 0:
            ok &= kpos > qpos - window
        s = torch.where(ok, mm(q, k[:, :, j0:j0 + KEYS].transpose(-1, -2)), NEG_INF)
        mx = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp2((m - mx) * c)
        p = torch.where(ok, torch.exp2(s * c - mx * c), 0.0)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + mm(p, v[:, :, j0:j0 + KEYS])
        m = mx
    return acc / l.clamp_min(1e-30)


def ssd_emulated(x, dt, A, B, C, mm=mm3):
    """ssd_scan.cu's arithmetic on x (b, T, H, P), dt (b, T, H), B and C
    (b, T, N): the chunked scan at chunk 64, a ragged last chunk as zero
    rows, every product in ``mm``."""
    b, T, H, P = x.shape
    N = B.shape[-1]
    state = torch.zeros(b, H, P, N)
    tri = torch.tril(torch.ones(CHUNK, CHUNK, dtype=torch.bool))
    ys = []
    for t0 in range(0, T, CHUNK):
        n = min(CHUNK, T - t0)

        def rows(t):
            out = t[:, t0:t0 + n]
            return torch.cat([out, out.new_zeros(b, CHUNK - n, *out.shape[2:])], 1)

        xc, dtc, bc, cc = rows(x), rows(dt), rows(B), rows(C)
        cs = torch.cumsum(A * dtc, dim=1)  # (b, c, H)
        G = mm(cc, bc.transpose(1, 2))  # (b, t, s)
        L = torch.where(tri[None, :, :, None],
                        torch.exp(cs[:, :, None, :] - cs[:, None, :, :]), 0.0)
        W = (G[..., None] * L * dtc[:, None, :, :]).permute(0, 3, 1, 2)  # (b, H, t, s)
        y = mm(W, xc.permute(0, 2, 1, 3))  # (b, H, t, P)
        y = y + torch.exp(cs).permute(0, 2, 1)[..., None] * mm(
            cc[:, None], state.transpose(-1, -2))
        last = cs[:, -1]  # (b, H)
        w = torch.exp(last[:, None, :] - cs) * dtc  # (b, c, H)
        xw = (xc * w[..., None]).permute(0, 2, 3, 1)  # (b, H, P, s)
        state = torch.exp(last)[..., None, None] * state + mm(xw, bc[:, None])
        ys.append(y.permute(0, 2, 1, 3)[:, :n])
    return torch.cat(ys, dim=1)


def _rng_arrays(rng, *shapes, scale=1.0):
    return [(scale * rng.standard_normal(s)).astype(np.float32) for s in shapes]


def _share(got, want):
    """The largest |got - want| as a share of 2e-5 x max(1, max|want|)."""
    return float((got - want).abs().max()) / (GATE * max(1.0, float(want.abs().max())))


# (B, H, Hkv, T, S, dh, window, q_offset): Qwen1.5-0.5B's heads (dh 64, MHA)
# cut to 2 heads and 512 positions, causal and with a window whose edge
# falls inside a key tile; GQA at dh 128 and 80 with a decode-like offset
FLASH = [
    (1, 2, 2, 512, 512, 64, 0, 0),
    (1, 2, 2, 512, 512, 64, 200, 0),
    (1, 4, 1, 96, 352, 128, 0, 256),
    (1, 4, 2, 160, 160, 80, 100, 0),
]


@pytest.mark.parametrize("case", FLASH, ids=lambda c: "x".join(map(str, c)))
def test_flash_3xtf32_holds_the_f32_gate(case):
    B, H, Hkv, T, S, dh, win, qoff = case
    rng = np.random.default_rng(sum(case))
    q, k, v = _rng_arrays(rng, (B, H, T, dh), (B, Hkv, S, dh), (B, Hkv, S, dh))
    tq, tk, tv = map(torch.tensor, (q, k, v))
    got = flash_emulated(tq, tk, tv, True, win, qoff)
    plain = mha_ref(tq, tk, tv, causal=True, window=win, q_offset=qoff)
    jax = torch.tensor(np.asarray(jax_mha_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                              causal=True, window=win, q_offset=qoff)))
    assert _share(got, plain) <= 1.0
    assert _share(got, jax) <= 1.0
    # one TF32 rounding of each operand is an order of magnitude off
    assert _share(flash_emulated(tq, tk, tv, True, win, qoff, mm=mm1), plain) > 10.0


def test_flash_3xtf32_where_v_cancels():
    """v's entries cancel across keys (rows of +-1 of one pattern), so |o| is
    far below |v|: the split of p is what keeps the error under the gate."""
    rng = np.random.default_rng(7)
    q, k = _rng_arrays(rng, (1, 2, 256, 64), (1, 2, 256, 64))
    sign = np.where(rng.random((1, 2, 256, 1)) < 0.5, -1.0, 1.0)
    v = (sign * (1.0 + 1e-3 * rng.standard_normal((1, 2, 256, 64)))).astype(np.float32)
    tq, tk, tv = map(torch.tensor, (q, k, v))
    got = flash_emulated(tq, tk, tv, True, 0, 0)
    plain = mha_ref(tq, tk, tv)
    assert _share(got, plain) <= 1.0
    assert _share(flash_emulated(tq, tk, tv, True, 0, 0, mm=mm1), plain) > 10.0


def test_f32_itself_misses_the_gate_at_softmax_scale_1():
    """Why the card's large-magnitude cases keep the kernel's scale dh^-0.5:
    with |q|, |k| ~ 8 at softmax scale 1 (scores of ~500) the plain f32
    version is itself farther than the gate from the float64 value, so no
    f32 kernel can be held to it there; at scale dh^-0.5 it is not."""
    rng = np.random.default_rng(5)
    q, k, v = (torch.tensor(8 * rng.standard_normal((1, 4, 200, 64)), dtype=torch.float32)
               for _ in range(3))
    causal = torch.tril(torch.ones(200, 200, dtype=torch.bool))

    def exact(scale):
        s = torch.where(causal, q.double() @ k.double().transpose(-1, -2) * scale, -1e300)
        p = torch.where(causal, torch.exp(s - s.amax(-1, keepdim=True)), 0.0)
        return (p @ v.double()) / p.sum(-1, keepdim=True)

    def share(scale):
        plain = attention_ref(q, k, v, True, 0, 0, scale=scale)
        return float((plain.double() - exact(scale)).abs().max()) / (
            GATE * max(1.0, float(plain.abs().max())))

    assert share(1.0) > 1.0
    assert share(64 ** -0.5) < 1.0


def _ssd_arrays(seed, b, T, H, P, N, dt_max=0.15, a_max=2.0):
    """JAX's sweep (tests/test_kernels.py:86-92): dt in [0.05, dt_max], A in
    [-a_max, -1], B and C of std 0.5."""
    rng = np.random.default_rng(seed)
    return [a.astype(np.float32) for a in (
        rng.standard_normal((b, T, H, P)),
        0.05 + rng.random((b, T, H)) * (dt_max - 0.05),
        -1.0 - rng.random(H) * (a_max - 1.0),
        rng.standard_normal((b, T, N)) * 0.5,
        rng.standard_normal((b, T, N)) * 0.5)]


# (b, T, H, P, N, dt_max, a_max): Mamba2-2.7B's P and N over 16 and 17
# chunks (the second ragged), and the steep decay of the card's
# test_ssd_scan_kernel_steep_decay (dt up to 1, A down to -12)
SSD = [
    (1, 1024, 2, 64, 128, 0.15, 2.0),
    (2, 1050, 1, 64, 128, 0.15, 2.0),
    (1, 1024, 2, 64, 128, 1.0, 12.0),
]


@pytest.mark.parametrize("case", SSD, ids=lambda c: "x".join(map(str, c)))
def test_ssd_3xtf32_holds_the_f32_gates(case):
    b, T, H, P, N, dt_max, a_max = case
    arrs = _ssd_arrays(sum(case[:5]), b, T, H, P, N, dt_max, a_max)
    x, dt, A, B, C = map(torch.tensor, arrs)
    got = ssd_emulated(x, dt, A, B, C)
    assert bool(torch.isfinite(got).all())
    plain = ssd_chunked_batched(x, dt, A, B, C)
    assert _share(got, plain) <= 1.0
    for s in range(b):
        x_s, dt_s, B_s, C_s = (arrs[i][s] for i in (0, 1, 3, 4))
        ref, _ = jax_ssd_ref(*map(jnp.asarray, (x_s, dt_s, arrs[2], B_s, C_s)))
        ref = torch.tensor(np.asarray(ref))
        err = float((got[s] - ref).abs().max())
        assert err <= REF_GATE * max(1.0, float(ref.abs().max()))
    assert _share(ssd_emulated(x, dt, A, B, C, mm=mm1), plain) > 10.0


def test_tf32_rounds_as_cvt_rna():
    """Ties go away from zero; 10 mantissa bits survive; the split is exact
    to 2^-22 of x."""
    one_ulp = 2.0 ** -10
    x = torch.tensor([1.0 + one_ulp / 2, -(1.0 + one_ulp / 2), 1.0 + one_ulp / 2 - 2 ** -23,
                      3.0, 0.0, -0.0])
    want = torch.tensor([1.0 + one_ulp, -(1.0 + one_ulp), 1.0, 3.0, 0.0, -0.0])
    assert torch.equal(tf32(x), want)
    y = torch.tensor(np.random.default_rng(0).standard_normal(1000).astype(np.float32))
    hi = tf32(y)
    lo = tf32(y - hi)
    assert bool(((hi + lo - y).abs() <= 2.0 ** -21 * y.abs()).all())
    assert bool(((hi.view(torch.int32) & 0x1FFF) == 0).all())
