// Forward attention with an online softmax (FlashAttention-style) on Hopper's
// tensor cores: bf16 inputs as bf16 products, f32 inputs as 3xTF32 products.
//
//   o[b, h, i] = sum_j p[i, j] v[b, hk, j] / max(sum_j p[i, j], 1e-30)
//   p[i, j]    = valid(i, j) ? exp(s[i, j] - max_j s[i, j]) : 0
//   s[i, j]    = (q[b, h, i] . k[b, hk, j]) * scale,   hk = h / (H / Hkv)
//   valid      = j < S, and j <= i + q_offset if causal, and
//                j > i + q_offset - window if window > 0
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/flash_attention.py
// flash_attention_pallas (its pallas_call, body _flash_kernel), whose batch
// and GQA grouping were vmaps in the JAX wrapper and whose ragged T and S
// were padded there. Here one launch covers every (batch, head): a block owns
// a tile of query rows of one (b, h), reads kv head h / (H / Hkv) in place
// (no copy), and masks ragged rows and keys itself, so no caller pads. The
// TPU ran the kv axis as a sequential grid axis with the running max,
// denominator and accumulator in VMEM scratch; here that axis is a loop
// inside the block, and the running state lives in registers. As in
// _flash_kernel: masked scores are -1e30 and masked probabilities 0 (a row
// with no valid key gives 0, not NaN), kv tiles wholly outside the causal
// and window band are never loaded (the loop bounds skip them), and the
// output is acc / max(l, 1e-30), cast to q's type.
//
// What bounds it: 4 dh operations a valid (query, key) pair (two products
// of dh multiply-adds) against reading q, k, v and writing o once. At the
// Qwen1.5-0.5B prefill (B 4, H 16, T = S 2048, dh 64, causal) that is
// 34.4 G operations against 67 MB in bf16: bound by operations, 0.035 ms at
// 989 TFLOP/s (bf16 tensor cores); in f32, 0.21 ms at 164.9 TFLOP/s (three
// TF32 products a product, 494.7 / 3; 0.51 ms at fp32's 67 TFLOP/s outside
// the tensor cores). Rates are the H100 SXM data sheet's.
//
// bf16: flash_kernel_tc, the FlashAttention-2 structure on mma.sync
// m16n8k16 (bf16 operands, f32 accumulation) with ldmatrix.
//  - 128 threads a block, four warps of 16 query rows: 64 rows a block.
//    A warp loads its rows of q once into registers (A fragments) and keeps
//    its 16 x dh output accumulator, row max and row sum in registers. Up
//    to dh 64 a thread holds 128 registers, so four blocks share an SM
//    (three at dh 80, two at dh 128).
//    (Two m-tiles of 16 rows a warp halve the shared-memory reads a product
//    but need ~240 registers; at the Qwen shape that ran 4% slower.)
//  - k and v come in tiles of 64 keys, copied by cp.async (16 bytes a
//    thread, rows past S zero-filled) into a two-stage ring in shared
//    memory: tile t + 1 is in flight while tile t is multiplied (a third
//    stage ran 2% slower). Shared rows are padded by 16 bytes (dh + 8
//    elements), which puts the 8 rows of every ldmatrix on distinct banks
//    for each dh (32, 64, 80, 128; dh 80 is five k-steps of 16, ten output
//    tiles of 8); an XOR swizzle needs a multiple of 8 chunks a row, which
//    dh 32 and 80 are not.
//  - s = q kT: k's rows read by ldmatrix are the B fragments directly.
//    Products of bf16 values are exact in f32, so s differs from the
//    plain version only in the order of its f32 sums.
//  - The softmax is f32. The running max is kept in raw-score units and
//    p = 2^(s c - m c) with c = scale log2(e): one fma and one ex2.approx
//    (about 2 ulp; results below 2^-126 flush to 0, where the plain
//    version's expf keeps denormals no sum can see). The row max is reduced
//    over the 4 lanes that share a row; the row sum stays a per-lane
//    partial until the end. The mask runs only on tiles that need it (the
//    diagonal tile, the window's edge, the ragged last key tile);
//    interior tiles run a copy of the softmax without it.
//  - o += p v with the score accumulator reused in registers as the A
//    fragment (no shared-memory round trip for p), and v's rows read by
//    ldmatrix.trans as the B fragments. The plain version multiplies an
//    f32 p by v; v is exact in bf16, so p is the only operand rounded.
//    p rounded once to bf16 is off by up to 2^-9 of itself, and that error
//    is not small against |o| where v's entries cancel: SDPA, which rounds
//    so, uses 17x the bf16 gate at the Qwen shape. So p is split: p_hi =
//    bf16(p), p_lo = bf16(p - p_hi), two products into the same f32
//    accumulator; p_hi + p_lo is within 2^-17 p of p, which puts the error
//    under f32's own reordering noise at the gate's 2e-5. It costs 1.5x
//    the tensor work of a plain bf16 kernel (the bound is not changed).
//  - The output is divided by max(l, 1e-30), converted to bf16, staged in
//    the warp's rows of the q tile and written in 16-byte stores; ragged
//    rows are not written.
//  - Blocks of the last query tiles, which see the most keys under a causal
//    mask, start first.
//  At the Qwen shape, on an H100 80GB HBM3 at 700 W, this runs in ~175 us,
//  ~5x its bound and ~1.8x SDPA. A wgmma
//  version (a warpgroup a 64-row tile, k and v by TMA with mbarriers, the
//  softmax and split of one tile overlapping the products of the next) is
//  queued in ROADMAP.md.
//
// f32: flash_kernel_f32, the same structure on mma.sync m16n8k8 in TF32.
// TF32 keeps 10 bits of the mantissa, far from the f32 gate (2e-5 of the
// plain version), so every operand x is split into x_hi = tf32(x) and
// x_lo = tf32(x - x_hi), and a.b is taken as a_lo.b_hi + a_hi.b_lo +
// a_hi.b_hi into one f32 accumulator (3xTF32, as pairwise.cu's dot core);
// the dropped a_lo.b_lo is 2^-22 of |a||b|, below f32's reordering noise.
//  - 128 threads a block, four warps of 16 query rows. A warp splits its
//    rows of q once and keeps the hi and lo A fragments in registers.
//  - k and v come in tiles of 64 keys by cp.async into a two-stage ring.
//    The q tile is staged in the second stage's k area, read once into
//    registers, and then overwritten by the second kv tile: 75,776 bytes
//    at dh 64. Up to dh 80 two blocks share an SM, one at dh 128: a thread
//    takes all 255 registers at dh 64 (and spills 32 bytes); held to 168
//    for three blocks an SM, it spilled 436 bytes and ran 13% slower.
//  - Both products sum over the mma's k index, so it need not follow dh or
//    the keys in order. In q kT, a lane's columns tq and tq + 4 of a pair of
//    k-steps are dh 16 kp + 4 tq + {0, 1} and + {2, 3}: its q and k values
//    are one 16-byte read. In p v, column tq of a k-step is key 2 tq and
//    column tq + 4 key 2 tq + 1, which is where the score accumulator holds
//    them, so p stays in registers as the A fragment (split hi + lo), with
//    no shuffle. v's B fragments come 16 bytes at a time as well: column g
//    of output tiles 4 r .. 4 r + 3 is dh 32 r + 4 g + u (8 bytes and two
//    tiles at dh 80, which is not a multiple of 32), and the output is
//    written back from that order in 16-byte (8-byte) stores.
//  - Shared rows of q and k are padded to 16 mod 32 floats and rows of v
//    to 4 mod 16, which puts every 16-byte fragment read on distinct banks.
//  - Few roundings on the running sums, which decide the error where |s|
//    is large (inputs of magnitude 8: a near-tie of two scores turns an
//    error of a few ulp of s into one the gate sees, for the plain version
//    as much as for this kernel). In q kT the products of the hi parts of
//    each pair of k-steps are summed from 0 (two mma's) and added to s by an
//    f32 add; the two small ones go into a sum of their own, added at the
//    end of the tile. (Accumulated straight into s, one mma a k-step, the
//    error against float64 was ~1.7x larger, and a magnitude-8 edge case
//    missed the gate.) A tile's p v is summed in
//    registers of its own and folded into the output by one f32 fma,
//    o = alpha o + p v, not accumulated into it three times a k-step.
//  - The softmax is the bf16 kernel's: f32, p = 2^(s c - m c) by
//    ex2.approx, the mask only on edge tiles. ex2.approx is within 2 ulp of
//    2^x; that moves the output by ~1e-7 of |v|, two orders under the
//    gate, and less than the plain version's own rounding of s (f32 sums of
//    dh products), so expf would buy nothing the gate can see.
//  At the Qwen shape, on an H100 80GB HBM3 at 700 W, this runs in ~0.81 ms,
//  ~3.9x its 3xTF32 bound and ~0.69x SDPA's f32 time (the FMA-unit kernel
//  it replaces took ~1.4 ms).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;

// ---------------------------------------------------------------------------
// bf16: the tensor-core kernel
// ---------------------------------------------------------------------------
using bf16 = __nv_bfloat16;
constexpr int kWarpsTC = 4;
constexpr int kThreadsTC = 32 * kWarpsTC;
constexpr int kRowsTC = 16 * kWarpsTC;  // query rows a block, 16 a warp
constexpr int kKeysTC = 64;             // keys a tile
constexpr float kLog2e = 1.4426950408889634f;

// shared memory: the q tile (later the output), then two stages of k and v
template <int DH>
constexpr size_t smem_bytes_tc() {
  return (size_t)(kRowsTC + 4 * kKeysTC) * (DH + 8) * sizeof(bf16);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, or 16 zero bytes where !full
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(full ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// c (16 x 8, f32) += a (16 x 16, bf16, row-major) b (16 x 8, bf16, col-major)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

// two neighbouring probabilities as bf16 pairs hi = bf16(p), lo = bf16(p - hi)
__device__ __forceinline__ void split(float p0, float p1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(p0, p1);
  const float2 hf = __bfloat1622float2(h);
  hi = bits(h);
  lo = bits(__floats2bfloat162_rn(p0 - hf.x, p1 - hf.y));
}

// 2^x to about 2 ulp; results below 2^-126 are flushed to 0
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// One key tile's online softmax for one m-tile. s holds the raw scores q.k
// and becomes p; m, the running max in raw-score units, and l, this lane's
// partial row sums, are updated; returns the factors of rows g and g + 8
// for the accumulator. p = 2^(s c - m c) with c = scale log2(e), one fma
// and one ex2. With EDGE the mask is applied: element e of score tile n is
// at position pos + 8 (e / 2) and key j0 + 8 n + 2 tq + e % 2.
template <bool EDGE, int NT>
__device__ __forceinline__ float2 softmax_tile(float (&s)[NT][4], float (&m)[2],
                                               float (&l)[2], float c, int j0, int pos,
                                               int tq, int n_k, int causal, int window) {
  uint32_t ok = 0xffffffffu;  // bit 4 n + e
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int n = 0; n < NT; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (EDGE) {
        const int j = j0 + n * 8 + 2 * tq + (e & 1);
        const int p = pos + 8 * (e >> 1);
        if (!(j < n_k && (!causal || j <= p) && (window <= 0 || j > p - window))) {
          s[n][e] = kNegInf;
          ok &= ~(1u << (4 * n + e));
        }
      }
      mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
    }
  }
  float alpha[2], mc[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    alpha[r] = ex2((m[r] - mx[r]) * c);
    m[r] = mx[r];
    mc[r] = mx[r] * c;
    l[r] *= alpha[r];
  }
#pragma unroll
  for (int n = 0; n < NT; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float p = ex2(fmaf(s[n][e], c, -mc[e >> 1]));
      if (EDGE && !((ok >> (4 * n + e)) & 1u)) p = 0.f;
      s[n][e] = p;
      l[e >> 1] += p;
    }
  }
  return make_float2(alpha[0], alpha[1]);
}

// rows [r0, r0 + 64) of a row-major (n, DH) matrix into shared rows of
// DH + 8 elements, by cp.async, 16 bytes a thread a step; rows at or past n
// are 0
template <int DH>
__device__ __forceinline__ void load_tile(const bf16* __restrict__ src, int n, int r0,
                                          bf16* dst) {
  constexpr int kChunks = DH / 8;  // 16-byte chunks a row
  static_assert(kRowsTC == 64 && kKeysTC == 64, "one tile height");
  static_assert((64 * kChunks) % kThreadsTC == 0, "whole steps");
#pragma unroll
  for (int it = 0; it < 64 * kChunks / kThreadsTC; ++it) {
    const int c = threadIdx.x + it * kThreadsTC;
    const int r = c / kChunks;
    const int col = (c % kChunks) * 8;
    const bool in = r0 + r < n;
    cp_async16(smem_u32(dst + r * (DH + 8) + col),
               src + (in ? (size_t)(r0 + r) * DH + col : 0), in);
  }
}

// Registers are held to what lets four blocks share an SM up to dh 64
// (128 a thread) and three at dh 80 (170); dh 128 needs ~224, two blocks.
template <int DH>
__global__ void __launch_bounds__(kThreadsTC, DH <= 64 ? 4 : (DH <= 80 ? 3 : 2))
flash_kernel_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, bf16* __restrict__ o, int H, int Hkv, int n_q,
                int n_k, int causal, int window, int q_offset, float scale_log2) {
  static_assert(DH % 16 == 0, "dh a multiple of 16");
  constexpr int LD = DH + 8;       // shared row, elements
  constexpr int KS = DH / 16;      // k-steps of q kT; pairs of output tiles of p v
  constexpr int NT = kKeysTC / 8;  // score tiles of 8 keys
  constexpr int DT = DH / 8;       // output tiles of 8 columns
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sq = reinterpret_cast<bf16*>(smem_raw);  // [kRowsTC][LD], later the output
  bf16* skv = sq + kRowsTC * LD;                 // stage s: k, then v, [kKeysTC][LD] each

  const int bh = blockIdx.x;  // b * H + h
  const int qb = gridDim.y - 1 - blockIdx.y;
  const int b = bh / H;
  const int hk = (bh % H) / (H / Hkv);
  const size_t kv_off = ((size_t)b * Hkv + hk) * n_k * DH;
  q += (size_t)bh * n_q * DH;
  o += (size_t)bh * n_q * DH;
  k += kv_off;
  v += kv_off;

  const int i0 = qb * kRowsTC;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;   // the thread's rows in its warp's 16: g and g + 8
  const int tq = lane % 4;  // its columns in each tile of 8: 2 tq, 2 tq + 1

  // the keys any real row of this block may see: tiles [t0, t1)
  const int q_lo = i0 + q_offset;
  const int q_hi = min(i0 + kRowsTC, n_q) - 1 + q_offset;
  const int k_begin = window > 0 ? max(0, q_lo - window + 1) : 0;
  const int k_end = causal ? min(n_k, q_hi + 1) : n_k;
  const int t0 = k_begin / kKeysTC;
  const int t1 = k_end > k_begin ? (k_end + kKeysTC - 1) / kKeysTC : t0;

  if (t0 >= t1) {  // no row of the block sees a key: o = 0
    for (int it = 0; it < kRowsTC * DT / kThreadsTC; ++it) {
      const int c = threadIdx.x + it * kThreadsTC;
      const int i = i0 + c / DT;
      if (i < n_q)
        *reinterpret_cast<uint4*>(o + (size_t)i * DH + (c % DT) * 8) = make_uint4(0, 0, 0, 0);
    }
    return;
  }

  load_tile<DH>(q, n_q, i0, sq);
  load_tile<DH>(k, n_k, t0 * kKeysTC, skv);
  load_tile<DH>(v, n_k, t0 * kKeysTC, skv + kKeysTC * LD);
  cp_async_commit();

  uint32_t qf[KS][4];
  float acc[DT][4];
#pragma unroll
  for (int d = 0; d < DT; ++d) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[d][e] = 0.f;
  }
  float m[2] = {kNegInf, kNegInf};  // running max, raw-score units
  float l[2] = {0.f, 0.f};          // this lane's partial sums
  const int pos0 = i0 + warp * 16 + g + q_offset;  // position of row g
  // this lane's ldmatrix row and column offsets: q and v (A, B-trans), k (B)
  const int lrow = (lane & 7) + 8 * ((lane >> 3) & 1);
  const int lcol = 8 * (lane >> 4);
  const int krow = (lane & 7) + 8 * (lane >> 4);
  const int kcol = 8 * ((lane >> 3) & 1);

  for (int t = t0; t < t1; ++t) {
    const bf16* sk = skv + ((t - t0) & 1) * 2 * kKeysTC * LD;
    const bf16* sv = sk + kKeysTC * LD;
    cp_async_wait_all();
    __syncthreads();  // tile t is in for every thread; tile t - 1's stage is free
    if (t == t0) {
#pragma unroll
      for (int ks = 0; ks < KS; ++ks)
        ldsm_x4(qf[ks], smem_u32(sq + (warp * 16 + lrow) * LD + ks * 16 + lcol));
    }
    if (t + 1 < t1) {  // tile t + 1 into tile t - 1's stage
      bf16* dst = skv + ((t + 1 - t0) & 1) * 2 * kKeysTC * LD;
      load_tile<DH>(k, n_k, (t + 1) * kKeysTC, dst);
      load_tile<DH>(v, n_k, (t + 1) * kKeysTC, dst + kKeysTC * LD);
      cp_async_commit();
    }

    // s = q kT, 16 rows x 64 keys a warp
    float s[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
    }
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t kb[4];
        ldsm_x4(kb, smem_u32(sk + (np * 16 + krow) * LD + ks * 16 + kcol));
        mma_bf16(s[2 * np], qf[ks], kb[0], kb[1]);
        mma_bf16(s[2 * np + 1], qf[ks], kb[2], kb[3]);
      }
    }

    // online softmax, the mask only on the tiles that need it
    const int j0 = t * kKeysTC;
    const bool edge = j0 + kKeysTC > n_k || (causal && j0 + kKeysTC - 1 > q_lo) ||
                      (window > 0 && j0 <= i0 + kRowsTC - 1 + q_offset - window);
    const float2 alpha =
        edge ? softmax_tile<true>(s, m, l, scale_log2, j0, pos0, tq, n_k, causal, window)
             : softmax_tile<false>(s, m, l, scale_log2, j0, pos0, tq, n_k, causal, window);
#pragma unroll
    for (int d = 0; d < DT; ++d) {
      acc[d][0] *= alpha.x;
      acc[d][1] *= alpha.x;
      acc[d][2] *= alpha.y;
      acc[d][3] *= alpha.y;
    }

    // o += p v: the score tiles 2 kk, 2 kk + 1 are the A fragment of keys
    // 16 kk.. (hi and lo halves of p)
#pragma unroll
    for (int kk = 0; kk < NT / 2; ++kk) {
      uint32_t ph[4], pl[4];
      split(s[2 * kk][0], s[2 * kk][1], ph[0], pl[0]);
      split(s[2 * kk][2], s[2 * kk][3], ph[1], pl[1]);
      split(s[2 * kk + 1][0], s[2 * kk + 1][1], ph[2], pl[2]);
      split(s[2 * kk + 1][2], s[2 * kk + 1][3], ph[3], pl[3]);
#pragma unroll
      for (int dp = 0; dp < KS; ++dp) {
        uint32_t vb[4];
        ldsm_x4_trans(vb, smem_u32(sv + (kk * 16 + lrow) * LD + dp * 16 + lcol));
        mma_bf16(acc[2 * dp], pl, vb[0], vb[1]);
        mma_bf16(acc[2 * dp], ph, vb[0], vb[1]);
        mma_bf16(acc[2 * dp + 1], pl, vb[2], vb[3]);
        mma_bf16(acc[2 * dp + 1], ph, vb[2], vb[3]);
      }
    }
  }

  // o = acc / max(l, 1e-30), staged as bf16 in the warp's rows of the q tile
  float denom[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    denom[r] = fmaxf(l[r], 1e-30f);
  }
  bf16* so = sq + warp * 16 * LD;
#pragma unroll
  for (int d = 0; d < DT; ++d) {
    *reinterpret_cast<__nv_bfloat162*>(so + g * LD + d * 8 + 2 * tq) =
        __floats2bfloat162_rn(acc[d][0] / denom[0], acc[d][1] / denom[0]);
    *reinterpret_cast<__nv_bfloat162*>(so + (g + 8) * LD + d * 8 + 2 * tq) =
        __floats2bfloat162_rn(acc[d][2] / denom[1], acc[d][3] / denom[1]);
  }
  __syncwarp();
#pragma unroll
  for (int it = 0; it < DT / 2; ++it) {  // 16 rows of DT chunks over 32 lanes
    const int c = lane + it * 32;
    const int r = c / DT;
    const int i = i0 + warp * 16 + r;
    if (i < n_q)
      *reinterpret_cast<uint4*>(o + (size_t)i * DH + (c % DT) * 8) =
          *reinterpret_cast<const uint4*>(so + r * LD + (c % DT) * 8);
  }
}

template <int DH>
cudaError_t launch_tc(const void* q, const void* k, const void* v, void* o, int B, int H,
                      int Hkv, int n_q, int n_k, int causal, int window, int q_offset,
                      float scale, cudaStream_t s) {
  const size_t bytes = smem_bytes_tc<DH>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel_tc<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, (n_q + kRowsTC - 1) / kRowsTC);
  flash_kernel_tc<DH><<<grid, kThreadsTC, bytes, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), H, Hkv, n_q, n_k, causal, window, q_offset, scale * kLog2e);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// f32: the 3xTF32 tensor-core kernel
// ---------------------------------------------------------------------------
constexpr int kKeysF = 64;  // keys a tile; query rows a block are kRowsTC
static_assert(kKeysF == kRowsTC, "the q tile is staged in a k tile's place");

// shared row lengths, floats: k and q at 16 mod 32, v at 4 mod 16
template <int DH>
__host__ __device__ constexpr int ld_k() {
  return DH % 32 == 16 ? DH : DH + 16;
}
template <int DH>
__host__ __device__ constexpr int ld_v() {
  return DH + 4;
}
template <int DH>
constexpr size_t smem_bytes_f32() {
  return (size_t)2 * kKeysF * (ld_k<DH>() + ld_v<DH>()) * sizeof(float);
}

// x = hi + lo: hi is x rounded to TF32, lo the rest rounded to TF32
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(x));
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(x - __uint_as_float(hi)));
}

// c (16 x 8, f32) += a (16 x 8, TF32, row-major) b (8 x 8, TF32, col-major)
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a b in 3xTF32, the small terms first
__device__ __forceinline__ void mma_3x(float (&c)[4], const uint32_t (&ah)[4],
                                       const uint32_t (&al)[4], const uint32_t (&bh)[2],
                                       const uint32_t (&bl)[2]) {
  mma_tf32(c, al, bh[0], bh[1]);
  mma_tf32(c, ah, bl[0], bl[1]);
  mma_tf32(c, ah, bh[0], bh[1]);
}

// rows [r0, r0 + 64) of a row-major (n, DH) f32 matrix into shared rows of
// LD floats, by cp.async, 16 bytes a thread a step; rows at or past n are 0
template <int DH, int LD>
__device__ __forceinline__ void load_tile_f32(const float* __restrict__ src, int n, int r0,
                                              float* dst) {
  constexpr int kChunks = DH / 4;  // 16-byte chunks a row
  static_assert((kKeysF * kChunks) % kThreadsTC == 0, "whole steps");
#pragma unroll
  for (int it = 0; it < kKeysF * kChunks / kThreadsTC; ++it) {
    const int c = threadIdx.x + it * kThreadsTC;
    const int r = c / kChunks;
    const int col = (c % kChunks) * 4;
    const bool in = r0 + r < n;
    cp_async16(smem_u32(dst + r * LD + col), src + (in ? (size_t)(r0 + r) * DH + col : 0), in);
  }
}

// W neighbouring floats (W = 4 or 2), and back
template <int W>
__device__ __forceinline__ void ld_vec(const float* p, float (&x)[W]) {
  if constexpr (W == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    x[0] = t.x, x[1] = t.y, x[2] = t.z, x[3] = t.w;
  } else {
    const float2 t = *reinterpret_cast<const float2*>(p);
    x[0] = t.x, x[1] = t.y;
  }
}

template <int W>
__device__ __forceinline__ void st_vec(float* p, const float (&x)[W]) {
  if constexpr (W == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  } else {
    *reinterpret_cast<float2*>(p) = make_float2(x[0], x[1]);
  }
}

template <int DH>
__global__ void __launch_bounds__(kThreadsTC, DH <= 80 ? 2 : 1)
flash_kernel_f32(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, int H, int Hkv, int n_q,
                 int n_k, int causal, int window, int q_offset, float scale_log2) {
  static_assert(DH % 16 == 0, "dh a multiple of 16");
  constexpr int LDK = ld_k<DH>();
  constexpr int LDV = ld_v<DH>();
  constexpr int STAGE = kKeysF * (LDK + LDV);  // floats of a stage: k, then v
  constexpr int KP = DH / 16;                  // pairs of k-steps of q kT
  constexpr int NT = kKeysF / 8;               // score tiles of 8 keys
  constexpr int DT = DH / 8;                   // output tiles of 8 columns
  constexpr int GW = DH % 32 == 0 ? 4 : 2;     // output tiles a read of v serves
  extern __shared__ __align__(16) float smf[];

  const int bh = blockIdx.x;  // b * H + h
  const int qb = gridDim.y - 1 - blockIdx.y;
  const int b = bh / H;
  const int hk = (bh % H) / (H / Hkv);
  const size_t kv_off = ((size_t)b * Hkv + hk) * n_k * DH;
  q += (size_t)bh * n_q * DH;
  o += (size_t)bh * n_q * DH;
  k += kv_off;
  v += kv_off;

  const int i0 = qb * kRowsTC;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;   // the thread's rows in its warp's 16: g and g + 8
  const int tq = lane % 4;  // its accumulator columns in a tile of 8: 2 tq, 2 tq + 1

  // the keys any real row of this block may see: tiles [t0, t1)
  const int q_lo = i0 + q_offset;
  const int q_hi = min(i0 + kRowsTC, n_q) - 1 + q_offset;
  const int k_begin = window > 0 ? max(0, q_lo - window + 1) : 0;
  const int k_end = causal ? min(n_k, q_hi + 1) : n_k;
  const int t0 = k_begin / kKeysF;
  const int t1 = k_end > k_begin ? (k_end + kKeysF - 1) / kKeysF : t0;

  if (t0 >= t1) {  // no row of the block sees a key: o = 0
    for (int it = 0; it < kRowsTC * (DH / 4) / kThreadsTC; ++it) {
      const int c = threadIdx.x + it * kThreadsTC;
      const int i = i0 + c / (DH / 4);
      if (i < n_q)
        *reinterpret_cast<float4*>(o + (size_t)i * DH + (c % (DH / 4)) * 4) =
            make_float4(0.f, 0.f, 0.f, 0.f);
    }
    return;
  }

  load_tile_f32<DH, LDK>(q, n_q, i0, smf + STAGE);
  load_tile_f32<DH, LDK>(k, n_k, t0 * kKeysF, smf);
  load_tile_f32<DH, LDV>(v, n_k, t0 * kKeysF, smf + kKeysF * LDK);
  cp_async_commit();

  uint32_t qh[KP][2][4], ql[KP][2][4];  // q's A fragments, both k-steps of a pair
  float acc[DT][4];
#pragma unroll
  for (int d = 0; d < DT; ++d) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[d][e] = 0.f;
  }
  float m[2] = {kNegInf, kNegInf};  // running max, raw-score units
  float l[2] = {0.f, 0.f};          // this lane's partial sums
  const int pos0 = i0 + warp * 16 + g + q_offset;  // position of row g

  for (int t = t0; t < t1; ++t) {
    const float* sk = smf + ((t - t0) & 1) * STAGE;
    const float* sv = sk + kKeysF * LDK;
    cp_async_wait_all();
    __syncthreads();  // tile t is in for every thread; tile t - 1's stage is free
    if (t == t0) {
      const float* sq = smf + STAGE + warp * 16 * LDK;
#pragma unroll
      for (int kp = 0; kp < KP; ++kp) {
        const float4 r0 = *reinterpret_cast<const float4*>(sq + g * LDK + 16 * kp + 4 * tq);
        const float4 r1 =
            *reinterpret_cast<const float4*>(sq + (g + 8) * LDK + 16 * kp + 4 * tq);
        split_tf32(r0.x, qh[kp][0][0], ql[kp][0][0]);
        split_tf32(r1.x, qh[kp][0][1], ql[kp][0][1]);
        split_tf32(r0.y, qh[kp][0][2], ql[kp][0][2]);
        split_tf32(r1.y, qh[kp][0][3], ql[kp][0][3]);
        split_tf32(r0.z, qh[kp][1][0], ql[kp][1][0]);
        split_tf32(r1.z, qh[kp][1][1], ql[kp][1][1]);
        split_tf32(r0.w, qh[kp][1][2], ql[kp][1][2]);
        split_tf32(r1.w, qh[kp][1][3], ql[kp][1][3]);
      }
      __syncthreads();  // every warp holds its q before tile t0 + 1 lands on it
    }
    if (t + 1 < t1) {  // tile t + 1 into tile t - 1's stage
      float* dst = smf + ((t + 1 - t0) & 1) * STAGE;
      load_tile_f32<DH, LDK>(k, n_k, (t + 1) * kKeysF, dst);
      load_tile_f32<DH, LDV>(v, n_k, (t + 1) * kKeysF, dst + kKeysF * LDK);
      cp_async_commit();
    }

    // s = q kT, 16 rows x 64 keys a warp, in two halves of 32 keys. The
    // products of the hi parts of a pair of k-steps are summed from 0 and
    // added to s in an f32 add, the two small ones into a sum of their own
    // that is added at the end: the running sum of large values takes one
    // rounding a pair of k-steps, not six mma's
    float s[NT][4];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float sm[NT / 2][4];
#pragma unroll
      for (int n = 0; n < NT / 2; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[half * NT / 2 + n][e] = sm[n][e] = 0.f;
      }
#pragma unroll
      for (int kp = 0; kp < KP; ++kp) {
#pragma unroll
        for (int n = 0; n < NT / 2; ++n) {
          const int nn = half * NT / 2 + n;
          const float4 kb =
              *reinterpret_cast<const float4*>(sk + (nn * 8 + g) * LDK + 16 * kp + 4 * tq);
          uint32_t bh[2], bl[2];
          split_tf32(kb.x, bh[0], bl[0]);
          split_tf32(kb.y, bh[1], bl[1]);
          float big[4] = {0.f, 0.f, 0.f, 0.f};
          mma_tf32(sm[n], ql[kp][0], bh[0], bh[1]);
          mma_tf32(sm[n], qh[kp][0], bl[0], bl[1]);
          mma_tf32(big, qh[kp][0], bh[0], bh[1]);
          split_tf32(kb.z, bh[0], bl[0]);
          split_tf32(kb.w, bh[1], bl[1]);
          mma_tf32(sm[n], ql[kp][1], bh[0], bh[1]);
          mma_tf32(sm[n], qh[kp][1], bl[0], bl[1]);
          mma_tf32(big, qh[kp][1], bh[0], bh[1]);
#pragma unroll
          for (int e = 0; e < 4; ++e) s[nn][e] += big[e];
        }
      }
#pragma unroll
      for (int n = 0; n < NT / 2; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[half * NT / 2 + n][e] += sm[n][e];
      }
    }

    // online softmax, the mask only on the tiles that need it
    const int j0 = t * kKeysF;
    const bool edge = j0 + kKeysF > n_k || (causal && j0 + kKeysF - 1 > q_lo) ||
                      (window > 0 && j0 <= i0 + kRowsTC - 1 + q_offset - window);
    const float2 alpha =
        edge ? softmax_tile<true>(s, m, l, scale_log2, j0, pos0, tq, n_k, causal, window)
             : softmax_tile<false>(s, m, l, scale_log2, j0, pos0, tq, n_k, causal, window);

    // o = alpha o + p v. The tile's p v is summed in registers of its own,
    // GW output tiles at a time, and folded in with one rounding (an f32
    // fma), rather than accumulated into the running output 3 NT times a
    // tile. Score tile kk is the A fragment of keys 8 kk.. (column tq is
    // key 2 tq, column tq + 4 key 2 tq + 1).
#pragma unroll
    for (int r = 0; r < DT / GW; ++r) {
      float pv[GW][4];
#pragma unroll
      for (int u = 0; u < GW; ++u) {
#pragma unroll
        for (int e = 0; e < 4; ++e) pv[u][e] = 0.f;
      }
#pragma unroll
      for (int kk = 0; kk < NT; ++kk) {
        uint32_t ph[4], pl[4];
        split_tf32(s[kk][0], ph[0], pl[0]);
        split_tf32(s[kk][2], ph[1], pl[1]);
        split_tf32(s[kk][1], ph[2], pl[2]);
        split_tf32(s[kk][3], ph[3], pl[3]);
        const float* v0 = sv + (kk * 8 + 2 * tq) * LDV + GW * g + 8 * GW * r;  // key 2 tq
        float b0[GW], b1[GW];
        ld_vec<GW>(v0, b0);
        ld_vec<GW>(v0 + LDV, b1);  // key 2 tq + 1
#pragma unroll
        for (int u = 0; u < GW; ++u) {
          uint32_t bh[2], bl[2];
          split_tf32(b0[u], bh[0], bl[0]);
          split_tf32(b1[u], bh[1], bl[1]);
          mma_3x(pv[u], ph, pl, bh, bl);
        }
      }
#pragma unroll
      for (int u = 0; u < GW; ++u) {
        float* a = acc[GW * r + u];
        a[0] = fmaf(a[0], alpha.x, pv[u][0]);
        a[1] = fmaf(a[1], alpha.x, pv[u][1]);
        a[2] = fmaf(a[2], alpha.y, pv[u][2]);
        a[3] = fmaf(a[3], alpha.y, pv[u][3]);
      }
    }
  }

  // o = acc / max(l, 1e-30); accumulator column 2 tq + e of output tile
  // GW r + u is dh 8 GW r + GW (2 tq + e) + u
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    const float denom = fmaxf(l[h], 1e-30f);
    const int i = i0 + warp * 16 + g + 8 * h;
    if (i >= n_q) continue;
    float* orow = o + (size_t)i * DH;
#pragma unroll
    for (int r = 0; r < DT / GW; ++r) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float x[GW];
#pragma unroll
        for (int u = 0; u < GW; ++u) x[u] = acc[GW * r + u][2 * h + e] / denom;
        st_vec<GW>(orow + 8 * GW * r + GW * (2 * tq + e), x);
      }
    }
  }
}

template <int DH>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o, int B, int H,
                       int Hkv, int n_q, int n_k, int causal, int window, int q_offset,
                       float scale, cudaStream_t s) {
  const size_t bytes = smem_bytes_f32<DH>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel_f32<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, (n_q + kRowsTC - 1) / kRowsTC);
  flash_kernel_f32<DH><<<grid, kThreadsTC, bytes, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), H, Hkv, n_q, n_k, causal,
      window, q_offset, scale * kLog2e);
  return cudaGetLastError();
}

template <int DH>
cudaError_t launch(int dtype, const void* q, const void* k, const void* v, void* o, int B,
                   int H, int Hkv, int n_q, int n_k, int causal, int window, int q_offset,
                   float scale, cudaStream_t s) {
  if (dtype == 0)
    return launch_f32<DH>(q, k, v, o, B, H, Hkv, n_q, n_k, causal, window, q_offset, scale, s);
  return launch_tc<DH>(q, k, v, o, B, H, Hkv, n_q, n_k, causal, window, q_offset, scale, s);
}

}  // namespace

// o (B, H, T, dh) = attention of q (B, H, T, dh) over k, v (B, Hkv, S, dh),
// all contiguous, of one type, f32 (dtype 0) or bf16 (dtype 1), and each
// pointer 16-byte aligned. dh is 32, 64, 80 or 128 and H a multiple of
// Hkv. Launch on `stream`; returns cudaGetLastError() (0 = launched),
// cudaErrorInvalidValue for arguments the kernel does not take, or
// cudaErrorMisalignedAddress for a pointer off 16 bytes.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* o,
                                      int B, int H, int Hkv, int T, int S, int dh,
                                      int causal, int window, int q_offset, float scale,
                                      int dtype, void* stream) {
  if (B <= 0 || H <= 0 || T <= 0) return 0;
  if (Hkv <= 0 || H % Hkv != 0 || S < 0 || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const uintptr_t addr = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                         reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o);
  if ((addr & 15) != 0) return static_cast<int>(cudaErrorMisalignedAddress);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (dh) {
    case 32:
      err = launch<32>(dtype, q, k, v, o, B, H, Hkv, T, S, causal, window, q_offset, scale, s);
      break;
    case 64:
      err = launch<64>(dtype, q, k, v, o, B, H, Hkv, T, S, causal, window, q_offset, scale, s);
      break;
    case 80:
      err = launch<80>(dtype, q, k, v, o, B, H, Hkv, T, S, causal, window, q_offset, scale, s);
      break;
    case 128:
      err = launch<128>(dtype, q, k, v, o, B, H, Hkv, T, S, causal, window, q_offset, scale, s);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
