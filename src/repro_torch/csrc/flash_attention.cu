// Forward attention with an online softmax (FlashAttention-style) on Hopper:
// bf16 inputs on the tensor cores, f32 inputs on the FMA units.
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
// 989 TFLOP/s (bf16 tensor cores); in f32, 0.51 ms at 67 TFLOP/s.
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
//  At the Qwen shape this runs at ~5x its bound and ~1.8x SDPA. A wgmma
//  version (a warpgroup a 64-row tile, k and v by TMA with mbarriers, the
//  softmax and split of one tile overlapping the products of the next) is
//  queued in ROADMAP.md.
//
// f32: flash_kernel, on the FMA units. TF32 keeps about 10 bits and would not
// hold the f32 gate (2e-5 of the plain version); a 3xTF32 split would. 256
// threads (16 x 16) a block and tiles of kBQ = kBKV = 64. The query tile is
// staged once, transposed, in shared memory; each kv tile is staged (k
// transposed, v as is) in turn. A thread owns a 4 x 4 block of the 64 x 64
// score tile (rows ty*4.., keys tx*4..), read as two float4s of q and k a
// step of the dot product, and a 4 x dh/16 block of the output accumulator
// (rows ty*4.., columns tx*dh/16..). The 16 threads of a row group share
// its running max and denominator, reduced with shuffles. The
// probabilities go through shared memory, transposed, to the P @ V product.
// exp is expf (no fast math), and p stays f32 in the P @ V product.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;

// ---------------------------------------------------------------------------
// f32: the FMA kernel
// ---------------------------------------------------------------------------
constexpr int kBQ = 64;   // query rows a block
constexpr int kBKV = 64;  // keys a tile
constexpr int kSide = 16;
constexpr int kThreads = kSide * kSide;
constexpr int kPad = 4;  // keeps float4 alignment, spreads transposed rows

// Rows [r0, r0 + 64) of a row-major (n, DH) matrix into shared memory,
// transposed (dst[d * ld + r]) or not (dst[r * ld + d]); rows at or past n
// are 0. Neighbouring threads read neighbouring elements.
template <int DH, bool TRANS>
__device__ __forceinline__ void stage(const float* __restrict__ src, int n, int r0,
                                      float* __restrict__ dst, int ld) {
  static_assert(kBQ == kBKV, "one staging shape");
  for (int e = threadIdx.x; e < kBKV * DH; e += kThreads) {
    const int r = e / DH;
    const int d = e % DH;
    const float x = (r0 + r < n) ? src[(size_t)(r0 + r) * DH + d] : 0.f;
    if (TRANS) {
      dst[d * ld + r] = x;
    } else {
      dst[r * ld + d] = x;
    }
  }
}

// CT neighbouring floats from shared memory, as float4, float2 or scalars.
template <int CT>
__device__ __forceinline__ void load_cols(const float* p, float (&out)[CT]) {
  if constexpr (CT % 4 == 0) {
#pragma unroll
    for (int c = 0; c < CT; c += 4) {
      const float4 x = *reinterpret_cast<const float4*>(p + c);
      out[c] = x.x;
      out[c + 1] = x.y;
      out[c + 2] = x.z;
      out[c + 3] = x.w;
    }
  } else if constexpr (CT % 2 == 0) {
#pragma unroll
    for (int c = 0; c < CT; c += 2) {
      const float2 x = *reinterpret_cast<const float2*>(p + c);
      out[c] = x.x;
      out[c + 1] = x.y;
    }
  } else {
#pragma unroll
    for (int c = 0; c < CT; ++c) out[c] = p[c];
  }
}

// max and sum over the 16 threads of a row group (lanes 0-15 or 16-31)
__device__ __forceinline__ float group_max(float x) {
#pragma unroll
  for (int off = kSide / 2; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int off = kSide / 2; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <int DH>
constexpr size_t smem_floats() {
  // q^T, k^T, v, p^T
  return (size_t)DH * (kBQ + kPad) + (size_t)DH * (kBKV + kPad) + (size_t)kBKV * DH +
         (size_t)kBKV * (kBQ + kPad);
}

template <int DH>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, float* __restrict__ o, int H, int Hkv, int n_q,
             int n_k, int causal, int window, int q_offset, float scale) {
  static_assert(DH % kSide == 0, "dh a multiple of 16");
  constexpr int CT = DH / kSide;  // output columns a thread
  constexpr int ldq = kBQ + kPad;
  constexpr int ldk = kBKV + kPad;
  constexpr int ldv = DH;
  constexpr int ldp = kBQ + kPad;
  extern __shared__ __align__(16) float smem[];
  float* qt = smem;              // [DH][ldq]
  float* kt = qt + DH * ldq;     // [DH][ldk]
  float* vs = kt + DH * ldk;     // [kBKV][ldv]
  float* pt = vs + kBKV * ldv;   // [kBKV][ldp]

  const int bh = blockIdx.x;  // b * H + h
  const int qb = gridDim.y - 1 - blockIdx.y;
  const int b = bh / H;
  const int hk = (bh % H) / (H / Hkv);
  const size_t kv_off = ((size_t)b * Hkv + hk) * n_k * DH;
  q += (size_t)bh * n_q * DH;
  o += (size_t)bh * n_q * DH;
  k += kv_off;
  v += kv_off;

  const int i0 = qb * kBQ;
  const int ty = threadIdx.x / kSide;
  const int tx = threadIdx.x % kSide;

  // the keys any real row of this block may see: tiles [t0, t1)
  const int q_lo = i0 + q_offset;
  const int q_hi = min(i0 + kBQ, n_q) - 1 + q_offset;
  const int k_begin = window > 0 ? max(0, q_lo - window + 1) : 0;
  const int k_end = causal ? min(n_k, q_hi + 1) : n_k;
  const int t0 = k_begin / kBKV;
  const int t1 = k_end > k_begin ? (k_end + kBKV - 1) / kBKV : t0;

  stage<DH, true>(q, n_q, i0, qt, ldq);

  int qpos[4];
  float m[4], l[4], acc[4][CT];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    qpos[r] = i0 + ty * 4 + r + q_offset;
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < CT; ++c) acc[r][c] = 0.f;
  }

  for (int t = t0; t < t1; ++t) {
    const int j0 = t * kBKV;
    __syncthreads();  // the previous tile's k, v and p are consumed
    stage<DH, true>(k, n_k, j0, kt, ldk);
    stage<DH, false>(v, n_k, j0, vs, ldv);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
#pragma unroll
      for (int c = 0; c < 4; ++c) s[r][c] = 0.f;
    }
#pragma unroll 8
    for (int d = 0; d < DH; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(&qt[d * ldq + ty * 4]);
      const float4 bk = *reinterpret_cast<const float4*>(&kt[d * ldk + tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {bk.x, bk.y, bk.z, bk.w};
#pragma unroll
      for (int r = 0; r < 4; ++r) {
#pragma unroll
        for (int c = 0; c < 4; ++c) s[r][c] = fmaf(av[r], bv[c], s[r][c]);
      }
    }

#pragma unroll
    for (int r = 0; r < 4; ++r) {
      bool ok[4];
      float mx = kNegInf;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int j = j0 + tx * 4 + c;
        ok[c] = j < n_k && (!causal || j <= qpos[r]) && (window <= 0 || j > qpos[r] - window);
        s[r][c] = ok[c] ? s[r][c] * scale : kNegInf;
        mx = fmaxf(mx, s[r][c]);
      }
      const float m_new = fmaxf(m[r], group_max(mx));
      const float alpha = expf(m[r] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[r][c] = ok[c] ? expf(s[r][c] - m_new) : 0.f;  // now p
        sum += s[r][c];
      }
      l[r] = l[r] * alpha + group_sum(sum);
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < CT; ++c) acc[r][c] *= alpha;
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      *reinterpret_cast<float4*>(&pt[(tx * 4 + c) * ldp + ty * 4]) =
          make_float4(s[0][c], s[1][c], s[2][c], s[3][c]);
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < kBKV; ++j) {
      const float4 p4 = *reinterpret_cast<const float4*>(&pt[j * ldp + ty * 4]);
      const float pr[4] = {p4.x, p4.y, p4.z, p4.w};
      float vv[CT];
      load_cols<CT>(&vs[j * ldv + tx * CT], vv);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
#pragma unroll
        for (int c = 0; c < CT; ++c) acc[r][c] = fmaf(pr[r], vv[c], acc[r][c]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = i0 + ty * 4 + r;
    if (i >= n_q) continue;
    const float denom = fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int c = 0; c < CT; ++c) o[(size_t)i * DH + tx * CT + c] = acc[r][c] / denom;
  }
}

template <int DH>
cudaError_t launch_fma(const void* q, const void* k, const void* v, void* o, int B, int H,
                       int Hkv, int n_q, int n_k, int causal, int window, int q_offset,
                       float scale, cudaStream_t s) {
  const size_t bytes = smem_floats<DH>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, (n_q + kBQ - 1) / kBQ);
  flash_kernel<DH><<<grid, kThreads, bytes, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), H, Hkv, n_q, n_k, causal,
      window, q_offset, scale);
  return cudaGetLastError();
}

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

template <int DH>
cudaError_t launch(int dtype, const void* q, const void* k, const void* v, void* o, int B,
                   int H, int Hkv, int n_q, int n_k, int causal, int window, int q_offset,
                   float scale, cudaStream_t s) {
  if (dtype == 0)
    return launch_fma<DH>(q, k, v, o, B, H, Hkv, n_q, n_k, causal, window, q_offset, scale, s);
  return launch_tc<DH>(q, k, v, o, B, H, Hkv, n_q, n_k, causal, window, q_offset, scale, s);
}

}  // namespace

// o (B, H, T, dh) = attention of q (B, H, T, dh) over k, v (B, Hkv, S, dh),
// all contiguous and of one type: f32 (dtype 0) or bf16 (dtype 1, each
// pointer 16-byte aligned). dh is 32, 64, 80 or 128 and H a multiple of
// Hkv. Launch on `stream`; returns cudaGetLastError() (0 = launched),
// cudaErrorInvalidValue for arguments the kernel does not take, or
// cudaErrorMisalignedAddress for a bf16 pointer off 16 bytes.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* o,
                                      int B, int H, int Hkv, int T, int S, int dh,
                                      int causal, int window, int q_offset, float scale,
                                      int dtype, void* stream) {
  if (B <= 0 || H <= 0 || T <= 0) return 0;
  if (Hkv <= 0 || H % Hkv != 0 || S < 0 || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const uintptr_t addr = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                         reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o);
  if (dtype == 1 && (addr & 15) != 0) return static_cast<int>(cudaErrorMisalignedAddress);
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
