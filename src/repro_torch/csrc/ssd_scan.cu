// Mamba2 SSD chunked scan (state-space duality), forward, f32, on Hopper's
// tensor cores (3xTF32).
//
// For every sequence b and head h (ngroups = 1: B and C are shared by the
// heads), with ga_t = A_h dt_{t,h} and cs its inclusive cumulative sum over
// the chunk, chunk by chunk in order:
//
//   G[t, s] = C_t . B_s                                   (per (b, chunk))
//   W[t, s] = s <= t ? exp(cs_t - cs_s) G[t, s] dt_s : 0
//   y_t     = sum_s W[t, s] x_s + exp(cs_t) (state C_t)
//   state  <- exp(cs_last) state + sum_s exp(cs_last - cs_s) dt_s x_s ⊗ B_s
//
// with the (P, N) state starting at 0. This is the recurrence
// S_t = exp(A dt_t) S_{t-1} + dt_t x_t ⊗ B_t, y_t = S_t C_t of the JAX
// package's kernels/ssd_scan/ref.py.
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan/ssd_scan.py
// ssd_scan_pallas (its pallas_call, body _ssd_kernel). That kernel took
// head-major inputs prepared by its wrapper (x (H, T, P), ga = A dt), ran
// the chunks as the sequential inner axis of a (H, T / chunk) grid with the
// state in VMEM scratch, and needed T to be a multiple of the chunk. Here
// one call takes the model's own time-major layout (x (B, T, H, P), dt
// (B, T, H), B and C (B, T, N)) at any T, and makes two launches:
// ssd_kernel_gram writes G of every (b, chunk) once, for all heads, into a
// scratch the caller allocates (B x chunks x 64 x 64 floats, 2 MB at the
// prefill shape, read back from L2); ssd_kernel then walks the chunks of one
// (b, h) and 32 of its P columns a block, with the state in shared memory. The
// kernel picks its own chunk (kC = 64 rows), forms ga and the cumulative sum
// itself (a warp scan), and masks a ragged last chunk: its missing rows are
// zeros, so they decay nothing and add nothing. Every decay is exp of a
// difference of cumulative sums, exp(cs_t - cs_s) and exp(cs_last - cs_s),
// never exp(cs_t) exp(-cs_s), which would overflow f32 for a long chunk or
// a large |A|; the masked (s > t) entries are a select, never a product with
// the mask (there exp may be inf).
//
// What bounds it: operations. Per (b, chunk) of 64 rows the function needs
// the causal lower triangle of G once (c (c + 1) N) and, per head, the
// intra-chunk product over the same triangle (c (c + 1) P), the inter-chunk
// product (2 c N P, not in the first chunk, where the state is 0) and the
// state update (2 c P N, not after the last chunk); at Mamba2-2.7B's prefill
// (B 4, T 2048, H 80, P 64, N 128) that is ~23.6 GFLOP a call against
// ~347 MB of inputs and output: 0.143 ms at 164.9 TFLOP/s (three TF32
// products a product, 494.7 / 3), 0.35 ms at fp32's 67 TFLOP/s outside the
// tensor cores, 0.10 ms of bytes at 3.35 TB/s (the H100 SXM data sheet).
//
// Every product runs on mma.sync m16n8k8 in TF32, as 3xTF32: each operand x
// is split into x_hi = tf32(x) and x_lo = tf32(x - x_hi) and a.b is taken as
// a_lo.b_hi + a_hi.b_lo + a_hi.b_hi into one f32 accumulator (the dropped
// a_lo.b_lo is 2^-22 of |a||b|), which holds the f32 gate (2e-5 of the plain
// chunked version) where TF32 alone (10 bits) would not.
//
// ssd_kernel_gram: two blocks of four warps a (b, chunk), 32 rows of G a
// block; a warp takes every other 8-column tile at or below the diagonal of
// one 16-row tile, so the triangle is spread evenly; tiles above it are
// neither computed nor written (the scan reads none of them). C's and B's
// rows are read from global memory as the fragments themselves, 16 bytes a
// lane.
//
// ssd_kernel: 128 threads a block for (b, h, 32 columns of P), so 640 blocks
// at the prefill shape. A block alone is bound by latency (its chain of
// chunks, two barriers each), so the design is set by how many blocks an SM
// holds: 41,728 bytes of shared memory and 96 registers a thread (a
// 32-byte spill) let five share an SM, and all 640 run in one wave on 132
// SMs. (With the
// state in registers, 167 of them and three blocks an SM, the grid took two
// waves and the kernel ~15% longer; at four an SM, 1.2 waves, ~20%.) Per
// chunk:
//  - every warp loads the chunk's dt and forms cs by a warp scan; each lane
//    stages x of two rows and eight columns in shared memory, transposed.
//  - y: warp w owns rows 16 w.., all 32 columns. The inter-chunk term
//    multiplies C's rows (read from global memory as A fragments) by the
//    state; then W is formed in registers from G (global, L2), cs and dt as
//    the A fragment of the intra-chunk product, for the 16-column blocks of
//    s at or below the warp's rows only. exp there is ex2.approx of the
//    difference times log2(e): within ~2e-6 of expf for the differences
//    that matter (|cs_t - cs_s| < ~20), two orders under the gate, and the
//    scan's largest instruction count otherwise.
//  - the state: shared memory holds it as hi + rest, hi = tf32(state) and
//    rest = state - hi exactly, which is at once the split the inter-chunk
//    product reads and the state itself. Warp w owns its 32 columns of N
//    for all 32 rows of P: it reads them, scales by exp(cs_last), adds
//    (x w)^T B in registers (B's rows read from global memory as B
//    fragments), and after the chunk's second barrier writes them back.
//  The mma's k index need not follow n or s in order, since every product
//  sums over it: a lane's columns tq and tq + 4 of a pair of k-steps are
//  16 kp + 4 tq + {0, 1} and + {2, 3}, so each lane reads its A and B values
//  as 16-byte loads; the state's columns are taken in the order that makes
//  B's reads 16-byte loads too (column g of n-tile u is n = 32 w + 4 g + u).
//  Rows of the shared tiles are 64 or 128 floats with the 16-byte groups of
//  odd rows XORed by 4, which puts the 16-byte fragment reads of a
//  quarter-warp on distinct banks.
//  At the Mamba2-2.7B prefill shape, on an H100 80GB HBM3 at 700 W, the two
//  launches take ~0.78 ms (~16 us of it the Gram matrices), ~5.4x the
//  3xTF32 bound; the FMA-unit kernel they replace took ~1.59 ms.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kC = 64;    // chunk rows
constexpr int kP = 64;    // largest head dim
constexpr int kN = 128;   // largest state dim
constexpr int kPB = 32;   // head-dim columns a scan block
constexpr int kThreads = 128;
constexpr size_t kSmemFloats = 2 * (size_t)kPB * kN + (size_t)kPB * kC + 3 * kC;

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float at(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

constexpr float kLog2e = 1.4426950408889634f;

// 2^x to about 2 ulp (ex2.approx); results below 2^-126 flush to 0
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// x rounded to TF32 (10 bits of mantissa, to nearest, ties away from zero)
__device__ __forceinline__ float tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return __uint_as_float(r);
}

// x = hi + lo: hi is x rounded to TF32, lo the rest rounded to TF32
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  const float h = tf32(x);
  hi = __float_as_uint(h);
  lo = __float_as_uint(tf32(x - h));
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

// The A fragments (hi, lo) of a pair of k-steps from rows g (r0) and g + 8
// (r1) at columns 16 kp + 4 tq..: step 0 takes .x and .y, step 1 .z and .w.
__device__ __forceinline__ void split_a(const float4& r0, const float4& r1,
                                        uint32_t (&ah)[2][4], uint32_t (&al)[2][4]) {
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    split_tf32(at(r0, 2 * k), ah[k][0], al[k][0]);
    split_tf32(at(r1, 2 * k), ah[k][1], al[k][1]);
    split_tf32(at(r0, 2 * k + 1), ah[k][2], al[k][2]);
    split_tf32(at(r1, 2 * k + 1), ah[k][3], al[k][3]);
  }
}

// Float offset of (row r, column c) in shared rows of W floats: the 16-byte
// group of c is XORed by 4 on odd rows.
template <int W>
__device__ __forceinline__ int swz(int r, int c) {
  return r * W + (((c >> 2) ^ ((r & 1) << 2)) << 2) + (c & 3);
}

// G[b, chunk] = C B^T over the chunk's 64 rows, unmasked. Two blocks a
// (b, chunk), 32 rows each; the 8-column tiles at or below the diagonal of
// a 16-row tile r are split over two warps (r + 1 each).
__global__ void __launch_bounds__(kThreads)
ssd_kernel_gram(const float* __restrict__ Bm, const float* __restrict__ Cm,
                float* __restrict__ G, int T, int N, int n_chunks) {
  const int cb = blockIdx.x / 2;  // b * n_chunks + chunk
  const int b = cb / n_chunks;
  const int t0 = (cb % n_chunks) * kC;
  const int len = min(kC, T - t0);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int tq = lane % 4;
  const int r = 2 * (blockIdx.x % 2) + warp / 2;  // the warp's 16-row tile
  const int r0 = 16 * r + g;                       // rows r0 and r0 + 8
  const int j0 = warp % 2;                         // column tiles j0, j0 + 2, ..
  const float* c0 = Cm + ((size_t)b * T + t0 + r0) * N;
  const float* c1 = c0 + (size_t)8 * N;
  const float* bg = Bm + ((size_t)b * T + t0 + g) * N;  // row g of column tile j: + 8 j N
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);

  float acc[4][4] = {};
  for (int n0 = 0; n0 < N; n0 += 16) {
    const int n = n0 + 4 * tq;
    const bool nok = n < N;
    uint32_t ah[2][4], al[2][4];
    split_a(nok && r0 < len ? ld4(c0 + n) : zero, nok && r0 + 8 < len ? ld4(c1 + n) : zero,
            ah, al);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (i > r) break;
      const int j = j0 + 2 * i;
      const float4 bv = nok && 8 * j + g < len ? ld4(bg + (size_t)8 * j * N + n) : zero;
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        uint32_t bh[2], bl[2];
        split_tf32(at(bv, 2 * k), bh[0], bl[0]);
        split_tf32(at(bv, 2 * k + 1), bh[1], bl[1]);
        mma_3x(acc[i], ah[k], al[k], bh, bl);
      }
    }
  }
  float* out = G + ((size_t)cb * kC + r0) * kC + 2 * tq;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (i > r) break;
    const int j = j0 + 2 * i;
    *reinterpret_cast<float2*>(out + 8 * j) = make_float2(acc[i][0], acc[i][1]);
    *reinterpret_cast<float2*>(out + 8 * kC + 8 * j) = make_float2(acc[i][2], acc[i][3]);
  }
}

__global__ void __launch_bounds__(kThreads, 5)
ssd_kernel(const float* __restrict__ x, const float* __restrict__ dt,
           const float* __restrict__ A, const float* __restrict__ Bm,
           const float* __restrict__ Cm, const float* __restrict__ G, float* __restrict__ y,
           int T, int H, int P, int N, int n_chunks, int n_slices) {
  extern __shared__ __align__(16) float smem[];
  float* sth = smem;            // the state as hi + rest (rest = state - hi, exact);
  float* str = sth + kPB * kN;  // (p, n) in rows of kN
  float* xt = str + kPB * kN;   // x^T: (p, s) in rows of kC
  float* cs = xt + kPB * kC;    // [kC]
  float* dts = cs + kC;         // [kC]
  float* wds = dts + kC;        // [kC], w_s = exp(cs_last - cs_s) dt_s

  const int bh = blockIdx.x / n_slices;
  const int b = bh / H;
  const int h = bh % H;
  const int pb = (blockIdx.x % n_slices) * kPB;  // the block's first column of P
  const float a_h = A[h];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int tq = lane % 4;
  const int tr0 = 16 * warp + g;     // y: rows tr0 and tr0 + 8 of a chunk
  const int nb = 32 * warp + 4 * g;  // state: B's columns nb + u, u = 0..3
  const int xp = pb + 8 * warp;      // staging: columns xp.. of rows 2 lane, 2 lane + 1
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int c = 0; c < n_chunks; ++c) {
    const int t0 = c * kC;
    const int len = min(kC, T - t0);
    const bool last = c + 1 == n_chunks;

    // ---- stage x^T and, by a warp scan in every warp (two rows a lane), cs
    float4 xr[2][2];
    float dtr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int s = 2 * lane + r;
      const bool ok = s < len;
      const size_t row = (size_t)b * T + t0 + s;
      const float* xrow = x + (row * H + h) * P;
      xr[r][0] = ok && xp < P ? ld4(xrow + xp) : zero;
      xr[r][1] = ok && xp + 4 < P ? ld4(xrow + xp + 4) : zero;
      dtr[r] = ok ? dt[row * H + h] : 0.f;
    }
    const float g0 = a_h * dtr[0];
    const float pair = g0 + a_h * dtr[1];
    float incl = pair;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float up = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += up;
    }
    const float excl = incl - pair;
    const float cs0 = excl + g0;
    const float cs1 = excl + pair;
    const float cs_last = __shfl_sync(0xffffffffu, cs1, 31);
    if (warp == 0) {
      *reinterpret_cast<float2*>(cs + 2 * lane) = make_float2(cs0, cs1);
      *reinterpret_cast<float2*>(dts + 2 * lane) = make_float2(dtr[0], dtr[1]);
      *reinterpret_cast<float2*>(wds + 2 * lane) =
          make_float2(expf(cs_last - cs0) * dtr[0], expf(cs_last - cs1) * dtr[1]);
    }
#pragma unroll
    for (int q = 0; q < 2; ++q) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        *reinterpret_cast<float2*>(xt + swz<kC>(8 * warp + 4 * q + e, 2 * lane)) =
            make_float2(at(xr[0][q], e), at(xr[1][q], e));
      }
    }
    __syncthreads();  // the chunk's x, cs, dt and w, and the last chunk's state, are in

    // ---- y: rows tr0 and tr0 + 8, columns pb + 8 nt + 2 tq (+ 1)
    float acc[kPB / 8][4] = {};
    const bool ok0 = tr0 < len;
    const bool ok1 = tr0 + 8 < len;
    if (c > 0) {  // C_t . state, the state being 0 before the first chunk
      const float* c0 = Cm + ((size_t)b * T + t0 + tr0) * N;
      const float* c1 = c0 + (size_t)8 * N;
#pragma unroll 2
      for (int n0 = 0; n0 < kN; n0 += 16) {
        if (n0 >= N) break;
        const int n = n0 + 4 * tq;
        const bool nok = n < N;
        uint32_t ah[2][4], al[2][4];
        split_a(ok0 && nok ? ld4(c0 + n) : zero, ok1 && nok ? ld4(c1 + n) : zero, ah, al);
#pragma unroll
        for (int nt = 0; nt < kPB / 8; ++nt) {
          const int o = swz<kN>(8 * nt + g, n);
          const float4 sh = ld4(sth + o);
          const float4 sr = ld4(str + o);
          const uint32_t bh0[2] = {__float_as_uint(sh.x), __float_as_uint(sh.y)};
          const uint32_t bl0[2] = {__float_as_uint(sr.x), __float_as_uint(sr.y)};
          const uint32_t bh1[2] = {__float_as_uint(sh.z), __float_as_uint(sh.w)};
          const uint32_t bl1[2] = {__float_as_uint(sr.z), __float_as_uint(sr.w)};
          mma_3x(acc[nt], ah[0], al[0], bh0, bl0);
          mma_3x(acc[nt], ah[1], al[1], bh1, bl1);
        }
      }
      const float e0 = expf(cs[tr0]);
      const float e1 = expf(cs[tr0 + 8]);
#pragma unroll
      for (int nt = 0; nt < kPB / 8; ++nt) {
        acc[nt][0] *= e0;
        acc[nt][1] *= e0;
        acc[nt][2] *= e1;
        acc[nt][3] *= e1;
      }
    }
    {  // sum_s W[t, s] x_s over the 16-column blocks of s at or below the rows
      const float ct0 = cs[tr0];
      const float ct1 = cs[tr0 + 8];
      const float* g0r = G + (((size_t)b * n_chunks + c) * kC + tr0) * kC;
      const float* g1r = g0r + 8 * kC;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (j > warp) break;
        const int s = 16 * j + 4 * tq;
        const float4 ga = ld4(g0r + s);
        const float4 gb = ld4(g1r + s);
        const float4 cv = ld4(cs + s);
        const float4 dv = ld4(dts + s);
        float wa[4], wb[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          wa[e] = s + e <= tr0 ? at(ga, e) * ex2((ct0 - at(cv, e)) * kLog2e) * at(dv, e) : 0.f;
          wb[e] = s + e <= tr0 + 8 ? at(gb, e) * ex2((ct1 - at(cv, e)) * kLog2e) * at(dv, e) : 0.f;
        }
        uint32_t ah[2][4], al[2][4];
        split_a(make_float4(wa[0], wa[1], wa[2], wa[3]), make_float4(wb[0], wb[1], wb[2], wb[3]),
                ah, al);
#pragma unroll
        for (int nt = 0; nt < kPB / 8; ++nt) {
          const float4 xv = ld4(xt + swz<kC>(8 * nt + g, s));
          uint32_t bh[2][2], bl[2][2];
#pragma unroll
          for (int e = 0; e < 4; ++e) split_tf32(at(xv, e), bh[e / 2][e % 2], bl[e / 2][e % 2]);
          mma_3x(acc[nt], ah[0], al[0], bh[0], bl[0]);
          mma_3x(acc[nt], ah[1], al[1], bh[1], bl[1]);
        }
      }
    }
#pragma unroll
    for (int nt = 0; nt < kPB / 8; ++nt) {
      const int p = pb + 8 * nt + 2 * tq;
      if (p >= P) continue;
      float* yr = y + (((size_t)b * T + t0 + tr0) * H + h) * P + p;
      if (ok0) *reinterpret_cast<float2*>(yr) = make_float2(acc[nt][0], acc[nt][1]);
      if (ok1)
        *reinterpret_cast<float2*>(yr + (size_t)8 * H * P) = make_float2(acc[nt][2], acc[nt][3]);
    }

    // ---- the state (not after the last chunk): exp(cs_last) state + (x w)^T B.
    // Warp w's part, rows p = 16 mt + g (+ 8) and columns 32 w + 8 tq + 4 e + u
    // (accumulator column 2 tq + e of n-tile u), is read from shared memory,
    // updated in registers and, after the barrier, written back.
    float st[2][4][4];
    if (!last) {
      const float decay = expf(cs_last);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int o = swz<kN>(16 * mt + g + 8 * hh, 32 * warp + 8 * tq + 4 * e);
            const float4 sh = c > 0 ? ld4(sth + o) : zero;
            const float4 sr = c > 0 ? ld4(str + o) : zero;
#pragma unroll
            for (int u = 0; u < 4; ++u)
              st[mt][u][2 * hh + e] = (at(sh, u) + at(sr, u)) * decay;
          }
        }
      }
      const float* brow = Bm + ((size_t)b * T + t0) * N + nb;
      const bool bok = nb < N;
#pragma unroll
      for (int s0 = 0; s0 < kC; s0 += 16) {
        const int s = s0 + 4 * tq;
        const float4 wv = ld4(wds + s);
#pragma unroll
        for (int k = 0; k < 2; ++k) {  // rows s + 2 k and s + 2 k + 1
          const int sk = s + 2 * k;
          const float4 b0 = bok && sk < len ? ld4(brow + (size_t)sk * N) : zero;
          const float4 b1 = bok && sk + 1 < len ? ld4(brow + (size_t)(sk + 1) * N) : zero;
          uint32_t bh[4][2], bl[4][2];  // [n-tile u][row]
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            split_tf32(at(b0, u), bh[u][0], bl[u][0]);
            split_tf32(at(b1, u), bh[u][1], bl[u][1]);
          }
          const float w0 = at(wv, 2 * k);
          const float w1 = at(wv, 2 * k + 1);
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            const float2 xa = *reinterpret_cast<const float2*>(xt + swz<kC>(16 * mt + g, sk));
            const float2 xb = *reinterpret_cast<const float2*>(xt + swz<kC>(16 * mt + g + 8, sk));
            uint32_t ah[4], al[4];
            split_tf32(xa.x * w0, ah[0], al[0]);
            split_tf32(xb.x * w0, ah[1], al[1]);
            split_tf32(xa.y * w1, ah[2], al[2]);
            split_tf32(xb.y * w1, ah[3], al[3]);
#pragma unroll
            for (int u = 0; u < 4; ++u) mma_3x(st[mt][u], ah, al, bh[u], bl[u]);
          }
        }
      }
    }
    __syncthreads();  // every read of the old state, x, cs, dt and w is done
    if (!last) {  // the new state into shared memory as hi + rest
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int o = swz<kN>(16 * mt + g + 8 * hh, 32 * warp + 8 * tq + 4 * e);
            float hi[4], rest[4];
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              hi[u] = tf32(st[mt][u][2 * hh + e]);
              rest[u] = st[mt][u][2 * hh + e] - hi[u];
            }
            *reinterpret_cast<float4*>(sth + o) = make_float4(hi[0], hi[1], hi[2], hi[3]);
            *reinterpret_cast<float4*>(str + o) = make_float4(rest[0], rest[1], rest[2], rest[3]);
          }
        }
      }
    }
  }
}

}  // namespace

// y (B, T, H, P) = the SSD scan of x (B, T, H, P), dt (B, T, H), A (H,),
// B and C (B, T, N) from a zero state; all f32, contiguous and 16-byte
// aligned, P <= 64 and N <= 128 multiples of 4. G is scratch of
// B x ceil(T / 64) x 64 x 64 floats. Two launches on `stream`; returns
// cudaGetLastError() (0 = launched), or cudaErrorInvalidValue for shapes the
// kernel does not take.
extern "C" int ssd_scan_launch(const void* x, const void* dt, const void* A, const void* Bm,
                               const void* Cm, void* y, void* G, int B, int T, int H, int P,
                               int N, void* stream) {
  if (B <= 0 || T <= 0 || H <= 0) return 0;
  if (P <= 0 || P > kP || P % 4 || N <= 0 || N > kN || N % 4)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_chunks = (T + kC - 1) / kC;
  const int n_slices = (P + kPB - 1) / kPB;
  ssd_kernel_gram<<<2 * B * n_chunks, kThreads, 0, s>>>(static_cast<const float*>(Bm),
                                                     static_cast<const float*>(Cm),
                                                     static_cast<float*>(G), T, N, n_chunks);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t bytes = kSmemFloats * sizeof(float);
  err = cudaFuncSetAttribute(ssd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_kernel<<<B * H * n_slices, kThreads, bytes, s>>>(
      static_cast<const float*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const float*>(Bm),
      static_cast<const float*>(Cm), static_cast<const float*>(G), static_cast<float*>(y), T,
      H, P, N, n_chunks, n_slices);
  return static_cast<int>(cudaGetLastError());
}
