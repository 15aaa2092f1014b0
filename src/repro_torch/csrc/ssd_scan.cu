// Mamba2 SSD chunked scan (state-space duality), forward, f32, on Hopper.
//
// For every sequence b and head h (ngroups = 1: B and C are shared by the
// heads), with ga_t = A_h dt_{t,h} and cs its inclusive cumulative sum over
// the chunk, chunk by chunk in order:
//
//   W[t, s] = s <= t ? exp(cs_t - cs_s) (C_t . B_s) : 0
//   y_t     = sum_s W[t, s] dt_s x_s + exp(cs_t) (state C_t)
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
// one launch covers every (b, h) of the model's own time-major layout
// (x (B, T, H, P), dt (B, T, H), B and C (B, T, N)): a block owns one
// (b, h) and walks its chunks in a loop, with the state in shared memory.
// The kernel forms ga and the cumulative sum itself (a warp scan), picks
// its own chunk (kC = 64 rows), and masks a ragged last chunk: its missing
// rows are staged as zeros, so they decay nothing and add nothing. Every
// decay is exp of a difference of cumulative sums, exp(cs_t - cs_s) and
// exp(cs_last - cs_s), never exp(cs_t) exp(-cs_s), which would overflow
// f32 for a long chunk or a large |A|; the masked (s > t) entries are a
// select, never a product with the mask (there exp may be inf). exp is
// expf (no fast math).
//
// What bounds it: operations. Per (b, chunk) of 64 rows the function needs
// the causal lower triangle of the Gram matrix C B^T once (c (c + 1) N)
// and, per head, the intra-chunk product over the same triangle
// (c (c + 1) P), the inter-chunk product (2 c N P, not in the first chunk,
// where the state is 0) and the state update (2 c P N, not after the last
// chunk); at Mamba2-2.7B's prefill (B 4, T 2048, H 80, P 64, N 128) that
// is ~23.6 GFLOP a launch against ~350 MB of inputs and output, so ~0.35 ms
// at 67 TFLOP/s (f32 outside the tensor cores) against ~0.10 ms of bytes.
// This kernel does every product in f32 on the FMA units (TF32 or
// bf16 tensor cores would not hold the f32 oracle's tolerance), forms the
// Gram matrix once per head and not once per (b, chunk) (80x the minimal
// count of that term), whole: the half above the diagonal is computed and
// masked away. The intra-chunk product stops at each warp's last row.
//
// Design: 256 threads, one block per (b, h), 139,008 bytes of dynamic
// shared memory (one block an SM): the state transposed, St[n][p]; the
// chunk's C and B transposed, Ct[n][t] and Bt[n][s]; x as Xs[s][p]; the
// masked Gram matrix transposed, with dt_s folded in, Wt[s][t] =
// W[t, s] dt_s; cs, dt and exp(cs_last - cs_s) dt_s. Rows are padded to 68
// floats, so float4 reads of 16 neighbouring threads on 16 neighbouring
// rows hit distinct banks. P <= 64 and N <= 128 (both multiples of 4) are
// staged zero-padded to 64 and 128, and the products run over the padded
// widths with fixed trip counts (padded state columns stay 0; padded
// output columns are not stored). Each of the three products gives a
// thread a 4 x 4 (Gram, y) or 8 x 4 (state) register tile, read as float4
// columns of the transposed operands. The next chunk's x, dt, B and C are
// loaded into registers while the current chunk computes (16-byte loads:
// B and C by pairs of threads over one 32-byte sector of a row, stored
// transposed without bank conflicts), so the loads' latency hides behind
// the products.

#include <cuda_runtime.h>

namespace {

constexpr int kC = 64;   // chunk rows
constexpr int kP = 64;   // largest head dim
constexpr int kN = 128;  // largest state dim
constexpr int kThreads = 256;
constexpr int kLd = 68;  // padded row of Ct, Bt, Wt (kC + 4) and St (kP + 4)
static_assert(kC + 4 == kLd && kP + 4 == kLd, "one padded row length");
constexpr int kBC4 = kC * kN / 4 / kThreads;  // float4s of B (and of C) a thread
constexpr int kX4 = kC * kP / 4 / kThreads;   // float4s of x a thread

constexpr size_t kSmemFloats =
    3 * (size_t)kN * kLd + (size_t)kC * kP + (size_t)kC * kLd + 3 * kC;

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// One chunk's inputs, held in registers between their load and their
// store to shared memory.
struct Staged {
  float4 b[kBC4], c[kBC4], x[kX4];
  float dt[2];  // rows 2*lane, 2*lane + 1 (warp 0 only)
};

// B and C: float4 f = tid + 256 i covers row t = (f / 2) % 64 and columns
// 4 n4.. with n4 = 2 ((f / 2) / 64) + f % 2. x: row f / 16, columns
// 4 (f % 16)... Rows at or past len, and columns past N or P, are 0.
__device__ __forceinline__ void load_chunk(Staged& st, const float* __restrict__ x,
                                           const float* __restrict__ dt,
                                           const float* __restrict__ Bm,
                                           const float* __restrict__ Cm, int b, int h,
                                           int T, int H, int P, int N, int t0, int len) {
  const int tid = threadIdx.x;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
  for (int i = 0; i < kBC4; ++i) {
    const int f = tid + kThreads * i;
    const int t = (f >> 1) % kC;
    const int n = 4 * (2 * ((f >> 1) / kC) + (f & 1));
    const bool ok = t < len && n < N;
    const size_t off = ((size_t)b * T + t0 + t) * N + n;
    st.b[i] = ok ? ld4(Bm + off) : zero;
    st.c[i] = ok ? ld4(Cm + off) : zero;
  }
#pragma unroll
  for (int i = 0; i < kX4; ++i) {
    const int f = tid + kThreads * i;
    const int s = f / (kP / 4);
    const int p = 4 * (f % (kP / 4));
    st.x[i] = (s < len && p < P) ? ld4(x + (((size_t)b * T + t0 + s) * H + h) * P + p) : zero;
  }
  if (tid < 32) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = 2 * tid + r;
      st.dt[r] = row < len ? dt[((size_t)b * T + t0 + row) * H + h] : 0.f;
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1)
ssd_kernel(const float* __restrict__ x, const float* __restrict__ dt,
           const float* __restrict__ A, const float* __restrict__ Bm,
           const float* __restrict__ Cm, float* __restrict__ y, int T, int H, int P,
           int N) {
  extern __shared__ __align__(16) float smem[];
  float* St = smem;               // [kN][kLd], St[n][p]
  float* Ct = St + kN * kLd;      // [kN][kLd], Ct[n][t]
  float* Bt = Ct + kN * kLd;      // [kN][kLd], Bt[n][s]
  float* Xs = Bt + kN * kLd;      // [kC][kP],  x[s][p]
  float* Wt = Xs + kC * kP;       // [kC][kLd], Wt[s][t] = W[t, s] dt_s
  float* cs = Wt + kC * kLd;      // [kC]
  float* dts = cs + kC;           // [kC]
  float* wdec = dts + kC;         // [kC], exp(cs_last - cs_s) dt_s

  const int tid = threadIdx.x;
  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const float a_h = A[h];
  const int ty = tid / 16;  // Gram and y: rows ty*4..; state: p = ty*4..
  const int tx = tid % 16;  // Gram: s = tx*4..; y: p = tx*4..; state: n = tx + 16k

  for (int e = tid; e < kN * kLd; e += kThreads) St[e] = 0.f;

  Staged st;
  load_chunk(st, x, dt, Bm, Cm, b, h, T, H, P, N, 0, min(kC, T));

  for (int t0 = 0; t0 < T; t0 += kC) {
    const int len = min(kC, T - t0);
    __syncthreads();  // the previous chunk is consumed

    // ---- store the staged chunk; cs by warp scan (two rows a lane)
#pragma unroll
    for (int i = 0; i < kBC4; ++i) {
      const int f = tid + kThreads * i;
      const int t = (f >> 1) % kC;
      const int n = 4 * (2 * ((f >> 1) / kC) + (f & 1));
      Bt[(n + 0) * kLd + t] = st.b[i].x;
      Bt[(n + 1) * kLd + t] = st.b[i].y;
      Bt[(n + 2) * kLd + t] = st.b[i].z;
      Bt[(n + 3) * kLd + t] = st.b[i].w;
      Ct[(n + 0) * kLd + t] = st.c[i].x;
      Ct[(n + 1) * kLd + t] = st.c[i].y;
      Ct[(n + 2) * kLd + t] = st.c[i].z;
      Ct[(n + 3) * kLd + t] = st.c[i].w;
    }
#pragma unroll
    for (int i = 0; i < kX4; ++i) {
      *reinterpret_cast<float4*>(&Xs[4 * (tid + kThreads * i)]) = st.x[i];
    }
    if (tid < 32) {
      const float g0 = a_h * st.dt[0];
      const float pair = g0 + a_h * st.dt[1];
      float incl = pair;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float up = __shfl_up_sync(0xffffffffu, incl, off);
        if (tid >= off) incl += up;
      }
      const float excl = incl - pair;
      cs[2 * tid] = excl + g0;
      cs[2 * tid + 1] = excl + pair;
      dts[2 * tid] = st.dt[0];
      dts[2 * tid + 1] = st.dt[1];
    }
    __syncthreads();

    // the next chunk's loads fly while this one computes
    if (t0 + kC < T) load_chunk(st, x, dt, Bm, Cm, b, h, T, H, P, N, t0 + kC,
                                min(kC, T - t0 - kC));

    // ---- the decay-masked Gram matrix times dt_s, Wt[s][t], and wdec
    if (tid < kC) wdec[tid] = expf(cs[kC - 1] - cs[tid]) * dts[tid];
    {
      float acc[4][4] = {};
#pragma unroll 8
      for (int n = 0; n < kN; ++n) {
        const float4 c4 = ld4(&Ct[n * kLd + ty * 4]);
        const float4 b4 = ld4(&Bt[n * kLd + tx * 4]);
        const float cv[4] = {c4.x, c4.y, c4.z, c4.w};
        const float bv[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(cv[i], bv[j], acc[i][j]);
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int s = tx * 4 + j;
        const float d = dts[s];
        float w[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int t = ty * 4 + i;
          w[i] = s <= t ? expf(cs[t] - cs[s]) * acc[i][j] * d : 0.f;
        }
        *reinterpret_cast<float4*>(&Wt[s * kLd + ty * 4]) = make_float4(w[0], w[1], w[2], w[3]);
      }
    }
    __syncthreads();

    // ---- y: rows ty*4.., columns tx*4..
    {
      float acc[4][4] = {};   // sum_s W[t, s] dt_s x_s
      float accs[4][4] = {};  // C_t . state
      const int s_end = min(ty * 4 + 4, len);
#pragma unroll 4
      for (int s = 0; s < s_end; ++s) {
        const float4 w4 = ld4(&Wt[s * kLd + ty * 4]);
        const float4 x4 = ld4(&Xs[s * kP + tx * 4]);
        const float wv[4] = {w4.x, w4.y, w4.z, w4.w};
        const float xv[4] = {x4.x, x4.y, x4.z, x4.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(wv[i], xv[j], acc[i][j]);
        }
      }
      if (t0 > 0) {  // the state is 0 before the first chunk
#pragma unroll 8
        for (int n = 0; n < kN; ++n) {
          const float4 c4 = ld4(&Ct[n * kLd + ty * 4]);
          const float4 s4 = ld4(&St[n * kLd + tx * 4]);
          const float cv[4] = {c4.x, c4.y, c4.z, c4.w};
          const float sv[4] = {s4.x, s4.y, s4.z, s4.w};
#pragma unroll
          for (int i = 0; i < 4; ++i) {
#pragma unroll
            for (int j = 0; j < 4; ++j) accs[i][j] = fmaf(cv[i], sv[j], accs[i][j]);
          }
        }
      }
      const int p0 = tx * 4;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = ty * 4 + i;
        if (t >= len || p0 >= P) continue;
        const float ecs = expf(cs[t]);
        *reinterpret_cast<float4*>(y + (((size_t)b * T + t0 + t) * H + h) * P + p0) =
            make_float4(acc[i][0] + ecs * accs[i][0], acc[i][1] + ecs * accs[i][1],
                        acc[i][2] + ecs * accs[i][2], acc[i][3] + ecs * accs[i][3]);
      }
    }
    __syncthreads();  // every read of the old state is done

    // ---- state: St[n][p] for p = ty*4.., n = tx + 16k
    {
      float acc[8][4] = {};
      const int s_end = (len + 3) & ~3;  // staged rows past len are 0
      for (int s = 0; s < s_end; s += 4) {
        const float4 d4 = ld4(&wdec[s]);
        const float dv[4] = {d4.x, d4.y, d4.z, d4.w};
        float xw[4][4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float4 x4 = ld4(&Xs[(s + q) * kP + ty * 4]);
          xw[q][0] = dv[q] * x4.x;
          xw[q][1] = dv[q] * x4.y;
          xw[q][2] = dv[q] * x4.z;
          xw[q][3] = dv[q] * x4.w;
        }
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const float4 b4 = ld4(&Bt[(tx + 16 * k) * kLd + s]);
          const float bv[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
          for (int q = 0; q < 4; ++q) {
#pragma unroll
            for (int i = 0; i < 4; ++i) acc[k][i] = fmaf(bv[q], xw[q][i], acc[k][i]);
          }
        }
      }
      const float decay = expf(cs[kC - 1]);
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        float* row = &St[(tx + 16 * k) * kLd + ty * 4];
        const float4 old = ld4(row);
        *reinterpret_cast<float4*>(row) =
            make_float4(fmaf(decay, old.x, acc[k][0]), fmaf(decay, old.y, acc[k][1]),
                        fmaf(decay, old.z, acc[k][2]), fmaf(decay, old.w, acc[k][3]));
      }
    }
  }
}

}  // namespace

// y (B, T, H, P) = the SSD scan of x (B, T, H, P), dt (B, T, H), A (H,),
// B and C (B, T, N) from a zero state; all f32, contiguous and 16-byte
// aligned, P <= 64 and N <= 128 multiples of 4. Launch on `stream`; returns
// cudaGetLastError() (0 = launched), or cudaErrorInvalidValue for shapes
// the kernel does not take.
extern "C" int ssd_scan_launch(const void* x, const void* dt, const void* A, const void* Bm,
                               const void* Cm, void* y, int B, int T, int H, int P, int N,
                               void* stream) {
  if (B <= 0 || T <= 0 || H <= 0) return 0;
  if (P <= 0 || P > kP || P % 4 || N <= 0 || N > kN || N % 4)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes = kSmemFloats * sizeof(float);
  cudaError_t err =
      cudaFuncSetAttribute(ssd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_kernel<<<B * H, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const float*>(Bm),
      static_cast<const float*>(Cm), static_cast<float*>(y), T, H, P, N);
  return static_cast<int>(cudaGetLastError());
}
