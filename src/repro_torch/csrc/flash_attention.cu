// Forward attention with an online softmax (FlashAttention-style), for f32
// and bf16 inputs on Hopper, with f32 arithmetic throughout.
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
// kBQ query rows of one (b, h), reads kv head h / (H / Hkv) in place (no
// copy), and masks ragged rows and keys itself, so no caller pads. The TPU
// ran the kv axis as a sequential grid axis with the running max,
// denominator and accumulator in VMEM scratch; here that axis is a loop
// inside the block, and the running state lives in registers. As in
// _flash_kernel: masked scores are -1e30 and masked probabilities 0 (a row
// with no valid key gives 0, not NaN), kv tiles wholly outside the causal
// and window band are never loaded (the loop bounds skip them), and the
// output is acc / max(l, 1e-30), cast to q's type. exp is expf (no fast
// math), and p stays f32 in the P @ V product.
//
// What bounds it: 4 dh operations a valid (query, key) pair (two products
// of dh multiply-adds) against reading q, k, v and writing o once. At the
// Qwen1.5-0.5B prefill (B 4, H 16, T = S 2048, dh 64, causal) that is
// 34.4 G operations against 134 MB in f32: bound by operations, 0.51 ms at
// 67 TFLOP/s (f32 outside the tensor cores); in bf16 the tensor-core bound
// is 0.035 ms. This first kernel keeps every product in f32 on the FMA
// units (bf16 inputs are widened as they are staged), so it cannot approach
// the bf16 bound; wgmma with bf16 operands is later work.
//
// Design: 256 threads (16 x 16) a block and tiles of kBQ = kBKV = 64. The
// query tile is staged once, transposed, in shared memory; each kv tile is
// staged (k transposed, v as is) in turn. A thread owns a 4 x 4 block of
// the 64 x 64 score tile (rows ty*4.., keys tx*4..), read as two float4s
// of q and k a step of the dot product, and a 4 x dh/16 block of the output
// accumulator (rows ty*4.., columns tx*dh/16..). The 16 threads of a row
// group share its running max and denominator, reduced with shuffles. The
// probabilities go through shared memory, transposed, to the P @ V
// product. dh is a template parameter (32, 64, 80, 128); blocks of the last
// query tiles, which see the most keys under a causal mask, start first.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 64;   // query rows a block
constexpr int kBKV = 64;  // keys a tile
constexpr int kSide = 16;
constexpr int kThreads = kSide * kSide;
constexpr int kPad = 4;  // keeps float4 alignment, spreads transposed rows
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// Rows [r0, r0 + 64) of a row-major (n, DH) matrix into shared memory as
// f32, transposed (dst[d * ld + r]) or not (dst[r * ld + d]); rows at or
// past n are 0. Neighbouring threads read neighbouring elements.
template <typename T, int DH, bool TRANS>
__device__ __forceinline__ void stage(const T* __restrict__ src, int n, int r0,
                                      float* __restrict__ dst, int ld) {
  static_assert(kBQ == kBKV, "one staging shape");
  for (int e = threadIdx.x; e < kBKV * DH; e += kThreads) {
    const int r = e / DH;
    const int d = e % DH;
    const float x = (r0 + r < n) ? to_f(src[(size_t)(r0 + r) * DH + d]) : 0.f;
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

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
             T* __restrict__ o, int H, int Hkv, int n_q, int n_k, int causal, int window,
             int q_offset, float scale) {
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

  stage<T, DH, true>(q, n_q, i0, qt, ldq);

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
    stage<T, DH, true>(k, n_k, j0, kt, ldk);
    stage<T, DH, false>(v, n_k, j0, vs, ldv);
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
    for (int c = 0; c < CT; ++c) store(&o[(size_t)i * DH + tx * CT + c], acc[r][c] / denom);
  }
}

template <typename T, int DH>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B, int H,
                   int Hkv, int n_q, int n_k, int causal, int window, int q_offset,
                   float scale, cudaStream_t s) {
  const size_t bytes = smem_floats<DH>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<T, DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, (n_q + kBQ - 1) / kBQ);
  flash_kernel<T, DH><<<grid, kThreads, bytes, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), H, Hkv, n_q, n_k, causal, window, q_offset, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dh(int dh, const void* q, const void* k, const void* v, void* o, int B,
                      int H, int Hkv, int n_q, int n_k, int causal, int window,
                      int q_offset, float scale, cudaStream_t s) {
  switch (dh) {
    case 32:
      return launch<T, 32>(q, k, v, o, B, H, Hkv, n_q, n_k, causal, window, q_offset, scale, s);
    case 64:
      return launch<T, 64>(q, k, v, o, B, H, Hkv, n_q, n_k, causal, window, q_offset, scale, s);
    case 80:
      return launch<T, 80>(q, k, v, o, B, H, Hkv, n_q, n_k, causal, window, q_offset, scale, s);
    case 128:
      return launch<T, 128>(q, k, v, o, B, H, Hkv, n_q, n_k, causal, window, q_offset, scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// o (B, H, T, dh) = attention of q (B, H, T, dh) over k, v (B, Hkv, S, dh),
// all contiguous and of one type: f32 (dtype 0) or bf16 (dtype 1). dh is
// 32, 64, 80 or 128 and H a multiple of Hkv. Launch on `stream`; returns
// cudaGetLastError() (0 = launched), or cudaErrorInvalidValue for
// arguments the kernel does not take.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* o,
                                      int B, int H, int Hkv, int T, int S, int dh,
                                      int causal, int window, int q_offset, float scale,
                                      int dtype, void* stream) {
  if (B <= 0 || H <= 0 || T <= 0) return 0;
  if (Hkv <= 0 || H % Hkv != 0 || S < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = launch_dh<float>(dh, q, k, v, o, B, H, Hkv, T, S, causal, window, q_offset, scale, s);
  } else if (dtype == 1) {
    err = launch_dh<__nv_bfloat16>(dh, q, k, v, o, B, H, Hkv, T, S, causal, window, q_offset,
                                   scale, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
