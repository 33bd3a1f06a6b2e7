// Hand-written Hopper (sm_90a) kernel for causal GQA attention, forward
// (the long-prefill attention of the serving path):
//
//   nq_flash_attention  replaces repro/kernels/flash_attention/kernel.py:60
//                       flash_attention
//
// What it computes: o[b, s, h, :] = softmax_j(q[b, s, h] . k[b, j, h / G]
// * 1/sqrt(hd), j <= s) @ v[b, :, h / G] for q (B, S, Hq, hd) and k, v
// (B, S, Hkv, hd), G = Hq / Hkv.  The softmax is online (running max m,
// denominator l and accumulator acc, all f32), as the TPU kernel keeps
// them; p is rounded to v's dtype before the PV product (kernel.py:48),
// and o = acc / max(l, 1e-30) is cast to q's dtype.  f32 inputs use plain
// IEEE f32 FMAs (no TF32 anywhere).
//
// What bounds it: 2 * B * Hq * S^2 * hd flops for the causal half (QK^T
// and PV) over (3 + 1) * B * S * H * hd values read and written; at
// S = 2048, hd = 128 that is ~3000 flops per byte, so the bound is the
// tensor cores' bf16 rate.  This first kernel uses CUDA-core FMAs (a
// simple kernel that is right first; wgmma and TMA come later), so it
// runs far from that bound.  The design:
//   * one CTA of 256 threads per (64-row query tile, query head, batch);
//     query head h reads kv head h / G.  Tiles are launched heaviest
//     first (the last query tile has the most key tiles under the
//     diagonal);
//   * the query tile and ONE key-or-value tile of 64 rows live in shared
//     memory as f32, rows padded by one word so the column reads of the
//     score product fall in distinct banks.  K is staged, the 64 x 64
//     score tile computed, then V is staged into the same buffer: ~83 KB
//     of dynamic shared memory at hd = 128, two CTAs per SM;
//   * each thread owns 4 query rows x 4 key columns of the score tile and
//     4 rows x hd/16 output columns of the accumulator; the row max and
//     row sum are reduced over the 16 threads of a row with shuffles;
//   * key tiles wholly above the diagonal are skipped (their masked
//     contribution is exactly 0); within the diagonal tile and past a
//     ragged S the scores are masked to -1e30, whose exp underflows to 0
//     against any unmasked max, and a row with nothing unmasked yet keeps
//     m = -1e30 (exp(0) terms that the first unmasked tile rescales by
//     exp(-1e30 - m) = 0).
//
// Limits (the Python wrapper checks them first): bf16 or f32, q/k/v of
// one dtype, hd <= 128 and a multiple of 8, Hq a multiple of Hkv.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;        // query rows per CTA
constexpr int kBK = 64;        // key rows per tile
constexpr int kThreads = 256;  // 16 row groups x 16 column lanes
constexpr int kMaxHd = 128;
constexpr int kOutCols = kMaxHd / 16;  // accumulator columns per thread
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// p rounded to v's dtype (p.astype(v.dtype) in the TPU kernel)
__device__ __forceinline__ float round_as(float p, const float*) { return p; }
__device__ __forceinline__ float round_as(float p, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(p));
}

__device__ __forceinline__ void store(float* o, size_t i, float v) { o[i] = v; }
__device__ __forceinline__ void store(__nv_bfloat16* o, size_t i, float v) {
  o[i] = __float2bfloat16_rn(v);
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int B, S, Hq, Hkv, hd;
  float scale;
};

// rows [r0, r0 + 64) of one head of a (B, S, H, hd) tensor -> smem (64, hd + 1)
template <typename T>
__device__ __forceinline__ void stage(float* dst, const T* src, int b, int r0, int h,
                                      int H, const Args& a) {
  const int hdp = a.hd + 1;
  for (int i = threadIdx.x; i < kBK * a.hd; i += kThreads) {
    const int r = i / a.hd;
    const int d = i - r * a.hd;
    float val = 0.f;
    if (r0 + r < a.S) {
      val = to_f32(src[((static_cast<size_t>(b) * a.S + r0 + r) * H + h) * a.hd + d]);
    }
    dst[r * hdp + d] = val;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) flash_fwd(const Args a) {
  extern __shared__ float smem[];
  const int hdp = a.hd + 1;
  float* qs = smem;                 // (64, hd + 1) query tile
  float* kv = qs + kBQ * hdp;       // (64, hd + 1) key, then value tile
  float* ps = kv + kBK * hdp;       // (64, 65) probabilities

  const int qt = gridDim.x - 1 - blockIdx.x;   // heaviest tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (a.Hq / a.Hkv);
  const int q0 = qt * kBQ;
  const int ty = threadIdx.x >> 4;  // row group: rows ty * 4 .. + 4
  const int tx = threadIdx.x & 15;  // column lane
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);

  stage(qs, q, b, q0, h, a.Hq, a);

  float m[4], l[4], acc[4][kOutCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < kOutCols; ++j) acc[i][j] = 0.f;
  }

  const int last_q = min(q0 + kBQ, a.S) - 1;
  const int n_tiles = last_q / kBK + 1;  // tiles with a key <= the last query
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();                 // the previous V tile is consumed
    stage(kv, k, b, k0, hk, a.Hkv, a);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int d = 0; d < a.hd; ++d) {
      float qv[4], kvv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = qs[(ty * 4 + i) * hdp + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kvv[j] = kv[(tx + 16 * j) * hdp + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kvv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty * 4 + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        s[i][j] = (kpos <= qpos && kpos < a.S) ? s[i][j] * a.scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float corr = __expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = __expf(s[i][j] - m_new);
        sum += p;
        ps[(ty * 4 + i) * (kBK + 1) + tx + 16 * j] = round_as(p, v);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < kOutCols; ++j) acc[i][j] *= corr;
    }

    __syncthreads();                 // scores read K; now V takes its place
    stage(kv, v, b, k0, hk, a.Hkv, a);
    __syncthreads();

    for (int c = 0; c < kBK; ++c) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = ps[(ty * 4 + i) * (kBK + 1) + c];
#pragma unroll
      for (int j = 0; j < kOutCols; ++j) {
        const int col = tx + 16 * j;
        if (col < a.hd) {
          const float vv = kv[c * hdp + col];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
        }
      }
    }
  }

  T* o = static_cast<T*>(a.o);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q0 + ty * 4 + i;
    if (qpos >= a.S) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < kOutCols; ++j) {
      const int col = tx + 16 * j;
      if (col < a.hd) {
        store(o, ((static_cast<size_t>(b) * a.S + qpos) * a.Hq + h) * a.hd + col,
              acc[i][j] * inv);
      }
    }
  }
}

template <typename T>
int launch_t(const Args& a, cudaStream_t stream) {
  const size_t smem = (2 * static_cast<size_t>(kBQ) * (a.hd + 1) + kBQ * (kBK + 1)) *
                      sizeof(float);
  // opt in to the largest tile once (hd = 128), before any graph capture
  static cudaError_t opt_in = cudaFuncSetAttribute(
      flash_fwd<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>((2 * kBQ * (kMaxHd + 1) + kBQ * (kBK + 1)) * sizeof(float)));
  if (opt_in != cudaSuccess) return static_cast<int>(opt_in);
  const dim3 grid((a.S + kBQ - 1) / kBQ, a.Hq, a.B);
  flash_fwd<T><<<grid, kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// q (B, S, Hq, hd), k/v (B, S, Hkv, hd), o like q; all contiguous, one
// dtype (bf16 when is_bf16, else f32).
int nq_flash_attention(const void* q, const void* k, const void* v, void* o,
                       int is_bf16, int B, int S, int Hq, int Hkv, int hd,
                       float scale, void* stream) {
  if (B < 1 || S < 1 || Hkv < 1 || Hq < Hkv || Hq % Hkv != 0 || hd < 8 ||
      hd > kMaxHd || hd % 8 != 0 || Hq > 65535 || B > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a = {q, k, v, o, B, S, Hq, Hkv, hd, scale};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch_t<__nv_bfloat16>(a, s) : launch_t<float>(a, s);
}

}  // extern "C"
