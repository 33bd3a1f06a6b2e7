// Hand-written Hopper (sm_90a) kernels for the three weight matmuls of the
// NestQuant serving path, one templated body instantiated for 1..4 packed
// word streams:
//
//   nq_packed_matmul  replaces repro/kernels/packed_matmul/kernel.py:48
//                     packed_matmul (rung 0: the base stream alone)
//   nq_nested_matmul  replaces repro/kernels/nested_matmul/kernel.py:61
//                     nested_matmul (rung 1: base + one delta, dual stream)
//   nq_ladder_matmul  replaces repro/kernels/nested_matmul/kernel.py:125
//                     ladder_matmul (rungs >= 2: base + 2..3 deltas)
//
// What it computes: y[M, N] = (x[M, K] @ W[K, N]) * scale[N], where W holds
// the INT codes chain-recomposed from the block-packed streams
// (repro/core/decompose.py chain_recompose: codes = clip(codes * 2^gap +
// delta) per level), each code cast to x's dtype before the product as the
// TPU kernel does, products summed in f32, the scale applied once in the
// epilogue.  f32 inputs use plain IEEE f32 FMAs (no TF32 anywhere).
//
// What bounds it: at decode (M = 1..8) every packed weight word is read
// once for 2*M flops per weight, far below the card's ~295 flop/byte
// ridge, so the bound is the bytes of the packed words: 4 / 7 / 10 bits per
// weight at rungs 0 / 1 / 2 of an (8, 6, 4) ladder.  The design:
//   * the 32 lanes of a warp own 32 neighbouring output columns, so each
//     word-row load is one coalesced 128-byte line, and each word is loaded
//     once per CTA and yields 32 / w codes;
//   * words are unpacked BY INDEX - element p of pack block b sits in row
//     b * rows_pb + off_c + p mod R_c at bit (p div R_c) * w_c - in uint32
//     arithmetic, so nothing depends on the TPU's tile shapes.  The CTA
//     walks the word rows r of the widest component; every narrower
//     component's word for the same elements is its row r mod R_c;
//   * the x tile of one pack block (8 rows x block) is staged in shared
//     memory as f32 and read as a warp-wide broadcast;
//   * one CTA per (32 columns, 8 rows, pack block): split-K over pack
//     blocks puts enough CTAs on the 132 SMs at decode shapes.  Partial
//     sums go to an f32 workspace and a second pass adds them in a fixed
//     order (deterministic), applies the scale and casts;
//   * CUDA-core FMAs, no tensor cores and no TMA yet: a simple kernel that
//     is right comes first.
//
// Limits (the Python wrappers check them first): 1..4 streams, every
// bitwidth <= 16, pack block a multiple of 32 and <= 512.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxStreams = 4;
constexpr int kMaxComps = 4;  // a <= 16-bit field splits into <= 4 parts
constexpr int kBN = 32;       // output columns per CTA: one per lane
constexpr int kWarps = 8;     // warps per CTA, splitting the word rows
constexpr int kBM = 8;        // activation rows per CTA
constexpr int kMaxBlock = 512;
constexpr int kThreads = kWarps * 32;
static_assert(kWarps == kBM, "the epilogue maps one warp to one output row");

struct Stream {
  const uint32_t* words;
  int rows_pb;          // word rows one pack block of this stream holds
  int code_bits;        // width of the stream's codes
  int ncomp;            // power-of-two components, widest first
  int w[kMaxComps];     // component widths
  int R[kMaxComps];     // word rows of each component within a block
  int off[kMaxComps];   // first row of each component within a block
  int q[kMaxComps];     // rmax / R[c]
};

struct Args {
  const void* x;
  void* out;
  const float* scale;
  float* partial;       // (nk, M, N) f32 split-K partial sums (nk > 1)
  int M, N, K, block, nk;
  int rmax;             // word rows of the widest component in a block
  int slots;            // block / rmax: codes per word of that component
  int out_f32;
  Stream s[kMaxStreams];
  int gap[kMaxStreams];  // level i >= 1: codes = clip(codes * 2^gap + delta)
  int lo[kMaxStreams];
  int hi[kMaxStreams];
};

__device__ __forceinline__ float load_x(const float* x, size_t i) { return x[i]; }
__device__ __forceinline__ float load_x(const __nv_bfloat16* x, size_t i) {
  return __bfloat162float(x[i]);
}

// The code cast to x's dtype (codes.astype(x.dtype) in the TPU kernel):
// exact up to 8 bits in bf16, rounded to nearest even above.
__device__ __forceinline__ float code_as(int c, const float*) {
  return static_cast<float>(c);
}
__device__ __forceinline__ float code_as(int c, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(static_cast<float>(c)));
}

__device__ __forceinline__ void store_out(const Args& a, int m, int n, float v) {
  const size_t i = static_cast<size_t>(m) * a.N + n;
  if (a.out_f32) {
    static_cast<float*>(a.out)[i] = v;
  } else {
    static_cast<__nv_bfloat16*>(a.out)[i] = __float2bfloat16_rn(v);
  }
}

template <int NS, typename T>
__global__ void __launch_bounds__(kThreads) stream_matmul(const Args a) {
  __shared__ float xs[kBM][kMaxBlock];
  __shared__ float red[kWarps][kBM][kBN];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n = blockIdx.x * kBN + lane;
  const int m0 = blockIdx.y * kBM;
  const int kb = blockIdx.z;
  const T* x = static_cast<const T*>(a.x);

  // stage this pack block's x tile; ragged M rows and a ragged K tail are 0
  const size_t k0 = static_cast<size_t>(kb) * a.block;
  for (int i = threadIdx.x; i < kBM * a.block; i += kThreads) {
    const int m = i / a.block;
    const int p = i - m * a.block;
    float v = 0.f;
    if (m0 + m < a.M && k0 + p < static_cast<size_t>(a.K)) {
      v = load_x(x, static_cast<size_t>(m0 + m) * a.K + k0 + p);
    }
    xs[m][p] = v;
  }
  __syncthreads();

  float acc[kBM];
#pragma unroll
  for (int m = 0; m < kBM; ++m) acc[m] = 0.f;

  if (n < a.N) {
    for (int r = warp; r < a.rmax; r += kWarps) {
      uint32_t wd[NS][kMaxComps];
      int sub[NS][kMaxComps];
#pragma unroll
      for (int s = 0; s < NS; ++s) {
#pragma unroll
        for (int c = 0; c < kMaxComps; ++c) {
          wd[s][c] = 0u;
          sub[s][c] = 0;
          if (c < a.s[s].ncomp) {
            const int R = a.s[s].R[c];
            const size_t row = static_cast<size_t>(kb) * a.s[s].rows_pb +
                               a.s[s].off[c] + (r % R);
            wd[s][c] = __ldg(a.s[s].words + row * a.N + n);
            sub[s][c] = r / R;
          }
        }
      }
      for (int j = 0; j < a.slots; ++j) {
        int code = 0;
#pragma unroll
        for (int s = 0; s < NS; ++s) {
          uint32_t u = 0u;
          int cs = 0;
#pragma unroll
          for (int c = 0; c < kMaxComps; ++c) {
            if (c < a.s[s].ncomp) {
              const int w = a.s[s].w[c];
              const int slot = j * a.s[s].q[c] + sub[s][c];
              u |= ((wd[s][c] >> (slot * w)) & ((1u << w) - 1u)) << cs;
              cs += w;
            }
          }
          const int bits = a.s[s].code_bits;
          int v = static_cast<int>(u);
          if (v >= (1 << (bits - 1))) v -= (1 << bits);
          code = (s == 0) ? v : min(max(code * (1 << a.gap[s]) + v, a.lo[s]), a.hi[s]);
        }
        const float cf = code_as(code, x);
        const float* xp = &xs[0][j * a.rmax + r];
#pragma unroll
        for (int m = 0; m < kBM; ++m) acc[m] = fmaf(cf, xp[m * kMaxBlock], acc[m]);
      }
    }
  }

#pragma unroll
  for (int m = 0; m < kBM; ++m) red[warp][m][lane] = acc[m];
  __syncthreads();
  const int m = warp;
  if (m0 + m < a.M && n < a.N) {
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) sum += red[w][m][lane];
    if (a.nk == 1) {
      store_out(a, m0 + m, n, sum * a.scale[n]);
    } else {
      a.partial[(static_cast<size_t>(kb) * a.M + m0 + m) * a.N + n] = sum;
    }
  }
}

// Second pass of the split-K: add the pack blocks' partial sums in order,
// scale once, cast.
__global__ void reduce_partials(const Args a) {
  const size_t mn = static_cast<size_t>(a.M) * a.N;
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= mn) return;
  float sum = 0.f;
  for (int kb = 0; kb < a.nk; ++kb) sum += a.partial[static_cast<size_t>(kb) * mn + i];
  const int n = static_cast<int>(i % a.N);
  store_out(a, static_cast<int>(i / a.N), n, sum * a.scale[n]);
}

int split_components(int k, int* w) {
  int n = 0;
  for (int i = 4; i >= 0; --i) {
    if ((k >> i) & 1) w[n++] = 1 << i;
  }
  return n;
}

template <int NS>
void launch_body(const Args& a, int x_bf16, dim3 grid, cudaStream_t stream) {
  if (x_bf16) {
    stream_matmul<NS, __nv_bfloat16><<<grid, kThreads, 0, stream>>>(a);
  } else {
    stream_matmul<NS, float><<<grid, kThreads, 0, stream>>>(a);
  }
}

// bits: ascending ladder bitwidths of the resident streams (one per
// stream).  Stream 0 holds bits[0]-bit codes, stream i the
// (bits[i] - bits[i-1] + 1)-bit compensated delta of level i.
int launch(const void* x, int x_bf16, const void* const* words, const int* bits,
           int ns, const void* scale, void* out, int out_f32, void* partial,
           int M, int N, int K, int block, cudaStream_t stream) {
  if (ns < 1 || ns > kMaxStreams || M < 1 || N < 1 || K < 1 || block < 32 ||
      block > kMaxBlock || block % 32 != 0 || bits[0] < 1 || bits[ns - 1] > 16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args a = {};
  a.x = x;
  a.out = out;
  a.scale = static_cast<const float*>(scale);
  a.partial = static_cast<float*>(partial);
  a.M = M;
  a.N = N;
  a.K = K;
  a.block = block;
  a.nk = (K + block - 1) / block;
  a.out_f32 = out_f32;
  int wmax = 1;
  for (int s = 0; s < ns; ++s) {
    if (s > 0 && bits[s] <= bits[s - 1]) return static_cast<int>(cudaErrorInvalidValue);
    Stream& st = a.s[s];
    st.words = static_cast<const uint32_t*>(words[s]);
    st.code_bits = (s == 0) ? bits[0] : bits[s] - bits[s - 1] + 1;
    st.ncomp = split_components(st.code_bits, st.w);
    int off = 0;
    for (int c = 0; c < st.ncomp; ++c) {
      st.R[c] = block * st.w[c] / 32;
      st.off[c] = off;
      off += st.R[c];
      if (st.w[c] > wmax) wmax = st.w[c];
    }
    st.rows_pb = off;
    if (s > 0) {
      a.gap[s] = bits[s] - bits[s - 1];
      a.lo[s] = -(1 << (bits[s] - 1));
      a.hi[s] = (1 << (bits[s] - 1)) - 1;
    }
  }
  a.rmax = block * wmax / 32;
  a.slots = 32 / wmax;
  for (int s = 0; s < ns; ++s) {
    for (int c = 0; c < a.s[s].ncomp; ++c) a.s[s].q[c] = a.rmax / a.s[s].R[c];
  }
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM, a.nk);
  if (grid.y > 65535 || grid.z > 65535 || (a.nk > 1 && partial == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  switch (ns) {
    case 1: launch_body<1>(a, x_bf16, grid, stream); break;
    case 2: launch_body<2>(a, x_bf16, grid, stream); break;
    case 3: launch_body<3>(a, x_bf16, grid, stream); break;
    default: launch_body<4>(a, x_bf16, grid, stream); break;
  }
  if (a.nk > 1) {
    const size_t mn = static_cast<size_t>(M) * N;
    const unsigned nblk = static_cast<unsigned>((mn + 255) / 256);
    reduce_partials<<<nblk, 256, 0, stream>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// K1: rung 0, the k-bit base stream alone.
int nq_packed_matmul(const void* x, int x_bf16, const void* words, int k,
                     const void* scale, void* out, int out_f32, void* partial,
                     int M, int N, int K, int block, void* stream) {
  const void* streams[1] = {words};
  const int bits[1] = {k};
  return launch(x, x_bf16, streams, bits, 1, scale, out, out_f32, partial, M, N,
                K, block, static_cast<cudaStream_t>(stream));
}

// K2: rung 1, the h-bit base and the (n - h + 1)-bit delta.
int nq_nested_matmul(const void* x, int x_bf16, const void* words_high,
                     const void* words_low, int n, int h, const void* scale,
                     void* out, int out_f32, void* partial, int M, int N, int K,
                     int block, void* stream) {
  const void* streams[2] = {words_high, words_low};
  const int bits[2] = {h, n};
  return launch(x, x_bf16, streams, bits, 2, scale, out, out_f32, partial, M, N,
                K, block, static_cast<cudaStream_t>(stream));
}

// K3: rungs >= 2, the base and every resident delta (2..4 streams here;
// the 2-stream case is accepted too and computes what K2 does).
int nq_ladder_matmul(const void* x, int x_bf16, const void* const* streams,
                     const int* bits, int nstreams, const void* scale, void* out,
                     int out_f32, void* partial, int M, int N, int K, int block,
                     void* stream) {
  return launch(x, x_bf16, streams, bits, nstreams, scale, out, out_f32, partial,
                M, N, K, block, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
