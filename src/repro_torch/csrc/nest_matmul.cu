// Hand-written Hopper (sm_90a) kernels for the three weight matmuls of the
// NestQuant serving path, two templated bodies (a CUDA-core one and a
// tensor-core one), each instantiated for 1..4 packed word streams:
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
// Words are unpacked BY INDEX in both bodies - element p of pack block b
// sits in row b * rows_pb + off_c + p mod R_c at bit (p div R_c) * w_c - in
// uint32 arithmetic, so nothing depends on the TPU's tile shapes.  A body
// walks the word rows r of the widest component (rmax per block, 32 / w_max
// slots per word); every narrower component's word for the same elements
// is its row r mod R_c.  The caller picks the body (kernels/dispatch.py
// matmul_route: bf16 at M >= TC_MIN_M takes the tensor cores); nothing here
// switches from one to the other.
//
// CUDA-core body (stream_matmul; decode, short prefill, every f32 call).
// At decode (M = 1..8) every packed weight word is read once for 2*M flops
// per weight, far below the card's ~295 flop/byte ridge, so the bound is
// the bytes of the packed words: 4 / 7 / 10 bits per weight at rungs
// 0 / 1 / 2 of an (8, 6, 4) ladder.  The design:
//   * the 32 lanes of a warp own 32 neighbouring output columns, so each
//     word-row load is one coalesced 128-byte line, and each word is loaded
//     once per CTA and yields 32 / w codes;
//   * the x tile of one pack block (8 rows x block) is staged in shared
//     memory as f32 and read as a warp-wide broadcast;
//   * one CTA per (32 columns, 8 rows, pack block): split-K over pack
//     blocks puts enough CTAs on the 132 SMs at decode shapes.  Partial
//     sums go to an f32 workspace and a second pass adds them in a fixed
//     order (deterministic), applies the scale and casts;
//   * CUDA-core FMAs: at decode the time goes to dependent word loads
//     (latency), not arithmetic.
//
// Tensor-core body (stream_matmul_tc; bf16 at prefill M).  At M = 4096
// a weight is used 4096 times, ~14 flops per packed bit: the products
// bound it (989 TFLOP/s bf16 dense, H100 SXM at 700 W), and the CUDA-core
// body's re-unpack of every word for every 8 rows is what it avoids:
//   * one CTA of 16 warps per 256 x BN output tile, BN = 128, or 64 where
//     128-wide tiles would fill fewer than half the SMs (k/v, N = 256, at
//     any M; q/o and down at M <= 1280).  A narrower tile, not a
//     split-K: this route allocates no workspace;
//   * a K step is rb = 2 * w_max (or w_max, when the block's rmax is an
//     odd multiple of w_max) consecutive word rows of the widest component
//     within one pack block, and every slot of them: 64 (or 32) codes per
//     column.  Each word is copied to shared memory and unpacked once per
//     CTA, for all 256 rows of x - 32x fewer unpacks per flop than the
//     CUDA-core body; a narrower component's word row r mod R_c is copied
//     once for each word row of the widest that it serves;
//   * the step's x columns (for each slot j, the contiguous run of elements
//     j * rmax + r; 16-byte cp.async at qwen2's shapes, narrower where the
//     alignment asks) and word rows go through a 2-stage cp.async ring.
//     x of step t + 1 and the words of step t + 2 are in flight while the
//     words of step t + 1 are unpacked and step t is multiplied, so every
//     warp mixes integer and tensor-core work; one __syncthreads per step;
//   * 512 threads unpack and chain-recompose the staged words (running
//     shifts; r / R_c by a multiply-shift; no division in the loops) into
//     a double-buffered bf16 code tile (64 x BN, k-major, rows padded by
//     16 bytes); the cast to bf16 is exact up to 8 bits and rounds to
//     nearest even above, as code_as does;
//   * each warp multiplies a 64 x 32 (BN 128) or 32 x 32 (BN 64) sub-tile
//     with mma.sync m16n8k16 bf16 -> f32, A by ldmatrix from the x tile
//     (rows padded by 16 bytes, conflict-free), B by ldmatrix.trans from
//     the code tile; warps whose rows all lie past M skip their products.
//     The sum runs in another order than the CUDA-core body's, over the
//     same products;
//   * the epilogue applies the scale per column and casts; ragged M, N and
//     K (the last pack block's elements past K, zero-filled x) are masked
//     in the kernel.
//   What still bounds it: the unpack (~30 integer instructions per code at
//   rung 2, once per 256 rows) and mma.sync fed from shared memory by 16
//   warps; wgmma with TMA and a warp-specialised unpack are the next step.
//
// Limits (the Python wrappers check them first): 1..4 streams, every
// bitwidth <= 16, pack block a multiple of 32 and <= 512; the tensor-core
// body takes bf16 activations only and returns cudaErrorInvalidValue
// otherwise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tensor_core.cuh"

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
  // tensor-core route only
  int first;            // index of component 0 among every stream's components
  int cs[kMaxComps];    // bit position of each component in the stream's code
  int rdiv[kMaxComps];  // ceil(2^20 / R[c]): r / R[c] == (r * rdiv) >> 20, r < 512
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
  // tensor-core route only
  int rb, rb_shift;     // widest-component word rows per K step, its log2
  int bk;               // codes of K per step: rb * slots (64, or 32)
  int spb;              // K steps per pack block: rmax / rb
  int nsteps;           // nk * spb
  int ncomp_all;        // components of every stream together
  int vx_shift;         // log2 of the x elements per async copy (1..8)
  int vw_shift;         // log2 of the words per async copy of a word row (1..4)
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

// ---------------------------------------------------------------------------
// Tensor-core route: bf16 activations at prefill M
// ---------------------------------------------------------------------------
constexpr int kTcBM = 256;            // activation rows per CTA
constexpr int kTcBK = 64;             // codes of K per step
constexpr int kTcWarps = 16;
constexpr int kTcThreads = kTcWarps * 32;
constexpr int kTcLDA = kTcBK + 8;     // x tile row stride: 16 bytes of padding
constexpr int kTcMaxSmem = 227 * 1024;

size_t tc_smem_bytes(int bn, int wrows) {
  return 2ull * kTcBK * (bn + 8) * sizeof(__nv_bfloat16)                  // code ring
         + 2ull * kTcBM * kTcLDA * sizeof(__nv_bfloat16)                  // x ring
         + 2ull * wrows * bn * sizeof(uint32_t);                           // word ring
}

// an int code as f32, exact for |c| < 2^22 (two full-rate adds, no I2F)
__device__ __forceinline__ float code_f32(int c) {
  return __int_as_float(0x4B400000 + c) - 12582912.f;
}

template <int NS, int BN>
__global__ void __launch_bounds__(kTcThreads, 1) stream_matmul_tc(const Args a) {
  using nq_tc::smem_u32;
  constexpr int LDB = BN + 8;          // code tile row stride: 16 bytes of padding
  constexpr int WN = BN / 32;          // warps across N, 32 columns each
  constexpr int WM = kTcWarps / WN;    // warps across M
  constexpr int MT = kTcBM / WM / 16;  // m16 tiles per warp
  constexpr int BN_SHIFT = BN == 128 ? 7 : 6;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* bs = reinterpret_cast<__nv_bfloat16*>(smem_raw);       // 2 x (64, LDB)
  __nv_bfloat16* as = bs + 2 * kTcBK * LDB;                               // 2 x (128, LDA)
  uint32_t* ws = reinterpret_cast<uint32_t*>(as + 2 * kTcBM * kTcLDA);   // 2 x (wrows, BN)
  const int wrows = a.rb * a.ncomp_all;
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * kTcBM;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int wm = warp / WN;
  const int wn = warp % WN;
  const __nv_bfloat16* x = static_cast<const __nv_bfloat16*>(a.x);

  // K step t covers word rows r0 .. r0 + rb - 1 of the widest component in
  // pack block kb (a step never straddles two blocks) and every slot j of
  // them: code j * rb + (r - r0) of the step is element j * rmax + r of the
  // block.
  auto x_stage = [&](int t, int buf) {   // x columns: runs of vx per slot
    const int kb = t / a.spb;
    const int r0 = (t - kb * a.spb) * a.rb;
    const size_t kbase = static_cast<size_t>(kb) * a.block + r0;
    __nv_bfloat16* ad = as + buf * kTcBM * kTcLDA;
    const int per_m_shift = (a.bk == 64 ? 6 : 5) - a.vx_shift;   // copies per x row
    for (int i = threadIdx.x; i < (kTcBM << per_m_shift); i += kTcThreads) {
      const int mi = i >> per_m_shift;
      const int kk = (i - (mi << per_m_shift)) << a.vx_shift;   // code of the step
      const int j = kk >> a.rb_shift;
      const size_t kx = kbase + static_cast<size_t>(j) * a.rmax + (kk - (j << a.rb_shift));
      const bool ok = m0 + mi < a.M && kx < static_cast<size_t>(a.K);
      const __nv_bfloat16* src = ok ? x + static_cast<size_t>(m0 + mi) * a.K + kx : x;
      __nv_bfloat16* dst = ad + mi * kTcLDA + kk;
      switch (a.vx_shift) {
        case 3: nq_tc::cp_async<16>(smem_u32(dst), src, ok); break;
        case 2: nq_tc::cp_async<8>(smem_u32(dst), src, ok); break;
        case 1: nq_tc::cp_async<4>(smem_u32(dst), src, ok); break;
        default: *dst = ok ? *src : __float2bfloat16_rn(0.f); break;
      }
    }
  };
  auto w_stage = [&](int t, int buf) {   // every component's word rows r mod R_c
    const int kb = t / a.spb;
    const int r0 = (t - kb * a.spb) * a.rb;
    uint32_t* wd = ws + buf * wrows * BN;
    const int cshift = BN_SHIFT - a.vw_shift;                   // copies per row
#pragma unroll
    for (int s = 0; s < NS; ++s) {
#pragma unroll
      for (int c = 0; c < kMaxComps; ++c) {
        if (c < a.s[s].ncomp) {
          uint32_t* rows = wd + (a.s[s].first + c) * a.rb * BN;
          const uint32_t* base = a.s[s].words +
              (static_cast<size_t>(kb) * a.s[s].rows_pb + a.s[s].off[c]) * a.N + n0;
          for (int i = threadIdx.x; i < (a.rb << cshift); i += kTcThreads) {
            const int gi = i >> cshift;
            const int col = (i - (gi << cshift)) << a.vw_shift;
            const int r = r0 + gi;
            const int rr = r - ((r * a.s[s].rdiv[c]) >> 20) * a.s[s].R[c];   // r mod R_c
            const bool ok = n0 + col < a.N;
            const uint32_t* src = ok ? base + static_cast<size_t>(rr) * a.N + col : a.s[s].words;
            const uint32_t dst = smem_u32(rows + gi * BN + col);
            switch (a.vw_shift) {
              case 2: nq_tc::cp_async<16>(dst, src, ok); break;
              case 1: nq_tc::cp_async<8>(dst, src, ok); break;
              default: nq_tc::cp_async<4>(dst, src, ok); break;
            }
          }
        }
      }
    }
  };

  // unpack + chain-recompose the staged words of step t into code tile
  // `buf` (64 x BN bf16, k-major); each task is one word row and a column
  // pair, and emits the pair's codes for every slot
  auto unpack = [&](int t, int buf) {
    const uint32_t* wd = ws + (t & 1) * wrows * BN;
    __nv_bfloat16* bt = bs + buf * kTcBK * LDB;
    const int r0 = (t % a.spb) * a.rb;
    for (int i = threadIdx.x; i < (a.rb << (BN_SHIFT - 1)); i += kTcThreads) {
      const int gi = i >> (BN_SHIFT - 1);
      const int np = i - (gi << (BN_SHIFT - 1));
      const int r = r0 + gi;
      uint32_t w0[NS][kMaxComps], w1[NS][kMaxComps];
#pragma unroll
      for (int s = 0; s < NS; ++s) {
#pragma unroll
        for (int c = 0; c < kMaxComps; ++c) {
          w0[s][c] = 0u;
          w1[s][c] = 0u;
          if (c < a.s[s].ncomp) {
            const uint2 p = *reinterpret_cast<const uint2*>(
                wd + ((a.s[s].first + c) * a.rb + gi) * BN + 2 * np);
            const int sub = ((r * a.s[s].rdiv[c]) >> 20) * a.s[s].w[c];   // slot of j = 0
            w0[s][c] = p.x >> sub;
            w1[s][c] = p.y >> sub;
          }
        }
      }
      __nv_bfloat16* dst = bt + gi * LDB + 2 * np;
      for (int j = 0; j < a.slots; ++j) {
        int c0 = 0, c1 = 0;
#pragma unroll
        for (int s = 0; s < NS; ++s) {
          uint32_t u0 = 0u, u1 = 0u;
#pragma unroll
          for (int c = 0; c < kMaxComps; ++c) {
            if (c < a.s[s].ncomp) {
              const uint32_t mask = (1u << a.s[s].w[c]) - 1u;
              u0 |= (w0[s][c] & mask) << a.s[s].cs[c];
              u1 |= (w1[s][c] & mask) << a.s[s].cs[c];
              const int step = a.s[s].q[c] * a.s[s].w[c];   // bits to the next slot
              w0[s][c] >>= step;
              w1[s][c] >>= step;
            }
          }
          const int up = 32 - a.s[s].code_bits;  // sign-extend the field
          const int v0 = static_cast<int>(u0 << up) >> up;
          const int v1 = static_cast<int>(u1 << up) >> up;
          if (s == 0) {
            c0 = v0;
            c1 = v1;
          } else {
            c0 = min(max((c0 << a.gap[s]) + v0, a.lo[s]), a.hi[s]);
            c1 = min(max((c1 << a.gap[s]) + v1, a.lo[s]), a.hi[s]);
          }
        }
        // codes.astype(bf16): exact up to 8 bits, nearest even above
        *reinterpret_cast<uint32_t*>(dst + (j << a.rb_shift) * LDB) =
            nq_tc::pack_bf16(code_f32(c0), code_f32(c1));
      }
    }
  };

  float acc[MT][4][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] =
        acc[mt][nt][3] = 0.f;

  // Ring: x of step t + 1 and the words of step t + 2 are in flight while
  // step t + 1 is unpacked and step t multiplied, so every warp mixes
  // integer work with tensor-core work; one __syncthreads per step.
  const int nsteps = a.nsteps;
  x_stage(0, 0);
  w_stage(0, 0);
  nq_tc::cp_async_commit();
  if (nsteps > 1) w_stage(1, 1);
  nq_tc::cp_async_commit();
  nq_tc::cp_async_wait_all();
  __syncthreads();
  unpack(0, 0);
  for (int t = 0; t < nsteps; ++t) {
    nq_tc::cp_async_wait_all();
    __syncthreads();   // x(t), words(t + 1), codes(t) complete; step t - 1 consumed
    if (t + 1 < nsteps) x_stage(t + 1, (t + 1) & 1);
    if (t + 2 < nsteps) w_stage(t + 2, t & 1);
    nq_tc::cp_async_commit();
    if (t + 1 < nsteps) unpack(t + 1, (t + 1) & 1);
    const __nv_bfloat16* ab = as + (t & 1) * kTcBM * kTcLDA;
    const __nv_bfloat16* bt = bs + (t & 1) * kTcBK * LDB;
#pragma unroll
    for (int kk = 0; kk < kTcBK / 16; ++kk) {
      if (kk * 16 >= a.bk || m0 + wm * MT * 16 >= a.M) break;   // no rows of x left
      uint32_t af[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        nq_tc::ldmatrix_x4(af[mt], smem_u32(ab + (wm * MT * 16 + mt * 16 + (lane & 15)) * kTcLDA +
                                            kk * 16 + (lane >> 4) * 8));
      }
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        uint32_t bf[4];
        nq_tc::ldmatrix_x4_trans(
            bf, smem_u32(bt + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LDB + wn * 32 +
                         np * 16 + (lane >> 4) * 8));
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          nq_tc::mma_bf16(acc[mt][2 * np], af[mt], bf[0], bf[1]);
          nq_tc::mma_bf16(acc[mt][2 * np + 1], af[mt], bf[2], bf[3]);
        }
      }
    }
  }

  // epilogue: the scale once per column, cast, ragged M and N masked
  const int g = lane >> 2;
  const int t4 = lane & 3;
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    const int col = n0 + wn * 32 + nt * 8 + 2 * t4;
    if (col >= a.N) continue;
    const bool two = col + 1 < a.N;
    const float s0 = a.scale[col];
    const float s1 = two ? a.scale[col + 1] : 0.f;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int m = m0 + wm * MT * 16 + mt * 16 + g + half * 8;
        if (m >= a.M) continue;
        const float v0 = acc[mt][nt][2 * half] * s0;
        const float v1 = acc[mt][nt][2 * half + 1] * s1;
        const size_t i = static_cast<size_t>(m) * a.N + col;
        if (two && a.N % 2 == 0) {
          if (a.out_f32) {
            *reinterpret_cast<float2*>(static_cast<float*>(a.out) + i) = make_float2(v0, v1);
          } else {
            *reinterpret_cast<uint32_t*>(static_cast<__nv_bfloat16*>(a.out) + i) =
                nq_tc::pack_bf16(v0, v1);
          }
        } else {
          store_out(a, m, col, v0);
          if (two) store_out(a, m, col + 1, v1);
        }
      }
    }
  }
}

template <int NS, int BN>
int launch_tc_body(const Args& a, size_t smem, cudaStream_t stream) {
  // opt in above 48 KB once per instantiation, before any graph capture
  static cudaError_t opt_in = cudaFuncSetAttribute(
      stream_matmul_tc<NS, BN>, cudaFuncAttributeMaxDynamicSharedMemorySize, kTcMaxSmem);
  if (opt_in != cudaSuccess) return static_cast<int>(opt_in);
  const dim3 grid((a.N + BN - 1) / BN, (a.M + kTcBM - 1) / kTcBM);
  stream_matmul_tc<NS, BN><<<grid, kTcThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int BN>
int launch_tc_ns(const Args& a, int ns, size_t smem, cudaStream_t stream) {
  switch (ns) {
    case 1: return launch_tc_body<1, BN>(a, smem, stream);
    case 2: return launch_tc_body<2, BN>(a, smem, stream);
    case 3: return launch_tc_body<3, BN>(a, smem, stream);
    default: return launch_tc_body<4, BN>(a, smem, stream);
  }
}

int log2_exact(int v) {
  int s = 0;
  while ((1 << s) < v) ++s;
  return s;
}

// Tensor-core route: Args filled by launch() up to the CUDA-core fields.
int launch_tc(Args a, int ns, cudaStream_t stream) {
  static int sms = [] {
    int dev = 0, n = 132;
    if (cudaGetDevice(&dev) == cudaSuccess) {
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    }
    return n;
  }();
  // K step: 2 * w_max word rows (64 codes) when they tile the block's
  // rmax = (block / 32) * w_max rows, else w_max rows (32 codes)
  const int wmax = 32 / a.slots;
  a.rb = (a.rmax % (2 * wmax) == 0) ? 2 * wmax : wmax;
  a.rb_shift = log2_exact(a.rb);
  a.bk = a.rb * a.slots;
  a.spb = a.rmax / a.rb;
  a.nsteps = a.nk * a.spb;
  a.ncomp_all = 0;
  for (int s = 0; s < ns; ++s) {
    Stream& st = a.s[s];
    a.ncomp_all += st.ncomp;
    int cs = 0;
    for (int c = 0; c < st.ncomp; ++c) {
      st.cs[c] = cs;
      cs += st.w[c];
      st.rdiv[c] = ((1 << 20) + st.R[c] - 1) / st.R[c];
    }
  }
  // widest async copies the alignment allows (16 bytes at qwen2's shapes)
  int vx = 8;
  while (vx > 1 && (a.rb % vx || a.rmax % vx || a.K % vx ||
                    reinterpret_cast<uintptr_t>(a.x) % (2 * vx))) {
    vx /= 2;
  }
  a.vx_shift = log2_exact(vx);
  int vw = 4;
  for (bool fits = false; !fits && vw > 1;) {
    fits = a.N % vw == 0;
    for (int s = 0; s < ns; ++s) {
      fits = fits && reinterpret_cast<uintptr_t>(a.s[s].words) % (4 * vw) == 0;
    }
    if (!fits) vw /= 2;
  }
  a.vw_shift = log2_exact(vw);
  // 128-column tiles unless they would fill fewer than half the SMs (k/v,
  // N = 256, and short M at N = 1536 take 64)
  const long tiles = static_cast<long>((a.M + kTcBM - 1) / kTcBM) * ((a.N + 127) / 128);
  const int bn = 2 * tiles >= sms ? 128 : 64;
  const size_t smem = tc_smem_bytes(bn, a.rb * a.ncomp_all);
  if (smem > static_cast<size_t>(kTcMaxSmem) || (a.M + kTcBM - 1) / kTcBM > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return bn == 128 ? launch_tc_ns<128>(a, ns, smem, stream)
                   : launch_tc_ns<64>(a, ns, smem, stream);
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
           int M, int N, int K, int block, int tensor_cores, cudaStream_t stream) {
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
  int first = 0;
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
    st.first = first;
    first += st.ncomp;
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
  if (tensor_cores) {  // bf16 only: f32 keeps its CUDA-core body (no TF32)
    return x_bf16 ? launch_tc(a, ns, stream) : static_cast<int>(cudaErrorInvalidValue);
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
                     int M, int N, int K, int block, int tensor_cores, void* stream) {
  const void* streams[1] = {words};
  const int bits[1] = {k};
  return launch(x, x_bf16, streams, bits, 1, scale, out, out_f32, partial, M, N,
                K, block, tensor_cores, static_cast<cudaStream_t>(stream));
}

// K2: rung 1, the h-bit base and the (n - h + 1)-bit delta.
int nq_nested_matmul(const void* x, int x_bf16, const void* words_high,
                     const void* words_low, int n, int h, const void* scale,
                     void* out, int out_f32, void* partial, int M, int N, int K,
                     int block, int tensor_cores, void* stream) {
  const void* streams[2] = {words_high, words_low};
  const int bits[2] = {h, n};
  return launch(x, x_bf16, streams, bits, 2, scale, out, out_f32, partial, M, N,
                K, block, tensor_cores, static_cast<cudaStream_t>(stream));
}

// K3: rungs >= 2, the base and every resident delta (2..4 streams here;
// the 2-stream case is accepted too and computes what K2 does).
int nq_ladder_matmul(const void* x, int x_bf16, const void* const* streams,
                     const int* bits, int nstreams, const void* scale, void* out,
                     int out_f32, void* partial, int M, int N, int K, int block,
                     int tensor_cores, void* stream) {
  return launch(x, x_bf16, streams, bits, nstreams, scale, out, out_f32, partial,
                M, N, K, block, tensor_cores, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
