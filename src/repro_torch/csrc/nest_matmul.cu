// Hand-written Hopper (sm_90a) kernels for the three weight matmuls of the
// NestQuant serving path, three templated bodies (a decode one, a CUDA-core
// one and a tensor-core one), each instantiated for 1..4 packed word
// streams; the fourth body, for bf16 at M 9-63 (the short prefill), is in
// nest_matmul_mid.cu, and the operands and plans the two sources share in
// nest_matmul.cuh:
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
// Words are unpacked BY INDEX in every body - element p of pack block b
// sits in row b * rows_pb + off_c + p mod R_c at bit (p div R_c) * w_c - in
// uint32 arithmetic, so nothing depends on the TPU's tile shapes.  A body
// walks the word rows r of the widest component (rmax per block, 32 / w_max
// slots per word); every narrower component's word for the same elements
// is its row r mod R_c.  The caller picks the body (kernels/dispatch.py
// matmul_route: M <= 8 the decode body, bf16 at M >= TC_MIN_M the tensor
// cores, bf16 in between the short-prefill body (nest_matmul_mid.cu), f32
// above M 8 the CUDA cores; the decode route of a decode step or a
// speculative verify pass names the decode body for groups of <= 8 rows;
// the C entry points' `body` argument); nothing here switches from one to
// another.
//
// Decode body (stream_matmul_dec; M <= 8, bf16 and f32).  Every packed word
// is used for 2*M <= 16 flops, so the bound is the bytes of the words (4 /
// 7 / 10 bits per weight at rungs 0 / 1 / 2 of an (8, 6, 4) ladder: 0.23 /
// 0.40 / 0.58 ms per qwen2-1.5b decode step at 3.35 TB/s), and in practice
// the integer instructions that unpack them: at the byte bound gate/up
// leaves ~6 INT32 instructions per code (64 lanes per SM).  What the design
// does about it:
//   * each word is loaded and unpacked once per call, for all M rows: a
//     CTA stages the x of its pack block (M <= 8 rows, f32, row-fastest, so
//     one broadcast 16-byte read serves 4 rows), and accumulators and FMAs
//     exist for MB in {1, 2, 4, 8} rows (a template; M 3 and 5..7 mask
//     rows of zeros);
//   * a unit is the widest component's rows r = rho + t * R_min (t <
//     w_max / w_min) of one rho < R_min of a pack block; with them every
//     narrower component's words for those rows (R_c / R_min of them) are
//     copied once - not once per widest row they serve;
//   * 16-byte cp.async copies, 32 lanes reading 512 contiguous bytes of a
//     word row; 8- or 4-byte copies where N % 4 != 0 or a stream's base is
//     not 16-byte aligned (the same body);
//   * work items (one chunk of units x one column tile of 128, 64 or 32
//     columns x one pack block), numbered block-major, split evenly over the
//     CTAs: one CTA per item, or, with more than 4 items per resident CTA
//     (the LM head), as many CTAs as fit the SMs at once, each walking its
//     run with the words of the next item in flight (a 2-stage cp.async
//     ring).  Narrow tiles spread k/v (N = 256) and q/o over the SMs;
//   * the packed-field path (every stream's code fits w_max bits, codes <=
//     9 bits or f32 x: the served (8, 6, 4) ladder): per row, each stream's
//     components merge into one word holding its code for every slot, w_max
//     bits apart; per slot and stream one LOP3 turns the low field into the
//     f32 2^23 + code + 2^(b-1), one FADD into the signed code, and the
//     chain recompose runs on exact f32 integers (FFMA, FMNMX; the upper
//     clip of a compensated chain can never bind): 2 INT32 instructions per
//     stream and code, the rest on the FP32 pipe.  Other ladders take the
//     general path in the same body (codes assembled from their fields one
//     column at a time, bf16 rounding of codes over 8 bits as code_as does);
//   * one launch per matmul, deterministic: each run of items of one
//     (block, tile) adds its rows in a fixed order (warp shuffles, then
//     warps) into its own f32 partial slot; the run that brings the tile's
//     arrival count (a per-tile int32 in a workspace the wrapper keeps, 0
//     between launches) to all the tile's items adds every slot of the tile
//     in (block, CTA) order, applies the scale, casts, and resets the count.
//     No float atomics, no second pass.
//   * rows that do not depend on M: the plan (items, chunks, column tile,
//     grid) is a function of the bitwidths, N, K, the pack block, the
//     streams' alignment and the device alone - the grid takes the 8-row
//     instantiation's occupancy at every M - and a row's FMAs, shuffles and
//     slot sums run in one order whatever rows sit beside it.  So row m of
//     a launch at any M <= 8 is bit for bit the same row of a launch at any
//     other M.  The speculative verify pass (S = k + 1 positions of B
//     sequences, M = B * S > 8) needs exactly that: its rows must equal the
//     decode steps' (dispatch.DECODE, named).  The wrapper launches this body
//     once per group of <= 8 rows rather than adding a row-group grid axis:
//     each group is then the very launch a decode step makes, with its
//     workspace and the per-tile arrival counters (which a grid axis would
//     have to split per group) unchanged, at the price of reading the
//     words once per group;
//   What still bounds it: the unpack and the 2*M FMAs per code run at a
//   fraction of the SMs' instruction rate (no ncu on the card's machine to
//   say which stall), and short launches (k/v, q/o) pay a launch and one round trip
//   to memory: 2-23 % of the byte bound per shape at M = 4 (PERF.md).
//
// CUDA-core body (stream_matmul; f32 above M 8; it was written for decode,
// which the decode body now serves, and bf16 at M 9-63 takes the
// short-prefill body).
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
// body takes bf16 activations only, the decode body M <= 8, and each
// returns cudaErrorInvalidValue otherwise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "nest_matmul.cuh"
#include "tensor_core.cuh"

namespace {

using namespace nq_mm;

constexpr int kBN = 32;       // output columns per CTA: one per lane
constexpr int kWarps = 8;     // warps per CTA, splitting the word rows
constexpr int kBM = 8;        // activation rows per CTA
constexpr int kThreads = kWarps * 32;
static_assert(kWarps == kBM, "the epilogue maps one warp to one output row");

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

// Tensor-core route: Args filled by launch() up to the CUDA-core fields.
int launch_tc(Args a, int ns, cudaStream_t stream) {
  const int sms = device_sms();
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
  a.vw_shift = word_copy_shift(a, ns);
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

// ---------------------------------------------------------------------------
// Decode route: M <= 8, bf16 or f32 activations
// ---------------------------------------------------------------------------
constexpr int kDecWarps = 8;
constexpr int kDecThreads = kDecWarps * 32;
constexpr int kDecStageBytes = 20 * 1024;  // words of one chunk (one ring stage)
constexpr int kDecMaxM = 8;
constexpr int kDecItems = 4;               // work items per SM the plan aims for
constexpr int kDecPersist = 4;             // above this many items per resident CTA,
                                           // CTAs loop over items (else one item each)

__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// x rows 0..MB-1 of element p: one broadcast shared-memory read per 4 rows
template <int MB>
__device__ __forceinline__ void dec_x(const float* xp, float (&xv)[MB]) {
  if constexpr (MB >= 4) {
#pragma unroll
    for (int m = 0; m < MB; m += 4) {
      const float4 q = *reinterpret_cast<const float4*>(xp + m);
      xv[m] = q.x;
      xv[m + 1] = q.y;
      xv[m + 2] = q.z;
      xv[m + 3] = q.w;
    }
  } else if constexpr (MB == 2) {
    const float2 q = *reinterpret_cast<const float2*>(xp);
    xv[0] = q.x;
    xv[1] = q.y;
  } else {
    xv[0] = *xp;
  }
}

// One widest-component word row r of a unit, every slot, four columns, on
// the packed-field path (every stream's code fits wmax bits, codes <= 9
// bits).  Per row, each stream's components are merged into one word per
// column holding that stream's code of every slot, wmax bits apart.  Per
// slot and stream, one LOP3 turns the low field into the f32 2^23 + code +
// 2^(b-1) (offset binary in the mantissa), one FADD into the signed code,
// and the chain recompose runs on exact f32 integers (FFMA, FMNMX): two
// integer instructions per stream and code, the rest on the FP32 pipe.
template <int NS, int MB>
__device__ __forceinline__ void dec_row_spread(const Args& a, const uint32_t* wb,
                                               const float* xs, int q, int rp, int t,
                                               int r, float (&acc)[MB][4]) {
  const int bn = 1 << a.bn_log;
  uint32_t u[NS][4];
#pragma unroll
  for (int s = 0; s < NS; ++s) {
    u[s][0] = u[s][1] = u[s][2] = u[s][3] = 0u;
#pragma unroll
    for (int c = 0; c < kMaxComps; ++c) {
      if (c < a.s[s].ncomp) {
        const int glog = a.s[s].glog[c];
        const int row = ((a.s[s].cbase[c] + (t & ((1 << glog) - 1))) << a.g_log) + rp;
        const uint4 v = *reinterpret_cast<const uint4*>(wb + row * bn + 4 * q);
        const int sh = (t >> glog) * a.s[s].w[c];   // bit of slot 0 for this row
        const uint32_t m = a.s[s].spread[c];
        const int cs = a.s[s].cs[c];
        u[s][0] |= ((v.x >> sh) & m) << cs;
        u[s][1] |= ((v.y >> sh) & m) << cs;
        u[s][2] |= ((v.z >> sh) & m) << cs;
        u[s][3] |= ((v.w >> sh) & m) << cs;
      }
    }
  }
  const float* xp = xs + r * MB;
  const int xstep = a.rmax * MB;
  for (int j = 0; j < a.slots; ++j, xp += xstep) {
    float code[4];
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      const Stream& st = a.s[s];
      const uint32_t field = (1u << st.code_bits) - 1u;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float v = __uint_as_float((u[s][k] & field) ^ st.fbias) - st.foff;
        u[s][k] >>= a.wmax;
        code[k] = (s == 0) ? v : fmaxf(fmaf(code[k], st.fmul, v), st.flo);
      }
    }
    float xv[MB];
    dec_x<MB>(xp, xv);
#pragma unroll
    for (int m = 0; m < MB; ++m) {
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[m][k] = fmaf(code[k], xv[m], acc[m][k]);
    }
  }
}

// The same on the general path (a stream's code wider than wmax, or codes
// over 9 bits in bf16): each code assembled from its components' fields,
// one column at a time (few registers: this path must not set the
// packed-field path's occupancy).
template <int NS, int MB>
__device__ __forceinline__ void dec_row(const Args& a, const uint32_t* wb, const float* xs,
                                        int q, int rp, int t, int r, float (&acc)[MB][4]) {
  const int bn = 1 << a.bn_log;
#pragma unroll 1
  for (int k = 0; k < 4; ++k) {
    uint32_t wd[NS][kMaxComps];
#pragma unroll
    for (int s = 0; s < NS; ++s) {
#pragma unroll
      for (int c = 0; c < kMaxComps; ++c) {
        if (c < a.s[s].ncomp) {
          const int glog = a.s[s].glog[c];
          const int row = ((a.s[s].cbase[c] + (t & ((1 << glog) - 1))) << a.g_log) + rp;
          wd[s][c] = wb[row * bn + 4 * q + k] >> ((t >> glog) * a.s[s].w[c]);
        }
      }
    }
    float part[MB];
#pragma unroll
    for (int m = 0; m < MB; ++m) part[m] = 0.f;
    const float* xp = xs + r * MB;
    for (int j = 0; j < a.slots; ++j, xp += a.rmax * MB) {
      int code = 0;
#pragma unroll
      for (int s = 0; s < NS; ++s) {
        uint32_t u = 0u;
        int cs = 0;
#pragma unroll
        for (int c = 0; c < kMaxComps; ++c) {
          if (c < a.s[s].ncomp) {
            u |= (wd[s][c] & ((1u << a.s[s].w[c]) - 1u)) << cs;
            wd[s][c] >>= a.wmax;                    // every component: wmax bits a slot
            cs += a.s[s].w[c];
          }
        }
        const int up = 32 - a.s[s].code_bits;      // sign-extend the field
        const int v = static_cast<int>(u << up) >> up;
        code = (s == 0) ? v : min(max(code * (1 << a.gap[s]) + v, a.lo[s]), a.hi[s]);
      }
      float cf = code_f32(code);
      if (a.round_codes) cf = __bfloat162float(__float2bfloat16_rn(cf));
      float xv[MB];
      dec_x<MB>(xp, xv);
#pragma unroll
      for (int m = 0; m < MB; ++m) part[m] = fmaf(cf, xv[m], part[m]);
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      if (kk == k) {
#pragma unroll
        for (int m = 0; m < MB; ++m) acc[m][kk] += part[m];
      }
    }
  }
}

// Stream-K over work items.  An item is one chunk of one column tile (bn =
// 32, 64 or 128 columns) in one pack block, numbered block-major: item I
// is block b = I / (tiles * cpb), tile T = (I / cpb) mod tiles, chunk
// I mod cpb, so a CTA's run of items seldom changes block (x is staged
// again only then).  A chunk is 2^g_log units; a unit the widest-component
// rows r = rho + t * rmin (t < umax) of one rho < rmin together with every
// word that any component holds for those rows, each copied once.  CTA p
// of P takes items [p W / P, (p + 1) W / P): every CTA the same work
// (+-1 item), all of them resident at once, the words of item i + 1 in
// flight while item i is unpacked.  A run of items of one (block, tile)
// is a segment: its sums go to partial slot b * tiles + T + p, and the
// last segment of a tile to arrive adds the tile's slots in (block, CTA)
// order (deterministic whoever arrives last), scales, casts and resets
// the tile's counter.  Thread i owns the 4 columns of quad i mod (bn / 4)
// and takes every (1024 / bn)-th widest-component row of a chunk.

// (pack block, column tile, chunk) of an item, advanced without division
struct DecItem {
  int b, T, c;
  __device__ __forceinline__ void next(const Args& a) {
    if (++c == a.cpb) {
      c = 0;
      if (++T == a.tiles) {
        T = 0;
        ++b;
      }
    }
  }
};

template <int NS, int MB>
__global__ void __launch_bounds__(kDecThreads) stream_matmul_dec(const Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int G = 1 << a.g_log;
  const int bn = 1 << a.bn_log;
  const int stage_words = a.wpu * G * bn;
  float* xs = reinterpret_cast<float*>(smem_raw);                  // (block, MB) f32
  float* red = xs + a.block * MB;                                   // (warps, MB, bn)
  uint32_t* ring = reinterpret_cast<uint32_t*>(red + kDecWarps * MB * bn);  // 2 stages
  int* flag = reinterpret_cast<int*>(ring + 2 * stage_words);
  int* segs = flag + 4;                       // (nk * cpb) partial slots of one tile
  const int q = threadIdx.x & ((bn >> 2) - 1);                      // column quad
  const int rg = threadIdx.x >> (a.bn_log - 2);                     // row group
  const int nrg = kDecThreads >> (a.bn_log - 2);
  const int warp = threadIdx.x >> 5;
  const long W = a.nitems;
  const long P = gridDim.x;
  const int start = static_cast<int>(blockIdx.x * W / P);
  const int end = static_cast<int>((blockIdx.x + 1) * W / P);
  const int per_b = a.tiles * a.cpb;

  auto stage = [&](const DecItem& it, int buf) {
    const int n0 = it.T << a.bn_log;
    const int rho0 = it.c << a.g_log;
    uint32_t* dst = ring + buf * stage_words;
    const int cshift = a.bn_log - a.vw_shift;                   // copies per word row
#pragma unroll
    for (int s = 0; s < NS; ++s) {
#pragma unroll
      for (int c = 0; c < kMaxComps; ++c) {
        if (c < a.s[s].ncomp) {
          const int rows = 1 << (a.s[s].glog[c] + a.g_log);
          const uint32_t* base = a.s[s].words +
              (static_cast<size_t>(it.b) * a.s[s].rows_pb + a.s[s].off[c] + rho0) * a.N + n0;
          uint32_t* d = dst + (a.s[s].cbase[c] << a.g_log) * bn;
          for (int i = threadIdx.x; i < (rows << cshift); i += kDecThreads) {
            const int row = i >> cshift;                        // (t mod g) * G + rho'
            const int col = (i - (row << cshift)) << a.vw_shift;
            const int grow = (row >> a.g_log) * a.rmin + (row & (G - 1));
            const bool ok = n0 + col < a.N;
            const uint32_t* src = ok ? base + static_cast<size_t>(grow) * a.N + col
                                     : a.s[s].words;
            const uint32_t sd = nq_tc::smem_u32(d + row * bn + col);
            switch (a.vw_shift) {
              case 2: nq_tc::cp_async<16>(sd, src, ok); break;
              case 1: nq_tc::cp_async<8>(sd, src, ok); break;
              default: nq_tc::cp_async<4>(sd, src, ok); break;
            }
          }
        }
      }
    }
  };

  float acc[MB][4];
#pragma unroll
  for (int m = 0; m < MB; ++m) acc[m][0] = acc[m][1] = acc[m][2] = acc[m][3] = 0.f;

  DecItem cur;                                                   // the item unpacked now
  cur.b = start / per_b;
  cur.T = (start - cur.b * per_b) / a.cpb;
  cur.c = start - cur.b * per_b - cur.T * a.cpb;
  DecItem ahead = cur;                                           // the next to stage
  stage(ahead, 0);
  nq_tc::cp_async_commit();
  ahead.next(a);
  if (start + 1 < end) stage(ahead, 1);
  nq_tc::cp_async_commit();
  ahead.next(a);

  const int rows = a.umax << a.g_log;                            // widest rows per chunk
  int xb = -1;
  int seg_items = 0;
  for (int item = start; item < end; ++item, cur.next(a)) {
    const int it = item - start;
    if (cur.b != xb) {
      // x of pack block b as f32, (p, m) with m fastest; rows past M and
      // elements past K are 0 (every thread is past the previous item)
      const size_t k0 = static_cast<size_t>(cur.b) * a.block;
      for (int i = threadIdx.x; i < MB * a.block; i += kDecThreads) {
        const int m = i / a.block;
        const int p = i - m * a.block;
        float v = 0.f;
        if (m < a.M && k0 + p < static_cast<size_t>(a.K)) {
          const size_t xi = static_cast<size_t>(m) * a.K + k0 + p;
          v = a.x_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(a.x)[xi])
                       : static_cast<const float*>(a.x)[xi];
        }
        xs[p * MB + m] = v;
      }
      xb = cur.b;
    }
    if (item + 1 < end) {
      cp_async_wait_one();
    } else {
      nq_tc::cp_async_wait_all();
    }
    __syncthreads();                                             // item (and x) landed
    const uint32_t* wb = ring + (it & 1) * stage_words;
    const int rho0 = cur.c << a.g_log;
    for (int idx = rg; idx < rows; idx += nrg) {
      const int rp = idx & (G - 1);
      const int t = idx >> a.g_log;
      const int r = rho0 + rp + t * a.rmin;
      if (a.spread) {
        dec_row_spread<NS, MB>(a, wb, xs, q, rp, t, r, acc);
      } else {
        dec_row<NS, MB>(a, wb, xs, q, rp, t, r, acc);
      }
    }
    ++seg_items;

    if (item + 1 == end || cur.c + 1 == a.cpb) {                 // the segment ends
      // row groups of a warp (lanes bn/4 apart), then the warps in order
      for (int off = bn >> 2; off < 32; off <<= 1) {
#pragma unroll
        for (int m = 0; m < MB; ++m) {
#pragma unroll
          for (int k = 0; k < 4; ++k) acc[m][k] += __shfl_xor_sync(0xffffffffu, acc[m][k], off);
        }
      }
      if ((threadIdx.x & 31) < (bn >> 2)) {
#pragma unroll
        for (int m = 0; m < MB; ++m) {
          *reinterpret_cast<float4*>(red + (warp * MB + m) * bn + 4 * q) =
              make_float4(acc[m][0], acc[m][1], acc[m][2], acc[m][3]);
        }
      }
#pragma unroll
      for (int m = 0; m < MB; ++m) acc[m][0] = acc[m][1] = acc[m][2] = acc[m][3] = 0.f;
      __syncthreads();
      const int n0 = cur.T << a.bn_log;
      const bool whole = a.nk == 1 && seg_items == a.cpb;       // the tile in one run
      const long slot = static_cast<long>(cur.b) * a.tiles + cur.T + blockIdx.x;
      for (int i = threadIdx.x; i < (MB << a.bn_log); i += kDecThreads) {
        const int m = i >> a.bn_log;
        const int col = i & (bn - 1);
        if (m >= a.M || n0 + col >= a.N) continue;
        float sum = 0.f;
#pragma unroll
        for (int w = 0; w < kDecWarps; ++w) sum += red[(w * MB + m) * bn + col];
        if (whole) {
          store_out(a, m, n0 + col, sum * a.scale[n0 + col]);
        } else {
          a.partial[(slot * a.M + m) * bn + col] = sum;
        }
      }
      if (!whole) {
        // arrivals count items: the run that brings the tile's count to
        // nk * cpb is the last
        __threadfence();
        __syncthreads();
        if (threadIdx.x == 0) {
          *flag = atomicAdd(a.counters + cur.T, seg_items) + seg_items == a.nk * a.cpb;
        }
        __syncthreads();
        if (*flag) {
          __threadfence();
          if (threadIdx.x == 0) {                                  // the tile's runs
            int n = 0;
            for (int b = 0; b < a.nk; ++b) {
              const long i0 = (static_cast<long>(b) * a.tiles + cur.T) * a.cpb;
              const int p0 = dec_owner(i0, W, P);
              const int p1 = dec_owner(i0 + a.cpb - 1, W, P);
              for (int p = p0; p <= p1; ++p) segs[n++] = b * a.tiles + cur.T + p;
            }
            flag[1] = n;
          }
          __syncthreads();
          const int nseg = flag[1];
          for (int i = threadIdx.x; i < (MB << a.bn_log); i += kDecThreads) {
            const int m = i >> a.bn_log;
            const int col = i & (bn - 1);
            if (m >= a.M || n0 + col >= a.N) continue;
            const float* pm = a.partial + static_cast<long>(m) * bn + col;
            const long stride = static_cast<long>(a.M) * bn;
            float sum = 0.f;
#pragma unroll 8
            for (int k = 0; k < nseg; ++k) sum += __ldcg(pm + segs[k] * stride);
            store_out(a, m, n0 + col, sum * a.scale[n0 + col]);
          }
          if (threadIdx.x == 0) a.counters[cur.T] = 0;
        }
      }
      seg_items = 0;
    }
    __syncthreads();                                             // stage it & 1 is free
    if (item + 2 < end) stage(ahead, it & 1);
    nq_tc::cp_async_commit();
    ahead.next(a);
  }
}

size_t dec_smem_bytes(const Args& a, int mb) {
  const size_t bn = static_cast<size_t>(1) << a.bn_log;
  return static_cast<size_t>(a.block) * mb * sizeof(float)                    // x
         + static_cast<size_t>(kDecWarps) * mb * bn * sizeof(float)          // red
         + 2ull * a.wpu * (1 << a.g_log) * bn * sizeof(uint32_t)             // ring
         + (4ull + static_cast<size_t>(a.nk) * a.cpb) * sizeof(int);        // flag, slots
}

// The opt-in above 48 KB of dynamic shared memory, once per instantiation,
// before any graph capture (the body has no static shared memory, so all
// 227 KB may be dynamic); the occupancy query and the launch both take it
template <int NS, int MB>
cudaError_t dec_opt_in() {
  static cudaError_t opt_in = cudaFuncSetAttribute(
      stream_matmul_dec<NS, MB>, cudaFuncAttributeMaxDynamicSharedMemorySize, kTcMaxSmem);
  return opt_in;
}

// CTAs of one instantiation that fit an SM at this shared memory
template <int NS, int MB>
int dec_occupancy_body(size_t smem) {
  int n = 0;
  if (dec_opt_in<NS, MB>() != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, stream_matmul_dec<NS, MB>, kDecThreads,
                                                    smem) != cudaSuccess) {
    return 1;
  }
  return n > 0 ? n : 1;
}

template <int MB>
int dec_occupancy_ns(int ns, size_t smem) {
  switch (ns) {
    case 1: return dec_occupancy_body<1, MB>(smem);
    case 2: return dec_occupancy_body<2, MB>(smem);
    case 3: return dec_occupancy_body<3, MB>(smem);
    default: return dec_occupancy_body<4, MB>(smem);
  }
}

int dec_mb(int M) { return M == 1 ? 1 : M == 2 ? 2 : M <= 4 ? 4 : 8; }

template <int NS, int MB>
int launch_dec_body(const Args& a, size_t smem, cudaStream_t stream) {
  const cudaError_t opt_in = dec_opt_in<NS, MB>();
  if (opt_in != cudaSuccess) return static_cast<int>(opt_in);
  stream_matmul_dec<NS, MB><<<a.nctas, kDecThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int MB>
int launch_dec_ns(const Args& a, int ns, size_t smem, cudaStream_t stream) {
  switch (ns) {
    case 1: return launch_dec_body<1, MB>(a, smem, stream);
    case 2: return launch_dec_body<2, MB>(a, smem, stream);
    case 3: return launch_dec_body<3, MB>(a, smem, stream);
    default: return launch_dec_body<4, MB>(a, smem, stream);
  }
}

// Decode route: the tile, chunk, item and grid plan of one launch, from
// Args filled by make_args().  It reads bits, N, K, the pack block, the
// streams' alignment and the device, never M.  nq_dec_workspace() reads the
// same plan, so the wrapper allocates exactly the partials the launch writes.
void dec_plan(Args& a, int ns) {
  const int sms = device_sms();
  unit_plan(a, ns);
  // the widest column tile (128, 64, 32) whose tiles times pack blocks
  // reach kDecItems per SM; the largest chunk (a power of two of units
  // dividing rmin) whose words fit one ring stage; then smaller chunks
  // until the items reach kDecItems per SM, while a chunk still holds a
  // row for every row group
  const long want = static_cast<long>(kDecItems) * sms;
  a.bn_log = 7;
  while (a.bn_log > 5 && ((a.N + (1 << a.bn_log) - 1) >> a.bn_log) * a.nk < want) --a.bn_log;
  auto items = [&] {
    return static_cast<long>((a.N + (1 << a.bn_log) - 1) >> a.bn_log) * a.nk *
           (a.rmin >> a.g_log);
  };
  a.g_log = 0;
  while (a.rmin % (2 << a.g_log) == 0 &&
         static_cast<long>(a.wpu) * (2 << a.g_log) * (4 << a.bn_log) <= kDecStageBytes) {
    ++a.g_log;
  }
  const int nrg = (kDecThreads * 4) >> a.bn_log;
  while (a.g_log > 0 && items() < want && (a.umax << (a.g_log - 1)) >= nrg) --a.g_log;
  a.tiles = (a.N + (1 << a.bn_log) - 1) >> a.bn_log;
  a.cpb = a.rmin >> a.g_log;
  a.nitems = items();
  // one CTA per item, or, above kDecPersist items per resident CTA, as many
  // CTAs as fit the SMs at once, each looping over an equal run of items.
  // The fit is the 8-row instantiation's at every M, so the grid - and with
  // it which items each CTA adds into its partial slot - does not depend on
  // M: a row's sum is formed in the same order at every M <= 8
  const long fit = static_cast<long>(sms) * dec_occupancy_ns<kDecMaxM>(
      ns, dec_smem_bytes(a, kDecMaxM));
  a.nctas = static_cast<int>(a.nitems > kDecPersist * fit ? fit : a.nitems);
  a.vw_shift = word_copy_shift(a, ns);                // 16-byte copies unless misaligned
}

// f32 partial floats per activation row: one (bn)-wide slot per segment
long dec_workspace(const Args& a) {
  return (static_cast<long>(a.nk) * a.tiles + a.nctas) << a.bn_log;
}

int launch_dec(Args a, int ns, int x_bf16, int top_bits, int* counters, int ncounters,
               long nworkspace, cudaStream_t stream) {
  if (a.M > kDecMaxM) return static_cast<int>(cudaErrorInvalidValue);
  dec_plan(a, ns);
  const int mb = dec_mb(a.M);
  a.x_bf16 = x_bf16;
  a.round_codes = x_bf16 && top_bits > 9;            // |code| > 256: bf16 rounds it
  a.spread = a.spread && !a.round_codes;
  a.counters = counters;
  const size_t smem = dec_smem_bytes(a, mb);
  if (smem > static_cast<size_t>(kTcMaxSmem) || a.partial == nullptr ||
      nworkspace < dec_workspace(a) * a.M || counters == nullptr || ncounters < a.tiles) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  switch (mb) {
    case 1: return launch_dec_ns<1>(a, ns, smem, stream);
    case 2: return launch_dec_ns<2>(a, ns, smem, stream);
    case 4: return launch_dec_ns<4>(a, ns, smem, stream);
    default: return launch_dec_ns<8>(a, ns, smem, stream);
  }
}

template <int NS>
void launch_body(const Args& a, int x_bf16, dim3 grid, cudaStream_t stream) {
  if (x_bf16) {
    stream_matmul<NS, __nv_bfloat16><<<grid, kThreads, 0, stream>>>(a);
  } else {
    stream_matmul<NS, float><<<grid, kThreads, 0, stream>>>(a);
  }
}

// body: 0 = CUDA cores, 1 = tensor cores (bf16 only), 2 = decode (M <= 8).
// partial: npartial f32 (the CUDA-core body: (nk, M, N) when nk > 1; the
// decode body: nq_dec_workspace() * M); counters: ncounters int32 arrival
// counts, 0 between launches (decode only).
int launch(const void* x, int x_bf16, const void* const* words, const int* bits,
           int ns, const void* scale, void* out, int out_f32, void* partial, int npartial,
           void* counters, int ncounters, int M, int N, int K, int block, int body,
           cudaStream_t stream) {
  Args a = {};
  const int err = make_args(a, words, bits, ns, M, N, K, block);
  if (err != 0) return err;
  a.x = x;
  a.out = out;
  a.scale = static_cast<const float*>(scale);
  a.partial = static_cast<float*>(partial);
  a.out_f32 = out_f32;
  if (body == 2) {
    return launch_dec(a, ns, x_bf16, bits[ns - 1], static_cast<int*>(counters), ncounters,
                      npartial, stream);
  }
  if (body == 1) {  // bf16 only: f32 keeps its CUDA-core body (no TF32)
    return x_bf16 ? launch_tc(a, ns, stream) : static_cast<int>(cudaErrorInvalidValue);
  }
  if (body != 0) return static_cast<int>(cudaErrorInvalidValue);
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
                     const void* scale, void* out, int out_f32, void* partial, int npartial,
                     void* counters, int ncounters, int M, int N, int K, int block,
                     int body, void* stream) {
  const void* streams[1] = {words};
  const int bits[1] = {k};
  return launch(x, x_bf16, streams, bits, 1, scale, out, out_f32, partial, npartial,
                counters, ncounters, M, N, K, block, body, static_cast<cudaStream_t>(stream));
}

// K2: rung 1, the h-bit base and the (n - h + 1)-bit delta.
int nq_nested_matmul(const void* x, int x_bf16, const void* words_high,
                     const void* words_low, int n, int h, const void* scale,
                     void* out, int out_f32, void* partial, int npartial, void* counters,
                     int ncounters, int M, int N, int K, int block, int body, void* stream) {
  const void* streams[2] = {words_high, words_low};
  const int bits[2] = {h, n};
  return launch(x, x_bf16, streams, bits, 2, scale, out, out_f32, partial, npartial,
                counters, ncounters, M, N, K, block, body, static_cast<cudaStream_t>(stream));
}

// K3: rungs >= 2, the base and every resident delta (2..4 streams here;
// the 2-stream case is accepted too and computes what K2 does).
int nq_ladder_matmul(const void* x, int x_bf16, const void* const* streams,
                     const int* bits, int nstreams, const void* scale, void* out,
                     int out_f32, void* partial, int npartial, void* counters, int ncounters,
                     int M, int N, int K, int block, int body, void* stream) {
  return launch(x, x_bf16, streams, bits, nstreams, scale, out, out_f32, partial, npartial,
                counters, ncounters, M, N, K, block, body, static_cast<cudaStream_t>(stream));
}

// The decode body's f32 partials per activation row for these operands,
// and its column tiles (the arrival counters it needs), or -1 where it
// refuses them.  The launch follows the same plan.
int nq_dec_workspace(const int* bits, int nstreams, int M, int N, int K, int block,
                     int* tiles) {
  Args a = {};
  if (make_args(a, nullptr, bits, nstreams, M, N, K, block) != 0 || M > kDecMaxM) return -1;
  dec_plan(a, nstreams);
  *tiles = a.tiles;
  return static_cast<int>(dec_workspace(a));
}

// Rows of the decode-body instantiation an M-row launch runs, or -1 above
// the decode body's M.  ``dispatch.dec_rows`` must agree (a gpu test holds it).
int nq_dec_rows(int M) { return M >= 1 && M <= kDecMaxM ? dec_mb(M) : -1; }

}  // extern "C"
