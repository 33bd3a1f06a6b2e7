// Hand-written Hopper (sm_90a) f32 body of the three weight matmuls K1-K3
// (stream_matmul_f32): f32 activations above M 8 (the decode body takes M
// <= 8), the fifth body beside nest_matmul.cu's decode, CUDA-core and
// tensor-core bodies and nest_matmul_mid.cu's short-prefill body.  It
// computes what those compute for
//
//   nq_f32_matmul  repro/kernels/packed_matmul/kernel.py:48 packed_matmul
//                  (rung 0), repro/kernels/nested_matmul/kernel.py:61
//                  nested_matmul (rung 1) and :125 ladder_matmul (rungs >= 2)
//
// y[M, N] = (x[M, K] @ W[K, N]) * scale[N], W the INT codes chain-recomposed
// from 1..4 block-packed streams, every code exact in f32, products summed
// in f32 by plain IEEE FMAs on the CUDA cores (no TF32 anywhere: the f32
// path is the port's exactness reference), the scale applied once, the
// output f32 (or bf16).
//
// What bounds it: a 10-bit code is worth 2 * M flops, and the card's f32
// ridge is 67 TFLOP/s over 3.35 TB/s = 20 flops per byte, so from M ~16 up
// the f32 FMAs bound it (a qwen2-1.5b 2 x 2048 prefill: 10.74 TFLOP, 160
// ms at 67 TFLOP/s).  The CUDA-core body (stream_matmul, written for
// decode) re-loaded and re-unpacked every word once per 8 rows (512 times
// at M 4096) on a general per-column path, ran one scalar shared read per
// FMA pair and split K over every pack block into an (nk, M, N) f32
// workspace (440 MB for gate/up at M 4096) added by a second pass.  The
// design, an SGEMM whose B operand is unpacked once per CTA:
//   * one CTA of 256 threads per BM x BN output tile, BN = 128, or 32
//     where 128-wide tiles would cover under a quarter of the SMs and
//     32-wide ones leave a CTA at most 3x the K steps (k/v at any M, q/o
//     at short M, not down's long K); BM = 32 to M 32, 64 to M 64 and at
//     BN 32, else 128; thread (ty, tx)
//     of 16 x 16 owns rows ty + 16 i (i < BM / 16) and BN / 16 columns
//     (4 tx .. 4 tx + 3 and 64 + 4 tx .. + 3 at BN 128): a register
//     micro-tile of up to 8 x 8 sums;
//   * a K step is w_max consecutive word rows of the widest component
//     within one pack block and every slot of them: 32 codes of K, as the
//     tensor-core body walks it.  Each word is copied to shared memory and
//     unpacked once per CTA, for all BM rows; a narrower component's word
//     row r mod R_c is copied once for each word row of the widest that it
//     serves;
//   * the permutation goes on x, never on the words: code j * w_max + i of
//     a step is element j * rmax + r0 + i of the pack block (slot j of word
//     row r0 + i), so the step's x is staged in that order, runs of w_max
//     neighbours in K (16-byte cp.async at qwen2's shapes, 8 or 4 bytes
//     where the alignment asks);
//   * a 2-stage cp.async ring: x of step t + 1 and the words of step t + 2
//     are in flight while the words of step t + 1 are unpacked and step t
//     is multiplied, so every warp mixes its integer work with its FMAs;
//     one __syncthreads per step;
//   * the packed-field path (every stream's code fits w_max bits: the
//     served (8, 6, 4) ladder): per word row and column, each stream's
//     components merge into one word holding its code of every slot,
//     w_max bits apart; per slot and stream one LOP3 gives the f32 2^23 +
//     code + 2^(b-1), one FADD the signed code, and the chain recompose
//     runs on exact f32 integers (FFMA, FMNMX).  Other ladders take the
//     general path in the same body (codes assembled from their fields,
//     clipped in integers);
//   * the codes land in a k-major f32 tile (rows padded by 4 floats), x in
//     an m-major one (rows padded by 4 floats): a thread reads x as one
//     float4 along K per row and the codes as two float4 along N per code
//     row (one float2 at BN 32), 16 FMAs per 16-byte shared read at BM
//     128 and BN 128, no bank conflicts
//     (a warp is 4 row threads x 8 column threads);
//   * where the tiles fill fewer than the SMs (M 9-63, k/v at N 256), K is
//     split into runs of steps (at least 4 steps a run, at most two CTAs
//     per SM in all, a tile's slots at most 512 KB): each run writes its
//     tile into its own f32 slot, and
//     the run that brings the tile's arrival count (the per-tile int32
//     counters the decode and short-prefill bodies share, 0 between
//     launches) to the runs of the tile adds the slots in run order (each
//     run's loads for all of a thread's outputs in flight together),
//     applies the scale, casts and resets the count.  One launch,
//     deterministic, no float atomics, no second pass; the workspace is
//     splits x M x N floats where splits > 1, else none;
//   * ragged M, N and K (zero-filled x past M and K, columns past N never
//     stored) and unaligned streams (narrower copies) are masked in the
//     kernel.
//   What still bounds it (PERF.md): at M 4096 the FMAs at the f32 rate,
//   with the unpack (~10-25 instructions per code by rung, once per 128
//   rows) and the shared reads in the same issue slots; at short M the
//   unpack itself (a code is worth only 2 M flops there), the steps each
//   CTA walks and the last run's sum of the slots.
//
// Limits (the Python wrappers check them first): f32 x, 1..4 streams,
// every bitwidth <= 16, pack block a multiple of 32 and <= 512;
// cudaErrorInvalidValue otherwise.

#include <cuda_runtime.h>
#include <stdint.h>

#include "nest_matmul.cuh"
#include "tensor_core.cuh"

namespace {

using namespace nq_mm;

constexpr int kF32BK = 32;                  // codes of K per step
constexpr int kF32Threads = 256;            // 16 row threads x 16 column threads
constexpr int kF32LDX = kF32BK + 4;         // x tile row stride (floats)
constexpr int kF32CtasPerSm = 2;            // CTAs per SM the split plan counts on
constexpr int kF32MinSteps = 4;             // K steps a split run takes at least
constexpr int kF32MaxSmem = 227 * 1024;

constexpr long kF32SlotBytes = 512 * 1024;   // a tile's split slots at most

// activation rows per CTA: 32 or 64 (and 128 above M 64 with 128-column
// tiles)
int f32_bm(int M, int bn) { return M <= 32 ? 32 : M <= 64 || bn == 32 ? 64 : 128; }

size_t f32_smem_bytes(int bm, int bn, int wrows) {
  return 2ull * bm * kF32LDX * sizeof(float)                  // x ring
         + 2ull * kF32BK * (bn + 4) * sizeof(float)           // code ring
         + 2ull * wrows * bn * sizeof(uint32_t)               // word ring
         + 4 * sizeof(int);                                   // arrival flag
}

long f32_tiles(int M, int N, int bn) {
  const int bm = f32_bm(M, bn);
  return static_cast<long>((M + bm - 1) / bm) * ((N + bn - 1) / bn);
}

// runs of K steps for tiles of bn columns: 1 where the tiles fill the SMs,
// else as many runs of at least kF32MinSteps steps as keep the CTAs within
// two per SM and a tile's slots within kF32SlotBytes (its last run reads
// them all)
int f32_runs(int M, int N, int bn, int nsteps, int sms) {
  const long tiles = f32_tiles(M, N, bn);
  if (tiles >= sms) return 1;
  long s = static_cast<long>(kF32CtasPerSm) * sms / tiles;
  if (s > nsteps / kF32MinSteps) s = nsteps / kF32MinSteps;
  const long cap = kF32SlotBytes / (4L * f32_bm(M, bn) * bn);
  if (s > cap) s = cap;
  return s > 1 ? static_cast<int>(s) : 1;
}

// 128 output columns per CTA, or 32 where 128-wide tiles would fill fewer
// than a quarter of the SMs (k/v at any M, q/o at short M), unless that
// leaves a CTA over 3x the K steps (down's long K): a short launch's time
// follows its steps per CTA, and its last run's sum of the slots grows
// with the tile
int f32_bn(int M, int N, int nsteps, int sms) {
  if (4 * f32_tiles(M, N, 128) > sms) return 128;
  const int wide = (nsteps + f32_runs(M, N, 128, nsteps, sms) - 1) /
                   f32_runs(M, N, 128, nsteps, sms);
  const int narrow = (nsteps + f32_runs(M, N, 32, nsteps, sms) - 1) /
                     f32_runs(M, N, 32, nsteps, sms);
  return narrow <= 3 * wide ? 32 : 128;
}

int f32_splits(int M, int N, int nsteps, int sms) {
  return f32_runs(M, N, f32_bn(M, N, nsteps, sms), nsteps, sms);
}

// VW consecutive floats of shared memory (VW = 4 or 2)
template <int VW>
__device__ __forceinline__ void lds(const float* p, float (&v)[VW]) {
  if constexpr (VW == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  } else {
    const float2 q = *reinterpret_cast<const float2*>(p);
    v[0] = q.x; v[1] = q.y;
  }
}

template <int NS, int BM, int BN>
__global__ void __launch_bounds__(kF32Threads, kF32CtasPerSm)
    stream_matmul_f32(const Args a, int splits) {
  using nq_tc::smem_u32;
  constexpr int TM = BM / 16;                  // rows per thread: ty + 16 i
  constexpr int CW = BN / 16;                  // columns per thread (8 or 2) ...
  constexpr int VW = CW < 4 ? CW : 4;          // ... in chunks of VW neighbours ...
  constexpr int NCH = CW / VW;                 // ... VW tx + (BN / 2) h, h < NCH
  constexpr int LDB = BN + 4;                  // code tile row stride (floats)
  constexpr int BN_LOG = BN == 128 ? 7 : 5;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* xs = reinterpret_cast<float*>(smem_raw);                    // 2 x (BM, LDX)
  float* codes = xs + 2 * BM * kF32LDX;                              // 2 x (BK, LDB)
  uint32_t* ws = reinterpret_cast<uint32_t*>(codes + 2 * kF32BK * LDB);  // 2 x (wrows, BN)
  const int wrows = a.rb * a.ncomp_all;
  int* flag = reinterpret_cast<int*>(ws + 2 * wrows * BN);
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;
  const int split = blockIdx.z;
  const int t_begin = static_cast<int>(static_cast<long>(a.nsteps) * split / splits);
  const int nsteps = static_cast<int>(static_cast<long>(a.nsteps) * (split + 1) / splits) -
                     t_begin;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int ty = ((warp >> 1) << 2) + (lane >> 3);                   // 4 row threads a warp
  const int tx = ((warp & 1) << 3) + (lane & 7);                     // 8 column threads
  const float* x = static_cast<const float*>(a.x);

  // Step t covers word rows r0 .. r0 + rb - 1 (rb = w_max) of the widest
  // component in pack block kb and every slot j of them: code j * rb + i
  // of the step is element j * rmax + r0 + i of the block.
  auto x_stage = [&](int t, int buf) {   // x in the step's order, runs of vx
    const int kb = t / a.spb;
    const size_t kbase = static_cast<size_t>(kb) * a.block + (t - kb * a.spb) * a.rb;
    float* xd = xs + buf * BM * kF32LDX;
    const int per_m_shift = 5 - a.vx_shift;                          // copies per x row
    for (int i = threadIdx.x; i < (BM << per_m_shift); i += kF32Threads) {
      const int mi = i >> per_m_shift;
      const int kk = (i - (mi << per_m_shift)) << a.vx_shift;       // code of the step
      const int j = kk >> a.rb_shift;
      const size_t kx = kbase + static_cast<size_t>(j) * a.rmax + (kk - (j << a.rb_shift));
      const bool ok = m0 + mi < a.M && kx < static_cast<size_t>(a.K);
      const float* src = ok ? x + static_cast<size_t>(m0 + mi) * a.K + kx : x;
      const uint32_t dst = smem_u32(xd + mi * kF32LDX + kk);
      switch (a.vx_shift) {
        case 2: nq_tc::cp_async<16>(dst, src, ok); break;
        case 1: nq_tc::cp_async<8>(dst, src, ok); break;
        default: nq_tc::cp_async<4>(dst, src, ok); break;
      }
    }
  };
  auto w_stage = [&](int t, int buf) {   // every component's word rows r mod R_c
    const int kb = t / a.spb;
    const int r0 = (t - kb * a.spb) * a.rb;
    uint32_t* wd = ws + buf * wrows * BN;
    const int cshift = BN_LOG - a.vw_shift;                          // copies per row
#pragma unroll
    for (int s = 0; s < NS; ++s) {
#pragma unroll
      for (int c = 0; c < kMaxComps; ++c) {
        if (c < a.s[s].ncomp) {
          uint32_t* rows = wd + (a.s[s].first + c) * a.rb * BN;
          const uint32_t* base = a.s[s].words +
              (static_cast<size_t>(kb) * a.s[s].rows_pb + a.s[s].off[c]) * a.N + n0;
          for (int i = threadIdx.x; i < (a.rb << cshift); i += kF32Threads) {
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

  // Unpack and chain-recompose the staged words of step t into code tile
  // `buf` (32 x BN f32, k-major): one task per (word row i of the step,
  // column), emitting the column's code of every slot j at row j * rb + i.
  // Slot j of component c sits at bit j * w_max + (r div R_c) * w_c of its
  // word row r mod R_c, so after one shift by the row's offset every
  // component steps by w_max bits a slot.
  auto unpack = [&](int t, int buf) {
    const uint32_t* wd = ws + buf * wrows * BN;
    float* ct = codes + buf * kF32BK * LDB;
    const int r0 = (t % a.spb) * a.rb;
    const int jstep = a.rb * LDB;                                    // rows j * rb apart
    for (int i = threadIdx.x; i < (a.rb << BN_LOG); i += kF32Threads) {
      const int gi = i >> BN_LOG;
      const int n = i & (BN - 1);
      const int r = r0 + gi;
      float* dst = ct + gi * LDB + n;
      if (a.spread) {
        uint32_t u[NS];
#pragma unroll
        for (int s = 0; s < NS; ++s) {
          u[s] = 0u;
#pragma unroll
          for (int c = 0; c < kMaxComps; ++c) {
            if (c < a.s[s].ncomp) {
              const uint32_t w = wd[((a.s[s].first + c) * a.rb + gi) * BN + n];
              const int sub = ((r * a.s[s].rdiv[c]) >> 20) * a.s[s].w[c];
              u[s] |= ((w >> sub) & a.s[s].spread[c]) << a.s[s].cs[c];
            }
          }
        }
        // the upper clip of a compensated chain never binds (as in the
        // decode and short-prefill bodies): one FFMA and one FMNMX a level
#pragma unroll 8
        for (int j = 0; j < a.slots; ++j) {
          float code = 0.f;
#pragma unroll
          for (int s = 0; s < NS; ++s) {
            const Stream& st = a.s[s];
            const float v = __uint_as_float(((u[s] >> (j * a.wmax)) &
                                             ((1u << st.code_bits) - 1u)) ^ st.fbias) - st.foff;
            code = (s == 0) ? v : fmaxf(fmaf(code, st.fmul, v), st.flo);
          }
          dst[j * jstep] = code;
        }
      } else {
        uint32_t wv[NS][kMaxComps];
#pragma unroll
        for (int s = 0; s < NS; ++s) {
#pragma unroll
          for (int c = 0; c < kMaxComps; ++c) {
            wv[s][c] = 0u;
            if (c < a.s[s].ncomp) {
              wv[s][c] = wd[((a.s[s].first + c) * a.rb + gi) * BN + n] >>
                         (((r * a.s[s].rdiv[c]) >> 20) * a.s[s].w[c]);
            }
          }
        }
        for (int j = 0; j < a.slots; ++j, dst += jstep) {
          int code = 0;
#pragma unroll
          for (int s = 0; s < NS; ++s) {
            uint32_t u = 0u;
#pragma unroll
            for (int c = 0; c < kMaxComps; ++c) {
              if (c < a.s[s].ncomp) {
                u |= (wv[s][c] & ((1u << a.s[s].w[c]) - 1u)) << a.s[s].cs[c];
                wv[s][c] >>= a.wmax;
              }
            }
            const int up = 32 - a.s[s].code_bits;                    // sign-extend the field
            const int v = static_cast<int>(u << up) >> up;
            code = (s == 0) ? v : min(max(code * (1 << a.gap[s]) + v, a.lo[s]), a.hi[s]);
          }
          *dst = code_f32(code);
        }
      }
    }
  };

  float acc[TM][CW];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int e = 0; e < CW; ++e) acc[i][e] = 0.f;

  // x row ty + 16 i of the tile as a float4 along K; each code row's
  // columns as NCH chunks of VW along N
  auto multiply = [&](int buf) {
    const float* xa = xs + buf * BM * kF32LDX + ty * kF32LDX;
    const float* cb = codes + buf * kF32BK * LDB + VW * tx;
#pragma unroll
    for (int kq = 0; kq < kF32BK; kq += 4) {
      float b[4][CW];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
#pragma unroll
        for (int h = 0; h < NCH; ++h) {
          float v[VW];
          lds<VW>(cb + (kq + q) * LDB + (BN / 2) * h, v);
#pragma unroll
          for (int e = 0; e < VW; ++e) b[q][VW * h + e] = v[e];
        }
      }
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        float xq[4];
        lds<4>(xa + i * 16 * kF32LDX + kq, xq);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
#pragma unroll
          for (int e = 0; e < CW; ++e) acc[i][e] = fmaf(xq[q], b[q][e], acc[i][e]);
        }
      }
    }
  };

  // Ring: x of step t + 1 and the words of step t + 2 are in flight while
  // step t + 1 is unpacked and step t multiplied; one __syncthreads a step.
  // Buffers are indexed by the step's place in this CTA's run.
  x_stage(t_begin, 0);
  w_stage(t_begin, 0);
  nq_tc::cp_async_commit();
  if (nsteps > 1) w_stage(t_begin + 1, 1);
  nq_tc::cp_async_commit();
  nq_tc::cp_async_wait_all();
  __syncthreads();
  unpack(t_begin, 0);
  for (int lt = 0; lt < nsteps; ++lt) {
    nq_tc::cp_async_wait_all();
    __syncthreads();   // x(lt), words(lt + 1), codes(lt) complete; step lt - 1 consumed
    if (lt + 1 < nsteps) x_stage(t_begin + lt + 1, (lt + 1) & 1);
    if (lt + 2 < nsteps) w_stage(t_begin + lt + 2, lt & 1);
    nq_tc::cp_async_commit();
    if (lt + 1 < nsteps) unpack(t_begin + lt + 1, (lt + 1) & 1);
    multiply(lt & 1);
  }

  // epilogue: this thread's rows m0 + ty + 16 i, chunks of VW columns at n
  // = n0 + VW tx + (BN / 2) h
  const bool vec = a.N % VW == 0;
  const bool vec_out = vec && a.out_f32 && (reinterpret_cast<uintptr_t>(a.out) & 15) == 0 &&
                       (reinterpret_cast<uintptr_t>(a.scale) & 15) == 0;
  auto col = [&](int h) { return n0 + VW * tx + (BN / 2) * h; };
  auto store = [&](int m, int n, const float (&v)[VW]) {   // scaled and cast, past N dropped
    if (vec_out && n < a.N) {
      float* o = static_cast<float*>(a.out) + static_cast<size_t>(m) * a.N + n;
      if constexpr (VW == 4) {
        const float4 q = *reinterpret_cast<const float4*>(a.scale + n);
        *reinterpret_cast<float4*>(o) =
            make_float4(v[0] * q.x, v[1] * q.y, v[2] * q.z, v[3] * q.w);
      } else {
        const float2 q = *reinterpret_cast<const float2*>(a.scale + n);
        *reinterpret_cast<float2*>(o) = make_float2(v[0] * q.x, v[1] * q.y);
      }
      return;
    }
#pragma unroll
    for (int e = 0; e < VW; ++e) {
      if (n + e < a.N) store_out(a, m, n + e, v[e] * a.scale[n + e]);
    }
  };
  if (splits == 1) {
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int m = m0 + ty + 16 * i;
      if (m >= a.M) continue;
#pragma unroll
      for (int h = 0; h < NCH; ++h) {
        float v[VW];
#pragma unroll
        for (int e = 0; e < VW; ++e) v[e] = acc[i][VW * h + e];
        store(m, col(h), v);
      }
    }
    return;
  }
  // Split K: this run's sums into its slot (split, M, N)
  const size_t stride = static_cast<size_t>(a.M) * a.N;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= a.M) continue;
#pragma unroll
    for (int h = 0; h < NCH; ++h) {
      const int n = col(h);
      float* p = a.partial + split * stride + static_cast<size_t>(m) * a.N + n;
#pragma unroll
      for (int e = 0; e < VW; ++e) {
        if (n + e < a.N) p[e] = acc[i][VW * h + e];
      }
    }
  }
  // The run that brings the tile's arrival count to `splits` is the last:
  // every thread fences its slot writes before the barrier and thread 0's
  // count; the last run fences again before reading the others' slots
  __threadfence();
  __syncthreads();
  const int tile = blockIdx.y * gridDim.x + blockIdx.x;
  if (threadIdx.x == 0) {
    *flag = atomicAdd(a.counters + tile, 1) + 1 == splits;
    if (*flag) __threadfence();
  }
  __syncthreads();
  if (!*flag) return;
  __threadfence();
  // the tile's slots in run order; each run's loads for all of this
  // thread's outputs are independent, so they are in flight together
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int e = 0; e < CW; ++e) acc[i][e] = 0.f;
#pragma unroll 2
  for (int k = 0; k < splits; ++k) {
    const float* pk = a.partial + k * stride;
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int m = m0 + ty + 16 * i;
#pragma unroll
      for (int h = 0; h < NCH; ++h) {
        const int n = col(h);
        const float* p = pk + static_cast<size_t>(m) * a.N + n;
#pragma unroll
        for (int e = 0; e < VW; ++e) {
          if (m < a.M && n + e < a.N) acc[i][VW * h + e] += __ldcg(p + e);
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= a.M) continue;
#pragma unroll
    for (int h = 0; h < NCH; ++h) {
      float v[VW];
#pragma unroll
      for (int e = 0; e < VW; ++e) v[e] = acc[i][VW * h + e];
      store(m, col(h), v);
    }
  }
  if (threadIdx.x == 0) a.counters[tile] = 0;
}

// The step, unpack and copy plan of one launch, from Args filled by
// make_args(): K steps of w_max widest-component rows (32 codes), every
// component's bit offset, field masks and f32 constants of the
// packed-field path, the copy widths.
void f32_plan(Args& a, int ns) {
  unit_plan(a, ns);
  a.rb = a.wmax;
  a.rb_shift = log2_exact(a.rb);
  a.bk = a.rb * a.slots;                                 // 32
  a.spb = a.rmax / a.rb;                                 // block / 32
  a.nsteps = a.nk * a.spb;
  a.ncomp_all = 0;
  for (int s = 0; s < ns; ++s) {
    Stream& st = a.s[s];
    st.first = a.ncomp_all;
    a.ncomp_all += st.ncomp;
    for (int c = 0; c < st.ncomp; ++c) st.rdiv[c] = ((1 << 20) + st.R[c] - 1) / st.R[c];
  }
  a.vw_shift = word_copy_shift(a, ns);
}

// f32 partials of one launch (0 where K is not split) and its tiles (the
// arrival counters it needs); kernels/build.py::f32_workspace mirrors it
long f32_workspace(const Args& a, int splits, int* tiles) {
  *tiles = static_cast<int>(f32_tiles(a.M, a.N, f32_bn(a.M, a.N, a.nsteps, device_sms())));
  return splits > 1 ? static_cast<long>(splits) * a.M * a.N : 0;
}

template <int NS, int BM, int BN>
int launch_f32_body(const Args& a, int splits, size_t smem, cudaStream_t stream) {
  // opt in above 48 KB once per instantiation, at its first launch
  static cudaError_t opt_in = cudaFuncSetAttribute(
      stream_matmul_f32<NS, BM, BN>, cudaFuncAttributeMaxDynamicSharedMemorySize, kF32MaxSmem);
  if (opt_in != cudaSuccess) return static_cast<int>(opt_in);
  const dim3 grid((a.N + BN - 1) / BN, (a.M + BM - 1) / BM, splits);
  stream_matmul_f32<NS, BM, BN><<<grid, kF32Threads, smem, stream>>>(a, splits);
  return static_cast<int>(cudaGetLastError());
}

template <int BM, int BN>
int launch_f32_ns(const Args& a, int ns, int splits, size_t smem, cudaStream_t stream) {
  switch (ns) {
    case 1: return launch_f32_body<1, BM, BN>(a, splits, smem, stream);
    case 2: return launch_f32_body<2, BM, BN>(a, splits, smem, stream);
    case 3: return launch_f32_body<3, BM, BN>(a, splits, smem, stream);
    default: return launch_f32_body<4, BM, BN>(a, splits, smem, stream);
  }
}

// the (BM, BN) instantiations: 32-column tiles 32 or 64 rows high
int launch_f32_tile(const Args& a, int ns, int splits, int bn, size_t smem,
                    cudaStream_t stream) {
  switch (f32_bm(a.M, bn) * (bn == 128 ? 1 : -1)) {
    case 32: return launch_f32_ns<32, 128>(a, ns, splits, smem, stream);
    case 64: return launch_f32_ns<64, 128>(a, ns, splits, smem, stream);
    case 128: return launch_f32_ns<128, 128>(a, ns, splits, smem, stream);
    case -32: return launch_f32_ns<32, 32>(a, ns, splits, smem, stream);
    default: return launch_f32_ns<64, 32>(a, ns, splits, smem, stream);
  }
}

}  // namespace

extern "C" {

// K1-K3 on the f32 body: f32 x (M, K); `streams` the 1..4 word streams of
// the resident rungs with their ascending `bits`; partial: npartial f32
// (nq_f32_workspace()); counters: ncounters int32 arrival counts, 0
// between launches (both unused, and may be null, where K is not split).
int nq_f32_matmul(const void* x, const void* const* streams, const int* bits, int nstreams,
                  const void* scale, void* out, int out_f32, void* partial, int npartial,
                  void* counters, int ncounters, int M, int N, int K, int block,
                  void* stream) {
  Args a = {};
  const int err = make_args(a, streams, bits, nstreams, M, N, K, block);
  if (err != 0) return err;
  a.x = x;
  a.out = out;
  a.scale = static_cast<const float*>(scale);
  a.partial = static_cast<float*>(partial);
  a.out_f32 = out_f32;
  a.counters = static_cast<int*>(counters);
  f32_plan(a, nstreams);
  int vx = 4;                                    // x floats per async copy: <= a run
  while (vx > 1 && (vx > a.rb || K % vx || reinterpret_cast<uintptr_t>(x) % (4 * vx))) vx /= 2;
  a.vx_shift = log2_exact(vx);
  const int sms = device_sms();
  const int splits = f32_splits(M, N, a.nsteps, sms);
  const int bn = f32_bn(M, N, a.nsteps, sms);
  int tiles = 0;
  const long need = f32_workspace(a, splits, &tiles);
  const int bm = f32_bm(M, bn);
  const size_t smem = f32_smem_bytes(bm, bn, a.rb * a.ncomp_all);
  if (smem > static_cast<size_t>(kF32MaxSmem) || (M + bm - 1) / bm > 65535 ||
      (splits > 1 && (a.partial == nullptr || npartial < need || a.counters == nullptr ||
                      ncounters < tiles))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return launch_f32_tile(a, nstreams, splits, bn, smem, st);
}

// The f32 body's partial floats for these operands (0 where K is not
// split) and its output tiles (the arrival counters it needs), or -1 where
// it refuses them.  The launch follows the same plan.
int nq_f32_workspace(const int* bits, int nstreams, int M, int N, int K, int block,
                     int* tiles) {
  Args a = {};
  if (make_args(a, nullptr, bits, nstreams, M, N, K, block) != 0) return -1;
  f32_plan(a, nstreams);
  return static_cast<int>(f32_workspace(a, f32_splits(M, N, a.nsteps, device_sms()), tiles));
}

}  // extern "C"
