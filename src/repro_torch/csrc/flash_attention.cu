// Hand-written Hopper (sm_90a) kernel for causal GQA attention, forward
// (the long-prefill attention of the serving path):
//
//   nq_flash_attention  replaces repro/kernels/flash_attention/kernel.py:60
//                       flash_attention
//
// What it computes: o[b, i, h, :] = softmax_j(q[b, i, h] . k[b, j, h / G]
// * 1/sqrt(hd), j <= q_off + i) @ v[b, :, h / G] for q (B, Sq, Hq, hd) and
// k, v (B, Skv, Hkv, hd), G = Hq / Hkv, q_off + Sq <= Skv: query row i sits
// at position q_off + i of the key sequence.  The whole causal prefill is
// q_off = 0, Sq = Skv; a sequence-parallel rank's block of query rows is
// q_off = its first row (key tiles past the block's last row are never
// read, so the work is the block's share of the causal triangle).  Each
// body is instantiated twice: for the whole sequence (q_off = 0 and
// Skv = Sq fixed at compile time, so that launch compiles to the code it
// had without an offset, and keeps its time) and for a block.
//
// The softmax is online (running max m, denominator l and accumulator
// acc, all f32), as the TPU kernel keeps them; p is rounded to v's dtype
// before the PV product (kernel.py:48), and o = acc / max(l, 1e-30) is
// cast to q's dtype.  f32 inputs use plain IEEE f32 FMAs (no TF32
// anywhere).
//
// What bounds it: 2 * B * Hq * S^2 * hd flops for the causal half (QK^T
// and PV) over (3 + 1) * B * S * H * hd values read and written; at
// S = 2048, hd = 128 that is ~3000 flops per byte, so the bound is the
// tensor cores' bf16 rate (989 TFLOP/s dense on an H100 SXM at 700 W).
//
// bf16 (flash_fwd_tc): both products on the tensor cores, FlashAttention-2
// style.  What the design does about the bound:
//   * one CTA of 8 warps per (128-row query tile, query head, batch);
//     query head h reads kv head h / G; heaviest tiles (most key tiles
//     under the diagonal) launched first.  Each warp owns 16 query rows,
//     and the 8 warps share every K/V tile they copy;
//   * Q K^T and P V are mma.sync m16n8k16 bf16 -> f32, their operands fed
//     by ldmatrix (.trans for V, whose rows are the reduction dimension).
//     The query fragments are loaded once and stay in registers;
//   * P never leaves registers: the f32 score accumulators of two adjacent
//     8-key tiles are exactly the A fragment of one 16-key step of the PV
//     product, so each pair is rounded to bf16 (p.astype(v.dtype)) and
//     re-packed in place.  The row max and row sum live in the quad of
//     lanes that holds a row and are reduced with two xor shuffles;
//   * K and V tiles of 64 rows are copied with cp.async (16-byte chunks,
//     zero-filled past S and past hd) into a double buffer: the copy of
//     tile t + 1 is issued before tile t is computed, so it overlaps the
//     products; one __syncthreads per key tile;
//   * shared-memory rows are padded by 16 bytes (stride hd_pad + 8
//     elements): the 8 row addresses of every ldmatrix fall in 8 distinct
//     16-byte bank groups, so ldmatrix has no bank conflicts;
//   * hd is padded in shared memory to 64 or 128 (two instantiations); the
//     zero columns add nothing to Q K^T and are never stored from P V.
//   * a warp skips a key tile that lies wholly past its own last row (on
//     the diagonal of a 128-row tile, up to half of them): its p would be
//     exactly 0;
//   Shared memory: (128 + 2 * 64 + 2 * 64) rows x (hd_pad + 8) bf16 =
//   102 KB at hd 128, two CTAs (16 warps) per SM.  What still bounds it:
//   every warp reads the whole K and V tile from shared memory through
//   ldmatrix for its 16 rows (one 16-byte read per 2 products), mma.sync
//   cannot reach wgmma's rate, and the softmax's exp and shuffles run
//   between the two products.
//
// f32 (flash_fwd): CUDA-core FMAs on f32 tiles in shared memory (no TF32
// anywhere: the f32 path is the port's exactness reference).  At S 2048,
// hd 128, 12/2 heads, B 2 the causal half is 25.8 GFLOP, 0.385 ms at the
// 67 TFLOP/s f32 rate; the bytes are far below it, so the FMAs bound it.
// The first port staged K and then V through one shared buffer by plain
// loads (four __syncthreads per key tile, no copy overlapping a product)
// and read one 4-byte shared word for every two FMAs.  The design:
//   * one CTA of 256 threads (16 row groups x 16 column threads) per
//     (64-row query tile, query head, batch), heaviest tiles first; row
//     group g owns rows g + 16 i (i < 4), column thread c keys c and c + 16
//     of each 32-key tile for the scores, and hd columns 4 c .. 4 c + 3
//     (and 64 + 4 c .. + 3 at hd > 64) for the output: registers hold 4 x 2
//     scores and 4 x 8 output sums a thread, and the row max and row sum
//     are reduced over the half-warp of a row with four xor shuffles (8
//     rows a thread and 128 threads give each warp more reuse but leave an
//     SM 8 warps, and ran slower on the card);
//   * Q (64 rows), K and V (32 rows each, separate buffers, double
//     buffered) in shared memory as f32, rows padded by 4 floats; K and V
//     of tile t + 1 are copied by cp.async (16-byte chunks, zero-filled
//     past S and past hd) while tile t is multiplied: two __syncthreads per
//     key tile (the tile landed; P complete);
//   * Q K^T reads Q and K rows as float4 along hd (6 16-byte reads per 32
//     FMAs); P goes through a (64, 48) shared tile and P V reads it as
//     float4 along the keys and V as float4 along hd (12 reads per 128
//     FMAs).  Warps read Q and P two rows at a time (broadcast) and K and
//     V 16 rows at a time: no bank conflicts;
//   * hd is padded in shared memory to 64 or 128 (two instantiations);
//     the zero columns add nothing to Q K^T and are never stored.
//   Shared memory: (64 + 4 x 32) rows x (hd_pad + 4) + 64 x 48 floats =
//   111.0 KB at hd 128 (two CTAs, 16 warps, per SM), 63.0 KB at hd 64.
//   What still bounds it (PERF.md): the FMAs at the f32 rate, with the
//   softmax's exp and shuffles and the shared reads in the same issue
//   slots, and 16 warps per SM to hide the shared-memory latency.
//
// Both: key tiles wholly above the diagonal are skipped (their masked
// contribution is exactly 0); within the diagonal tile and past a ragged
// S the scores are masked to -1e30, whose exp underflows to 0 against any
// unmasked max, and a row with nothing unmasked yet keeps m = -1e30
// (exp(0) terms that the first unmasked tile rescales by
// exp(-1e30 - m) = 0).
//
// Row statistics (the training forward): when ``stats`` is not null, both
// bodies also write each row's final running max m (in the units of the
// scaled scores, natural log: the kernel exponentiates with __expf) and
// its denominator l (the f32 sum of the unrounded p) as f32, m at
// stats[(b * Hq + h) * Sq + i] and l at stats[B * Hq * Sq + (b * Hq + h) *
// Sq + i]: the (m, l) of the reference's _flash_fwd_inner, which the
// blockwise backward recomputes p from.  Rows past Sq are not written.  One
// lane of the lanes that hold a row writes it (a quad in the bf16 body, 16
// column lanes in the f32 body), after the reduction that already gives
// every lane of the row the same value.  The serving launch passes null.
//
// Limits (the Python wrapper checks them first): bf16 or f32, q/k/v of
// one dtype, hd <= 128 and a multiple of 8, Hq a multiple of Hkv,
// 0 <= q_off and q_off + Sq <= Skv.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tensor_core.cuh"

namespace {

constexpr int kBK = 64;        // key rows per tile of the bf16 body
constexpr int kMaxHd = 128;
constexpr float kNegInf = -1e30f;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* stats;  // null, or (2, B, Hq, Sq) f32: m then l
  int B, Sq, Skv, q_off, Hq, Hkv, hd;
  float scale;
};

// row (b, h, s)'s (m, l) into the statistics, when asked for
__device__ __forceinline__ void store_stats(const Args& a, int b, int h, int s, float m,
                                            float l) {
  const size_t i = (static_cast<size_t>(b) * a.Hq + h) * a.Sq + s;
  a.stats[i] = m;
  a.stats[static_cast<size_t>(a.B) * a.Hq * a.Sq + i] = l;
}

// ---------------------------------------------------------------------------
// bf16: tensor-core body
// ---------------------------------------------------------------------------
constexpr int kTcBQ = 128;    // query rows per CTA
constexpr int kTcWarps = 8;   // 16 query rows each
constexpr int kTcThreads = kTcWarps * 32;

template <int HDP>  // head dim padded in shared memory: 64 or 128
constexpr size_t tc_smem_bytes() {
  return static_cast<size_t>(kTcBQ + 4 * kBK) * (HDP + 8) * sizeof(__nv_bfloat16);
}

// OFFSET false: the whole sequence (q_off = 0, Skv = Sq known at compile
// time, so the launch is the one without the offset, at its time)
template <int HDP, bool OFFSET>
__global__ void __launch_bounds__(kTcThreads) flash_fwd_tc(const Args a) {
  using nq_tc::ldmatrix_x4;
  using nq_tc::mma_bf16;
  using nq_tc::smem_u32;
  constexpr int LD = HDP + 8;    // row stride (elements): 16 bytes of padding
  constexpr int KS = HDP / 16;   // k16 steps over hd in Q K^T
  constexpr int NT = HDP / 8;    // n8 tiles over hd in P V
  constexpr int CH = HDP / 8;    // 16-byte chunks per row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // (128, LD)
  __nv_bfloat16* ks = qs + kTcBQ * LD;                              // 2 x (64, LD)
  __nv_bfloat16* vs = ks + 2 * kBK * LD;                            // 2 x (64, LD)

  const int qt = gridDim.x - 1 - blockIdx.x;   // heaviest tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (a.Hq / a.Hkv);
  const int q0 = qt * kTcBQ;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(a.q);
  const __nv_bfloat16* k = static_cast<const __nv_bfloat16*>(a.k);
  const __nv_bfloat16* v = static_cast<const __nv_bfloat16*>(a.v);
  const int q_off = OFFSET ? a.q_off : 0;
  const int Skv = OFFSET ? a.Skv : a.Sq;

  // rows [r0, r0 + rows) of head hh of a (B, S, H, hd) tensor -> (rows,
  // LD); rows past S and columns past hd are zero-filled
  auto load_tile = [&](__nv_bfloat16* dst, const __nv_bfloat16* src, int r0, int rows, int hh,
                       int H, int S) {
    for (int i = threadIdx.x; i < rows * CH; i += kTcThreads) {
      const int r = i / CH;
      const int c = (i - r * CH) * 8;
      const bool ok = r0 + r < S && c < a.hd;
      const __nv_bfloat16* p =
          ok ? src + ((static_cast<size_t>(b) * S + r0 + r) * H + hh) * a.hd + c : src;
      nq_tc::cp_async<16>(smem_u32(dst + r * LD + c), p, ok);
    }
  };

  const int last_q = q_off + min(q0 + kTcBQ, a.Sq) - 1;  // as a key position
  const int n_tiles = last_q / kBK + 1;  // tiles with a key <= the last query
  load_tile(qs, q, q0, kTcBQ, h, a.Hq, a.Sq);
  load_tile(ks, k, 0, kBK, hk, a.Hkv, Skv);
  load_tile(vs, v, 0, kBK, hk, a.Hkv, Skv);
  nq_tc::cp_async_commit();

  uint32_t qf[KS][4];
  float o[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};               // this lane's part of the row sums
  const int row0 = q0 + warp * 16 + g;   // this lane's rows: row0, row0 + 8
  // this warp's last query row that exists, as a key position: key tiles
  // past it are wholly masked for the warp (their p is exactly 0) and are
  // skipped
  const int warp_last =
      q0 + warp * 16 < a.Sq ? q_off + min(q0 + warp * 16 + 15, a.Sq - 1) : -1;

  for (int kt = 0; kt < n_tiles; ++kt) {
    nq_tc::cp_async_wait_all();
    __syncthreads();                     // tile kt landed; tile kt - 1 consumed
    if (kt + 1 < n_tiles) {              // prefetch tile kt + 1 into the other buffer
      const int nb = (kt + 1) & 1;
      load_tile(ks + nb * kBK * LD, k, (kt + 1) * kBK, kBK, hk, a.Hkv, Skv);
      load_tile(vs + nb * kBK * LD, v, (kt + 1) * kBK, kBK, hk, a.Hkv, Skv);
      nq_tc::cp_async_commit();
    }
    if (kt == 0) {
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        ldmatrix_x4(qf[kk], smem_u32(qs + (warp * 16 + (lane & 15)) * LD + kk * 16 +
                                     (lane >> 4) * 8));
      }
    }
    const __nv_bfloat16* kb = ks + (kt & 1) * kBK * LD;
    const __nv_bfloat16* vb = vs + (kt & 1) * kBK * LD;
    const int k0 = kt * kBK;
    if (k0 > warp_last) continue;        // still at the next tile's barrier

    // S = Q K^T: 16 rows x 64 keys per warp, 8 n8 tiles
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
      for (int jp = 0; jp < 4; ++jp) {   // keys jp*16 .. +15: two n8 tiles
        uint32_t bf[4];
        ldmatrix_x4(bf, smem_u32(kb + (jp * 16 + (lane & 7) + ((lane >> 4) << 3)) * LD +
                                 kk * 16 + ((lane >> 3) & 1) * 8));
        mma_bf16(s[2 * jp], qf[kk], bf[0], bf[1]);
        mma_bf16(s[2 * jp + 1], qf[kk], bf[2], bf[3]);
      }
    }

    // online softmax over this tile: scale, mask, row max / sum in f32
    const bool masked = k0 + kBK - 1 > q_off + q0 + warp * 16 || k0 + kBK > Skv;
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float val = s[j][e] * a.scale;
        if (masked) {
          const int kpos = k0 + j * 8 + 2 * t4 + (e & 1);
          const int qpos = q_off + row0 + (e >> 1) * 8;
          if (kpos > qpos || kpos >= Skv) val = kNegInf;
        }
        s[j][e] = val;
        mx[e >> 1] = fmaxf(mx[e >> 1], val);
      }
    }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      corr[r] = __expf(m[r] - mx[r]);
      m[r] = mx[r];
      l[r] *= corr[r];
    }
    // P, rounded to bf16, re-packed as the A fragments of 4 k16 steps
    uint32_t pf[4][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float p0 = __expf(s[j][0] - m[0]);
      const float p1 = __expf(s[j][1] - m[0]);
      const float p2 = __expf(s[j][2] - m[1]);
      const float p3 = __expf(s[j][3] - m[1]);
      l[0] += p0 + p1;
      l[1] += p2 + p3;
      pf[j >> 1][(j & 1) * 2] = nq_tc::pack_bf16(p0, p1);
      pf[j >> 1][(j & 1) * 2 + 1] = nq_tc::pack_bf16(p2, p3);
    }
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      o[n][0] *= corr[0];
      o[n][1] *= corr[0];
      o[n][2] *= corr[1];
      o[n][3] *= corr[1];
    }
    // O += P V: V (keys x hd) row-major is the k-major B operand -> .trans
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t bf[4];
        nq_tc::ldmatrix_x4_trans(
            bf, smem_u32(vb + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + np * 16 +
                         (lane >> 4) * 8));
        mma_bf16(o[2 * np], pf[kk], bf[0], bf[1]);
        mma_bf16(o[2 * np + 1], pf[kk], bf[2], bf[3]);
      }
    }
  }

  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(a.o);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int qpos = row0 + r * 8;         // this block's row
    if (qpos >= a.Sq) continue;
    if (a.stats != nullptr && t4 == 0) store_stats(a, b, h, qpos, m[r], l[r]);
    const float inv = 1.f / fmaxf(l[r], 1e-30f);
    __nv_bfloat16* orow = out + ((static_cast<size_t>(b) * a.Sq + qpos) * a.Hq + h) * a.hd;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int col = n * 8 + 2 * t4;
      if (col < a.hd) {
        *reinterpret_cast<uint32_t*>(orow + col) =
            nq_tc::pack_bf16(o[n][2 * r] * inv, o[n][2 * r + 1] * inv);
      }
    }
  }
}

template <int HDP, bool OFFSET>
int launch_tc(const Args& a, cudaStream_t stream) {
  // opt in above 48 KB once, before any graph capture
  static cudaError_t opt_in =
      cudaFuncSetAttribute(flash_fwd_tc<HDP, OFFSET>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(tc_smem_bytes<HDP>()));
  if (opt_in != cudaSuccess) return static_cast<int>(opt_in);
  const dim3 grid((a.Sq + kTcBQ - 1) / kTcBQ, a.Hq, a.B);
  flash_fwd_tc<HDP, OFFSET><<<grid, kTcThreads, tc_smem_bytes<HDP>(), stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// f32: CUDA-core body
// ---------------------------------------------------------------------------
constexpr int kF32BQ = 64;              // query rows per CTA
constexpr int kF32BKV = 32;             // key rows per tile
constexpr int kF32Threads = 256;        // row groups x 16 column threads
constexpr int kF32Groups = kF32Threads / 16;  // row group g owns rows g + kF32Groups i
constexpr int kF32Rows = kF32BQ / kF32Groups;  // query rows per thread
constexpr int kF32LDP = kF32BKV + 16;   // probability tile row stride (floats)

template <int HDP>  // head dim padded in shared memory: 64 or 128
constexpr size_t f32_smem_bytes() {
  return (static_cast<size_t>(kF32BQ + 4 * kF32BKV) * (HDP + 4) + kF32BQ * kF32LDP) *
         sizeof(float);
}

// OFFSET false: the whole sequence (q_off = 0, Skv = Sq known at compile
// time), as for the bf16 body
template <int HDP, bool OFFSET>
__global__ void __launch_bounds__(kF32Threads, 2) flash_fwd(const Args a) {
  constexpr int LD = HDP + 4;    // row stride (floats): 16 bytes of padding
  constexpr int CH = HDP / 4;    // 16-byte chunks per row
  constexpr int OC = HDP / 64;   // output chunks per thread: 4 (cl + 16 c) .. + 3
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                                // (64, LD)
  float* ks = qs + kF32BQ * LD;                    // 2 x (32, LD)
  float* vs = ks + 2 * kF32BKV * LD;               // 2 x (32, LD)
  float* ps = vs + 2 * kF32BKV * LD;               // (64, LDP) probabilities

  const int qt = gridDim.x - 1 - blockIdx.x;   // heaviest tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (a.Hq / a.Hkv);
  const int q0 = qt * kF32BQ;
  const int lane = threadIdx.x & 31;
  const int rg = ((threadIdx.x >> 5) << 1) + (lane >> 4);   // rows rg + kF32Groups i
  const int cl = lane & 15;                                  // keys cl + 16 u (u < 2)
  const float* q = static_cast<const float*>(a.q);
  const float* k = static_cast<const float*>(a.k);
  const float* v = static_cast<const float*>(a.v);
  const int q_off = OFFSET ? a.q_off : 0;
  const int Skv = OFFSET ? a.Skv : a.Sq;

  // rows [r0, r0 + rows) of head hh of a (B, S, H, hd) tensor -> (rows,
  // LD); rows past S and columns past hd are zero-filled
  auto load_tile = [&](float* dst, const float* src, int r0, int rows, int hh, int H, int S) {
    for (int i = threadIdx.x; i < rows * CH; i += kF32Threads) {
      const int r = i / CH;
      const int c = (i - r * CH) * 4;
      const bool ok = r0 + r < S && c < a.hd;
      const float* p = ok ? src + ((static_cast<size_t>(b) * S + r0 + r) * H + hh) * a.hd + c
                          : src;
      nq_tc::cp_async<16>(nq_tc::smem_u32(dst + r * LD + c), p, ok);
    }
  };

  const int last_q = q_off + min(q0 + kF32BQ, a.Sq) - 1;  // as a key position
  const int n_tiles = last_q / kF32BKV + 1;  // tiles with a key <= the last query
  load_tile(qs, q, q0, kF32BQ, h, a.Hq, a.Sq);
  load_tile(ks, k, 0, kF32BKV, hk, a.Hkv, Skv);
  load_tile(vs, v, 0, kF32BKV, hk, a.Hkv, Skv);
  nq_tc::cp_async_commit();

  float m[kF32Rows], l[kF32Rows], acc[kF32Rows][4 * OC];
#pragma unroll
  for (int i = 0; i < kF32Rows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 4 * OC; ++j) acc[i][j] = 0.f;
  }

  for (int kt = 0; kt < n_tiles; ++kt) {
    nq_tc::cp_async_wait_all();
    __syncthreads();                   // tile kt landed; tile kt - 1 and its P consumed
    if (kt + 1 < n_tiles) {            // prefetch tile kt + 1 into the other buffers
      const int nb = (kt + 1) & 1;
      load_tile(ks + nb * kF32BKV * LD, k, (kt + 1) * kF32BKV, kF32BKV, hk, a.Hkv, Skv);
      load_tile(vs + nb * kF32BKV * LD, v, (kt + 1) * kF32BKV, kF32BKV, hk, a.Hkv, Skv);
      nq_tc::cp_async_commit();
    }
    const float* kb = ks + (kt & 1) * kF32BKV * LD;
    const float* vb = vs + (kt & 1) * kF32BKV * LD;
    const int k0 = kt * kF32BKV;

    // S = Q K^T: kF32Rows rows x 2 keys per thread, float4 along hd
    float s[kF32Rows][2];
#pragma unroll
    for (int i = 0; i < kF32Rows; ++i) s[i][0] = s[i][1] = 0.f;
#pragma unroll
    for (int d = 0; d < HDP; d += 4) {
      const float4 k0v = *reinterpret_cast<const float4*>(kb + cl * LD + d);
      const float4 k1v = *reinterpret_cast<const float4*>(kb + (cl + 16) * LD + d);
#pragma unroll
      for (int i = 0; i < kF32Rows; ++i) {
        const float4 qv = *reinterpret_cast<const float4*>(qs + (rg + kF32Groups * i) * LD + d);
        s[i][0] = fmaf(qv.x, k0v.x, s[i][0]);
        s[i][0] = fmaf(qv.y, k0v.y, s[i][0]);
        s[i][0] = fmaf(qv.z, k0v.z, s[i][0]);
        s[i][0] = fmaf(qv.w, k0v.w, s[i][0]);
        s[i][1] = fmaf(qv.x, k1v.x, s[i][1]);
        s[i][1] = fmaf(qv.y, k1v.y, s[i][1]);
        s[i][1] = fmaf(qv.z, k1v.z, s[i][1]);
        s[i][1] = fmaf(qv.w, k1v.w, s[i][1]);
      }
    }

    // online softmax over this tile: scale, mask, row max / sum over the
    // 16 column threads of a row (one half-warp)
    const bool masked = k0 + kF32BKV - 1 > q_off + q0 || k0 + kF32BKV > Skv;
#pragma unroll
    for (int i = 0; i < kF32Rows; ++i) {
      const int qpos = q_off + q0 + rg + kF32Groups * i;
      float mx = kNegInf;
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        float val = s[i][u] * a.scale;
        if (masked) {
          const int kpos = k0 + cl + 16 * u;
          if (kpos > qpos || kpos >= Skv) val = kNegInf;
        }
        s[i][u] = val;
        mx = fmaxf(mx, val);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float corr = __expf(m[i] - m_new);
      const float p0 = __expf(s[i][0] - m_new);
      const float p1 = __expf(s[i][1] - m_new);
      ps[(rg + kF32Groups * i) * kF32LDP + cl] = p0;   // p.astype(v.dtype): f32 as it is
      ps[(rg + kF32Groups * i) * kF32LDP + cl + 16] = p1;
      float sum = p0 + p1;
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < 4 * OC; ++j) acc[i][j] *= corr;
    }
    __syncthreads();                   // P complete

    // O += P V: kF32Rows rows x 4 * OC columns per thread, float4 along the keys
    // (P) and along hd (V)
#pragma unroll
    for (int j = 0; j < kF32BKV; j += 4) {
      float4 vv[4][OC];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
        for (int c = 0; c < OC; ++c) {
          vv[jj][c] = *reinterpret_cast<const float4*>(vb + (j + jj) * LD + 4 * (cl + 16 * c));
        }
      }
#pragma unroll
      for (int i = 0; i < kF32Rows; ++i) {
        const float4 pv =
            *reinterpret_cast<const float4*>(ps + (rg + kF32Groups * i) * kF32LDP + j);
        const float pj[4] = {pv.x, pv.y, pv.z, pv.w};
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
          for (int c = 0; c < OC; ++c) {
            acc[i][4 * c] = fmaf(pj[jj], vv[jj][c].x, acc[i][4 * c]);
            acc[i][4 * c + 1] = fmaf(pj[jj], vv[jj][c].y, acc[i][4 * c + 1]);
            acc[i][4 * c + 2] = fmaf(pj[jj], vv[jj][c].z, acc[i][4 * c + 2]);
            acc[i][4 * c + 3] = fmaf(pj[jj], vv[jj][c].w, acc[i][4 * c + 3]);
          }
        }
      }
    }
  }

  float* o = static_cast<float*>(a.o);
#pragma unroll
  for (int i = 0; i < kF32Rows; ++i) {
    const int qpos = q0 + rg + kF32Groups * i;   // this block's row
    if (qpos >= a.Sq) continue;
    if (a.stats != nullptr && cl == 0) store_stats(a, b, h, qpos, m[i], l[i]);
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
    float* orow = o + ((static_cast<size_t>(b) * a.Sq + qpos) * a.Hq + h) * a.hd;
#pragma unroll
    for (int c = 0; c < OC; ++c) {
      const int col = 4 * (cl + 16 * c);
      if (col < a.hd) {
        *reinterpret_cast<float4*>(orow + col) =
            make_float4(acc[i][4 * c] * inv, acc[i][4 * c + 1] * inv, acc[i][4 * c + 2] * inv,
                        acc[i][4 * c + 3] * inv);
      }
    }
  }
}

template <int HDP, bool OFFSET>
int launch_f32(const Args& a, cudaStream_t stream) {
  // opt in above 48 KB once, before any graph capture
  static cudaError_t opt_in =
      cudaFuncSetAttribute(flash_fwd<HDP, OFFSET>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(f32_smem_bytes<HDP>()));
  if (opt_in != cudaSuccess) return static_cast<int>(opt_in);
  const dim3 grid((a.Sq + kF32BQ - 1) / kF32BQ, a.Hq, a.B);
  flash_fwd<HDP, OFFSET><<<grid, kF32Threads, f32_smem_bytes<HDP>(), stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// q (B, Sq, Hq, hd), k/v (B, Skv, Hkv, hd), o like q; all contiguous, one
// dtype (bf16 when is_bf16, else f32); query row i at key position
// q_off + i, q_off >= 0 and q_off + Sq <= Skv.  stats: null, or
// (2, B, Hq, Sq) f32 for each row's (m, l).
int nq_flash_attention(const void* q, const void* k, const void* v, void* o, float* stats,
                       int is_bf16, int B, int Sq, int Skv, int q_off, int Hq, int Hkv,
                       int hd, float scale, void* stream) {
  if (B < 1 || Sq < 1 || q_off < 0 || q_off + Sq > Skv || Hkv < 1 || Hq < Hkv ||
      Hq % Hkv != 0 || hd < 8 || hd > kMaxHd || hd % 8 != 0 || Hq > 65535 || B > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a = {q, k, v, o, stats, B, Sq, Skv, q_off, Hq, Hkv, hd, scale};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_off == 0 && Sq == Skv) {  // the whole sequence
    if (!is_bf16) return hd <= 64 ? launch_f32<64, false>(a, s) : launch_f32<128, false>(a, s);
    return hd <= 64 ? launch_tc<64, false>(a, s) : launch_tc<128, false>(a, s);
  }
  if (!is_bf16) return hd <= 64 ? launch_f32<64, true>(a, s) : launch_f32<128, true>(a, s);
  return hd <= 64 ? launch_tc<64, true>(a, s) : launch_tc<128, true>(a, s);
}

}  // extern "C"
