// Hand-written Hopper (sm_90a) short-prefill body of the three weight
// matmuls K1-K3 (stream_matmul_mid): bf16 activations at M 9-64, the fourth
// body beside nest_matmul.cu's decode, CUDA-core and tensor-core bodies.
// It computes what those compute for
//
//   nq_mid_matmul  repro/kernels/packed_matmul/kernel.py:48 packed_matmul
//                  (rung 0), repro/kernels/nested_matmul/kernel.py:61
//                  nested_matmul (rung 1) and :125 ladder_matmul (rungs >= 2)
//
// y[M, N] = (x[M, K] @ W[K, N]) * scale[N], W the INT codes chain-recomposed
// from 1..4 block-packed streams, each code cast to bf16 as the TPU kernel
// does (exact up to 9 bits, nearest even above), products summed in f32,
// the scale applied once, the output bf16 or f32 (the LM head).
//
// What bounds it: at M <= 64 a code is worth <= 128 flops, far below the
// card's ridge, so the bound is the bytes of the packed words (4 / 7 / 10
// bits per weight at rungs 0 / 1 / 2 of an (8, 6, 4) ladder) and in
// practice the integer instructions that unpack them.  The CUDA-core body
// unpacked every word once per 8 rows (4 times at M 32, 8 at M 63) on a
// general per-column path and ran 16 FMAs per code per 8 rows.  The design:
//   * the decode body's units and an even run of work items per CTA:
//     items (a column tile x a pack block x a chunk of units) numbered
//     tile-major, so a CTA's run stays in one tile across pack blocks and
//     sums it in registers; one CTA per item, or, above two CTAs per SM,
//     runs of items.  The tile is the widest of 64, 32 and 16 columns whose
//     tiles times pack blocks reach one item per SM (k/v at N 256 and q/o
//     at 1536 take 16 and 32), and chunks shrink until the items do;
//   * a ring of 2 stages of cp.async copies (16-byte; 8- or 4-byte where N
//     % 4 != 0 or a stream's base is misaligned): the chunk's word rows and
//     the chunk's x for every token row, the next item's in flight while
//     this one is unpacked.  Each word is loaded and unpacked once per
//     call, for every row;
//   * the products run on the tensor cores, with A and B swapped: y^T =
//     W^T x^T, one mma.sync m16n8k16 bf16 -> f32 per 16 columns x 16 codes
//     x 8 tokens.  Each warp takes 16 columns of the tile (the tile's 1, 2
//     or 4 column groups each split over 8, 4 or 2 warps by rows of the
//     chunk); lane (g, t) unpacks columns g and g + 8 of two neighbouring
//     widest-component word rows in registers and packs their codes
//     straight into the A fragment; M rides on the n side in 8-token
//     tiles, so no row is padded past the next multiple of 8;
//   * the permutation goes on x, never on the words: a word holds the
//     codes of elements p = j * rmax + r (slot j), which are not contiguous
//     in K.  The chunk's x is staged in the chunk's order k' = j * rows +
//     idx (idx the widest row within the chunk; each (slot, unit row) a run
//     of G neighbours in K, one copy each), and a lane's k positions (2t,
//     2t+1) are rows idx, idx + 1 at one slot, (2t+8, 2t+9) the same rows
//     at the next: each half of a B fragment is one 4-byte shared load
//     (token rows 8 elements past the chunk apart: 32 banks).  Any
//     consistent order of K gives the same sum;
//   * the packed-field path (every stream's code fits w_max bits, codes
//     <= 9 bits: the served (8, 6, 4) ladder) merges each stream's
//     components into one word per column (the decode body's unpack: per
//     slot and stream one LOP3 and one FADD, the chain recompose on exact
//     f32 integers), then two codes per cvt into a bf16 pair.  Other
//     ladders (codes over 9 bits, 16-bit codes, chunks of one-row units
//     or under 8 rows) take the general path: each code assembled from
//     its components' fields, clipped in integers and rounded to bf16 as
//     code_as does;
//   * one launch per matmul, deterministic, no float atomics: the warps of
//     a column group add their fragments in shared memory in rank order; a
//     CTA's run of items of one tile writes the sum into its own f32 slot;
//     the run that brings the tile's arrival count (the per-tile int32
//     counters the decode body shares, 0 between launches) to all the
//     tile's items adds the tile's slots in CTA order, four columns a
//     thread, applies the scale, casts and resets the count.  A run that
//     holds a whole tile writes the output directly.
//   What still bounds it (PERF.md): the unpack on the integer pipe, the
//   partial slots' f32 traffic at large M, and short launches.
//
// Limits (the Python wrappers check them first): bf16 x, 1 <= M <= 64,
// 1..4 streams, every bitwidth <= 16, pack block a multiple of 32 and <=
// 512; cudaErrorInvalidValue otherwise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "nest_matmul.cuh"
#include "tensor_core.cuh"

namespace {

using namespace nq_mm;

constexpr int kMidWarps = 8;
constexpr int kMidThreads = kMidWarps * 32;
constexpr int kMidStages = 2;                // ring stages: chunks in flight or unpacked
constexpr int kMidStageBytes = 48 * 1024;    // words and x (64 rows) of one chunk: a stage
constexpr int kMidMaxM = 64;                 // 8 token tiles of 8
constexpr int kMidItems = 1;                 // work items per SM the plan aims for
constexpr int kMidCtasPerSm = 2;             // CTAs per SM the grid takes at most
constexpr int kMidMaxSmem = 227 * 1024;

// until at most N of the committed copy groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait_group() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// tile nt's B fragment for lane (g, t): b0 the 4 bytes at xq0, b1 at xq1,
// nt * 8 token rows further
__device__ __forceinline__ void mid_mma(const Args& a, const uint32_t (&af)[4],
                                        const __nv_bfloat16* xq0, const __nv_bfloat16* xq1,
                                        float (&acc)[8][4]) {
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    if (nt < a.mtiles) {
      const int o = nt * 8 * a.ldx;
      nq_tc::mma_bf16(acc[nt], af, *reinterpret_cast<const uint32_t*>(xq0 + o),
                      *reinterpret_cast<const uint32_t*>(xq1 + o));
    }
  }
}

// Packed-field path over one chunk.  MMA row group i takes the chunk's
// widest rows i .. i+7 (in the decode body's order idx = t_unit * G +
// rho'); lane t the adjacent rows 2t and 2t + 1 of it (G >= 2: one unit
// row, neighbours in K), and step h their slots 2h and 2h + 1.  Its k
// positions 2t, 2t+1 are (row 2t, row 2t+1) at slot 2h and 2t+8, 2t+9 the
// same at slot 2h + 1: each pair two neighbouring elements of x.  The wpc
// warps of a column group split the (row group, run of steps) units.
template <int NS>
__device__ __forceinline__ void mid_spread(const Args& a, const uint32_t* wb,
                                           const __nv_bfloat16* xc, int rows, int col0,
                                           int wr, int wpc, int g, int t, float (&acc)[8][4]) {
  const int G = 1 << a.g_log;
  const int ldw = (1 << a.bn_log) + 4;
  const int groups = rows >> 3;
  const int steps = a.slots >> 1;
  int split = 1;                                         // runs of steps a row group
  while (split < steps && groups * split < wpc) split <<= 1;
  const int per = steps / split;
  for (int unit = wr; unit < groups * split; unit += wpc) {
    const int idx = (unit / split) * 8 + 2 * t;
    const int h0 = (unit % split) * per;
    const int rp = idx & (G - 1);                       // rows idx and idx + 1
    const int tu = idx >> a.g_log;
    uint32_t u[NS][4];                                   // (row, column): 2 x 2
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      u[s][0] = u[s][1] = u[s][2] = u[s][3] = 0u;
#pragma unroll
      for (int c = 0; c < kMaxComps; ++c) {
        if (c < a.s[s].ncomp) {
          const int glog = a.s[s].glog[c];
          const int row = ((a.s[s].cbase[c] + (tu & ((1 << glog) - 1))) << a.g_log) + rp;
          const uint32_t* wr0 = wb + row * ldw + col0;
          // bit of slot 2 h0 for these rows
          const int sh = (tu >> glog) * a.s[s].w[c] + 2 * h0 * a.wmax;
          const uint32_t m = a.s[s].spread[c];
          const int cs = a.s[s].cs[c];
          u[s][0] |= ((wr0[0] >> sh) & m) << cs;
          u[s][1] |= ((wr0[8] >> sh) & m) << cs;
          u[s][2] |= ((wr0[ldw] >> sh) & m) << cs;
          u[s][3] |= ((wr0[ldw + 8] >> sh) & m) << cs;
        }
      }
    }
    const __nv_bfloat16* xr = xc + g * a.ldx + idx;   // x of rows idx, idx + 1 at slot 0
    for (int h = h0; h < h0 + per; ++h) {
      float code[2][4];                                  // (slot 2h, 2h + 1), (row, column)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
#pragma unroll
        for (int s = 0; s < NS; ++s) {
          const Stream& st = a.s[s];
          const uint32_t field = (1u << st.code_bits) - 1u;
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const float v = __uint_as_float((u[s][k] & field) ^ st.fbias) - st.foff;
            u[s][k] >>= a.wmax;
            code[half][k] = (s == 0) ? v : fmaxf(fmaf(code[half][k], st.fmul, v), st.flo);
          }
        }
      }
      // a0 (column g; rows r, r + 1 at slot 2h), a1 (column g + 8), a2 and
      // a3 the same at slot 2h + 1
      const uint32_t af[4] = {nq_tc::pack_bf16(code[0][0], code[0][2]),
                              nq_tc::pack_bf16(code[0][1], code[0][3]),
                              nq_tc::pack_bf16(code[1][0], code[1][2]),
                              nq_tc::pack_bf16(code[1][1], code[1][3])};
      const __nv_bfloat16* xq = xr + 2 * h * rows;
      mid_mma(a, af, xq, xq + rows, acc);
    }
  }
}

// The code of column `col` (of the staged tile) at chunk row idx, slot j,
// assembled from its components' fields, sign-extended and clipped per
// level in integers.
template <int NS>
__device__ __forceinline__ int mid_code(const Args& a, const uint32_t* wb, int col, int idx,
                                        int j) {
  const int ldw = (1 << a.bn_log) + 4;
  const int rp = idx & ((1 << a.g_log) - 1);
  const int tu = idx >> a.g_log;
  int code = 0;
#pragma unroll
  for (int s = 0; s < NS; ++s) {
    uint32_t u = 0u;
#pragma unroll
    for (int c = 0; c < kMaxComps; ++c) {
      if (c < a.s[s].ncomp) {
        const int glog = a.s[s].glog[c];
        const int row = ((a.s[s].cbase[c] + (tu & ((1 << glog) - 1))) << a.g_log) + rp;
        const int bit = (tu >> glog) * a.s[s].w[c] + j * a.wmax;
        u |= ((wb[row * ldw + col] >> bit) & ((1u << a.s[s].w[c]) - 1u)) << a.s[s].cs[c];
      }
    }
    const int up = 32 - a.s[s].code_bits;            // sign-extend the field
    const int v = static_cast<int>(u << up) >> up;
    code = (s == 0) ? v : min(max(code * (1 << a.gap[s]) + v, a.lo[s]), a.hi[s]);
  }
  return code;
}

// General path over one chunk (codes over 9 bits, a stream wider than
// w_max, or a chunk of fewer than 8 rows or of one-row units): the chunk's
// elements k' = j * rows + idx in fours, lane t the four k' = 4 (q + t)
// .. + 3 of MMA step q / 4 (steps split over the wpc warps of a column
// group), each code assembled by mid_code; the staged x holds the chunk in
// k' order, so the four are neighbours.  The bf16 pair cast rounds codes
// over 8 bits as code_as does.
template <int NS>
__device__ __forceinline__ void mid_general(const Args& a, const uint32_t* wb,
                                            const __nv_bfloat16* xc, int rows, int col0,
                                            int wr, int wpc, int g, int t,
                                            float (&acc)[8][4]) {
  const int rows_log = a.g_log + __ffs(a.umax) - 1;
  const int quads = (rows * a.slots) >> 2;
  for (int q = 4 * wr; q < quads; q += 4 * wpc) {
    float code[2][4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int k = 4 * (q + t) + e;
      const int idx = k & (rows - 1);
      const int j = k >> rows_log;
      code[0][e] = code_f32(mid_code<NS>(a, wb, col0, idx, j));
      code[1][e] = code_f32(mid_code<NS>(a, wb, col0 + 8, idx, j));
    }
    const uint32_t af[4] = {nq_tc::pack_bf16(code[0][0], code[0][1]),
                            nq_tc::pack_bf16(code[1][0], code[1][1]),
                            nq_tc::pack_bf16(code[0][2], code[0][3]),
                            nq_tc::pack_bf16(code[1][2], code[1][3])};
    const __nv_bfloat16* xq = xc + g * a.ldx + 4 * (q + t);   // x of k' = 4 (q + t) ..
    mid_mma(a, af, xq, xq + 2, acc);
  }
}

// four columns n .. n + 3 of row m (those below N), scaled and cast
__device__ __forceinline__ void store_out4(const Args& a, int m, int n, float4 v) {
  const float f[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (n + k < a.N) store_out(a, m, n + k, f[k] * a.scale[n + k]);
  }
}

// (column tile, pack block, chunk) of an item, numbered tile-major, advanced
// without division: a CTA's run stays in one tile across pack blocks, so it
// adds one run of the tile's K into one partial slot
struct MidItem {
  int T, b, c;
  __device__ __forceinline__ void next(const Args& a) {
    if (++c == a.cpb) {
      c = 0;
      if (++b == a.nk) {
        b = 0;
        ++T;
      }
    }
  }
};

template <int NS>
__global__ void __launch_bounds__(kMidThreads, kMidCtasPerSm) stream_matmul_mid(const Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int G = 1 << a.g_log;
  const int bn = 1 << a.bn_log;
  const int ldw = bn + 4;                              // staged word row stride
  const int ldr = bn + 4;                              // red row stride
  const int mpad = a.mtiles * 8;
  const int rows = a.umax << a.g_log;                  // widest rows a chunk
  const int word_words = a.wpu * G * ldw;              // a stage: words, then x
  const int stage_words = word_words + ((mpad * a.ldx) >> 1);
  float* red = reinterpret_cast<float*>(smem_raw);                       // (mpad, ldr) f32
  uint32_t* ring = reinterpret_cast<uint32_t*>(red + mpad * ldr);        // kMidStages
  const uint32_t** ubase = reinterpret_cast<const uint32_t**>(ring + kMidStages * stage_words);
  long long* ustep = reinterpret_cast<long long*>(ubase + a.wpu);        // (wpu) each
  int* flag = reinterpret_cast<int*>(ustep + a.wpu);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int ncg_log = a.bn_log - 4;                    // column groups of 16
  const int wpc = kMidWarps >> ncg_log;                // warps per column group
  const int wr = warp >> ncg_log;                      // this warp's rank in its group
  const int col0 = ((warp & ((1 << ncg_log) - 1)) << 4) + g;   // columns col0, col0 + 8
  const long W = a.nitems;
  const long P = gridDim.x;
  const int start = static_cast<int>(blockIdx.x * W / P);
  const int end = static_cast<int>((blockIdx.x + 1) * W / P);
  const int per_tile = a.nk * a.cpb;

  // every component's word rows of the chunk's units, bn columns each:
  // stage row sr = (cbase_c + tt) * G + rho' holds component c's block row
  // off_c + tt * rmin + rho0 + rho'; unit row ur = cbase_c + tt starts at
  // ubase[ur] in block 0 and ustep[ur] words further in each next block
  for (int ur = threadIdx.x; ur < a.wpu; ur += kMidThreads) {
#pragma unroll
    for (int s = 0; s < NS; ++s) {
#pragma unroll
      for (int c = 0; c < kMaxComps; ++c) {
        const int tt = ur - a.s[s].cbase[c];
        if (c < a.s[s].ncomp && tt >= 0 && tt < (1 << a.s[s].glog[c])) {
          ubase[ur] = a.s[s].words + static_cast<size_t>(a.s[s].off[c] + tt * a.rmin) * a.N;
          ustep[ur] = static_cast<long long>(a.s[s].rows_pb) * a.N;
        }
      }
    }
  }
  __syncthreads();
  const __nv_bfloat16* x = static_cast<const __nv_bfloat16*>(a.x);
  const int umax_log = __ffs(a.umax) - 1;
  const int run_log = umax_log + __ffs(a.slots) - 1;   // runs of G elements a token row
  auto stage = [&](const MidItem& it, int buf) {
    const int n0 = it.T << a.bn_log;
    const int rho0 = it.c << a.g_log;
    uint32_t* dst = ring + buf * stage_words;
    const int cshift = a.bn_log - a.vw_shift;                  // copies per word row
    for (int i = threadIdx.x; i < (a.wpu << (a.g_log + cshift)); i += kMidThreads) {
      const int sr = i >> cshift;
      const int col = (i - (sr << cshift)) << a.vw_shift;
      const int ur = sr >> a.g_log;
      const bool ok = n0 + col < a.N;
      const uint32_t* src = ubase[ur];
      if (ok) {
        src += it.b * ustep[ur] + static_cast<size_t>(rho0 + (sr & (G - 1))) * a.N + n0 + col;
      }
      const uint32_t sd = nq_tc::smem_u32(dst + sr * ldw + col);
      switch (a.vw_shift) {
        case 2: nq_tc::cp_async<16>(sd, src, ok); break;
        case 1: nq_tc::cp_async<8>(sd, src, ok); break;
        default: nq_tc::cp_async<4>(sd, src, ok); break;
      }
    }
    // the chunk's x: element k' = j * rows + idx (widest row idx = t_unit *
    // G + rho', slot j) of token row m at m * ldx + k'; each (j, t_unit) is
    // a run of G neighbours in K.  Rows past M and elements past K are 0
    __nv_bfloat16* xd = reinterpret_cast<__nv_bfloat16*>(dst + word_words);
    const size_t k0 = static_cast<size_t>(it.b) * a.block + rho0;
    const int piece_log = a.g_log - a.vx_shift;               // copies a run
    const int row_log = run_log + piece_log;                   // copies a token row
    for (int i = threadIdx.x; i < (mpad << row_log); i += kMidThreads) {
      const int m = i >> row_log;
      const int run = (i >> piece_log) & ((1 << run_log) - 1);   // j * umax + t_unit
      const int e = (i & ((1 << piece_log) - 1)) << a.vx_shift;
      const int p = (run >> umax_log) * a.rmax + (run & (a.umax - 1)) * a.rmin + e;
      const bool ok = m < a.M && k0 + p < static_cast<size_t>(a.K);
      const __nv_bfloat16* src = ok ? x + static_cast<size_t>(m) * a.K + k0 + p : x;
      __nv_bfloat16* d = xd + m * a.ldx + (run << a.g_log) + e;
      switch (a.vx_shift) {
        case 3: nq_tc::cp_async<16>(nq_tc::smem_u32(d), src, ok); break;
        case 2: nq_tc::cp_async<8>(nq_tc::smem_u32(d), src, ok); break;
        case 1: nq_tc::cp_async<4>(nq_tc::smem_u32(d), src, ok); break;
        default: *d = ok ? *src : __float2bfloat16_rn(0.f); break;
      }
    }
  };

  float acc[8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;

  MidItem cur;                                                   // the item unpacked now
  cur.T = start / per_tile;
  cur.b = (start - cur.T * per_tile) / a.cpb;
  cur.c = start - cur.T * per_tile - cur.b * a.cpb;
  MidItem ahead = cur;                                           // the next to stage
#pragma unroll
  for (int k = 0; k < kMidStages; ++k) {                         // one copy group each
    if (start + k < end) stage(ahead, k);
    nq_tc::cp_async_commit();
    ahead.next(a);
  }

  int seg_items = 0;
  int buf = 0;                                                   // the item's ring stage
  for (int item = start; item < end; ++item, cur.next(a)) {
    cp_async_wait_group<kMidStages - 1>();                       // the later items may fly
    __syncthreads();                                             // the item landed
    const uint32_t* wb = ring + buf * stage_words;
    const __nv_bfloat16* xc = reinterpret_cast<const __nv_bfloat16*>(wb + word_words);
    if (a.spread) {
      mid_spread<NS>(a, wb, xc, rows, col0, wr, wpc, g, t, acc);
    } else {
      mid_general<NS>(a, wb, xc, rows, col0, wr, wpc, g, t, acc);
    }
    ++seg_items;

    if (item + 1 == end || (cur.c + 1 == a.cpb && cur.b + 1 == a.nk)) {   // the run
      // leaves the tile.  The warps of each column group add their
      // fragments into red in rank order (lane (g, t): columns col0 (c0,
      // c1) and col0 + 8 (c2, c3) of tokens nt * 8 + 2t (c0, c2) and + 1
      // (c1, c3))
      for (int w = 0; w < wpc; ++w) {
        if (wr == w) {
#pragma unroll
          for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
            for (int v = 0; v < 4; ++v) {
              if (nt < a.mtiles) {
                float* pr = red + (nt * 8 + 2 * t + (v & 1)) * ldr + col0 + 8 * (v >> 1);
                *pr = (w == 0 ? 0.f : *pr) + acc[nt][v];
              }
              acc[nt][v] = 0.f;
            }
          }
        }
        __syncthreads();
      }
      const int n0 = cur.T << a.bn_log;
      const bool whole = seg_items == per_tile;                  // the tile in one run
      const long slot = cur.T + static_cast<long>(blockIdx.x);
      const int quads = bn >> 2;                                 // 4 columns a thread
      for (int i = threadIdx.x; i < a.M * quads; i += kMidThreads) {
        const int m = i >> (a.bn_log - 2);
        const int c = (i & (quads - 1)) << 2;
        const float4 v = *reinterpret_cast<const float4*>(red + m * ldr + c);
        if (whole) {
          store_out4(a, m, n0 + c, v);
        } else {
          *reinterpret_cast<float4*>(a.partial + (slot * a.M + m) * bn + c) = v;
        }
      }
      if (!whole) {
        // arrivals count items: the run that brings the tile's count to
        // nk * cpb is the last.  The barrier orders the CTA's slot writes
        // before thread 0's fence (cumulative at gpu scope) and its count;
        // its second fence orders the others' counts before the reads
        __syncthreads();
        if (threadIdx.x == 0) {
          __threadfence();
          *flag = atomicAdd(a.counters + cur.T, seg_items) + seg_items == per_tile;
          if (*flag) __threadfence();
        }
        __syncthreads();
        if (*flag) {
          // the tile's runs: CTAs p0 .. p1, slots T + p, added in CTA order
          const long i0 = static_cast<long>(cur.T) * per_tile;
          const int p0 = dec_owner(i0, W, P);
          const int p1 = dec_owner(i0 + per_tile - 1, W, P);
          const long stride = static_cast<long>(a.M) * bn;
          for (int i = threadIdx.x; i < a.M * quads; i += kMidThreads) {
            const int m = i >> (a.bn_log - 2);
            const int c = (i & (quads - 1)) << 2;
            const float4* pm = reinterpret_cast<const float4*>(
                a.partial + (cur.T + static_cast<long>(p0)) * stride + m * bn + c);
            float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 8
            for (int k = 0; k <= p1 - p0; ++k) {
              const float4 v = __ldcg(pm + k * (stride >> 2));
              sum.x += v.x;
              sum.y += v.y;
              sum.z += v.z;
              sum.w += v.w;
            }
            store_out4(a, m, n0 + c, sum);
          }
          if (threadIdx.x == 0) a.counters[cur.T] = 0;
        }
      }
      seg_items = 0;
    }
    __syncthreads();                                             // stage buf is free
    if (item + kMidStages < end) stage(ahead, buf);
    nq_tc::cp_async_commit();
    ahead.next(a);
    buf = buf + 1 == kMidStages ? 0 : buf + 1;
  }
}

// a stage's 4-byte words: the chunk's word rows, then its x (mpad rows)
size_t mid_stage_words(const Args& a, int mpad) {
  return static_cast<size_t>(a.wpu) * (1 << a.g_log) * ((1 << a.bn_log) + 4)
         + static_cast<size_t>(mpad) * (((a.umax << a.g_log) * a.slots + 8) >> 1);
}

size_t mid_smem_bytes(const Args& a) {
  const size_t mpad = static_cast<size_t>(a.mtiles) * 8;
  return mpad * ((1 << a.bn_log) + 4) * sizeof(float)                          // red
         + static_cast<size_t>(kMidStages) * mid_stage_words(a, mpad) * 4        // ring
         + static_cast<size_t>(a.wpu) * (sizeof(void*) + sizeof(long long))    // unit rows
         + 4 * sizeof(int);                                                    // flag
}

// The tile, chunk, item and grid plan of one launch, from Args filled by
// make_args().  It reads bits, N, K, the pack block, the streams'
// alignment and the device, never M (a ring stage is sized for 64 token
// rows): kernels/build.py::mid_workspace mirrors it (a gpu test holds the
// two equal), so the dry run sizes the partials the card allocates.
void mid_plan(Args& a, int ns) {
  unit_plan(a, ns);
  // the widest column tile (64, 32, 16) whose tiles times pack blocks
  // reach kMidItems per SM; the largest chunk (a power of two of units
  // dividing rmin) whose words and x fit one ring stage, and at least 16
  // codes a column (one MMA step); then smaller chunks until the items
  // reach kMidItems per SM, while a chunk keeps 2 units, 8 widest rows and
  // 32 codes a column
  const long want = static_cast<long>(kMidItems) * device_sms();
  a.bn_log = 6;
  while (a.bn_log > 4 && ((a.N + (1 << a.bn_log) - 1) >> a.bn_log) * a.nk < want) --a.bn_log;
  a.tiles = (a.N + (1 << a.bn_log) - 1) >> a.bn_log;
  a.g_log = 0;
  while (a.rmin % (2 << a.g_log) == 0) {
    ++a.g_log;
    if (mid_stage_words(a, kMidMaxM) * 4 > static_cast<size_t>(kMidStageBytes)) {
      --a.g_log;
      break;
    }
  }
  while ((a.umax << a.g_log) * a.slots < 16) ++a.g_log;
  auto items = [&] { return static_cast<long>(a.tiles) * a.nk * (a.rmin >> a.g_log); };
  while (a.g_log > 1 && items() < want && (a.umax << (a.g_log - 1)) >= 8 &&
         (a.umax << (a.g_log - 1)) * a.slots >= 32) {
    --a.g_log;
  }
  a.cpb = a.rmin >> a.g_log;
  a.nitems = items();
  const long fit = static_cast<long>(kMidCtasPerSm) * device_sms();
  a.nctas = static_cast<int>(a.nitems < fit ? a.nitems : fit);
  a.vw_shift = word_copy_shift(a, ns);
  // the packed-field path wants units of 2 rows and 8 widest rows a chunk
  // (2 per lane t)
  a.spread = a.spread && a.g_log >= 1 && (a.umax << a.g_log) >= 8;
}

// f32 partial floats per activation row: one tile-wide slot per run (a
// tile's CTAs p0 .. p1 write slots T + p)
long mid_workspace(const Args& a) {
  return (static_cast<long>(a.tiles) + a.nctas) << a.bn_log;
}

template <int NS>
int launch_mid_body(const Args& a, size_t smem, cudaStream_t stream) {
  // opt in above 48 KB once per instantiation, at its first launch
  static cudaError_t opt_in = cudaFuncSetAttribute(
      stream_matmul_mid<NS>, cudaFuncAttributeMaxDynamicSharedMemorySize, kMidMaxSmem);
  if (opt_in != cudaSuccess) return static_cast<int>(opt_in);
  stream_matmul_mid<NS><<<a.nctas, kMidThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// K1-K3 on the short-prefill body: bf16 x (M, K), M <= 64; `streams` the
// 1..4 word streams of the resident rungs with their ascending `bits`;
// partial: npartial f32 (nq_mid_workspace() * M); counters: ncounters int32
// arrival counts, 0 between launches.
int nq_mid_matmul(const void* x, const void* const* streams, const int* bits, int nstreams,
                  const void* scale, void* out, int out_f32, void* partial, int npartial,
                  void* counters, int ncounters, int M, int N, int K, int block,
                  void* stream) {
  Args a = {};
  const int err = make_args(a, streams, bits, nstreams, M, N, K, block);
  if (err != 0) return err;
  if (M > kMidMaxM) return static_cast<int>(cudaErrorInvalidValue);
  a.x = x;
  a.out = out;
  a.scale = static_cast<const float*>(scale);
  a.partial = static_cast<float*>(partial);
  a.out_f32 = out_f32;
  mid_plan(a, nstreams);
  a.mtiles = (M + 7) / 8;
  a.ldx = (a.umax << a.g_log) * a.slots + 8;    // a chunk's x and 16 bytes of bank shift
  int vx = 8;                                    // x elements per async copy: <= a run
  while (vx > 1 && (vx > (1 << a.g_log) || K % vx ||
                    reinterpret_cast<uintptr_t>(x) % (2 * vx))) {
    vx /= 2;
  }
  a.vx_shift = log2_exact(vx);
  a.round_codes = bits[nstreams - 1] > 9;        // |code| > 256: bf16 rounds it
  a.spread = a.spread && !a.round_codes;
  a.counters = static_cast<int*>(counters);
  const size_t smem = mid_smem_bytes(a);
  if (smem > static_cast<size_t>(kMidMaxSmem) || a.partial == nullptr ||
      npartial < mid_workspace(a) * M || a.counters == nullptr || ncounters < a.tiles) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (nstreams) {
    case 1: return launch_mid_body<1>(a, smem, st);
    case 2: return launch_mid_body<2>(a, smem, st);
    case 3: return launch_mid_body<3>(a, smem, st);
    default: return launch_mid_body<4>(a, smem, st);
  }
}

// The short-prefill body's f32 partials per activation row for these
// operands, and its column tiles (the arrival counters it needs), or -1
// where it refuses them.  The launch follows the same plan.
int nq_mid_workspace(const int* bits, int nstreams, int N, int K, int block, int* tiles) {
  Args a = {};
  if (make_args(a, nullptr, bits, nstreams, 1, N, K, block) != 0) return -1;
  mid_plan(a, nstreams);
  *tiles = a.tiles;
  return static_cast<int>(mid_workspace(a));
}

}  // extern "C"
