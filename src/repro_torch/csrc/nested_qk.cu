// Hand-written Hopper (sm_90a) kernel for the integer QK^T over packed
// nested KV pages:
//
//   nq_nested_qk  replaces repro/kernels/nested_attention/kernel.py:69
//                 nested_qk
//
// What it computes: out[bh, m, j] = sum_d q[bh, m, d] * kc[bh, j, d] in
// 32-bit two's complement, where kc are the K codes at the resident rung:
// the base stream and 0..3 delta streams, each block-packed along the
// POSITION axis with block = page, unpacked and chain-recomposed exactly as
// repro/core/decompose.py chain_recompose does (codes = clip(codes * 2^gap
// + delta) per level).  The caller applies the scales, the rung shift and
// the softmax.
//
// What bounds it: every packed K word is read once and every score written
// once, for 2 * M operations per K code; at decode (M = G = 6 query heads
// per kv head) that is a few operations per byte, so the bound is the
// bytes: the packed streams, the int32 queries and the int32 scores.  At
// the served shape (BH 4, S 2048, D 128) those bytes take ~0.5 us, below
// the cost of one launch.  What a launch pays for is each CTA's chain -
// the copies' round trip, the decode, the contraction, the stores - and
// the instructions its threads issue on the way: the card issues, it does
// not wait on memory (cold and warm L2 time the same).  The design keeps
// every word's trip to device memory single and cuts instructions.
//
// The design: one CTA of 512 threads per (bh, run of positions <= 64).
// Every thread of a CTA runs its set-up (indices, the table, the query
// pass, barriers), so fewer, larger CTAs issue fewer instructions; at the
// served shape 64 positions per CTA (128 CTAs of 16 warps) beat 32 or 16
// positions with 128-512 threads in kernel-only sweeps on the card.
//   * Sizing.  Where a page has <= 64 positions and its words fit, the CTA
//     owns as many whole pages as fit 64 positions and the staging budget
//     (the served launch: 4 pages of 16).  Larger pages take 64-position
//     runs of one page and read their words from device memory directly
//     (4-byte loads, the same decode).
//   * Staging.  A run of whole pages is one contiguous chunk of word rows
//     per stream: the CTA copies each chunk, and its query rows, into
//     shared memory with 16-byte cp.async (4-byte copies where D % 4 != 0
//     or a view is misaligned), so every word leaves device memory once.
//   * Decode.  Element p of page g sits, per power-of-two component c of
//     width w, in word row g * rows_pb + off_c + p mod R_c at bit (p div
//     R_c) * w.  While the copies fly the CTA tabulates, per (stream,
//     component, position), the staged row and where the field sits (a
//     float-reciprocal divide per table entry, none per code).  A thread
//     item is 16 d (8 d for wider codes) of one position; the kernel is
//     instantiated per resident stream count (1-4), so the stream loop is
//     unrolled and the component loop runs over the stream's own
//     components.  Two decodes:
//     - every resident bitwidth <= 8 (NARROW): byte lanes, 4 codes per
//       instruction.  Per component and 4 d: three byte permutes gather
//       the field's byte of the 4 words, a rotate and a masked OR place it
//       (fields are w-aligned, none straddles a byte).  The chain step
//       clip(code * 2^gap + delta) runs on biased codes C = code +
//       2^(b-1), never negative, in 16-bit lanes: C' = max(C * 2^gap + D,
//       2^gap) - 2^gap with D = delta + 2^gap (the field's top bit
//       flipped); only the lower clip can bind.  Codes go to a (64, D)
//       int8 tile, the tensor cores' B operand as it stands;
//     - wider codes: per code and component a rotate and a masked OR, per
//       stream a sign extension and the chain step, into an int16 tile.
//   * Contraction, by a uniform choice per CTA and query chunk of <= 64 rows:
//     - the int8 tensor cores (mma.sync m16n8k32 s8 x s8 -> s32) when every
//       resident bitwidth is <= 8 and every query code of the chunk lies in
//       [-128, 127] (__syncthreads_or over the pass that also packs the
//       queries to int8; every CTA takes this barrier): queries are A (rows
//       padded to 16, D to 32 with zeros), the int8 tile B; warps take
//       (8-position, 16-row) tiles.  Exact: |sum| <= 256 * 128 * 128 < 2^31;
//     - otherwise the CUDA cores, int32 multiply-adds in uint32 (which wrap
//       exactly as the reference's int32 dot_general) over the same tile,
//       each thread one position and every G-th query row (G = 512 / the
//       CTA's positions), so every warp works at any M.
//
// Limits (the Python wrapper checks them first): 1..4 resident streams,
// ascending bitwidths <= 16, any page >= 1, D <= 256.

#include <cuda_runtime.h>
#include <stdint.h>

#include "tensor_core.cuh"

namespace {

constexpr int kMaxStreams = 4;
constexpr int kMaxComps = 5;   // a <= 16-bit field splits into <= 5 parts
constexpr int kThreads = 512;
constexpr int kTP = 64;        // positions per CTA, at most: 8 n-tiles of 8
constexpr int kTM = 64;        // query rows per chunk: 4 m-tiles of 16
constexpr int kMaxD = 256;
constexpr int kStageBytes = 64 * 1024;   // staged words per CTA, at most

struct Stream {
  const uint32_t* words;       // (BH, npages * rows_pb, D)
  int rows_pb;                 // word rows one page of this stream holds
  int code_bits;
  int ncomp;
  int w[kMaxComps];            // component widths, widest first
  int R[kMaxComps];            // word rows of each component within a page
  int off[kMaxComps];          // first row of each component within a page
  int cs[kMaxComps];           // bit of the code where the component starts
  uint32_t mask[kMaxComps];    // (2^w - 1) << cs
  int soff;                    // staged: first word of this stream's chunk
  int vec;                     // staged: 16-byte copies
};

struct Args {
  const int32_t* q;            // (BH, M, D)
  int32_t* out;                // (BH, M, S)
  int BH, M, D, S, page, npages, ns;
  int Dw;                      // D rounded up to 4: staged row stride, words
  int Dp;                      // D rounded up to 32: tensor-core depth
  int staged;                  // 1: whole pages staged in shared memory
  int ppc;                     // staged: pages per CTA
  int cpp;                     // direct: 64-position runs per page
  int qvec;                    // queries: 16-byte copies
  int tab_bytes, tile_bytes, stage_bytes, q32_bytes;  // shared-memory carve-up
  Stream s[kMaxStreams];
  int gap[kMaxStreams];        // level i >= 1: codes = clip(codes * 2^gap + delta)
  int lo[kMaxStreams];
};

int split_components(int k, int* w) {
  int n = 0;
  for (int i = 4; i >= 0; --i) {
    if ((k >> i) & 1) w[n++] = 1 << i;
  }
  return n;
}

__host__ __device__ constexpr int round_up(int x, int m) { return (x + m - 1) / m * m; }

// x / d for 0 <= x < 2^16, d >= 1: a float reciprocal and one correction
// each way (the table's divides; no integer divide loop)
__device__ __forceinline__ int div_small(int x, int d) {
  int q = __float2int_rz(__int2float_rn(x) * __frcp_rn(__int2float_rn(d)));
  q += (q + 1) * d <= x;
  q -= q * d > x;
  return q;
}

// int16 code tile (codes over 8 bits) row stride, elements: 2 * Dp + 40
// bytes is an odd multiple of 8 modulo 128, so the CUDA-core path's 16
// neighbouring positions read distinct bank pairs.  The int8 tile's stride
// is Dp + 16 bytes, whose B-fragment reads (8 positions x 4 lanes) are
// conflict-free.
__host__ __device__ constexpr int tile_stride(int Dp) { return Dp + 20; }

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// rows [m0, m0 + rows) of the queries of bh -> q32 (rows, Dw) int32
__device__ __forceinline__ void stage_queries(const Args& a, int32_t* q32, int bh, int m0,
                                              int rows) {
  const int32_t* src = a.q + (static_cast<size_t>(bh) * a.M + m0) * a.D;
  if (a.qvec) {
    for (int i = threadIdx.x; i < rows * a.D / 4; i += kThreads) {
      nq_tc::cp_async<16>(nq_tc::smem_u32(q32 + 4 * i), src + 4 * i, true);
    }
  } else {
    for (int i = threadIdx.x; i < rows * a.D; i += kThreads) {
      const int r = i / a.D;
      nq_tc::cp_async<4>(nq_tc::smem_u32(q32 + r * a.Dw + (i - r * a.D)), src + i, true);
    }
  }
}

// The words of one component for Q quads (4 d each) of a position: quads
// qd + k * step, k < Q, those at or past nq left zero
template <bool STAGED, int Q>
__device__ __forceinline__ void load_quads(uint32_t (&w)[4 * Q], const Args& a, const Stream& st,
                                           const uint32_t* stage, int2 t, int bh, int qd,
                                           int step, int nq) {
  if constexpr (STAGED) {
#pragma unroll
    for (int k = 0; k < Q; ++k) {
      const uint4 v = qd + k * step < nq
                          ? *reinterpret_cast<const uint4*>(stage + t.x + 4 * (qd + k * step))
                          : make_uint4(0u, 0u, 0u, 0u);
      w[4 * k] = v.x; w[4 * k + 1] = v.y; w[4 * k + 2] = v.z; w[4 * k + 3] = v.w;
    }
  } else {
    const uint32_t* src = st.words + (static_cast<size_t>(bh) * a.npages * st.rows_pb + t.x) * a.D;
#pragma unroll
    for (int e = 0; e < 4 * Q; ++e) {
      const int d = 4 * (qd + (e >> 2) * step) + (e & 3);
      w[e] = d < a.D ? __ldg(src + d) : 0u;
    }
  }
}

// Codes of the CTA's positions -> the int16 tile.  A thread item is 8 d of
// one position (quads qd and qd + nh); the stream loop is unrolled (NS is a
// template argument), the component loop runs over the stream's own
// components only.
template <bool STAGED, int NS>
__device__ __forceinline__ void decode(const Args& a, const int2* tab, const uint32_t* stage,
                                       int16_t* tile, int bh, int TPc) {
  const int nq = a.Dw >> 2;
  const int nh = (nq + 1) >> 1;
  const int total = TPc * nh;
  const int ts = tile_stride(a.Dp);
  int pl = threadIdx.x / nh;
  int qd = threadIdx.x - pl * nh;
  const int dpl = kThreads / nh, dqd = kThreads - dpl * nh;
  for (int i = threadIdx.x; i < total; i += kThreads) {
    const int qd2 = qd + nh;
    const bool two = qd2 < nq;
    int code[8];
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      const Stream& st = a.s[s];
      uint32_t u[8] = {0u, 0u, 0u, 0u, 0u, 0u, 0u, 0u};
      const int2* te = tab + s * kMaxComps * kTP + pl;
#pragma unroll 1
      for (int c = 0; c < st.ncomp; ++c, te += kTP) {
        const int2 t = *te;
        const uint32_t mask = st.mask[c];
        uint32_t w[8];
        load_quads<STAGED, 2>(w, a, st, stage, t, bh, qd, nh, nq);
#pragma unroll
        for (int e = 0; e < 8; ++e) u[e] |= __funnelshift_r(w[e], w[e], t.y) & mask;
      }
      const int sh = 32 - st.code_bits;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int v = static_cast<int>(u[e] << sh) >> sh;
        code[e] = (s == 0) ? v : max(code[e] * (1 << a.gap[s]) + v, a.lo[s]);
      }
    }
    uint32_t c16[4];
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      const int d = 4 * (h < 2 ? qd : qd2) + 2 * (h & 1);
      c16[h] = (d < a.D ? static_cast<uint32_t>(code[2 * h]) & 0xffffu : 0u)
               | (d + 1 < a.D ? static_cast<uint32_t>(code[2 * h + 1]) << 16 : 0u);
    }
    int16_t* row = tile + pl * ts;
    *reinterpret_cast<uint2*>(row + 4 * qd) = make_uint2(c16[0], c16[1]);
    if (two) *reinterpret_cast<uint2*>(row + 4 * qd2) = make_uint2(c16[2], c16[3]);
    pl += dpl;
    qd += dqd;
    if (qd >= nh) {
      qd -= nh;
      ++pl;
    }
  }
}

// The same for a launch whose every resident bitwidth is <= 8, 16 d per
// item, four codes to a 32-bit word as int8 lanes (the int8 tile, the
// tensor cores' B operand as it stands).  Per component and quad: three byte permutes
// gather the field's byte of the 4 words, one rotate and one masked OR
// place it (fields are w-aligned, so none straddles a byte).  The chain
// step runs on biased codes (code + 2^(b-1), never negative) in 16-bit
// lanes: C' = max(C * 2^gap + D, 2^gap) - 2^gap with D = delta + 2^gap.
template <bool STAGED, int NS>
__device__ __forceinline__ void decode_narrow(const Args& a, const int2* tab,
                                              const uint32_t* stage, uint8_t* tile, int bh,
                                              int TPc) {
  constexpr int Q = 4;                  // quads per item: 16 d of one position
  const int nq = a.Dw >> 2;
  const int step = (nq + Q - 1) / Q;    // item (pl, qd) takes quads qd + k * step
  const int total = TPc * step;
  const int ts = a.Dp + 16;             // int8 tile row stride, bytes
  int pl = threadIdx.x / step;
  int qd = threadIdx.x - pl * step;
  const int dpl = kThreads / step, dqd = kThreads - dpl * step;
  for (int i = threadIdx.x; i < total; i += kThreads) {
    uint32_t cl[Q], ch[Q], out[Q];
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      const Stream& st = a.s[s];
      uint32_t u[Q] = {};
      const int2* te = tab + s * kMaxComps * kTP + pl;
#pragma unroll 1
      for (int c = 0; c < st.ncomp; ++c, te += kTP) {
        const int2 t = *te;
        const uint32_t sel = (static_cast<uint32_t>(t.y) >> 8) & 0xffu;
        const uint32_t mask = ((static_cast<uint32_t>(t.y) >> 16) & 0xffu) * 0x01010101u;
        uint32_t w[4 * Q];
        load_quads<STAGED, Q>(w, a, st, stage, t, bh, qd, step, nq);
#pragma unroll
        for (int k = 0; k < Q; ++k) {
          const uint32_t x = __byte_perm(__byte_perm(w[4 * k], w[4 * k + 1], sel),
                                         __byte_perm(w[4 * k + 2], w[4 * k + 3], sel), 0x5410);
          u[k] |= __funnelshift_r(x, x, t.y & 31) & mask;
        }
      }
      const uint32_t top = (1u << (st.code_bits - 1)) * 0x01010101u;   // the field's sign bit
#pragma unroll
      for (int k = 0; k < Q; ++k) {
        if (NS == 1) {
          out[k] = u[k];
        } else if (s == 0) {
          const uint32_t c = u[k] ^ top;                       // biased base codes
          cl[k] = __byte_perm(c, 0u, 0x4140);
          ch[k] = __byte_perm(c, 0u, 0x4342);
        } else {
          const uint32_t d = u[k] ^ top;                       // delta + 2^gap
          const uint32_t g2 = (1u << a.gap[s]) * 0x00010001u;
          cl[k] = __vmaxu2((cl[k] << a.gap[s]) + __byte_perm(d, 0u, 0x4140), g2) - g2;
          ch[k] = __vmaxu2((ch[k] << a.gap[s]) + __byte_perm(d, 0u, 0x4342), g2) - g2;
        }
      }
    }
    // b-bit codes (biased unless NS == 1) -> int8 lanes: flip the sign bit
    // back, then sign-extend each lane: (v & 2^(b-1)) * (2^(9-b) - 2) sets
    // bits b..7 of a negative lane and stays inside it
    const uint32_t half = NS == 1 ? 1u << (a.s[0].code_bits - 1)
                                  : static_cast<uint32_t>(-a.lo[NS - 1]);   // 2^(b-1)
    const uint32_t sbit = half * 0x01010101u;
    const uint32_t ext = 256u / half - 2u;
    uint8_t* row = tile + pl * ts;
#pragma unroll
    for (int k = 0; k < Q; ++k) {
      uint32_t v = NS == 1 ? out[k] : (__byte_perm(cl[k], ch[k], 0x6420) ^ sbit);
      v |= (v & sbit) * ext;                                   // sign-extend each lane
      const int d0 = 4 * (qd + k * step);
      if (d0 + 4 > a.D) v &= d0 >= a.D ? 0u : (1u << (8 * (a.D - d0))) - 1u;
      if (qd + k * step < nq) *reinterpret_cast<uint32_t*>(row + d0) = v;
    }
    pl += dpl;
    qd += dqd;
    if (qd >= step) {
      qd -= step;
      ++pl;
    }
  }
}

// <= 64 registers: 2 CTAs per SM
template <int NS, bool NARROW>
__global__ void __launch_bounds__(kThreads, 2) nested_qk(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  int2* tab = reinterpret_cast<int2*>(smem);
  // NARROW (every resident bitwidth <= 8): an int8 tile, else int16
  unsigned char* tile = smem + a.tab_bytes;
  uint32_t* stage = reinterpret_cast<uint32_t*>(smem + a.tab_bytes + a.tile_bytes);
  int32_t* q32 = reinterpret_cast<int32_t*>(smem + a.tab_bytes + a.tile_bytes + a.stage_bytes);
  int8_t* q8 = reinterpret_cast<int8_t*>(smem + a.tab_bytes + a.tile_bytes + a.stage_bytes +
                                         a.q32_bytes);
  const int bh = blockIdx.y;

  // the CTA's positions [j0, j0 + TPc): whole pages g0.. when staged
  int j0, TPc, g0 = 0;
  if (a.staged) {
    g0 = blockIdx.x * a.ppc;
    const int np = min(a.ppc, a.npages - g0);
    j0 = g0 * a.page;
    TPc = np * a.page;
    for (int s = 0; s < a.ns; ++s) {
      const Stream& st = a.s[s];
      const uint32_t* src = st.words
          + (static_cast<size_t>(bh) * a.npages + g0) * st.rows_pb * a.D;
      uint32_t* dst = stage + st.soff;
      const int n = np * st.rows_pb * a.D;
      if (st.vec) {
        for (int i = threadIdx.x; i < n / 4; i += kThreads) {
          nq_tc::cp_async<16>(nq_tc::smem_u32(dst + 4 * i), src + 4 * i, true);
        }
      } else {
        for (int i = threadIdx.x; i < n; i += kThreads) {
          const int r = i / a.D;
          nq_tc::cp_async<4>(nq_tc::smem_u32(dst + r * a.Dw + (i - r * a.D)), src + i, true);
        }
      }
    }
  } else {
    const int g = blockIdx.x / a.cpp;
    const int part = blockIdx.x - g * a.cpp;
    j0 = g * a.page + part * kTP;
    TPc = min(kTP, a.page - part * kTP);
  }
  stage_queries(a, q32, bh, 0, min(a.M, kTM));
  nq_tc::cp_async_commit();

  // (stream, component, position) -> staged word offset (direct: word row)
  // and the rotate that moves the field to bit cs of the code
  const int gq = a.staged ? 0 : j0 / a.page;      // direct: the CTA's page
  for (int i = threadIdx.x; i < a.ns * kMaxComps * TPc; i += kThreads) {
    const int e = div_small(i, TPc);               // stream * kMaxComps + component
    const int pl = i - e * TPc;
    const int s = e / kMaxComps;
    const int c = e - s * kMaxComps;
    const Stream& st = a.s[s];
    if (c < st.ncomp) {
      int tab_off, p, R = st.R[c];
      if (a.staged) {                              // pl < 64: cheap divides
        const int gl = div_small(pl, a.page);
        p = pl - gl * a.page;
        const int qr = div_small(p, R);
        tab_off = st.soff + (gl * st.rows_pb + st.off[c] + p - qr * R) * a.Dw;
        p = qr;
      } else {
        const int pp = j0 - gq * a.page + pl;
        tab_off = gq * st.rows_pb + st.off[c] + pp % R;
        p = pp / R;
      }
      const int at = p * st.w[c];                  // the field's first bit in its word
      if (NARROW) {                                // byte, rotate within it, byte mask
        const int byte = at >> 3;
        tab[e * kTP + pl] = make_int2(
            tab_off, (((at & 7) - st.cs[c]) & 31) | ((byte | (byte + 4) << 4) << 8)
                         | static_cast<int>(((1u << st.w[c]) - 1u) << st.cs[c]) << 16);
      } else {
        tab[e * kTP + pl] = make_int2(tab_off, (at - st.cs[c]) & 31);
      }
    }
  }
  nq_tc::cp_async_wait_all();
  __syncthreads();
  int16_t* tile16 = reinterpret_cast<int16_t*>(tile);
  if (NARROW) {
    if (a.staged) decode_narrow<true, NS>(a, tab, stage, tile, bh, TPc);
    else decode_narrow<false, NS>(a, tab, stage, tile, bh, TPc);
  } else {
    if (a.staged) decode<true, NS>(a, tab, stage, tile16, bh, TPc);
    else decode<false, NS>(a, tab, stage, tile16, bh, TPc);
  }

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int ts = NARROW ? a.Dp + 16 : tile_stride(a.Dp);   // tile row stride, elements
  const int qs = a.Dp + 16;             // int8 query row stride, bytes
  const int nq8 = a.Dp >> 2;            // int8 query quads per row
  const int rq = threadIdx.x / nq8, qq = threadIdx.x - rq * nq8;
  const int rstep = kThreads / nq8;     // nq8 <= 64, so rstep >= 8
  for (int m0 = 0; m0 < a.M; m0 += kTM) {
    const int rows = min(kTM, a.M - m0);
    const int mtiles = (rows + 15) >> 4;
    if (m0 > 0) {
      __syncthreads();                  // the previous chunk's queries are read
      stage_queries(a, q32, bh, m0, rows);
      nq_tc::cp_async_commit();
      nq_tc::cp_async_wait_all();
      __syncthreads();
    }
    // one pass: range check, and the int8 A tile (zero padded) for the tensor cores
    int wide = 0;
    if (NARROW) {
      for (int r = rq; r < mtiles * 16 && qq < nq8; r += rstep) {
        const int d0 = 4 * qq;
        int4 v = make_int4(0, 0, 0, 0);
        if (r < rows && d0 < a.D) v = *reinterpret_cast<const int4*>(q32 + r * a.Dw + d0);
        const int e[4] = {v.x, d0 + 1 < a.D ? v.y : 0, d0 + 2 < a.D ? v.z : 0,
                          d0 + 3 < a.D ? v.w : 0};
        uint32_t packed = 0u;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          wide |= e[k] < -128 || e[k] > 127;
          packed |= (static_cast<uint32_t>(e[k]) & 0xffu) << (8 * k);
        }
        *reinterpret_cast<uint32_t*>(q8 + r * qs + d0) = packed;
      }
    }
    // the barrier after the decode and the query pass, taken by every CTA
    // (not short-circuited); the choice is uniform per CTA and chunk
    const bool wide_any = __syncthreads_or(wide);
    if (NARROW && !wide_any) {
      // int8 tensor cores: warp tasks (8-position n-tile, 16-row m-tile)
      const int g = lane >> 2, t = lane & 3;
      const int ntiles = (TPc + 7) >> 3;
      for (int task = warp; task < ntiles * mtiles; task += kThreads / 32) {
        const int mt = task / ntiles;
        const int n0 = 8 * (task - mt * ntiles);
        const uint8_t* brow = tile + (n0 + g) * ts;
        const int8_t* arow = q8 + (mt * 16 + g) * qs;
        int acc[4] = {0, 0, 0, 0};
        for (int k0 = 0; k0 < a.Dp; k0 += 32) {
          uint32_t af[4];
          af[0] = *reinterpret_cast<const uint32_t*>(arow + k0 + 4 * t);
          af[1] = *reinterpret_cast<const uint32_t*>(arow + 8 * qs + k0 + 4 * t);
          af[2] = *reinterpret_cast<const uint32_t*>(arow + k0 + 16 + 4 * t);
          af[3] = *reinterpret_cast<const uint32_t*>(arow + 8 * qs + k0 + 16 + 4 * t);
          mma_s8(acc, af, *reinterpret_cast<const uint32_t*>(brow + k0 + 4 * t),
                 *reinterpret_cast<const uint32_t*>(brow + k0 + 16 + 4 * t));
        }
        const int pos = n0 + 2 * t;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = mt * 16 + g + 8 * h;
          if (m < rows) {
            int32_t* o = a.out + (static_cast<size_t>(bh) * a.M + m0 + m) * a.S + j0 + pos;
            if (pos < TPc) o[0] = acc[2 * h];
            if (pos + 1 < TPc) o[1] = acc[2 * h + 1];
          }
        }
      }
    } else {
      // CUDA cores: thread = one position and the query rows mg, mg + G, ...
      const int pl = threadIdx.x % TPc;
      const int G = kThreads / TPc;     // >= 8 row groups
      for (int m = threadIdx.x / TPc; m < rows && threadIdx.x < G * TPc; m += G) {
        uint32_t acc = 0u;
        const int32_t* qr = q32 + m * a.Dw;
        for (int d0 = 0; d0 < a.Dw; d0 += 4) {
          // columns d >= D hold code 0 (the staged query there is unset)
          int kc[4];
          if (NARROW) {
            const uint32_t cw = *reinterpret_cast<const uint32_t*>(tile + pl * ts + d0);
#pragma unroll
            for (int e = 0; e < 4; ++e) kc[e] = static_cast<int>(cw << (24 - 8 * e)) >> 24;
          } else {
            const uint2 cw = *reinterpret_cast<const uint2*>(tile16 + pl * ts + d0);
            kc[0] = static_cast<int>(cw.x << 16) >> 16;
            kc[1] = static_cast<int>(cw.x) >> 16;
            kc[2] = static_cast<int>(cw.y << 16) >> 16;
            kc[3] = static_cast<int>(cw.y) >> 16;
          }
          const int4 qv = *reinterpret_cast<const int4*>(qr + d0);
          acc += static_cast<uint32_t>(qv.x) * static_cast<uint32_t>(kc[0])
                 + static_cast<uint32_t>(qv.y) * static_cast<uint32_t>(kc[1])
                 + static_cast<uint32_t>(qv.z) * static_cast<uint32_t>(kc[2])
                 + static_cast<uint32_t>(qv.w) * static_cast<uint32_t>(kc[3]);
        }
        a.out[(static_cast<size_t>(bh) * a.M + m0 + m) * a.S + j0 + pl] = static_cast<int32_t>(acc);
      }
    }
  }
}

size_t smem_bytes(int ns, int Dp, bool narrow, int stage_bytes, int q_rows, int Dw, int* tab,
                  int* tile, int* q32) {
  *tab = round_up(ns * kMaxComps * kTP * 8, 16);
  *tile = round_up(narrow ? kTP * (Dp + 16) : kTP * tile_stride(Dp) * 2, 16);
  *q32 = round_up(q_rows * Dw * 4, 16);
  const int q8 = round_up((q_rows + 15) / 16 * 16 * (Dp + 16), 16);
  return static_cast<size_t>(*tab) + *tile + stage_bytes + *q32 + q8;
}

}  // namespace

extern "C" {

// q (BH, M, D) int32; streams[i] (BH, npages * rows_i, D) int32 packed along
// positions with block = page; bits: ascending resident bitwidths, one per
// stream; out (BH, M, npages * page) int32.  All contiguous.
int nq_nested_qk(const void* q, const void* const* streams, const int* bits, int ns,
                 void* out, int BH, int M, int D, int npages, int page, void* stream) {
  if (ns < 1 || ns > kMaxStreams || BH < 1 || M < 1 || D < 1 || D > kMaxD ||
      npages < 1 || page < 1 || BH > 65535 || bits[0] < 1 || bits[ns - 1] > 16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args a = {};
  a.q = static_cast<const int32_t*>(q);
  a.out = static_cast<int32_t*>(out);
  a.BH = BH;
  a.M = M;
  a.D = D;
  a.S = npages * page;
  a.page = page;
  a.npages = npages;
  a.ns = ns;
  a.Dw = round_up(D, 4);
  a.Dp = round_up(D, 32);
  const bool narrow = bits[ns - 1] <= 8;       // int8 codes: the NARROW kernels
  a.qvec = D % 4 == 0 && reinterpret_cast<uintptr_t>(q) % 16 == 0;
  int rows_total = 0;
  for (int s = 0; s < ns; ++s) {
    if (s > 0 && bits[s] <= bits[s - 1]) return static_cast<int>(cudaErrorInvalidValue);
    Stream& st = a.s[s];
    st.words = static_cast<const uint32_t*>(streams[s]);
    st.code_bits = (s == 0) ? bits[0] : bits[s] - bits[s - 1] + 1;
    st.ncomp = split_components(st.code_bits, st.w);
    int off = 0, cs = 0;
    for (int c = 0; c < st.ncomp; ++c) {
      const int per_word = 32 / st.w[c];
      st.R[c] = (page + per_word - 1) / per_word;
      st.off[c] = off;
      st.cs[c] = cs;
      st.mask[c] = ((1u << st.w[c]) - 1u) << cs;
      off += st.R[c];
      cs += st.w[c];
    }
    st.rows_pb = off;
    st.vec = D % 4 == 0 && reinterpret_cast<uintptr_t>(streams[s]) % 16 == 0;
    rows_total += off;
    if (s > 0) {
      a.gap[s] = bits[s] - bits[s - 1];
      a.lo[s] = -(1 << (bits[s] - 1));
    }
  }
  // stage as many whole pages as fit 64 positions and the staging budget
  const int page_bytes = rows_total * a.Dw * 4;
  a.ppc = page > kTP ? 0
          : (kTP / page < kStageBytes / page_bytes ? kTP / page : kStageBytes / page_bytes);
  a.staged = a.ppc >= 1;
  int grid_x;
  if (a.staged) {
    int soff = 0;
    for (int s = 0; s < ns; ++s) {
      a.s[s].soff = soff;
      soff += a.ppc * a.s[s].rows_pb * a.Dw;
    }
    a.stage_bytes = soff * 4;
    grid_x = (npages + a.ppc - 1) / a.ppc;
  } else {
    a.cpp = (page + kTP - 1) / kTP;
    grid_x = npages * a.cpp;
    if (static_cast<long long>(npages) * a.cpp > 0x7fffffffLL) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  const size_t smem = smem_bytes(ns, a.Dp, narrow, a.stage_bytes, min(M, kTM), a.Dw,
                                 &a.tab_bytes, &a.tile_bytes, &a.q32_bytes);
  // opt in to the largest carve-up once (4 streams, D = 256, a full staging
  // budget and query chunk), before any graph capture
  using Kernel = void (*)(Args);
  static const Kernel kernels[2][kMaxStreams] = {
      {nested_qk<1, false>, nested_qk<2, false>, nested_qk<3, false>, nested_qk<4, false>},
      {nested_qk<1, true>, nested_qk<2, true>, nested_qk<3, true>, nested_qk<4, true>}};
  static cudaError_t opt_in = [] {
    int t0, t1, t2;
    const size_t most = smem_bytes(kMaxStreams, kMaxD, false, kStageBytes, kTM, kMaxD, &t0, &t1,
                                   &t2);
    cudaError_t err = cudaSuccess;
    for (const auto& row : kernels) {
      for (Kernel k : row) {
        const cudaError_t e = cudaFuncSetAttribute(
            k, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(most));
        if (err == cudaSuccess) err = e;
      }
    }
    return err;
  }();
  if (opt_in != cudaSuccess) return static_cast<int>(opt_in);
  const dim3 grid(grid_x, BH);
  kernels[narrow][ns - 1]<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
