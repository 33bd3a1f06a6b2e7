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
// + delta) per level).  Products and sums are taken in uint32, which wraps
// exactly as the reference's int32 dot_general does, and reinterpreted.
// The caller applies the scales, the rung shift and the softmax.
//
// What bounds it: every packed K word is read once and every score written
// once, for 2 * M operations per K code; at decode (M = G = 6 query heads
// per kv head) that is a few operations per byte, so the bound is the
// bytes: the packed streams, the int32 queries and the int32 scores.  The
// design:
//   * one CTA of 256 threads per (32 positions, bh).  The CTA first
//     unpacks the 32 x D codes of its positions by index - element p of
//     page g sits, per power-of-two component c of width w, in word row
//     g * rows_pb + off_c + p mod R_c at bit (p div R_c) * w - with the
//     32 threads of a warp on 32 neighbouring d, so every word-row read is
//     one coalesced line.  Any page >= 1 works, including pages that
//     leave a word row partly used (page 16, a 1-bit component);
//   * the recomposed codes and a 32-row slice of the queries live in
//     shared memory as int32 (code rows padded by one word so the lanes of
//     a warp, one position each, read distinct banks);
//   * each warp produces one query row at a time for the 32 positions, one
//     per lane, so the score stores are coalesced.  Integer CUDA-core
//     multiply-adds; the int8 tensor cores (valid only while every
//     resident bitwidth is <= 8) come later.
//
// Limits (the Python wrapper checks them first): 1..4 resident streams,
// ascending bitwidths <= 16, any page >= 1, D <= 256.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxStreams = 4;
constexpr int kMaxComps = 5;   // a <= 16-bit field splits into <= 5 parts
constexpr int kTP = 32;        // positions per CTA
constexpr int kTM = 32;        // query rows staged at a time
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxD = 256;

struct Stream {
  const uint32_t* words;  // (BH, npages * rows_pb, D)
  int rows_pb;            // word rows one page of this stream holds
  int code_bits;
  int ncomp;
  int w[kMaxComps];       // component widths, widest first
  int R[kMaxComps];       // word rows of each component within a page
  int off[kMaxComps];     // first row of each component within a page
};

struct Args {
  const int32_t* q;       // (BH, M, D)
  int32_t* out;           // (BH, M, S)
  int BH, M, D, S, page, ns;
  Stream s[kMaxStreams];
  int gap[kMaxStreams];   // level i >= 1: codes = clip(codes * 2^gap + delta)
  int lo[kMaxStreams];
  int hi[kMaxStreams];
};

int split_components(int k, int* w) {
  int n = 0;
  for (int i = 4; i >= 0; --i) {
    if ((k >> i) & 1) w[n++] = 1 << i;
  }
  return n;
}

// The code of position j (page g, offset p) at column d of one stream.
__device__ __forceinline__ int unpack(const Stream& st, size_t bh_rows, int g, int p,
                                      int d, int D) {
  uint32_t u = 0u;
  int cs = 0;
#pragma unroll
  for (int c = 0; c < kMaxComps; ++c) {
    if (c < st.ncomp) {
      const int R = st.R[c];
      const size_t row = bh_rows + static_cast<size_t>(g) * st.rows_pb + st.off[c] + p % R;
      const uint32_t word = __ldg(st.words + row * D + d);
      const int w = st.w[c];
      const uint32_t mask = (w == 32) ? 0xffffffffu : ((1u << w) - 1u);
      u |= ((word >> ((p / R) * w)) & mask) << cs;
      cs += w;
    }
  }
  int v = static_cast<int>(u);
  if (v >= (1 << (st.code_bits - 1))) v -= (1 << st.code_bits);
  return v;
}

__global__ void __launch_bounds__(kThreads) nested_qk(const Args a) {
  extern __shared__ int32_t sm[];
  int32_t* kc = sm;                       // (kTP, D + 1) recomposed K codes
  int32_t* qs = kc + kTP * (a.D + 1);     // (kTM, D) query codes
  const int bh = blockIdx.y;
  const int j0 = blockIdx.x * kTP;
  const int npages = (a.S + a.page - 1) / a.page;

  for (int i = threadIdx.x; i < kTP * a.D; i += kThreads) {
    const int jl = i / a.D;
    const int d = i - jl * a.D;
    const int j = j0 + jl;
    int code = 0;
    if (j < a.S) {
      const int g = j / a.page;
      const int p = j - g * a.page;
      for (int s = 0; s < a.ns; ++s) {
        const size_t bh_rows = static_cast<size_t>(bh) * npages * a.s[s].rows_pb;
        const int v = unpack(a.s[s], bh_rows, g, p, d, a.D);
        code = (s == 0) ? v : min(max(code * (1 << a.gap[s]) + v, a.lo[s]), a.hi[s]);
      }
    }
    kc[jl * (a.D + 1) + d] = code;
  }

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int j = j0 + lane;
  for (int m0 = 0; m0 < a.M; m0 += kTM) {
    __syncthreads();                      // codes written / previous q slice read
    const int rows = min(kTM, a.M - m0);
    for (int i = threadIdx.x; i < rows * a.D; i += kThreads) {
      qs[i] = a.q[(static_cast<size_t>(bh) * a.M + m0) * a.D + i];
    }
    __syncthreads();
    for (int r = warp; r < rows; r += kWarps) {
      uint32_t acc = 0u;
      const int32_t* qr = qs + r * a.D;
      const int32_t* kr = kc + lane * (a.D + 1);
      for (int d = 0; d < a.D; ++d) {
        acc += static_cast<uint32_t>(qr[d]) * static_cast<uint32_t>(kr[d]);
      }
      if (j < a.S) {
        a.out[(static_cast<size_t>(bh) * a.M + m0 + r) * a.S + j] = static_cast<int32_t>(acc);
      }
    }
  }
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
  a.ns = ns;
  for (int s = 0; s < ns; ++s) {
    if (s > 0 && bits[s] <= bits[s - 1]) return static_cast<int>(cudaErrorInvalidValue);
    Stream& st = a.s[s];
    st.words = static_cast<const uint32_t*>(streams[s]);
    st.code_bits = (s == 0) ? bits[0] : bits[s] - bits[s - 1] + 1;
    st.ncomp = split_components(st.code_bits, st.w);
    int off = 0;
    for (int c = 0; c < st.ncomp; ++c) {
      const int per_word = 32 / st.w[c];
      st.R[c] = (page + per_word - 1) / per_word;
      st.off[c] = off;
      off += st.R[c];
    }
    st.rows_pb = off;
    if (s > 0) {
      a.gap[s] = bits[s] - bits[s - 1];
      a.lo[s] = -(1 << (bits[s] - 1));
      a.hi[s] = (1 << (bits[s] - 1)) - 1;
    }
  }
  const size_t smem = (static_cast<size_t>(kTP) * (D + 1) + kTM * D) * sizeof(int32_t);
  // opt in to the largest tile once (D = 256), before any graph capture
  static cudaError_t opt_in = cudaFuncSetAttribute(
      nested_qk, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>((kTP * (kMaxD + 1) + kTM * kMaxD) * sizeof(int32_t)));
  if (opt_in != cudaSuccess) return static_cast<int>(opt_in);
  const dim3 grid((a.S + kTP - 1) / kTP, BH);
  nested_qk<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
