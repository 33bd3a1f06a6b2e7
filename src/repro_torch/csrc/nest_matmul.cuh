// Operands and plans shared by the K1-K3 sources (nest_matmul.cu: the
// decode, CUDA-core and tensor-core bodies; nest_matmul_mid.cu: the
// short-prefill body).  Every body reads the same block-packed word streams
// through the same Args; the decode and short-prefill bodies stage the same
// units (unit_plan).  See the note at the top of nest_matmul.cu for the
// layout of the streams.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace nq_mm {

constexpr int kMaxStreams = 4;
constexpr int kMaxComps = 4;  // a <= 16-bit field splits into <= 4 parts
constexpr int kMaxBlock = 512;

struct Stream {
  const uint32_t* words;
  int rows_pb;          // word rows one pack block of this stream holds
  int code_bits;        // width of the stream's codes
  int ncomp;            // power-of-two components, widest first
  int w[kMaxComps];     // component widths
  int R[kMaxComps];     // word rows of each component within a block
  int off[kMaxComps];   // first row of each component within a block
  int q[kMaxComps];     // rmax / R[c]
  int cs[kMaxComps];    // bit position of each component in the stream's code
                        // (tensor-core, decode and short-prefill routes)
  // tensor-core route only
  int first;            // index of component 0 among every stream's components
  int rdiv[kMaxComps];  // ceil(2^20 / R[c]): r / R[c] == (r * rdiv) >> 20, r < 512
  // decode and short-prefill routes (unit_plan)
  int glog[kMaxComps];  // log2(R[c] / R_min): word rows of this component per unit
  int cbase[kMaxComps]; // first word row of this component in a unit (units of G rows)
  uint32_t spread[kMaxComps];  // the component's field mask repeated every wmax bits
  uint32_t fbias;       // 0x4B000000 | 2^(code_bits - 1): the code as an f32 2^23 + ...
  float foff;           // ... minus this is the signed code
  float fmul, flo;      // 2^gap and lo of this level as f32
};

struct Args {
  const void* x;
  void* out;
  const float* scale;
  float* partial;       // CUDA cores: (nk, M, N) split-K sums; decode, short prefill:
                        // per-run slots
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
  // decode and short-prefill routes
  int wmax;             // widest component's width: bits to a code's next slot
  int bn_log;           // log2 of the output columns per CTA (5..7)
  int rmin;             // word rows of the narrowest component in a block: units per block
  int umax;             // rmax / rmin: widest-component rows per unit
  int wpu;              // words per column in one unit, every component together
  int g_log;            // log2 of the units per chunk (a chunk is one ring stage)
  int cpb;              // chunks per pack block
  int tiles;            // column tiles of 2^bn_log
  long nitems;          // nk * tiles * cpb work items
  int nctas;            // CTAs, each taking an equal run of items
  int round_codes;      // bf16 x with codes over 9 bits: round each code to bf16
  int spread;           // every stream's code fits wmax bits (and no rounding): the
                        // packed-field path
  int x_bf16;
  int* counters;        // per column tile arrival counts, 0 between launches
  // short-prefill route only
  int mtiles;           // 8-row token tiles: ceil(M / 8)
  int ldx;              // row stride of the staged x, in bf16 elements
  Stream s[kMaxStreams];
  int gap[kMaxStreams];  // level i >= 1: codes = clip(codes * 2^gap + delta)
  int lo[kMaxStreams];
  int hi[kMaxStreams];
};

__device__ __forceinline__ void store_out(const Args& a, int m, int n, float v) {
  const size_t i = static_cast<size_t>(m) * a.N + n;
  if (a.out_f32) {
    static_cast<float*>(a.out)[i] = v;
  } else {
    static_cast<__nv_bfloat16*>(a.out)[i] = __float2bfloat16_rn(v);
  }
}

// an int code as f32, exact for |c| < 2^22 (two full-rate adds, no I2F)
__device__ __forceinline__ float code_f32(int c) {
  return __int_as_float(0x4B400000 + c) - 12582912.f;
}

// CTA p of P takes the run [p W / P, (p + 1) W / P) of the W work items of
// the decode and short-prefill bodies
__device__ __forceinline__ int dec_owner(long item, long W, long P) {
  return static_cast<int>(((item + 1) * P - 1) / W);  // the CTA whose run holds item
}

inline int log2_exact(int v) {
  int s = 0;
  while ((1 << s) < v) ++s;
  return s;
}

// SMs of the current device (132 on an H100 SXM), read once per process
inline int device_sms() {
  static int sms = [] {
    int dev = 0, n = 132;
    if (cudaGetDevice(&dev) == cudaSuccess) {
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    }
    return n;
  }();
  return sms;
}

// log2 of the words per async copy of a word row: 16-byte copies unless N %
// 4 != 0 or a stream's base is not 16-byte aligned
inline int word_copy_shift(const Args& a, int ns) {
  int vw = 4;
  for (bool fits = false; !fits && vw > 1;) {
    fits = a.N % vw == 0;
    for (int s = 0; s < ns; ++s) {
      fits = fits && reinterpret_cast<uintptr_t>(a.s[s].words) % (4 * vw) == 0;
    }
    if (!fits) vw /= 2;
  }
  return log2_exact(vw);
}

inline int split_components(int k, int* w) {
  int n = 0;
  for (int i = 4; i >= 0; --i) {
    if ((k >> i) & 1) w[n++] = 1 << i;
  }
  return n;
}

// bits: ascending ladder bitwidths of the resident streams (one per
// stream).  Stream 0 holds bits[0]-bit codes, stream i the
// (bits[i] - bits[i-1] + 1)-bit compensated delta of level i.  Fills the
// fields every body reads; returns a cudaError_t.
inline int make_args(Args& a, const void* const* words, const int* bits, int ns, int M,
                     int N, int K, int block) {
  if (ns < 1 || ns > kMaxStreams || M < 1 || N < 1 || K < 1 || block < 32 ||
      block > kMaxBlock || block % 32 != 0 || bits[0] < 1 || bits[ns - 1] > 16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  a.M = M;
  a.N = N;
  a.K = K;
  a.block = block;
  a.nk = (K + block - 1) / block;
  int wmax = 1;
  int first = 0;
  for (int s = 0; s < ns; ++s) {
    if (s > 0 && bits[s] <= bits[s - 1]) return static_cast<int>(cudaErrorInvalidValue);
    Stream& st = a.s[s];
    st.words = words == nullptr ? nullptr : static_cast<const uint32_t*>(words[s]);
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
  return 0;
}

// The units the decode and short-prefill bodies stage.  A unit is the
// widest component's rows r = rho + t * rmin (t < umax) of one rho < rmin
// of a pack block, together with every narrower component's words for those
// rows (R_c / rmin of them, each copied once).  Fills wmax, rmin, umax, wpu,
// every component's glog, cbase, cs and spread mask, every stream's f32
// constants of the packed-field path, and `spread` (every stream's code fits
// wmax bits).
inline void unit_plan(Args& a, int ns) {
  a.wmax = 32 / a.slots;
  int wmin = a.wmax;
  for (int s = 0; s < ns; ++s) {
    for (int c = 0; c < a.s[s].ncomp; ++c) wmin = a.s[s].w[c] < wmin ? a.s[s].w[c] : wmin;
  }
  a.rmin = a.block * wmin / 32;
  a.umax = a.rmax / a.rmin;
  a.wpu = 0;
  a.spread = 1;
  for (int s = 0; s < ns; ++s) {
    Stream& st = a.s[s];
    a.spread = a.spread && st.code_bits <= a.wmax;
    int cs = 0;
    for (int c = 0; c < st.ncomp; ++c) {
      st.glog[c] = log2_exact(st.w[c] / wmin);
      st.cbase[c] = a.wpu;
      a.wpu += st.w[c] / wmin;
      st.cs[c] = cs;
      cs += st.w[c];
      st.spread[c] = 0u;
      for (int j = 0; j < a.slots; ++j) st.spread[c] |= ((1u << st.w[c]) - 1u) << (j * a.wmax);
    }
    st.fbias = 0x4B000000u | (1u << (st.code_bits - 1));
    st.foff = 8388608.f + static_cast<float>(1 << (st.code_bits - 1));
    st.fmul = static_cast<float>(1 << a.gap[s]);
    st.flo = static_cast<float>(a.lo[s]);
  }
}

}  // namespace nq_mm
