// Hand-written Hopper (sm_90a) kernel for the page-in upgrade recompose:
//
//   nq_nest_recompose  replaces repro/kernels/nest_recompose/kernel.py:28
//                      nest_recompose
//
// What it computes: out[k, n] = clip(w_high[k, n] * 2^(n_bits - h) +
// w_low[k, n], INT-n_bits) as int8, where w_high holds h-bit codes and
// w_low the (n_bits - h + 1)-bit compensated delta, both block-packed
// along K (repro/core/decompose.py recompose, paper Eq. 6).  No matmul:
// the upgrade path never touches dequantized floats.
//
// What bounds it: (h + l + 1) / 8 bytes read and 1 byte written per
// weight, a handful of integer operations each: the bound is the bytes.
// The design: one thread per output code, 128 neighbouring columns per
// CTA row so every word-row read and every int8 store is coalesced; each
// code is unpacked BY INDEX - element p of pack block b sits, per
// power-of-two component c of width w, in word row b * rows_pb + off_c +
// p mod R_c at bit (p div R_c) * w - the same rule as the matmul and QK
// kernels, so no tile has to equal the pack block.  Each thread walks 8
// rows of K.
//
// Limits (the Python wrapper checks them first): 1 <= h < n_bits <= 8 (the
// output is int8), pack block >= 1.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxComps = 4;
constexpr int kCols = 128;    // columns per CTA, one per thread
constexpr int kRows = 8;      // rows of K per thread

struct Stream {
  const uint32_t* words;  // (nk * rows_pb, N)
  int rows_pb;
  int code_bits;
  int ncomp;
  int w[kMaxComps];
  int R[kMaxComps];
  int off[kMaxComps];
};

struct Args {
  Stream hi, lo;
  int8_t* out;            // (K, N)
  int K, N, block, shift, cmin, cmax;
};

int split_components(int k, int* w) {
  int n = 0;
  for (int i = 3; i >= 0; --i) {
    if ((k >> i) & 1) w[n++] = 1 << i;
  }
  return n;
}

void describe(Stream& st, const void* words, int bits, int block) {
  st.words = static_cast<const uint32_t*>(words);
  st.code_bits = bits;
  st.ncomp = split_components(bits, st.w);
  int off = 0;
  for (int c = 0; c < st.ncomp; ++c) {
    const int per_word = 32 / st.w[c];
    st.R[c] = (block + per_word - 1) / per_word;
    st.off[c] = off;
    off += st.R[c];
  }
  st.rows_pb = off;
}

__device__ __forceinline__ int unpack(const Stream& st, int b, int p, int n, int N) {
  uint32_t u = 0u;
  int cs = 0;
#pragma unroll
  for (int c = 0; c < kMaxComps; ++c) {
    if (c < st.ncomp) {
      const int R = st.R[c];
      const size_t row = static_cast<size_t>(b) * st.rows_pb + st.off[c] + p % R;
      const uint32_t word = __ldg(st.words + row * N + n);
      const int w = st.w[c];
      u |= ((word >> ((p / R) * w)) & ((1u << w) - 1u)) << cs;
      cs += w;
    }
  }
  int v = static_cast<int>(u);
  if (v >= (1 << (st.code_bits - 1))) v -= (1 << st.code_bits);
  return v;
}

__global__ void __launch_bounds__(kCols) nest_recompose(const Args a) {
  const int n = blockIdx.x * kCols + threadIdx.x;
  if (n >= a.N) return;
  const int k0 = blockIdx.y * kRows;
  const int k1 = min(k0 + kRows, a.K);
  for (int k = k0; k < k1; ++k) {
    const int b = k / a.block;
    const int p = k - b * a.block;
    const int v = unpack(a.hi, b, p, n, a.N) * (1 << a.shift) + unpack(a.lo, b, p, n, a.N);
    a.out[static_cast<size_t>(k) * a.N + n] = static_cast<int8_t>(min(max(v, a.cmin), a.cmax));
  }
}

}  // namespace

extern "C" {

// words_high (nk * rows_h, N), words_low (nk * rows_l, N) int32 packed along
// K with ``block``; out (K, N) int8.  All contiguous.
int nq_nest_recompose(const void* words_high, const void* words_low, void* out, int n,
                      int h, int K, int N, int block, void* stream) {
  if (h < 1 || n <= h || n > 8 || K < 1 || N < 1 || block < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args a = {};
  describe(a.hi, words_high, h, block);
  describe(a.lo, words_low, n - h + 1, block);
  a.out = static_cast<int8_t*>(out);
  a.K = K;
  a.N = N;
  a.block = block;
  a.shift = n - h;
  a.cmin = -(1 << (n - 1));
  a.cmax = (1 << (n - 1)) - 1;
  const dim3 grid((N + kCols - 1) / kCols, (K + kRows - 1) / kRows);
  if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidValue);
  nest_recompose<<<grid, kCols, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
