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
// weight, and ~10 integer operations per weight to unpack and recompose
// it: the bytes, with the card's integer issue rate not far behind.
//
// The layout it exploits: element p of pack block b sits, per
// power-of-two component c of width w_c, in word row b * rows_pb + off_c +
// p mod R_c at bit (p div R_c) * w_c.  When the block is a multiple of 32,
// R_c = block * w_c / 32 exactly, so with R_min = block * w_min / 32 (w_min
// the narrowest component of either stream) the positions p = r + j *
// R_min (0 <= r < R_min) find every component of both streams in the word
// rows r, r + R_min, r + 2 R_min, ... of the block (word i of that run is
// row b * rows_pb + r + i * R_min), and code j of component c lies in word
// off_c / R_min + j mod m, m = w_c / w_min, at field j div m.
//
// The fast path (block a multiple of 32, N a multiple of 4, both word
// streams 16-byte aligned; every main-path launch):
//   * four threads per (pack block, r, 4 neighbouring columns).  Thread js
//     takes the codes j = js + 4 * jj and loads only the words they use
//     (3 of the run's 7 at (6, 4)), 16 bytes each along N, all before any
//     is used.  The four threads are neighbouring lanes, so a word they
//     share is one request: every word leaves device memory once, and a
//     warp reads 128 contiguous bytes per word row;
//   * each thread emits 32 / w_min / 4 codes per column (8 at (6, 4)) with
//     shifts and masks only: the kernel is instantiated per (h, n_bits) (28
//     pairs, each a small unrolled body), so every field's word, shift and
//     mask is a constant (one runtime shift per loaded word aligns the
//     thread's fields);
//   * each output row goes out as one 4-byte store of the 4 columns'
//     codes, 8 neighbouring column groups of a warp writing 32 contiguous
//     bytes per row;
//   * the upper clip is never reached (hi * 2^l + lo <= 2^(n-1) - 1 for
//     any h-bit hi and (l+1)-bit lo), so only the lower one is applied.
// The general path of the same kernel takes the rest: a pack block that
// is not a multiple of 32, an N that is not a multiple of 4, a word-stream
// view that is not 16-byte aligned.  One thread per (column, run of 32
// positions of a block) walks its positions with running (p mod R_c,
// p div R_c) counters per component - no divide per code - reading 4-byte
// words (coalesced along N) and storing single bytes.
//
// Limits (the Python wrapper checks them first): 1 <= h < n_bits <= 8 (the
// output is int8), pack block >= 1.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 32;     // general path: positions per thread

// the power-of-two components of a k-bit field, widest first (bits 4..1)
__host__ __device__ constexpr int comp_width(int k, int c) {
  for (int i = 3; i >= 0; --i) {
    if ((k >> i) & 1) {
      if (c == 0) return 1 << i;
      --c;
    }
  }
  return 0;
}

__host__ __device__ constexpr int comp_count(int k) {
  return ((k >> 3) & 1) + ((k >> 2) & 1) + ((k >> 1) & 1) + (k & 1);
}

// the narrowest component of a field: its lowest set bit
__host__ __device__ constexpr int narrowest(int k) { return k & -k; }

struct Args {
  const uint32_t* hi;     // (nk * rows_h, N)
  const uint32_t* lo;     // (nk * rows_l, N)
  int8_t* out;            // (K, N)
  int K, N, block, nk;
  int rmin;               // fast path: R_min = block * w_min / 32
  int general;            // 1: the general path takes the whole launch
};

// Fast path.  Four threads share a run of words (rows r + i * R_min of a
// block); thread js takes the codes j = js + 4 * jj and loads only the words
// they use.  Component c of width w_c spans m = w_c / w_min words of the run:
// for m <= 4 code j lies in word j mod m = js mod m alone, at field
// js div m + (4 / m) * jj; for m > 4 in word js + 4 * (jj mod (m / 4)), at
// field jj div (m / 4).
__host__ __device__ constexpr int comp_words(int k, int c, int wmin) {
  return comp_width(k, c) / wmin <= 4 ? 1 : comp_width(k, c) / wmin / 4;
}

__host__ __device__ constexpr int thread_words(int k, int wmin) {
  int n = 0;
  for (int c = 0; c < comp_count(k); ++c) n += comp_words(k, c, wmin);
  return n;
}

// the thread's words of one k-bit stream, 4 columns each, every one shifted
// so that field jj of its component starts at a constant bit
template <int KB, int WMIN>
__device__ __forceinline__ void fast_load(uint32_t (&w)[4][thread_words(KB, WMIN)],
                                          const uint32_t* words, size_t row0, int rmin, int N,
                                          int col, int js) {
  uint4 v[thread_words(KB, WMIN)];
  int shift[thread_words(KB, WMIN)];
  int k = 0, prefix = 0;
#pragma unroll
  for (int c = 0; c < comp_count(KB); ++c) {
    const int wc = comp_width(KB, c);
    const int m = wc / WMIN;
#pragma unroll
    for (int t = 0; t < comp_words(KB, c, WMIN); ++t, ++k) {
      const int i = prefix / WMIN + (m <= 4 ? js % m : js + 4 * t);
      shift[k] = m <= 4 ? (js / m) * wc : 0;
      v[k] = __ldg(reinterpret_cast<const uint4*>(words + (row0 + static_cast<size_t>(i) * rmin) * N
                                                  + col));
    }
    prefix += wc;
  }
#pragma unroll
  for (int i = 0; i < thread_words(KB, WMIN); ++i) {
    w[0][i] = v[i].x >> shift[i];
    w[1][i] = v[i].y >> shift[i];
    w[2][i] = v[i].z >> shift[i];
    w[3][i] = v[i].w >> shift[i];
  }
}

// the k-bit code jj of the thread (code j = js + 4 * jj of the run) in one
// column, every word index and shift a constant once unrolled
template <int KB, int WMIN>
__device__ __forceinline__ int fast_code(const uint32_t (&w)[thread_words(KB, WMIN)], int jj) {
  uint32_t u = 0u;
  int k = 0, prefix = 0;
#pragma unroll
  for (int c = 0; c < comp_count(KB); ++c) {
    const int wc = comp_width(KB, c);
    const int m = wc / WMIN;
    uint32_t field;
    if (m <= 4) {
      field = w[k] >> ((4 / m) * wc * jj);
    } else {
      const int mm = m / 4;
      field = w[k + jj % mm] >> ((jj / mm) * wc);
    }
    u |= (field & ((1u << wc) - 1u)) << prefix;
    k += comp_words(KB, c, WMIN);
    prefix += wc;
  }
  return static_cast<int>(u << (32 - KB)) >> (32 - KB);
}

// General path: running (p mod R_c, p div R_c) of one component
struct Walk {
  int r, q, R;
  size_t row;             // first word row of the component in the block
};

template <int KB>
__device__ __forceinline__ void walk_start(Walk (&st)[comp_count(KB)], int block, int b, int p0) {
  int off = 0;
#pragma unroll
  for (int c = 0; c < comp_count(KB); ++c) {
    const int R = (block * comp_width(KB, c) + 31) >> 5;
    st[c].R = R;
    st[c].r = p0 % R;     // once per thread, not per code
    st[c].q = p0 / R;
    st[c].row = off;
    off += R;
  }
#pragma unroll
  for (int c = 0; c < comp_count(KB); ++c) st[c].row += static_cast<size_t>(b) * off;
}

template <int KB>
__device__ __forceinline__ int walk_code(Walk (&st)[comp_count(KB)], const uint32_t* words,
                                         int N, int n) {
  uint32_t u = 0u;
  int prefix = 0;
#pragma unroll
  for (int c = 0; c < comp_count(KB); ++c) {
    const int wc = comp_width(KB, c);
    const uint32_t word = __ldg(words + (st[c].row + st[c].r) * N + n);
    u |= ((word >> (st[c].q * wc)) & ((1u << wc) - 1u)) << prefix;
    prefix += wc;
    if (++st[c].r == st[c].R) {
      st[c].r = 0;
      ++st[c].q;
    }
  }
  return static_cast<int>(u << (32 - KB)) >> (32 - KB);
}

template <int H, int L1>
__global__ void __launch_bounds__(kThreads) nest_recompose(const Args a) {
  constexpr int SHIFT = L1 - 1;                    // n - h
  constexpr int CMIN = -(1 << (H + L1 - 2));       // -2^(n - 1)
  const long long tid = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;

  if (a.general) {
    const int nch = (a.block + kChunk - 1) / kChunk;
    if (tid >= static_cast<long long>(a.nk) * nch * a.N) return;
    const int n = static_cast<int>(tid % a.N);
    const long long rest = tid / a.N;
    const int ch = static_cast<int>(rest % nch);
    const int b = static_cast<int>(rest / nch);
    const int p0 = ch * kChunk;
    const int p1 = min(min(p0 + kChunk, a.block), a.K - b * a.block);
    Walk wh[comp_count(H)], wl[comp_count(L1)];
    walk_start<H>(wh, a.block, b, p0);
    walk_start<L1>(wl, a.block, b, p0);
    int8_t* o = a.out + (static_cast<size_t>(b) * a.block + p0) * a.N + n;
    for (int p = p0; p < p1; ++p, o += a.N) {
      const int v = walk_code<H>(wh, a.hi, a.N, n) * (1 << SHIFT) + walk_code<L1>(wl, a.lo, a.N, n);
      *o = static_cast<int8_t>(max(v, CMIN));
    }
    return;
  }

  constexpr int WMIN = narrowest(H) < narrowest(L1) ? narrowest(H) : narrowest(L1);
  constexpr int CODES = 32 / WMIN / 4;             // codes per thread and column
  const int NG = a.N >> 2;
  if (tid >= 4LL * a.nk * a.rmin * NG) return;
  const int js = static_cast<int>(tid & 3);
  const long long item = tid >> 2;
  const int cg = static_cast<int>(item % NG);
  const long long rest = item / NG;
  const int r = static_cast<int>(rest % a.rmin);
  const int b = static_cast<int>(rest / a.rmin);
  const int bpw = a.block >> 5;                    // block / 32
  uint32_t wh[4][thread_words(H, WMIN)], wl[4][thread_words(L1, WMIN)];
  fast_load<H, WMIN>(wh, a.hi, static_cast<size_t>(b) * bpw * H + r, a.rmin, a.N, 4 * cg, js);
  fast_load<L1, WMIN>(wl, a.lo, static_cast<size_t>(b) * bpw * L1 + r, a.rmin, a.N, 4 * cg, js);
  const int k0 = b * a.block + r + js * a.rmin;
  uint32_t* o = reinterpret_cast<uint32_t*>(a.out + static_cast<size_t>(k0) * a.N) + cg;
  const size_t step = 4 * static_cast<size_t>(a.rmin) * NG;   // 4 R_min rows, in words
#pragma unroll
  for (int jj = 0; jj < CODES; ++jj) {
    if (k0 + 4 * jj * a.rmin < a.K) {
      uint32_t packed = 0u;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int v = fast_code<H, WMIN>(wh[c], jj) * (1 << SHIFT) + fast_code<L1, WMIN>(wl[c], jj);
        packed |= (static_cast<uint32_t>(max(v, CMIN)) & 0xffu) << (8 * c);
      }
      o[jj * step] = packed;
    }
  }
}

using Launch = void (*)(const Args&, dim3, cudaStream_t);

template <int H, int L1>
void launch(const Args& a, dim3 grid, cudaStream_t s) {
  nest_recompose<H, L1><<<grid, kThreads, 0, s>>>(a);
}

Launch pick(int n, int h) {
#define NQ_PAIR(N_, H_) \
  case (N_) * 16 + (H_): return launch<H_, N_ - H_ + 1>;
  switch (n * 16 + h) {
    NQ_PAIR(2, 1)
    NQ_PAIR(3, 1) NQ_PAIR(3, 2)
    NQ_PAIR(4, 1) NQ_PAIR(4, 2) NQ_PAIR(4, 3)
    NQ_PAIR(5, 1) NQ_PAIR(5, 2) NQ_PAIR(5, 3) NQ_PAIR(5, 4)
    NQ_PAIR(6, 1) NQ_PAIR(6, 2) NQ_PAIR(6, 3) NQ_PAIR(6, 4) NQ_PAIR(6, 5)
    NQ_PAIR(7, 1) NQ_PAIR(7, 2) NQ_PAIR(7, 3) NQ_PAIR(7, 4) NQ_PAIR(7, 5) NQ_PAIR(7, 6)
    NQ_PAIR(8, 1) NQ_PAIR(8, 2) NQ_PAIR(8, 3) NQ_PAIR(8, 4) NQ_PAIR(8, 5) NQ_PAIR(8, 6)
    NQ_PAIR(8, 7)
    default: return nullptr;
  }
#undef NQ_PAIR
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
  const Launch fn = pick(n, h);
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  Args a = {};
  a.hi = static_cast<const uint32_t*>(words_high);
  a.lo = static_cast<const uint32_t*>(words_low);
  a.out = static_cast<int8_t*>(out);
  a.K = K;
  a.N = N;
  a.block = block;
  a.nk = (K + block - 1) / block;
  const int l1 = n - h + 1;
  const int wmin = narrowest(h) < narrowest(l1) ? narrowest(h) : narrowest(l1);
  a.rmin = (block / 32) * wmin;
  a.general = block % 32 != 0 || N % 4 != 0 ||
              reinterpret_cast<uintptr_t>(words_high) % 16 != 0 ||
              reinterpret_cast<uintptr_t>(words_low) % 16 != 0 ||
              reinterpret_cast<uintptr_t>(out) % 4 != 0;
  const long long threads =
      a.general ? static_cast<long long>(a.nk) * ((block + kChunk - 1) / kChunk) * N
                : 4LL * a.nk * a.rmin * (N / 4);
  const long long blocks = (threads + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  fn(a, dim3(static_cast<unsigned>(blocks)), static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
