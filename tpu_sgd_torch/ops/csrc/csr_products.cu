// Deterministic sparse (CSR) x dense products for Hopper (sm_90a).  Built by
// tpu_sgd_torch/ops/_build.py with nvcc into a shared library with a plain C
// interface; tpu_sgd_torch/ops/cuda_kernels.py loads it with ctypes.
//
// Not a port of a Pallas kernel: the JAX package leaves its BCOO products
// to XLA (tpu_sgd/ops/gradients.py margins_of and grad_sum_of, gather and
// segment-sum).  The port's sparse SGD needs the same two products on the
// card, and they must give the same bits on every run, which the library
// products do not:
//   margins  out (rows, T) = X (rows, k) . rhs (k, T)      rhs = w or W^T
//   gradient out (d, T)    = Xt (d, n)  . coeff (n, T)     Xt = X^T as CSR
// Both are one operation: a CSR matrix times a row-major dense matrix with
// T columns (T = 1 for a vector).  The gradient runs on the transposed CSR
// (ops/sparse.py transpose_csr, a stable sort by column), so neither product
// scatters into shared output slots and neither needs a float atomic.
//
// Work split.  A CSR row is cut into segments of kSegEntries entries (RCV1's
// column popularity follows a Zipf law: its most popular columns appear in
// nearly every row, and one warp on such a column alone would be the whole
// kernel's tail).  seg_prefix[r] (computed by the wrapper: a cumulative sum of
// ceil(len_r / kSegEntries), zero for a row that the mask drops) numbers the
// segments in row order.  Phase 0: one thread per row writes its row id into
// seg_row for each of its segments (a warp that searched seg_prefix for its
// row instead spent ~20 dependent loads: on an H100 80GB HBM3 that version
// took 0.61 ms for RCV1's margins, the library product 0.21).  Phase 1: one warp per segment reads its
// row, its lanes stride the segment's entries in a fixed order, each
// accumulating in f32, and a fixed shuffle tree adds the 32 lanes; lane 0
// writes the segment's partial.  Phase 2: one thread per output element adds
// its row's segment partials in segment order.  A row
// with no segment (masked out, or empty) writes 0 and reads nothing of X.
// The order of every addition depends only on the matrix's structure, so
// two calls on the same inputs are bitwise equal.
//
// What bounds it: bytes.  Each entry is a 4-byte value, a 4- or 8-byte
// column index and a 4-byte gather of rhs per output column; at 2 flops an
// entry and column it is far below the card's rate.  The gathers of rhs hit
// L2 (w of RCV1 is 189 KB), so the floor is the entry stream plus the row
// pointers and the output.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// entries of one segment: 32 a lane
constexpr long long kSegEntries = 1024;

__device__ __forceinline__ float warp_sum(float v) {
  // a fixed tree: lane 0 ends with ((l0 + l16) + (l8 + l24)) + ..., the
  // same order on every call
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

__global__ void __launch_bounds__(kThreads)
segment_rows(const long long* __restrict__ seg_prefix, long long rows,
             long long* __restrict__ seg_row) {
  const long long r =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (r >= rows) return;
  for (long long s = seg_prefix[r]; s < seg_prefix[r + 1]; ++s)
    seg_row[s] = r;
}

template <typename I>
__global__ void __launch_bounds__(kThreads)
segment_partials(const I* __restrict__ crow, const I* __restrict__ col,
                 const float* __restrict__ val,
                 const float* __restrict__ rhs, int T,
                 const long long* __restrict__ seg_prefix,
                 const long long* __restrict__ seg_row, long long rows,
                 float* __restrict__ partial) {
  const long long seg =
      static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (seg >= seg_prefix[rows]) return;
  const long long r = seg_row[seg];
  const long long first = static_cast<long long>(crow[r]) +
                          (seg - seg_prefix[r]) * kSegEntries;
  const long long row_end = static_cast<long long>(crow[r + 1]);
  const long long last =
      first + kSegEntries < row_end ? first + kSegEntries : row_end;
  for (int t = 0; t < T; ++t) {
    float acc = 0.0f;
    for (long long e = first + lane; e < last; e += 32)
      acc = fmaf(val[e], rhs[static_cast<long long>(col[e]) * T + t], acc);
    acc = warp_sum(acc);
    if (lane == 0) partial[seg * T + t] = acc;
  }
}

__global__ void __launch_bounds__(kThreads)
combine_rows(const float* __restrict__ partial,
             const long long* __restrict__ seg_prefix, long long rows, int T,
             float* __restrict__ out) {
  const long long idx =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (idx >= rows * T) return;
  const long long r = idx / T;
  const int t = static_cast<int>(idx - r * T);
  float acc = 0.0f;
  for (long long s = seg_prefix[r]; s < seg_prefix[r + 1]; ++s)
    acc += partial[s * T + t];
  out[idx] = acc;
}

template <typename I>
int launch(const void* crow, const void* col, const void* val,
           const void* rhs, int T, const void* seg_prefix, long long rows,
           long long max_segs, void* seg_row, void* partial, void* out,
           cudaStream_t stream) {
  if (rows > 0) {
    const long long blocks = (rows + kThreads - 1) / kThreads;
    if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
    segment_rows<<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
        static_cast<const long long*>(seg_prefix), rows,
        static_cast<long long*>(seg_row));
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (max_segs > 0) {
    const long long blocks = (max_segs + kWarps - 1) / kWarps;
    if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
    segment_partials<I><<<static_cast<unsigned>(blocks), kThreads, 0,
                          stream>>>(
        static_cast<const I*>(crow), static_cast<const I*>(col),
        static_cast<const float*>(val), static_cast<const float*>(rhs), T,
        static_cast<const long long*>(seg_prefix),
        static_cast<const long long*>(seg_row), rows,
        static_cast<float*>(partial));
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const long long elems = rows * T;
  if (elems > 0) {
    const long long blocks = (elems + kThreads - 1) / kThreads;
    if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
    combine_rows<<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
        static_cast<const float*>(partial),
        static_cast<const long long*>(seg_prefix), rows, T,
        static_cast<float*>(out));
    return cudaGetLastError();
  }
  return cudaSuccess;
}

}  // namespace

extern "C" {

// Entries a segment (the wrapper sizes seg_prefix and the partials by it).
long long tsgd_csr_segment_entries() { return kSegEntries; }

// out (rows, T) = CSR (crow, col, val) x rhs (k, T), both phases on
// `stream`.  index_bytes is 4 (int32 crow and col) or 8 (int64).
// seg_prefix (rows + 1, int64) numbers the segments; max_segs bounds its
// last entry and sizes the grid; seg_row holds max_segs int64 (each
// segment's row, written here); partial holds max_segs x T floats.
// Returns the cudaError_t of the launches (0 on success).  Does not
// synchronise.
int tsgd_csr_matmul(int index_bytes, const void* crow, const void* col,
                    const void* val, const void* rhs, int T,
                    const void* seg_prefix, long long rows,
                    long long max_segs, void* seg_row, void* partial,
                    void* out, void* stream) {
  if (rows < 0 || T < 1 || max_segs < 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (index_bytes == 4)
    return launch<int32_t>(crow, col, val, rhs, T, seg_prefix, rows,
                           max_segs, seg_row, partial, out, s);
  if (index_bytes == 8)
    return launch<int64_t>(crow, col, val, rhs, T, seg_prefix, rows,
                           max_segs, seg_row, partial, out, s);
  return cudaErrorInvalidValue;
}

const char* tsgd_csr_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
