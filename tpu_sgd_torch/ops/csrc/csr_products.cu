// Deterministic sparse (CSR) x dense products for Hopper (sm_90a).  Built by
// tpu_sgd_torch/ops/_build.py with nvcc into a shared library with a plain C
// interface; tpu_sgd_torch/ops/cuda_kernels.py loads it with ctypes and
// mirrors its work split in Python (csr_split, csr_walker_lanes, csr_walk).
//
// What it replaces.  No Pallas kernel: the JAX package leaves its BCOO
// products to XLA (tpu_sgd/ops/gradients.py:61 margins_of and :81
// grad_sum_of, a gather and a segment sum).  The port's sparse SGD and its
// line searches need the same two products on the card, with the same bits
// on every run, which the library products do not give:
//   margins  out (rows, T) = X (rows, k) . rhs (k, T)      rhs = w or W^T
//   gradient out (d, T)    = Xt (d, n)  . coeff (n, T)     Xt = X^T as CSR
// Both are one operation: a CSR matrix times a row-major dense matrix with
// T columns (T = 1 for a vector), f32 values and sums, int32 or int64
// indices.  The gradient runs on the transposed CSR (ops/sparse.py), so no
// product scatters into shared output slots and none needs a float atomic.
//
// What bounds it: bytes.  Each entry is a 4-byte value and a 4- or 8-byte
// column index, read once; then the row pointers, the mask and the output.
// At 2 flops an entry and column it is far below the card's rate.  The
// gathers of rhs are not in that count: rhs is small (RCV1's w is 189 KB,
// coeff 2.8 MB, 30 trial points 5.7 MB) and stays in L2, but each entry
// still pulls its 4*T-byte line of rhs through L1 (where w must stay: the
// kernel keeps its shared memory small, and reads entries with streaming
// loads that do not displace it).
//
// Design: the merge path of Merrill and Garland's CSR product.  The rows'
// end marks and the entries form one path of rows + nnz items, each row's
// end mark right after its last entry.  What it does about the costs of a
// segment-a-warp design (a warp for each 1,024-entry piece of a row):
// 1. The kernel finds its own balanced share; no torch set-up.  Block b
//    takes path items [b*S, (b+1)*S) (S = block_items: 3,840, or 7,680
//    under a mask, which leaves most entries unread).  Two warps find the
//    block's first and last rows in crow, 32 probes a step, the first step
//    half spent where rows of equal length would put the diagonal (one
//    step for such a matrix).  The split depends on rows, nnz and S alone,
//    so the order of every addition is fixed by the matrix's structure and
//    two calls give the same bits.  The block's first 512 row ends (as
//    32-bit offsets from its first entry) and mask bytes go to shared
//    memory; inside the block, kThreads / W
//    walkers of W lanes each take S * W / kThreads consecutive path items
//    and find their first row by a binary search there.  A long row spans
//    walkers and blocks; many short rows share one walker.
// 2. No warp spends itself on one short row.  At T = 1 a walker is one
//    thread: the block first makes its products val[e] * rhs[col[e]] with
//    all threads over consecutive entries (coalesced, 15 loads in flight a
//    thread, issued before the walkers search) into shared memory, and a
//    walker then adds its rows' products in entry order.  Above T = 1 a
//    walker's lanes each take columns and run one fmaf chain a column.
// 3. Every entry is read once, whatever T is (not once a column).
//    rhs is row-major (k, T), so the T values one entry needs are one
//    line: a walker's W lanes (T rounded up to a power of two, at most 32)
//    each take C = ceil(T / W) columns t = lane + c*W, read the entry's
//    value and index once (a broadcast) and its line as W-wide pieces.
// 4. Rows that cross a boundary are completed without atomics, and no
//    thread walks a long list of partials (one thread adding all of a
//    Zipf-head row's partials was a serial tail).  A walker writes a row that
//    lies whole inside it; the unfinished row it ends inside is its tail.
//    The walkers' tails are scanned by row (at T = 1 by shuffles within a
//    warp, then the 8 warps' totals chained in order; above, a
//    Hillis-Steele scan over the walkers in shared memory), and a walker
//    that finishes a row begun before it adds the scan of the walkers
//    before it.  Where that row began in an earlier block, the block
//    writes the sum as its head carry instead of the output, and every
//    block writes the scanned tail of the row it ends inside as its tail
//    carry.  Pass 2 (csr_fixup), one warp a block with a head carry, adds
//    the tail carries of the blocks from the one holding the row's first
//    entry ((crow[r] + r) / S) up to its own, lanes strided over the
//    blocks and a fixed shuffle tree, then the head: a Zipf-head row of Xt
//    over hundreds of blocks is summed by 32 lanes.
// 5. No round trip of partials.  The carries are 2T + 2 floats a block of
//    S items, not a row id and a partial for every 1,024-entry piece, in
//    one buffer the caller allocates with
//    the output, both sized from rows, nnz and S.  Two launches; nothing is
//    read back to the host, so a call can be captured in a CUDA graph.
// The mask is applied here: a row it drops reads none of its entries and
// writes 0.  cuda_kernels.csr_walk is this arithmetic in numpy, in order.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kFixupWarps = kThreads / 32;
// path items a thread at T = 1: all of them are loaded in one round
constexpr int kItems = 15;
// row ends of a block kept in shared memory (more are read from crow)
constexpr int kWindow = 512;

__device__ __forceinline__ long long warp_min(long long x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = min(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ long long warp_max(long long x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = max(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

// The block's first and last rows: the rows whose end mark lies among the
// first d0 (d1) path items.  Warp 0 finds the first, warp 1 the last.  A
// step probes 32 rows and keeps the range between the last row found left
// of the diagonal and the first found right of it.  The first step spends
// 16 probes on the rows around where a matrix of equal rows would put the
// diagonal (exact for such a matrix) and 16 on an even spread; later steps
// spread all 32.
template <typename I>
__device__ void block_rows(const I* __restrict__ crow, long long d0,
                           long long d1, long long rows, long long nnz,
                           long long* s_rows) {
  const int warp = threadIdx.x >> 5;
  if (warp < 2) {
    const int lane = threadIdx.x & 31;
    const long long diag = warp == 0 ? d0 : d1;
    long long lo = 0, hi = rows;
    const long long guess = static_cast<long long>(
        static_cast<double>(diag) * static_cast<double>(rows) /
        static_cast<double>(rows + nnz));
    bool first = true;
    while (hi > lo) {
      long long q;
      if (!first)
        q = lo + ((hi - lo) * (lane + 1)) / 32;  // lane 31: hi
      else if (lane < 16)
        q = min(max(guess - 8 + lane, lo), hi);
      else
        q = lo + ((hi - lo) * (lane - 15)) / 16;  // lane 31: hi
      first = false;
      // one past the path position of row q's end mark: crow[q + 1]
      // entries and q end marks come before it
      const bool right =
          q >= hi || static_cast<long long>(__ldg(crow + q + 1)) + q + 1 > diag;
      lo = warp_max(right ? lo : q + 1);
      hi = warp_min(right ? q : hi);
    }
    if (lane == 0) s_rows[warp] = lo;
  }
  __syncthreads();
}

// A streamed (read-once) load of an entry's index or value.
template <typename T>
__device__ __forceinline__ T load_once(const T* p) {
  return __ldcs(p);
}
template <>
__device__ __forceinline__ int64_t load_once(const int64_t* p) {
  return static_cast<int64_t>(__ldcs(reinterpret_cast<const long long*>(p)));
}

// Stage the block's first kWindow row ends, as offsets from its first
// entry eb, into s_end, and the mask bytes of rows rb .. rb + nwin (those
// below rows) into s_mask.
template <typename I>
__device__ void stage_rows(const I* __restrict__ crow,
                           const uint8_t* __restrict__ mask, long long rows,
                           long long rb, long long eb, int nwin, int* s_end,
                           uint8_t* s_mask) {
  for (int i = threadIdx.x; i <= nwin; i += kThreads) {
    if (i < nwin) s_end[i] = static_cast<int>(__ldg(crow + rb + 1 + i) - eb);
    if (mask != nullptr && rb + i < rows) s_mask[i] = mask[rb + i];
  }
}

// A block's rows rb + i in 32-bit offsets from its first row and its
// first entry eb: end(i) = crow[rb + i + 1] - eb (at most S), the first
// kWindow from shared memory.
template <typename I>
struct LocalRows {
  const I* crow;
  const int* s_end;
  const uint8_t* mask;
  const uint8_t* s_mask;
  long long rb;
  long long eb;
  int nwin;
  int nrows;   // no row at or past it: rows - rb, or past the block's
  // where row rb starts: -1 if before the block's first entry eb (by any
  // distance, which may pass 32 bits in an int64 CSR), else 0
  int start0;
  __device__ int end(int i) const {
    return i < nwin ? s_end[i]
                    : static_cast<int>(__ldg(crow + rb + i + 1) - eb);
  }
  __device__ int start(int i) const { return i == 0 ? start0 : end(i - 1); }
  __device__ bool kept(int i) const {
    if (i >= nrows) return false;
    if (mask == nullptr) return true;
    return (i <= nwin ? s_mask[i] : mask[rb + i]) != 0;
  }
  // the rows in [lo, hi] whose end mark lies among the first diag items
  // of the block
  __device__ int search(int diag, int lo, int hi) const {
    while (hi > lo) {
      const int mid = lo + (hi - lo) / 2;
      if (end(mid) + mid + 1 > diag)
        hi = mid;
      else
        lo = mid + 1;
    }
    return lo;
  }
};

// The walkers' tails scanned by row, then each finished row and the
// block's carries written.  acc holds the walker's tail (row r1), part
// its part of row r0 when it finishes a row begun before it (has_head).
// Slot w of s_tail ends as the sum of the run of walkers up to w whose
// tail is row s_key[w] (Hillis-Steele, log2(walkers) steps).
template <int W, int C>
__device__ void finish(const float (&acc)[C], float (&part)[C], bool has_head,
                       long long r0, long long r1, long long carried_row,
                       long long b, int T, long long* s_key, float* s_tail,
                       float* __restrict__ out, float* __restrict__ head,
                       float* __restrict__ tail) {
  constexpr int kWalkers = kThreads / W;
  constexpr int kSlot = W * C;
  const int w = threadIdx.x / W;
  const int lane = threadIdx.x % W;
  float mine[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    mine[c] = acc[c];
    s_tail[w * kSlot + lane + c * W] = acc[c];
  }
  if (lane == 0) s_key[w] = r1;
  __syncthreads();
  for (int step = 1; step < kWalkers; step <<= 1) {
    const bool take = w >= step && s_key[w - step] == s_key[w];
    float left[C];
    if (take) {
#pragma unroll
      for (int c = 0; c < C; ++c)
        left[c] = s_tail[(w - step) * kSlot + lane + c * W];
    }
    __syncthreads();
    if (take) {
#pragma unroll
      for (int c = 0; c < C; ++c) {
        mine[c] = left[c] + mine[c];
        s_tail[w * kSlot + lane + c * W] = mine[c];
      }
    }
    __syncthreads();
  }
  if (has_head) {
    // walker w - 1 ends inside row r0, and so do all the block's walkers
    // before w that hold any of it
    if (w > 0) {
#pragma unroll
      for (int c = 0; c < C; ++c)
        part[c] = s_tail[(w - 1) * kSlot + lane + c * W] + part[c];
    }
    float* dst = r0 == carried_row ? head + b * T : out + r0 * T;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int t = lane + c * W;
      if (t < T) dst[t] = part[c];
    }
  }
  if (w == kWalkers - 1) {
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int t = lane + c * W;
      if (t < T) tail[b * T + t] = mine[c];
    }
  }
}

// finish at T = 1, where a walker is one thread: the tails are scanned by
// row within each warp by shuffles (Hillis-Steele, 5 steps), then the
// warps' totals are chained in warp order (at most kThreads / 32 of them)
// and added to the walkers whose run began in an earlier warp.
__device__ void finish_1(float acc, float part, bool has_head, long long r0,
                         long long r1, long long carried_row, long long b,
                         long long* s_wkey, float* s_wsum,
                         float* __restrict__ out, float* __restrict__ head,
                         float* __restrict__ tail) {
  constexpr int kWarps = kThreads / 32;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float v = acc;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const float up = __shfl_up_sync(0xffffffffu, v, d);
    const long long key = __shfl_up_sync(0xffffffffu, r1, d);
    if (lane >= d && key == r1) v = up + v;
  }
  if (lane == 31) {
    s_wkey[warp] = r1;
    s_wsum[warp] = v;
  }
  __syncthreads();
  // run: the scanned total of warp i's last walker; before: warp - 1's
  float run = s_wsum[0];
  float before = run;
  long long before_key = s_wkey[0];
#pragma unroll
  for (int i = 1; i < kWarps; ++i) {
    const long long key = s_wkey[i];
    run = s_wkey[i - 1] == key ? run + s_wsum[i] : s_wsum[i];
    if (i == warp - 1) {
      before = run;
      before_key = key;
    }
  }
  if (warp > 0 && before_key == r1) v = before + v;
  // the scanned tail of walker threadIdx.x - 1
  float prev = __shfl_up_sync(0xffffffffu, v, 1);
  if (lane == 0) prev = before;
  if (has_head) {
    // walker threadIdx.x - 1 ends inside row r0, and so do all the
    // block's walkers before this one that hold any of it
    if (threadIdx.x > 0) part = prev + part;
    if (r0 == carried_row)
      head[b] = part;
    else
      out[r0] = part;
  }
  if (threadIdx.x == kThreads - 1) tail[b] = v;
}

// Pass 1 at T = 1: a thread a walker.  The block's products
// val[e] * rhs[col[e]] are made first, by all its threads over
// consecutive entries (coalesced loads, kItems in flight a thread, issued
// before the walkers search when no mask is given), into shared memory;
// each walker then adds its rows' products from there.
template <typename I>
__global__ void __launch_bounds__(kThreads)
csr_blocks_1(const I* __restrict__ crow, const I* __restrict__ col,
             const float* __restrict__ val, const float* __restrict__ rhs,
             const uint8_t* __restrict__ mask, long long rows, long long nnz,
             long long S, float* __restrict__ out,
             long long* __restrict__ head_row, float* __restrict__ head,
             float* __restrict__ tail) {
  extern __shared__ float s_prod[];  // S floats, then S keep bytes (mask)
  __shared__ long long s_rows[2];
  __shared__ int s_end[kWindow];
  __shared__ uint8_t s_mask[kWindow + 1];
  __shared__ int s_first[kThreads + 1];
  __shared__ long long s_wkey[kThreads / 32];
  __shared__ float s_wsum[kThreads / 32];
  __shared__ long long s_carried;
  __shared__ int s_start0;

  const long long b = blockIdx.x;
  const long long d0 = b * S;
  const long long d1 = min(d0 + S, rows + nnz);
  block_rows(crow, d0, d1, rows, nnz, s_rows);
  const long long rb = s_rows[0];
  const long long re = s_rows[1];
  const long long eb = d0 - rb;                      // the block's first entry
  const int count = static_cast<int>((d1 - re) - eb);  // and its entries
  const int last = static_cast<int>(re - rb);        // its rows: [0, last]
  const int nwin = min(last, kWindow);
  stage_rows(crow, mask, rows, rb, eb, nwin, s_end, s_mask);
  I idx[kItems];  // -1: no product to make
  float v[kItems];
#pragma unroll
  for (int u = 0; u < kItems; ++u) {
    idx[u] = I(-1);
    v[u] = 0.0f;
  }
  if (mask == nullptr) {
    // issued here and first used after the walkers' search
#pragma unroll
    for (int u = 0; u < kItems; ++u) {
      const int i = threadIdx.x + u * kThreads;
      if (i < count) {
        idx[u] = load_once(col + eb + i);
        v[u] = load_once(val + eb + i);
      }
    }
  }
  if (threadIdx.x == 0) {
    // the block's first row, when it began in an earlier block and ends in
    // this one, is summed by pass 2
    const long long first = static_cast<long long>(crow[rb]);
    s_start0 = first < eb ? -1 : 0;
    s_carried = rb < re && eb > first ? rb : -1;
    head_row[b] = s_carried;
    s_first[kThreads] = last;
  }
  __syncthreads();

  const LocalRows<I> ends{crow, s_end, mask, s_mask, rb, eb, nwin,
                          static_cast<int>(min(rows - rb, re - rb + 1)),
                          s_start0};
  const int span = static_cast<int>(d1 - d0);
  const int dw0 = min(static_cast<int>(threadIdx.x) * (int)(S / kThreads),
                      span);
  const int dw1 = min(dw0 + static_cast<int>(S / kThreads), span);
  const int r0 = ends.search(dw0, 0, last);  // rows and entries from here
  s_first[threadIdx.x] = r0;                  // on are the block's own
  __syncthreads();
  const int r1 = s_first[threadIdx.x + 1];
  const int e0 = dw0 - r0;
  const int e1 = dw1 - r1;

  if (mask == nullptr) {
#pragma unroll
    for (int u = 0; u < kItems; ++u) {
      if (idx[u] >= 0)
        s_prod[threadIdx.x + u * kThreads] =
            v[u] * __ldg(rhs + static_cast<long long>(idx[u]));
    }
  } else {
    // which of the block's entries the mask keeps, from the walkers' rows:
    // a dropped row's entries are never loaded
    uint8_t* s_keep = reinterpret_cast<uint8_t*>(s_prod + S);
    int e = e0;
    for (int r = r0; r <= r1; ++r) {
      const int hi = r == r1 ? e1 : ends.end(r);
      const uint8_t keep = ends.kept(r);
      for (; e < hi; ++e) s_keep[e] = keep;
    }
    __syncthreads();
    for (int base = 0; base < count; base += kThreads * kItems) {
#pragma unroll
      for (int u = 0; u < kItems; ++u) {
        const int i = base + threadIdx.x + u * kThreads;
        idx[u] = I(-1);
        if (i < count && s_keep[i] != 0) {
          idx[u] = load_once(col + eb + i);
          v[u] = load_once(val + eb + i);
        }
      }
#pragma unroll
      for (int u = 0; u < kItems; ++u) {
        if (idx[u] >= 0)
          s_prod[base + threadIdx.x + u * kThreads] =
              v[u] * __ldg(rhs + static_cast<long long>(idx[u]));
      }
    }
  }
  __syncthreads();

  float acc = 0.0f;
  float part = 0.0f;
  bool has_head = false;
  int e = e0;
  for (int r = r0; r <= r1; ++r) {
    const int hi = r == r1 ? e1 : ends.end(r);
    acc = 0.0f;
    if (ends.kept(r))
      for (int k = e; k < hi; ++k) acc += s_prod[k];
    if (r < r1) {
      if (r == r0 && e0 > ends.start(r0)) {
        has_head = true;
        part = acc;
      } else {
        out[rb + r] = acc;
      }
    }
    e = hi;
  }
  finish_1(acc, part, has_head, rb + r0, rb + r1, s_carried, b, s_wkey,
           s_wsum, out, head, tail);
}

// Pass 1 at T > 1.  W lanes a walker, C columns a lane (W * C >= T); the
// W lanes read an entry's value and index once and its line of rhs as
// W-wide pieces.
template <typename I, int W, int C>
__global__ void __launch_bounds__(kThreads)
csr_blocks(const I* __restrict__ crow, const I* __restrict__ col,
           const float* __restrict__ val, const float* __restrict__ rhs, int T,
           const uint8_t* __restrict__ mask, long long rows, long long nnz,
           long long S, float* __restrict__ out,
           long long* __restrict__ head_row, float* __restrict__ head,
           float* __restrict__ tail) {
  constexpr int kWalkers = kThreads / W;
  // entries loaded ahead of their fmas, within one row
  constexpr int kAhead = C >= 8 ? 1 : 8 / C;
  __shared__ long long s_rows[2];
  __shared__ int s_end[kWindow];
  __shared__ uint8_t s_mask[kWindow + 1];
  __shared__ int s_first[kWalkers + 1];
  __shared__ long long s_key[kWalkers];
  __shared__ float s_tail[kWalkers * W * C];
  __shared__ long long s_carried;
  __shared__ int s_start0;

  const long long b = blockIdx.x;
  const long long d0 = b * S;
  const long long d1 = min(d0 + S, rows + nnz);
  block_rows(crow, d0, d1, rows, nnz, s_rows);
  const long long rb = s_rows[0];
  const long long re = s_rows[1];
  const long long eb = d0 - rb;                // the block's first entry
  const int last = static_cast<int>(re - rb);  // its rows: [0, last]
  const int nwin = min(last, kWindow);
  stage_rows(crow, mask, rows, rb, eb, nwin, s_end, s_mask);
  if (threadIdx.x == 0) {
    const long long first = static_cast<long long>(crow[rb]);
    s_start0 = first < eb ? -1 : 0;
    s_carried = rb < re && eb > first ? rb : -1;
    head_row[b] = s_carried;
    s_first[kWalkers] = last;
  }
  __syncthreads();

  const LocalRows<I> ends{crow, s_end, mask, s_mask, rb, eb, nwin,
                          static_cast<int>(min(rows - rb, re - rb + 1)),
                          s_start0};
  const int w = threadIdx.x / W;
  const int lane = threadIdx.x % W;
  const int span = static_cast<int>(d1 - d0);
  const int per = static_cast<int>(S / kWalkers);
  const int dw0 = min(w * per, span);
  const int dw1 = min(dw0 + per, span);
  const int r0 = ends.search(dw0, 0, last);  // rows and entries from here
  if (lane == 0) s_first[w] = r0;            // on are the block's own
  __syncthreads();
  const int r1 = s_first[w + 1];
  const int e0 = dw0 - r0;
  const int e1 = dw1 - r1;
  const I* bcol = col + eb;
  const float* bval = val + eb;

  float acc[C];
  float part[C];
  bool has_head = false;
  int e = e0;
  for (int r = r0; r <= r1; ++r) {
    const int hi = r == r1 ? e1 : ends.end(r);
#pragma unroll
    for (int c = 0; c < C; ++c) acc[c] = 0.0f;
    if (ends.kept(r)) {
      for (int k = e; k < hi; k += kAhead) {
        long long idx[kAhead];
        float v[kAhead];
#pragma unroll
        for (int u = 0; u < kAhead; ++u) {
          const bool in = k + u < hi;
          idx[u] = in ? static_cast<long long>(__ldg(bcol + k + u)) : 0;
          v[u] = in ? __ldg(bval + k + u) : 0.0f;
        }
#pragma unroll
        for (int u = 0; u < kAhead; ++u) {
          if (k + u < hi) {
            const float* x = rhs + idx[u] * T;
#pragma unroll
            for (int c = 0; c < C; ++c) {
              const int t = lane + c * W;
              if (t < T) acc[c] = fmaf(v[u], __ldg(x + t), acc[c]);
            }
          }
        }
      }
    }
    if (r < r1) {
      if (r == r0 && e0 > ends.start(r0)) {
        has_head = true;
#pragma unroll
        for (int c = 0; c < C; ++c) part[c] = acc[c];
      } else {
        float* dst = out + (rb + r) * T;
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const int t = lane + c * W;
          if (t < T) dst[t] = acc[c];
        }
      }
    }
    e = hi;
  }
  finish<W, C>(acc, part, has_head, rb + r0, rb + r1, s_carried, b, T, s_key,
               s_tail, out, head, tail);
}

// Pass 2.  One warp a block: where the block's first row began in an
// earlier block, out[r] = (tails of blocks first..b-1) + head of b.
// Lanes split into `ct` column lanes and 32 / ct block lanes.
template <typename I>
__global__ void __launch_bounds__(kThreads)
csr_fixup(const I* __restrict__ crow, long long S, int T, int ct,
          long long blocks, const long long* __restrict__ head_row,
          const float* __restrict__ head, const float* __restrict__ tail,
          float* __restrict__ out) {
  const long long b =
      static_cast<long long>(blockIdx.x) * kFixupWarps + (threadIdx.x >> 5);
  if (b >= blocks) return;
  const long long r = head_row[b];
  if (r < 0) return;
  const long long first = (static_cast<long long>(crow[r]) + r) / S;
  const int lane = threadIdx.x & 31;
  const int tl = lane % ct;
  const int j = lane / ct;
  const int step = 32 / ct;
  for (int t0 = 0; t0 < T; t0 += ct) {
    const int t = t0 + tl;
    float acc = 0.0f;
    if (t < T)
      for (long long i = first + j; i < b; i += step) acc += tail[i * T + t];
    for (int off = 16; off >= ct; off >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (j == 0 && t < T) out[r * T + t] = acc + head[b * T + t];
  }
}

template <typename I, int W, int C>
cudaError_t launch_blocks(const void* crow, const void* col, const void* val,
                          const void* rhs, int T, const void* mask,
                          long long rows, long long nnz, long long S,
                          long long grid, void* out, long long* head_row,
                          float* head, float* tail, cudaStream_t stream) {
  csr_blocks<I, W, C><<<static_cast<unsigned>(grid), kThreads, 0, stream>>>(
      static_cast<const I*>(crow), static_cast<const I*>(col),
      static_cast<const float*>(val), static_cast<const float*>(rhs), T,
      static_cast<const uint8_t*>(mask), rows, nnz, S,
      static_cast<float*>(out), head_row, head, tail);
  return cudaGetLastError();
}

template <typename I>
cudaError_t launch(const void* crow, const void* col, const void* val,
                   const void* rhs, int T, const void* mask, long long rows,
                   long long nnz, long long S, void* carries, void* out,
                   cudaStream_t stream) {
  if (rows == 0) return cudaSuccess;
  const long long grid = (rows + nnz + S - 1) / S;
  if (grid > 0x7fffffffLL) return cudaErrorInvalidValue;
  long long* head_row = static_cast<long long*>(carries);
  float* head = reinterpret_cast<float*>(head_row + grid);
  float* tail = head + grid * T;
  cudaError_t err;
  // W lanes a walker: T rounded up to a power of two, at most 32; then C
  // columns a lane
  if (T == 1) {
    // the block's products, and its keep bytes under a mask; without a
    // mask a thread loads all its items in one round
    const size_t smem = static_cast<size_t>((mask != nullptr ? 5 : 4) * S);
    if ((mask == nullptr && S > static_cast<long long>(kThreads) * kItems) ||
        smem > 40 * 1024)
      return cudaErrorInvalidValue;
    csr_blocks_1<I><<<static_cast<unsigned>(grid), kThreads, smem, stream>>>(
        static_cast<const I*>(crow), static_cast<const I*>(col),
        static_cast<const float*>(val), static_cast<const float*>(rhs),
        static_cast<const uint8_t*>(mask), rows, nnz, S,
        static_cast<float*>(out), head_row, head, tail);
    err = cudaGetLastError();
  } else if (T <= 2)
    err = launch_blocks<I, 2, 1>(crow, col, val, rhs, T, mask, rows, nnz, S,
                                 grid, out, head_row, head, tail, stream);
  else if (T <= 4)
    err = launch_blocks<I, 4, 1>(crow, col, val, rhs, T, mask, rows, nnz, S,
                                 grid, out, head_row, head, tail, stream);
  else if (T <= 8)
    err = launch_blocks<I, 8, 1>(crow, col, val, rhs, T, mask, rows, nnz, S,
                                 grid, out, head_row, head, tail, stream);
  else if (T <= 16)
    err = launch_blocks<I, 16, 1>(crow, col, val, rhs, T, mask, rows, nnz, S,
                                  grid, out, head_row, head, tail, stream);
  else if (T <= 32)
    err = launch_blocks<I, 32, 1>(crow, col, val, rhs, T, mask, rows, nnz, S,
                                  grid, out, head_row, head, tail, stream);
  else if (T <= 64)
    err = launch_blocks<I, 32, 2>(crow, col, val, rhs, T, mask, rows, nnz, S,
                                  grid, out, head_row, head, tail, stream);
  else if (T <= 128)
    err = launch_blocks<I, 32, 4>(crow, col, val, rhs, T, mask, rows, nnz, S,
                                  grid, out, head_row, head, tail, stream);
  else if (T <= 256)
    err = launch_blocks<I, 32, 8>(crow, col, val, rhs, T, mask, rows, nnz, S,
                                  grid, out, head_row, head, tail, stream);
  else if (T <= 512)
    err = launch_blocks<I, 32, 16>(crow, col, val, rhs, T, mask, rows, nnz, S,
                                   grid, out, head_row, head, tail, stream);
  else
    err = launch_blocks<I, 32, 32>(crow, col, val, rhs, T, mask, rows, nnz, S,
                                   grid, out, head_row, head, tail, stream);
  if (err != cudaSuccess) return err;
  int ct = 1;
  while (ct < T && ct < 32) ct <<= 1;
  const long long fix = (grid + kFixupWarps - 1) / kFixupWarps;
  csr_fixup<I><<<static_cast<unsigned>(fix), kThreads, 0, stream>>>(
      static_cast<const I*>(crow), S, T, ct, grid, head_row, head, tail,
      static_cast<float*>(out));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Threads a block; block_items must be a positive multiple of it, and at
// most kItems times it (the items a thread at T = 1).
int tsgd_csr_block_threads() { return kThreads; }
int tsgd_csr_thread_items() { return kItems; }

// out (rows, T) = CSR (crow, col, val) x rhs (k, T) on `stream`, masked by
// `mask` (rows bytes, 0 drops a row; null keeps every row): two launches.
// index_bytes is 4 (int32 crow and col) or 8 (int64).  nnz is crow[rows];
// block_items the path items a block (S).  carries holds grid int64 row
// ids, then grid x T floats of heads and grid x T of tails, grid =
// ceil((rows + nnz) / S).  Returns the cudaError_t of the launches (0 on
// success).  Does not synchronise.
int tsgd_csr_matmul(int index_bytes, const void* crow, const void* col,
                    const void* val, const void* rhs, int T, const void* mask,
                    long long rows, long long nnz, long long block_items,
                    void* carries, void* out, void* stream) {
  if (rows < 0 || nnz < 0 || T < 1 || T > 1024 || block_items <= 0 ||
      block_items % kThreads)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (index_bytes == 4)
    return launch<int32_t>(crow, col, val, rhs, T, mask, rows, nnz,
                           block_items, carries, out, s);
  if (index_bytes == 8)
    return launch<int64_t>(crow, col, val, rhs, T, mask, rows, nnz,
                           block_items, carries, out, s);
  return cudaErrorInvalidValue;
}

const char* tsgd_csr_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
