// Fused window and gathered-row gradient sums for generalized linear
// models, for Hopper (sm_90a).  Built by tpu_sgd_torch/ops/_build.py with
// nvcc into a shared library with a plain C interface;
// tpu_sgd_torch/ops/cuda_kernels.py loads it with ctypes and routes a call
// to it by shape (window_stage_plan).
//
// Replaces the Pallas TPU kernels of tpu_sgd/ops/pallas_kernels.py:
//   fused_window_sums     :342 (pallas_call :407, _window_kernel)
//   fused_window_sums_vpu :425 (pallas_call :407, _window_kernel_vpu)
//   fused_gradient_sums   :265 (pallas_call :313, _masked_kernel)
// The window entries sum rows [start, start + rows) of a row-major X, the
// gradient entry rows [0, n) of it, unmasked as a window at start 0, or
// the rows a bool mask keeps (gather_main):
//   margin = x . round_T(w)                f32 accumulation
//   (coeff, loss) = pointwise(margin, y)   in f32, zero where valid is 0
//   grad  += round_T(coeff) * x            f32 accumulation
// with loss and count summed in f64, under the JAX package's
// mixed-precision contract (tpu_sgd/ops/gradients.py margins_of /
// grad_sum_of); round_T rounds to X's element type (bf16 or f32).  The
// start is a device scalar times start_scale, placed as lax.dynamic_slice
// places it.  csrc/fused_sums.cu computes the same function; this kernel
// takes every width whose stage ring fits in shared memory, on any base
// aligned to X's element size, and fused_sums.cu the wider rows.
//
// What bounds it: the bytes of the rows summed.  A window's rows are one
// contiguous range of device memory, a mask's live rows are scattered
// whole rows of it, each read once (3.35 TB/s on an H100 SXM); the two dot
// products are 4 flops an element.  The design keeps HBM busy and the
// fixed costs small:
//   * a persistent grid, two blocks an SM for rows of up to 2,048
//     columns (so one block's margins overlap the other's column pass)
//     and one for wider rows, each walking a contiguous share of the
//     window (or of the mask's rows, whatever their live count) in tiles
//     of R rows;
//   * a ring of S tiles in shared memory, each filled by bulk copies
//     (cp.async.bulk, the Tensor Memory Accelerator) completing on the
//     tile's "full" mbarrier; a producer warp keeps the ring in flight and
//     refills a tile once all 8 consumer warps have arrived on its "empty"
//     mbarrier, so the next tiles load while this one is summed;
//   * window_main's producer is one thread: one copy of the tile's rows,
//     and copies of 16-byte aligned supersets of their labels and valid
//     flags (plain loads of the labels, even a tile ahead, put a
//     device-memory latency on every tile's path);
//   * gather_main's producer is the whole warp.  It walks its share of the
//     mask 512 rows a step (one 16-byte load a lane, the next step's already
//     in flight), compacts the live rows in row order (per-lane popcounts, a
//     shuffle scan) and deals them into the ring's R-row slots across steps,
//     so only a share's last tile is partial and no dropped row is read.  Each
//     lane walks its own set bits and issues the copies of its live rows, one
//     cp.async.bulk a run of consecutive rows, and lands each row's label with
//     a 4-byte cp.async tracked by the same full barrier
//     (cp.async.mbarrier.arrive): the labels cost the producer no load
//     latency and no registers (plain loads of the labels at the deal put
//     their latency in the producer's path; a bulk copy of each label's
//     16-byte unit would need 16 bytes a row of stage space, over the label
//     area the planner sizes the ring with).  Every lane arrives on the full
//     barrier when its tile is dealt; the tile's first word after the labels
//     holds its row count, and a share ends with a tile of fewer than R rows
//     (none when its live count is a multiple of R).  A copy a row costs
//     nothing against one a tile, nor does the rows' spread
//     (scripts/probe_gather_kernel.py, PERF.md);
//   * consumer warps that read X from shared memory only: margins (two
//     rows a warp, one 16-byte load a lane a row; the gather entry loads
//     both rows without a branch), the pointwise rule,
//     then the column pass with each thread's columns held in registers
//     for the whole share; every row crosses HBM once and never L1/L2
//     again.  Both entries run the same consumer code (ring_sums);
//   * a deterministic reduction that uses the card: blocks in clusters of
//     2 add their (d,) sums through distributed shared memory in rank
//     order, each rank a slice of the columns, leaving one partial a
//     cluster; a second kernel spreads the partials of 32 columns over 8
//     warps a block (ceil(d/32) blocks) and adds them in a fixed order in
//     f64.  There are no float atomics, so two calls are bitwise equal.
// gather_main takes the grid that window_main takes for n rows, so with
// every row live it deals the window's tiles and gives its bits.
//
// Rows of any width (the ALIGNED = false instances).  The layout above
// (rows back to back in a stage, one bulk copy a tile or a run) is the
// ALIGNED instance's, taken when a row is whole 16-byte units and X's base
// is 16-byte aligned, so every row starts on a unit.  Any other width (d =
// 1001 bf16, 101 f32) or base (a view one element off a unit) lands each
// row through its 16-byte aligned superset (aligned_span), one bulk copy a
// row in both entries, into a slot of row_pitch bytes: the superset's bound,
// the row after a lead of at most 16 - sizeof(T) bytes, rounded up to whole
// units.  A row's lead is its address mod 16: its bytes sit `lead` bytes
// into its slot.  window_main's consumers compute it from the row index;
// gather_main's producer writes it beside the tile's row count.  The
// consumers read the two aligned units (16 bytes, or 8 in the column pass
// of bf16) that hold a lane's values and shift them into place with word
// selects and __funnelshift_r: shared memory has bandwidth to spare (HBM's
// share of an SM is about 14 B/clk, shared memory's 128).  round_T(w) and
// the sums take d rounded up to whole 16-byte vectors of T, w zero past d;
// the margins' last vector zeroes the values past d, and the column pass's
// last chunk keeps its sums past d out of the output.  A superset reads at
// most 15 bytes before and after its row: whole 16-byte units that hold
// bytes of X, so they never cross a page, and adjacent rows share only the
// unit they meet in.  Each row still crosses HBM once, and the order of
// additions is the ALIGNED instance's, so two calls give the same bits.
// Launch state (the shared-memory attribute, the clusters that fit) is
// computed once per kernel instance, device and ring size, and cached
// (launch_cache.cuh).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "launch_cache.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kConsumerWarps = 8;
constexpr int kConsumers = kConsumerWarps * 32;
constexpr int kThreads = kConsumers + 32;  // + one producer warp
// rows whose margins one warp computes together (sharing its w loads)
constexpr int kRowsPerWarp = 2;
constexpr int kMaxStages = 8;
constexpr int kMaxStageRows = 16;
// a stage's labels (the aligned superset of up to 16 f32 values starts up
// to 3 values early) and valid flags (up to 15 bytes early) after its rows
constexpr int kLabelYBytes = 80;
constexpr int kLabelBytes = kLabelYBytes + 32;
// columns a thread's chunk covers in the column pass
constexpr int kColVec = 4;
constexpr int kMaxChunksPerThread = 8;
// shared memory a block may use (sm_90 opt-in), less a reserve for the
// kernel's static shared memory (barriers, coefficients, partials)
constexpr int kSmemPerBlock = 232448;
constexpr int kStaticReserve = 1024;
constexpr int kMaxDynamicSmem = kSmemPerBlock - kStaticReserve;
constexpr int kReduceThreads = 256;
constexpr int kReduceWarps = kReduceThreads / 32;

enum Family { kLeastSquares = 0, kLogistic = 1, kHinge = 2 };
enum DType { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ float round_to(float v);
template <>
__device__ __forceinline__ float round_to<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float v) {
  // round to nearest even, as jnp's astype(bfloat16)
  return __bfloat162float(__float2bfloat16_rn(v));
}

// The pointwise rules of tpu_sgd/ops/gradients.py:307-342 (as in
// fused_sums.cu).
template <int F>
__device__ __forceinline__ void pointwise(float m, float y, float& coeff,
                                          float& loss) {
  if constexpr (F == kLeastSquares) {
    const float diff = m - y;
    coeff = diff;
    loss = 0.5f * diff * diff;
  } else if constexpr (F == kLogistic) {
    const float neg = -m;
    coeff = 1.0f / (1.0f + expf(-m)) - y;
    const float sp = fmaxf(neg, 0.0f) + log1pf(expf(-fabsf(neg)));
    loss = y > 0.0f ? sp : sp - neg;
  } else {
    const float s = 2.0f * y - 1.0f;
    const float slack = 1.0f - s * m;
    const bool active = slack > 0.0f;
    coeff = active ? -s : 0.0f;
    loss = active ? slack : 0.0f;
  }
}

// 16 bytes of shared memory as f32 (4 f32 or 8 bf16 values).
template <typename T>
__device__ __forceinline__ void load16(const T* p,
                                       float (&out)[16 / sizeof(T)]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int k = 0; k < 16 / static_cast<int>(sizeof(T)); ++k) out[k] = to_f(e[k]);
}

// kColVec consecutive values of shared memory as f32 (8 or 16 bytes).
template <typename T>
__device__ __forceinline__ void load_cols(const T* p, float (&out)[kColVec]) {
  if constexpr (sizeof(T) == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    out[0] = v.x;
    out[1] = v.y;
    out[2] = v.z;
    out[3] = v.w;
  } else {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int k = 0; k < kColVec; ++k) out[k] = to_f(e[k]);
  }
}

// The bytes of a ring slot for one row of d values of T: the row itself
// (ALIGNED), else the bound of its 16-byte aligned superset.
template <typename T, bool ALIGNED>
__host__ __device__ constexpr int row_pitch(int d) {
  constexpr int kItem = static_cast<int>(sizeof(T));
  return ALIGNED ? d * kItem : (d * kItem + 16 - kItem + 15) & ~15;
}

// Columns of round_T(w) and of the sums in shared memory: d rounded up to
// whole 16-byte vectors of T (d itself when the rows are whole vectors).
template <typename T>
__host__ __device__ constexpr int padded_d(int d) {
  constexpr int kVec = 16 / static_cast<int>(sizeof(T));
  return (d + kVec - 1) / kVec * kVec;
}

// Four 32-bit words that begin `lead` bytes (below 16, a multiple of
// sizeof(T)) into w[0..7]: selects by whole words, then (bf16) a funnel
// shift by the 2 bytes left.
template <typename T>
__device__ __forceinline__ void shift_words(const uint32_t (&w)[8],
                                            uint32_t lead,
                                            uint32_t (&out)[4]) {
  uint32_t t[6], v[5];
#pragma unroll
  for (int i = 0; i < 6; ++i) t[i] = (lead & 8u) ? w[i + 2] : w[i];
#pragma unroll
  for (int i = 0; i < 5; ++i) v[i] = (lead & 4u) ? t[i + 1] : t[i];
  const uint32_t sh = (lead & 3u) * 8u;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    out[i] = sizeof(T) == 4 ? v[i] : __funnelshift_r(v[i], v[i + 1], sh);
}

// load16 for a row `lead` bytes into its slot (`slot` 16-byte aligned):
// its c-th 16 bytes, from the two aligned units that hold them.
template <typename T>
__device__ __forceinline__ void load16_at(const unsigned char* slot,
                                          uint32_t lead, int c,
                                          float (&out)[16 / sizeof(T)]) {
  const uint4* u = reinterpret_cast<const uint4*>(slot) + c;
  const uint4 a = u[0], b = u[1];
  const uint32_t w[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
  uint32_t raw[4];
  shift_words<T>(w, lead, raw);
  const T* e = reinterpret_cast<const T*>(raw);
#pragma unroll
  for (int k = 0; k < 16 / static_cast<int>(sizeof(T)); ++k) out[k] = to_f(e[k]);
}

// load_cols for a row `lead` bytes into its slot: its j-th chunk of
// kColVec values (f32: load16_at; bf16: 8 bytes from two aligned 8-byte
// words).
template <typename T>
__device__ __forceinline__ void load_cols_at(const unsigned char* slot,
                                             uint32_t lead, int j,
                                             float (&out)[kColVec]) {
  if constexpr (sizeof(T) == 4) {
    load16_at<T>(slot, lead, j, out);
  } else {
    const uint2* u = reinterpret_cast<const uint2*>(slot) + j + (lead >> 3);
    const uint2 a = u[0], b = u[1];
    const bool odd = lead & 4u;
    const uint32_t t0 = odd ? a.y : a.x, t1 = odd ? b.x : a.y,
                   t2 = odd ? b.y : b.x;
    const uint32_t sh = (lead & 3u) * 8u;
    const uint32_t raw[2] = {__funnelshift_r(t0, t1, sh),
                             __funnelshift_r(t1, t2, sh)};
    const T* e = reinterpret_cast<const T*>(raw);
#pragma unroll
    for (int k = 0; k < kColVec; ++k) out[k] = to_f(e[k]);
  }
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

// Spins until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// One bulk copy of `bytes` (a multiple of 16, both addresses 16-byte
// aligned) from device memory into this block's shared memory; completes
// on `bar`'s transaction count.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// The consumer warps only (named barrier 1; the producer warp is busy).
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(kConsumers) : "memory");
}

// Every thread of every block of the cluster; orders shared-memory writes
// before it with the cluster's reads after it.
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release;\n\t"
      "barrier.cluster.wait.acquire;" ::
          : "memory");
}

static_assert(kMaxStageRows <= kConsumerWarps * kRowsPerWarp &&
                  4 * (kMaxStageRows + 3) <= kLabelYBytes &&
                  kMaxStageRows + 15 <= kLabelBytes - kLabelYBytes,
              "a warp's margins cover its share of a tile, and a stage's "
              "label area holds its labels' aligned supersets");

// A 16-byte aligned superset of `count` elements of `elem` bytes from
// `src`: its first address, the elements before `src` in it, and its bytes
// (whole 16-byte units, which never cross a page, so the few bytes it reads
// around the range are always mapped).
struct Span {
  const unsigned char* base;
  int lead;
  uint32_t bytes;
};

__device__ __forceinline__ Span aligned_span(const void* src, int count,
                                             int elem) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(src);
  const uintptr_t lo = a & ~static_cast<uintptr_t>(15);
  const int lead = static_cast<int>(a - lo) / elem;
  const uint32_t bytes = static_cast<uint32_t>(((lead + count) * elem + 15) &
                                               ~15);
  return Span{reinterpret_cast<const unsigned char*>(lo), lead, bytes};
}

// One 4-byte copy from device memory into this block's shared memory
// (cp.async, tracked by the next cp.async.mbarrier.arrive of the thread).
__device__ __forceinline__ void copy4_async(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(smem_u32(dst)),
               "l"(src)
               : "memory");
}

// `bar` tracks this thread's cp.async copies issued so far: its pending
// count rises by one now and falls when they have landed.
__device__ __forceinline__ void mbar_track_async(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.shared::cta.b64 [%0];" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// Where a tile's row count sits in gather_main's ring: the word after the
// tile's labels (R f32 values from the label area's start).
constexpr int kGatherCountOffset = kLabelYBytes;
// Where the leads of a gathered tile's rows sit (ALIGNED = false): a byte
// a slot, after the row count.
constexpr int kGatherLeadOffset = kGatherCountOffset + 16;
static_assert(4 * kMaxStageRows <= kGatherCountOffset &&
                  kGatherCountOffset + 4 <= kGatherLeadOffset &&
                  kGatherLeadOffset + kMaxStageRows <= kLabelBytes,
              "a gathered tile's labels, row count and leads fit its label "
              "area");

// Rows of the mask one producer step covers: 16 a lane.
constexpr int kMaskStepRows = 16 * 32;

__device__ __forceinline__ int clamp16(long long v) {
  return static_cast<int>(v < 0 ? 0 : (v > 16 ? 16 : v));
}

// gather_main's producer: the whole warp walks the mask over rows
// [b_begin, b_end), compacts the live rows in row order and deals them into
// tiles of stage_rows; see the note at the top.  ALIGNED = false: a copy of
// each row's superset into its slot of `pitch` bytes, and its lead.
template <typename T, bool ALIGNED>
__device__ __forceinline__ void gather_produce(
    const T* __restrict__ X, const float* __restrict__ y,
    const uint8_t* __restrict__ mask, long long b_begin, long long b_end,
    int row_bytes, int pitch, int stage_rows, int stages, int stage_bytes,
    int x_bytes, unsigned char* ring, uint64_t* full, uint64_t* empty,
    int lane) {
  const unsigned char* xbytes = reinterpret_cast<const unsigned char*>(X);
  // 16-byte loads from the aligned unit holding the share's first flag
  // (a unit never crosses a page, so the flags it reads around the share
  // are mapped; they are masked off below)
  const uintptr_t a0 = reinterpret_cast<uintptr_t>(mask + b_begin);
  const unsigned char* base =
      reinterpret_cast<const unsigned char*>(a0 & ~static_cast<uintptr_t>(15));
  const long long first = b_begin - static_cast<long long>(a0 & 15);
  const long long R = stage_rows;
  long long dealt = 0;  // live rows dealt so far: the next one's ordinal
  uint32_t pend = 0;    // bytes this lane copied into the open tile

  auto flags = [&](long long c0) {
    const long long r = c0 + 16 * lane;
    if (r >= b_end) return make_uint4(0u, 0u, 0u, 0u);
    return __ldg(reinterpret_cast<const uint4*>(base + (r - first)));
  };
  // a dealt tile: its row count, then every lane's arrival (with the bytes
  // it copied into the tile, and its label copies tracked)
  auto close = [&](long long t, int nr) {
    const int s = static_cast<int>(t % stages);
    unsigned char* st = ring + s * stage_bytes;
    if (lane == 0)
      *reinterpret_cast<int*>(st + x_bytes + kGatherCountOffset) = nr;
    mbar_track_async(&full[s]);
    mbar_arrive_expect_tx(&full[s], pend);
    pend = 0;
  };
  auto open = [&](long long t) {
    mbar_wait(&empty[t % stages], ((t / stages) & 1) ^ 1);
  };

  uint4 cur = flags(first);
  for (long long c0 = first; c0 < b_end; c0 += kMaskStepRows) {
    const uint4 next = flags(c0 + kMaskStepRows);
    // this lane's 16 rows: bit k for row r0 + k, live and in the share
    const long long r0 = c0 + 16 * lane;
    const uint32_t word[4] = {__vcmpne4(cur.x, 0u), __vcmpne4(cur.y, 0u),
                              __vcmpne4(cur.z, 0u), __vcmpne4(cur.w, 0u)};
    uint32_t bits = 0;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const uint32_t v = word[q];
      bits |= ((v & 1u) | ((v >> 7) & 2u) | ((v >> 14) & 4u) |
               ((v >> 21) & 8u))
              << (4 * q);
    }
    const int klo = clamp16(b_begin - r0);
    const int khi = clamp16(b_end - r0);
    bits &= ((1u << khi) - 1u) & ~((1u << klo) - 1u);
    // ordinals: an inclusive scan of the lanes' counts
    const int cnt = __popc(bits);
    int incl = cnt;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += v;
    }
    const int total = __shfl_sync(0xffffffffu, incl, 31);
    const long long q0 = dealt + (incl - cnt);  // this lane's first ordinal
    // the tiles this step's live rows fall in, in order
    for (long long t = dealt / R; t * R < dealt + total; ++t) {
      if (t * R >= dealt) open(t);  // a tile begun in an earlier step is open
      const int s = static_cast<int>(t % stages);
      unsigned char* st = ring + s * stage_bytes;
      float* s_y = reinterpret_cast<float*>(st + x_bytes);
      const long long lo = t * R;
      // this lane's live rows in the tile: its set bits ranked [ja, jb)
      const long long ra = lo - q0, rb = lo + R - q0;
      const int ja = static_cast<int>(ra < 0 ? 0 : (ra > cnt ? cnt : ra));
      const int jb = static_cast<int>(rb < 0 ? 0 : (rb > cnt ? cnt : rb));
      uint32_t m = bits;
      for (int j = 0; j < ja; ++j) m &= m - 1u;
      int slot = static_cast<int>(q0 + ja - lo);
      for (int left = jb - ja; left > 0;) {
        // a run of consecutive live rows from bit k: one bulk copy
        const int k = __ffs(m) - 1;
        int len = __ffs(~(m >> k)) - 1;
        if (len > left) len = left;
        const long long r = r0 + k;
        for (int e = 0; e < len; ++e) copy4_async(s_y + slot + e, y + r + e);
        if constexpr (ALIGNED) {
          const uint32_t nb = static_cast<uint32_t>(len * row_bytes);
          bulk_load(st + slot * row_bytes,
                    xbytes + r * static_cast<long long>(row_bytes), nb,
                    &full[s]);
          pend += nb;
        } else {
          // one copy a row, into the row's own slot
          const int d = row_bytes / static_cast<int>(sizeof(T));
          uint8_t* lead = st + x_bytes + kGatherLeadOffset;
          for (int e = 0; e < len; ++e) {
            const Span xs = aligned_span(X + (r + e) * d, d, sizeof(T));
            bulk_load(st + (slot + e) * pitch, xs.base, xs.bytes, &full[s]);
            lead[slot + e] = static_cast<uint8_t>(xs.lead * sizeof(T));
            pend += xs.bytes;
          }
        }
        m &= ~(((1u << len) - 1u) << k);
        slot += len;
        left -= len;
      }
      if (lo + R <= dealt + total) close(t, stage_rows);
    }
    dealt += total;
    cur = next;
  }
  // the share's last tile: the open one, partial, or a fresh empty one
  const long long t = dealt / R;
  if (dealt % R == 0) open(t);
  close(t, static_cast<int>(dealt % R));
}

// The body of both entries.  WINDOW: rows [row0, row0 + rows) of X, the
// producer one thread.  GATHER: the rows of [0, rows) that `valid` keeps,
// dealt by gather_produce; tiles carry their row count, and the consumers
// stop after the first tile of fewer than stage_rows rows.  ALIGNED: rows
// back to back in a stage, else a slot of row_pitch bytes a row (see the
// note at the top).
template <int F, typename T, int CPT, bool GATHER, bool ALIGNED>
__device__ __forceinline__ void ring_sums(
    const T* __restrict__ X, const float* __restrict__ y,
    const float* __restrict__ w, const uint8_t* __restrict__ valid,
    const long long* __restrict__ start, long long start_scale,
    long long n_total, long long rows, int d, int stage_rows, int stages,
    float* __restrict__ part_grad,
    double* __restrict__ part_loss, double* __restrict__ part_cnt) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t full[kMaxStages];
  __shared__ __align__(8) uint64_t empty[kMaxStages];
  __shared__ float s_coeff[2][kMaxStageRows];
  __shared__ double s_wloss[kConsumerWarps];
  __shared__ double s_wcnt[kConsumerWarps];
  __shared__ double s_bloss;
  __shared__ double s_bcnt;

  constexpr int kVec16 = 16 / static_cast<int>(sizeof(T));
  const int row_bytes = d * static_cast<int>(sizeof(T));
  const int pitch = row_pitch<T, ALIGNED>(d);  // row_bytes when ALIGNED
  const int dp = ALIGNED ? d : padded_d<T>(d);
  const int x_bytes = stage_rows * pitch;
  const int stage_bytes = x_bytes + kLabelBytes;
  unsigned char* ring = smem;
  float* s_w = reinterpret_cast<float*>(smem + stages * stage_bytes);
  float* s_acc = s_w + dp;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  // As lax.dynamic_slice does, a negative start counts from the end, then
  // clamps into [0, n - rows].
  long long row0 = 0;
  if (start != nullptr) {
    long long s = start[0] * start_scale;
    if (s < 0) s += n_total;
    const long long hi = n_total - rows > 0 ? n_total - rows : 0;
    row0 = s < 0 ? 0 : (s > hi ? hi : s);
  }
  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      // a gathered tile is complete when every producer lane has arrived
      mbar_init(&full[s], GATHER ? 32 : 1);
      mbar_init(&empty[s], kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // this block's contiguous share of the window, in tiles of stage_rows
  const long long b_begin = rows * blockIdx.x / gridDim.x;
  const long long b_end = rows * (blockIdx.x + 1) / gridDim.x;
  const int ntiles =
      static_cast<int>((b_end - b_begin + stage_rows - 1) / stage_rows);
  const unsigned char* xbytes = reinterpret_cast<const unsigned char*>(X);

  if (warp == kConsumerWarps) {
    if constexpr (GATHER) {
      gather_produce<T, ALIGNED>(X, y, valid, b_begin, b_end, row_bytes,
                                 pitch, stage_rows, stages, stage_bytes,
                                 x_bytes, ring, full, empty, lane);
    } else if (lane == 0) {
      // producer: one thread keeps the ring full
      for (int t = 0; t < ntiles; ++t) {
        const int s = t % stages;
        const long long r0 = b_begin + static_cast<long long>(t) * stage_rows;
        const long long left = b_end - r0;
        const int nr = static_cast<int>(left < stage_rows ? left : stage_rows);
        // the first round passes at once (the ring starts empty)
        mbar_wait(&empty[s], ((t / stages) & 1) ^ 1);
        // the tile's rows of X, and aligned supersets of their labels and
        // valid flags, all on the stage's full barrier
        unsigned char* st = ring + s * stage_bytes;
        const uint32_t bytes = static_cast<uint32_t>(nr * row_bytes);
        const Span ys = aligned_span(y + row0 + r0, nr, 4);
        Span vs{nullptr, 0, 0};
        if (valid != nullptr) vs = aligned_span(valid + row0 + r0, nr, 1);
        if constexpr (ALIGNED) {
          mbar_arrive_expect_tx(&full[s], bytes + ys.bytes + vs.bytes);
          bulk_load(st,
                    xbytes + (row0 + r0) * static_cast<long long>(row_bytes),
                    bytes, &full[s]);
        } else {
          // each row's superset into its slot
          uint32_t landed = 0;
          for (int k = 0; k < nr; ++k) {
            const Span xs =
                aligned_span(X + (row0 + r0 + k) * d, d, sizeof(T));
            bulk_load(st + k * pitch, xs.base, xs.bytes, &full[s]);
            landed += xs.bytes;
          }
          mbar_arrive_expect_tx(&full[s], landed + ys.bytes + vs.bytes);
        }
        bulk_load(st + x_bytes, ys.base, ys.bytes, &full[s]);
        if (valid != nullptr)
          bulk_load(st + x_bytes + kLabelYBytes, vs.base, vs.bytes, &full[s]);
      }
    }
    __syncwarp();
  } else {
    float acc[CPT][kColVec];
#pragma unroll
    for (int k = 0; k < CPT; ++k)
#pragma unroll
      for (int e = 0; e < kColVec; ++e) acc[k][e] = 0.0f;
    double loss_acc = 0.0;
    double cnt_acc = 0.0;
    const int nvec = ALIGNED ? row_bytes / 16 : dp / kVec16;
    // round_T(w) while the producer's first copies are in flight
    for (int j = tid; j < d; j += kConsumers) s_w[j] = round_to<T>(w[j]);
    if constexpr (!ALIGNED)
      for (int j = d + tid; j < dp; j += kConsumers) s_w[j] = 0.0f;
    consumer_sync();
    const int nchunk = ALIGNED ? d / kColVec : (d + kColVec - 1) / kColVec;

    const int rb = warp * kRowsPerWarp;  // this warp's rows of a tile

    for (int t = 0; GATHER || t < ntiles; ++t) {
      const int s = t % stages;
      float* coeff = s_coeff[t & 1];
      mbar_wait(&full[s], (t / stages) & 1);
      const unsigned char* st = ring + s * stage_bytes;
      int nr;
      const float* s_y;
      const uint8_t* s_v;
      // ALIGNED = false: the tile's first row's address (its low bits
      // give each row's lead), or the gathered rows' leads
      uint32_t x0 = 0;
      const uint8_t* s_lead = st + x_bytes + kGatherLeadOffset;
      if constexpr (GATHER) {
        nr = *reinterpret_cast<const int*>(st + x_bytes + kGatherCountOffset);
        s_y = reinterpret_cast<const float*>(st + x_bytes);
        s_v = nullptr;
      } else {
        const long long r0 = b_begin + static_cast<long long>(t) * stage_rows;
        const long long left = b_end - r0;
        nr = static_cast<int>(left < stage_rows ? left : stage_rows);
        s_y = reinterpret_cast<const float*>(st + x_bytes) +
              aligned_span(y + row0 + r0, nr, 4).lead;
        s_v = valid == nullptr
                  ? nullptr
                  : st + x_bytes + kLabelYBytes +
                        aligned_span(valid + row0 + r0, nr, 1).lead;
        if constexpr (!ALIGNED)
          x0 = static_cast<uint32_t>(reinterpret_cast<uintptr_t>(
              xbytes + (row0 + r0) * static_cast<long long>(row_bytes)));
      }
      // the lead of the tile's row r (ALIGNED = false)
      auto lead_of = [&](int r) -> uint32_t {
        if constexpr (GATHER) return s_lead[r];
        return (x0 + static_cast<uint32_t>(r * row_bytes)) & 15u;
      };

      // (a) margins, pointwise rule, rounded coefficients: rows rb, rb + 1
      if (rb < nr) {
        bool in[kRowsPerWarp];
        const T* xr[kRowsPerWarp];
        float dot[kRowsPerWarp];
        uint32_t lead[kRowsPerWarp];
#pragma unroll
        for (int k = 0; k < kRowsPerWarp; ++k) {
          in[k] = rb + k < nr;
          xr[k] = reinterpret_cast<const T*>(st + (in[k] ? rb + k : rb) *
                                                      pitch);
          dot[k] = 0.0f;
          if constexpr (!ALIGNED) lead[k] = lead_of(in[k] ? rb + k : rb);
        }
        for (int c = lane; c < nvec; c += 32) {
          float wv[kVec16];
#pragma unroll
          for (int q = 0; q < kVec16; q += 4) {
            const float4 v = *reinterpret_cast<const float4*>(
                s_w + c * kVec16 + q);
            wv[q] = v.x;
            wv[q + 1] = v.y;
            wv[q + 2] = v.z;
            wv[q + 3] = v.w;
          }
          // The gather entry sums a missing row too (it reads the first
          // row's slot, and its dot is dropped below), so that no branch
          // holds the second row's loads back: with the branch, it ran 12%
          // slower at a 10% mask (PERF.md).
#pragma unroll
          for (int k = 0; k < kRowsPerWarp; ++k) {
            if (GATHER || in[k]) {
              float xv[kVec16];
              if constexpr (ALIGNED) {
                load16<T>(xr[k] + c * kVec16, xv);
              } else {
                load16_at<T>(reinterpret_cast<const unsigned char*>(xr[k]),
                             lead[k], c, xv);
                // the last vector's values past d (w is 0 there)
#pragma unroll
                for (int e = 0; e < kVec16; ++e)
                  if (c * kVec16 + e >= d) xv[e] = 0.0f;
              }
#pragma unroll
              for (int e = 0; e < kVec16; ++e)
                dot[k] = fmaf(xv[e], wv[e], dot[k]);
            }
          }
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
#pragma unroll
          for (int k = 0; k < kRowsPerWarp; ++k)
            dot[k] += __shfl_xor_sync(0xffffffffu, dot[k], o);
#pragma unroll
        for (int k = 0; k < kRowsPerWarp; ++k) {
          if (in[k]) {
            float cf, l;
            pointwise<F>(dot[k], s_y[rb + k], cf, l);
            const bool live = s_v == nullptr || s_v[rb + k] != 0;
            if (lane == 0) {
              coeff[rb + k] = live ? round_to<T>(cf) : 0.0f;
              if (live) {
                loss_acc += static_cast<double>(l);
                cnt_acc += 1.0;
              }
            }
          }
        }
      }
      consumer_sync();

      // (b) grad += coeff * x, each thread on its own columns, in row
      // order, from shared memory
#pragma unroll 4
      for (int r = 0; r < nr; ++r) {
        const float cf = coeff[r];
        const T* xr = reinterpret_cast<const T*>(st + r * pitch);
        const uint32_t lead = ALIGNED ? 0u : lead_of(r);
#pragma unroll
        for (int k = 0; k < CPT; ++k) {
          const int j = tid + k * kConsumers;
          if (j < nchunk) {
            float xv[kColVec];
            // (ALIGNED = false: the last chunk's sums past d stay out of
            // the output, which reads columns below d only)
            if constexpr (ALIGNED)
              load_cols<T>(xr + j * kColVec, xv);
            else
              load_cols_at<T>(reinterpret_cast<const unsigned char*>(xr),
                              lead, j, xv);
#pragma unroll
            for (int e = 0; e < kColVec; ++e)
              acc[k][e] = fmaf(cf, xv[e], acc[k][e]);
          }
        }
      }
      // a gathered share ends with its first partial tile
      if constexpr (GATHER) {
        if (nr < stage_rows) break;
      }
      // this warp is done with the tile: let the producer refill it
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    }

#pragma unroll
    for (int k = 0; k < CPT; ++k) {
      const int j = tid + k * kConsumers;
      if (j < nchunk)
#pragma unroll
        for (int e = 0; e < kColVec; ++e) s_acc[j * kColVec + e] = acc[k][e];
    }
    if (lane == 0) {
      s_wloss[warp] = loss_acc;
      s_wcnt[warp] = cnt_acc;
    }
  }
  __syncthreads();
  if (tid == 0) {
    double l = 0.0, c = 0.0;
    for (int k = 0; k < kConsumerWarps; ++k) {
      l += s_wloss[k];
      c += s_wcnt[k];
    }
    s_bloss = l;
    s_bcnt = c;
  }
  cluster_sync();

  // The cluster's blocks add their sums in rank order through distributed
  // shared memory; rank q writes columns [d q / C, d (q + 1) / C).
  cg::cluster_group cluster = cg::this_cluster();
  uint32_t csize_u, rank_u;
  asm volatile("mov.u32 %0, %%cluster_nctarank;" : "=r"(csize_u));
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(rank_u));
  const int csize = static_cast<int>(csize_u);
  const int rank = static_cast<int>(rank_u);
  const long long cid = blockIdx.x / csize;
  const int lo = static_cast<int>(static_cast<long long>(d) * rank / csize);
  const int hi =
      static_cast<int>(static_cast<long long>(d) * (rank + 1) / csize);
  for (int j = lo + tid; j < hi; j += kThreads) {
    float sum = 0.0f;
    for (int q = 0; q < csize; ++q) sum += cluster.map_shared_rank(s_acc, q)[j];
    part_grad[cid * d + j] = sum;
  }
  if (rank == 0 && tid == 0) {
    double l = 0.0, c = 0.0;
    for (int q = 0; q < csize; ++q) {
      l += *cluster.map_shared_rank(&s_bloss, q);
      c += *cluster.map_shared_rank(&s_bcnt, q);
    }
    part_loss[cid] = l;
    part_cnt[cid] = c;
  }
  // no block leaves while another still reads its shared memory
  cluster_sync();
}

template <int F, typename T, int CPT, bool ALIGNED>
__global__ void __launch_bounds__(kThreads, CPT <= 2 ? 2 : 1)
    window_main(const T* __restrict__ X, const float* __restrict__ y,
                const float* __restrict__ w,
                const uint8_t* __restrict__ valid,
                const long long* __restrict__ start, long long start_scale,
                long long n_total, long long rows, int d, int stage_rows,
                int stages, float* __restrict__ part_grad,
                double* __restrict__ part_loss,
                double* __restrict__ part_cnt) {
  ring_sums<F, T, CPT, false, ALIGNED>(X, y, w, valid, start, start_scale,
                                       n_total, rows, d, stage_rows, stages,
                                       part_grad, part_loss, part_cnt);
}

// The rows of [0, n) that `mask` keeps.
template <int F, typename T, int CPT, bool ALIGNED>
__global__ void __launch_bounds__(kThreads, CPT <= 2 ? 2 : 1)
    gather_main(const T* __restrict__ X, const float* __restrict__ y,
                const float* __restrict__ w,
                const uint8_t* __restrict__ mask, long long n, int d,
                int stage_rows, int stages, float* __restrict__ part_grad,
                double* __restrict__ part_loss,
                double* __restrict__ part_cnt) {
  ring_sums<F, T, CPT, true, ALIGNED>(X, y, w, mask, nullptr, 1, n, n, d,
                                      stage_rows, stages, part_grad,
                                      part_loss, part_cnt);
}

// Sums the clusters' partials: block b takes columns [32 b, 32 b + 32),
// warp k the partials k, k + 8, ..., then warp 0 adds the 8 warps' sums in
// order; block 0's warp 1 sums loss and count.  Deterministic, in f64.
__global__ void __launch_bounds__(kReduceThreads)
    window_reduce(const float* __restrict__ part_grad,
                  const double* __restrict__ part_loss,
                  const double* __restrict__ part_cnt, int parts, int d,
                  float* __restrict__ grad, float* __restrict__ loss,
                  float* __restrict__ cnt) {
  __shared__ double s[kReduceWarps][32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int j = blockIdx.x * 32 + lane;
  double v = 0.0;
  if (j < d)
    for (int p = warp; p < parts; p += kReduceWarps)
      v += static_cast<double>(part_grad[static_cast<long long>(p) * d + j]);
  s[warp][lane] = v;
  __syncthreads();
  if (warp == 0 && j < d) {
    double t = 0.0;
#pragma unroll
    for (int k = 0; k < kReduceWarps; ++k) t += s[k][lane];
    grad[j] = static_cast<float>(t);
  }
  if (blockIdx.x == 0 && warp == 1) {
    double l = 0.0, c = 0.0;
    for (int p = lane; p < parts; p += 32) {
      l += part_loss[p];
      c += part_cnt[p];
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      l += __shfl_xor_sync(0xffffffffu, l, o);
      c += __shfl_xor_sync(0xffffffffu, c, o);
    }
    if (lane == 0) {
      *loss = static_cast<float>(l);
      *cnt = static_cast<float>(c);
    }
  }
}

struct Args {
  int device;
  const void* X;
  const float* y;
  const float* w;
  const uint8_t* valid;     // window: null, every row counts; gather: mask
  const long long* start;   // null: rows start at 0; else device scalar
  long long start_scale;    // first row = clamp(start[0] * start_scale)
  long long n_total;        // rows of X
  long long rows;           // rows summed (gather: the mask's rows, n)
  int d;
  int stage_rows;           // R: rows a ring stage holds
  int stages;               // S: stages of the ring
  int cluster;              // blocks a cluster
  int max_parts;            // scratch rows: most clusters
  bool gather;              // gather_main (the rows `valid` keeps)
  float* part_grad;         // (max_parts, d)
  double* part_loss;        // (max_parts,)
  double* part_cnt;         // (max_parts,)
  float* grad;              // (d,)
  float* loss;              // (1,)
  float* cnt;               // (1,)
  cudaStream_t stream;
};

tsgd::LaunchCache g_launch_cache;

// The clusters of instance `kern` that fit on the card at once at `smem`
// bytes of dynamic shared memory (cached: launch_cache.cuh).
template <typename K>
cudaError_t max_clusters(K kern, const Args& a, int smem, int* clusters) {
  return g_launch_cache.get(
      kern, a.device, smem, a.cluster,
      [&](int* out) {
        int sms = 0;
        cudaError_t e = cudaDeviceGetAttribute(
            &sms, cudaDevAttrMultiProcessorCount, a.device);
        if (e != cudaSuccess) return e;
        cudaLaunchConfig_t cfg = {};
        cfg.gridDim = dim3((sms / a.cluster) * a.cluster);
        cfg.blockDim = dim3(kThreads);
        cfg.dynamicSmemBytes = static_cast<size_t>(smem);
        cudaLaunchAttribute attr[1];
        attr[0].id = cudaLaunchAttributeClusterDimension;
        attr[0].val.clusterDim.x = a.cluster;
        attr[0].val.clusterDim.y = 1;
        attr[0].val.clusterDim.z = 1;
        cfg.attrs = attr;
        cfg.numAttrs = 1;
        e = cudaOccupancyMaxActiveClusters(out, kern, &cfg);
        if (e != cudaSuccess) return e;
        return *out < 1 ? cudaErrorInvalidConfiguration : cudaSuccess;
      },
      clusters);
}

// The dynamic shared memory of a ring: its stages (rows, then labels),
// then round_T(w) and the sums (cuda_kernels.window_stage_plan's twin).
template <typename T, bool ALIGNED>
int ring_smem(const Args& a) {
  return a.stages * (a.stage_rows * row_pitch<T, ALIGNED>(a.d) + kLabelBytes) +
         8 * padded_d<T>(a.d);
}

// Clusters of the persistent grid over a.rows rows: as many as fit on the
// card at once (window_main's occupancy, for either entry, so that the
// gather entry splits n rows as the window entry does), at most one a
// scratch row (the wrapper sizes the scratch for the blocks an SM its plan
// aims at), and no more clusters than the rows have tiles.
template <int F, typename T, int CPT, bool ALIGNED>
cudaError_t grid_clusters(const Args& a, long long* clusters) {
  const int smem = ring_smem<T, ALIGNED>(a);
  if (smem > kMaxDynamicSmem) return cudaErrorInvalidValue;
  int fit = 0;
  cudaError_t e =
      max_clusters(window_main<F, T, CPT, ALIGNED>, a, smem, &fit);
  if (e != cudaSuccess) return e;
  const long long tiles = (a.rows + a.stage_rows - 1) / a.stage_rows;
  long long c = fit;
  if (c > a.max_parts) c = a.max_parts;
  const long long need = (tiles + a.cluster - 1) / a.cluster;
  if (c > need) c = need;
  if (c < 1) c = 1;
  *clusters = c;
  return cudaSuccess;
}

template <int F, typename T, int CPT, bool ALIGNED>
cudaError_t launch(const Args& a) {
  long long clusters = 0;
  cudaError_t e = grid_clusters<F, T, CPT, ALIGNED>(a, &clusters);
  if (e != cudaSuccess) return e;
  const int smem = ring_smem<T, ALIGNED>(a);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(clusters * a.cluster));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = a.stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (a.gather) {
    auto kern = gather_main<F, T, CPT, ALIGNED>;
    int fit = 0;  // sets the gather entry's shared-memory attribute
    e = max_clusters(kern, a, smem, &fit);
    if (e != cudaSuccess) return e;
    e = cudaLaunchKernelEx(&cfg, kern, static_cast<const T*>(a.X), a.y, a.w,
                           a.valid, a.rows, a.d, a.stage_rows, a.stages,
                           a.part_grad, a.part_loss, a.part_cnt);
  } else {
    e = cudaLaunchKernelEx(&cfg, window_main<F, T, CPT, ALIGNED>,
                           static_cast<const T*>(a.X), a.y, a.w, a.valid,
                           a.start, a.start_scale, a.n_total, a.rows, a.d,
                           a.stage_rows, a.stages, a.part_grad, a.part_loss,
                           a.part_cnt);
  }
  if (e != cudaSuccess) return e;
  const int parts = static_cast<int>(clusters);
  window_reduce<<<(a.d + 31) / 32, kReduceThreads, 0, a.stream>>>(
      a.part_grad, a.part_loss, a.part_cnt, parts, a.d, a.grad, a.loss,
      a.cnt);
  return cudaGetLastError();
}

// chunks: column chunks a consumer thread holds (a power of two)
template <int F, typename T, bool ALIGNED>
cudaError_t by_chunks(const Args& a) {
  const int chunks = (a.d + kColVec - 1) / kColVec;
  const int per = (chunks + kConsumers - 1) / kConsumers;
  if (per <= 1) return launch<F, T, 1, ALIGNED>(a);
  if (per <= 2) return launch<F, T, 2, ALIGNED>(a);
  if (per <= 4) return launch<F, T, 4, ALIGNED>(a);
  if (per <= kMaxChunksPerThread) return launch<F, T, 8, ALIGNED>(a);
  return cudaErrorInvalidValue;
}

// The ALIGNED instance when every row starts on a 16-byte unit: whole
// units a row, on an aligned base.
template <int F, typename T>
cudaError_t by_alignment(const Args& a) {
  const bool aligned = (a.d * static_cast<int>(sizeof(T))) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(a.X) % 16 == 0;
  return aligned ? by_chunks<F, T, true>(a) : by_chunks<F, T, false>(a);
}

template <int F>
cudaError_t by_dtype(int dtype, const Args& a) {
  if (dtype == kF32) return by_alignment<F, float>(a);
  if (dtype == kBF16) return by_alignment<F, __nv_bfloat16>(a);
  return cudaErrorInvalidValue;
}

int dispatch(int family, int dtype, const Args& a) {
  const int itemsize = dtype == kBF16 ? 2 : 4;
  if (a.d <= 0 || a.rows < 0 || a.rows > a.n_total || a.stage_rows < 1 ||
      a.stage_rows > kMaxStageRows || a.stages < 1 ||
      a.stages > kMaxStages || a.cluster < 1 || a.cluster > 8 ||
      a.max_parts < 1 ||
      reinterpret_cast<uintptr_t>(a.X) % itemsize != 0)
    return cudaErrorInvalidValue;
  switch (family) {
    case kLeastSquares: return by_dtype<kLeastSquares>(dtype, a);
    case kLogistic: return by_dtype<kLogistic>(dtype, a);
    case kHinge: return by_dtype<kHinge>(dtype, a);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Launches the window kernel and its reduction on `stream`; returns the
// cudaError_t of the launches (0 on success).  Does not synchronise.
int tsgd_window_sums(int family, int dtype, int device, const void* X,
                     const void* y, const void* w, const void* valid,
                     const void* start, long long start_scale,
                     long long n_total, long long rows, int d,
                     int stage_rows, int stages, int cluster, int max_parts,
                     void* part_grad, void* part_loss, void* part_cnt,
                     void* grad, void* loss, void* cnt, void* stream) {
  Args a{device,
         X,
         static_cast<const float*>(y),
         static_cast<const float*>(w),
         static_cast<const uint8_t*>(valid),
         static_cast<const long long*>(start),
         start_scale,
         n_total,
         rows,
         d,
         stage_rows,
         stages,
         cluster,
         max_parts,
         false,
         static_cast<float*>(part_grad),
         static_cast<double*>(part_loss),
         static_cast<double*>(part_cnt),
         static_cast<float*>(grad),
         static_cast<float*>(loss),
         static_cast<float*>(cnt),
         static_cast<cudaStream_t>(stream)};
  return dispatch(family, dtype, a);
}

// Launches the gather kernel (the rows of [0, n) that `mask` keeps) and
// the reduction on `stream`; returns the cudaError_t of the launches.
// Does not synchronise.
int tsgd_gather_sums(int family, int dtype, int device, const void* X,
                     const void* y, const void* w, const void* mask,
                     long long n, int d, int stage_rows, int stages,
                     int cluster, int max_parts, void* part_grad,
                     void* part_loss, void* part_cnt, void* grad, void* loss,
                     void* cnt, void* stream) {
  if (mask == nullptr) return cudaErrorInvalidValue;
  Args a{device,
         X,
         static_cast<const float*>(y),
         static_cast<const float*>(w),
         static_cast<const uint8_t*>(mask),
         nullptr,
         1,
         n,
         n,
         d,
         stage_rows,
         stages,
         cluster,
         max_parts,
         true,
         static_cast<float*>(part_grad),
         static_cast<double*>(part_loss),
         static_cast<double*>(part_cnt),
         static_cast<float*>(grad),
         static_cast<float*>(loss),
         static_cast<float*>(cnt),
         static_cast<cudaStream_t>(stream)};
  return dispatch(family, dtype, a);
}

const char* tsgd_window_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
