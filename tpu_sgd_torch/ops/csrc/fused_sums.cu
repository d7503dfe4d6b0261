// Fused mini-batch gradient sums for generalized linear models, for Hopper
// (sm_90a).  Built by tpu_sgd_torch/ops/_build.py with nvcc into a shared
// library with a plain C interface; tpu_sgd_torch/ops/cuda_kernels.py loads
// it with ctypes.
//
// Replaces the three Pallas TPU kernels of tpu_sgd/ops/pallas_kernels.py:
//   fused_gradient_sums   (_masked_kernel)      -> rows [0, n), optional mask
//   fused_window_sums     (_window_kernel)      -> rows [start, start + m)
//   fused_window_sums_vpu (_window_kernel_vpu)  -> the same window
// On the TPU the two window kernels differed only in how the gradient
// reduction used the matrix unit; here both are one dot product per row and
// one FMA per column, so a single kernel serves all three entries.  It
// takes the calls that csrc/window_sums.cu does not: widths whose ring of
// staged rows does not fit in shared memory (f32 above 4,124 columns, bf16
// above 7,216, any width above 8,192), and bases not aligned to X's
// element size (tpu_sgd_torch/ops/cuda_kernels.py's shape rule).  Such
// rows cannot be staged whole; this kernel reads a tile a second time from
// L2 instead.
//
// It computes (grad_sum (d,), loss_sum, count) under the JAX package's
// mixed-precision contract (tpu_sgd/ops/gradients.py margins_of/grad_sum_of):
//   margin = x . round_T(w)            f32 accumulation
//   (coeff, loss) = pointwise(margin, y)   in f32, zero where masked out
//   grad  += round_T(coeff) * x        f32 accumulation
// where round_T rounds to X's element type (bf16 or f32).
//
// What bounds it: the bytes of X.  Each selected row is read from device
// memory once (3.35 TB/s on an H100 SXM); the two dot products are 4 flops
// per element, far below the card's rate.  The design keeps the read single:
// each block walks a contiguous share of the rows in chunks of 1024; with a
// mask it first compacts the chunk's selected rows (a block-wide prefix sum,
// order kept), so rows that the mask drops are never read and a Bernoulli
// batch of fraction f reads f of X.  The live rows go in tiles of 32: each
// warp computes the margins of 4 rows (8- or 16-byte loads where the row
// width allows), then the block adds coeff * x for the tile column by
// column, 8 rows' loads in flight, while the tile is still in L1/L2, into a
// (d,) f32 accumulator in shared memory.  The grid holds as many blocks as
// fit on the card at once; that count (the shared-memory attribute, the
// occupancy) is computed once per kernel instance, device and size, and
// cached (launch_cache.cuh).
//
// Determinism: each block walks a fixed contiguous range of rows and writes
// its partial gradient, loss and count to scratch; a second kernel sums the
// partials in block order.  There are no float atomics, so repeated runs are
// bitwise identical.  Loss and count partials are summed in f64, so the
// count is exact for any row count below 2^53.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "launch_cache.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerWarp = 4;
constexpr int kTileRows = kWarps * kRowsPerWarp;
// rows of a tile whose loads phase (b) issues together
constexpr int kBatchRows = 8;
// rows whose mask one pass compacts (4 per thread)
constexpr int kChunkRows = 1024;
constexpr int kRowsPerThread = kChunkRows / kThreads;
// occupancy the register budget is fitted to (128 registers a thread): a
// sweep of 2/3/4 blocks and 4/8 rows a warp on the H100 found 4 rows at 2
// blocks fastest, and 64 registers (4 blocks) spilled and slowed f32 X
constexpr int kMinBlocksPerSM = 2;

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

// VEC consecutive elements as f32; VEC > 1 is one aligned 8- or 16-byte
// load.
template <typename T, int VEC>
__device__ __forceinline__ void load_vec(const T* p, float (&out)[VEC]) {
  if constexpr (VEC == 1) {
    out[0] = to_f(p[0]);
  } else if constexpr (VEC * sizeof(T) == 8) {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int k = 0; k < VEC; ++k) out[k] = to_f(e[k]);
  } else {
    static_assert(VEC * sizeof(T) == 16, "one 16-byte load");
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int k = 0; k < VEC; ++k) out[k] = to_f(e[k]);
  }
}

// The pointwise rules of tpu_sgd/ops/gradients.py:307-342.
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

struct Args {
  int device;
  const void* X;
  const float* y;
  const float* w;
  const uint8_t* mask;      // null: every row counts
  const long long* start;   // null: rows start at 0; else device scalar
  long long start_scale;    // first row = clamp(start[0] * start_scale)
  long long n_total;        // rows of X
  long long rows;           // rows summed
  int d;
  int w_in_smem;
  int blocks;               // most blocks: the scratch rows allocated
  float* part_grad;         // (blocks, d)
  double* part_loss;        // (blocks,)
  double* part_cnt;         // (blocks,)
  float* grad;              // (d,)
  float* loss;              // (1,)
  float* cnt;               // (1,)
  cudaStream_t stream;
};

template <int F, typename T, bool MASK, int VEC>
__global__ void __launch_bounds__(kThreads, kMinBlocksPerSM)
    sums_phase1(const T* __restrict__ X, const float* __restrict__ y,
                const float* __restrict__ w, const uint8_t* __restrict__ mask,
                const long long* __restrict__ start, long long start_scale,
                long long n_total, long long rows, int d, int w_in_smem,
                float* __restrict__ part_grad, double* __restrict__ part_loss,
                double* __restrict__ part_cnt) {
  extern __shared__ float smem[];
  float* acc = smem;                               // (d,) gradient sum
  float* ws = w_in_smem ? smem + d : nullptr;      // (d,) round_T(w)
  __shared__ int s_rows[MASK ? kChunkRows : 1];    // live rows of a chunk
  __shared__ int s_warp_live[kWarps];
  __shared__ float s_coeff[kTileRows];
  __shared__ int s_off[kTileRows];                 // tile row -> chunk row
  __shared__ double s_loss[kWarps];
  __shared__ double s_cnt[kWarps];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  // The window start lives on the device.  As lax.dynamic_slice does, a
  // negative start counts from the end, then clamps into [0, n - rows].
  long long row0 = 0;
  if (start != nullptr) {
    long long s = start[0] * start_scale;
    if (s < 0) s += n_total;
    const long long hi = n_total - rows > 0 ? n_total - rows : 0;
    row0 = s < 0 ? 0 : (s > hi ? hi : s);
  }
  for (int j = tid; j < d; j += kThreads) {
    acc[j] = 0.0f;
    if (ws != nullptr) ws[j] = round_to<T>(w[j]);
  }
  const bool w_pre = ws != nullptr;
  const float* wp = w_pre ? ws : w;
  __syncthreads();

  // this block's contiguous share of the rows
  const long long r_begin = rows * blockIdx.x / gridDim.x;
  const long long r_end = rows * (blockIdx.x + 1) / gridDim.x;
  const int nvec = d / VEC;  // the wrapper picks VEC to divide d
  double loss_acc = 0.0;
  double cnt_acc = 0.0;

  for (long long c0 = r_begin; c0 < r_end; c0 += kChunkRows) {
    const int span = static_cast<int>(
        r_end - c0 < kChunkRows ? r_end - c0 : kChunkRows);
    int n_live = span;
    if (MASK) {
      // Compact the chunk's selected rows into s_rows, in row order, so
      // the tiles below hold live rows only.
      int flags = 0, cnt = 0;
#pragma unroll
      for (int k = 0; k < kRowsPerThread; ++k) {
        const int i = tid * kRowsPerThread + k;
        const bool f = i < span && mask[row0 + c0 + i] != 0;
        flags |= static_cast<int>(f) << k;
        cnt += f;
      }
      int incl = cnt;  // inclusive scan of cnt over the warp
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int v = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += v;
      }
      if (lane == 31) s_warp_live[warp] = incl;
      __syncthreads();
      int base = 0;
      n_live = 0;
#pragma unroll
      for (int k = 0; k < kWarps; ++k) {
        const int v = s_warp_live[k];
        base += k < warp ? v : 0;
        n_live += v;
      }
      int pos = base + incl - cnt;
#pragma unroll
      for (int k = 0; k < kRowsPerThread; ++k)
        if ((flags >> k) & 1) s_rows[pos++] = tid * kRowsPerThread + k;
      __syncthreads();
    }

    for (int t0 = 0; t0 < n_live; t0 += kTileRows) {
      // (a) margins: each warp takes kRowsPerWarp rows of the tile
      bool live[kRowsPerWarp];
      int off[kRowsPerWarp];
      float dot[kRowsPerWarp];
      const T* xr[kRowsPerWarp];
#pragma unroll
      for (int k = 0; k < kRowsPerWarp; ++k) {
        const int i = t0 + warp * kRowsPerWarp + k;
        live[k] = i < n_live;
        off[k] = live[k] ? (MASK ? s_rows[i] : i) : 0;
        dot[k] = 0.0f;
        xr[k] = X + (row0 + c0 + off[k]) * static_cast<long long>(d);
      }
      for (int c = lane; c < nvec; c += 32) {
        float wv[VEC];
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          const float v = wp[c * VEC + e];
          wv[e] = w_pre ? v : round_to<T>(v);
        }
#pragma unroll
        for (int k = 0; k < kRowsPerWarp; ++k) {
          if (live[k]) {
            float xv[VEC];
            load_vec<T, VEC>(xr[k] + c * VEC, xv);
#pragma unroll
            for (int e = 0; e < VEC; ++e)
              dot[k] = fmaf(xv[e], wv[e], dot[k]);
          }
        }
      }
#pragma unroll
      for (int k = 0; k < kRowsPerWarp; ++k) {
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          dot[k] += __shfl_xor_sync(0xffffffffu, dot[k], o);
        float coeff = 0.0f;
        if (live[k]) {
          float cf, l;
          pointwise<F>(dot[k], y[row0 + c0 + off[k]], cf, l);
          coeff = round_to<T>(cf);
          if (lane == 0) {
            loss_acc += static_cast<double>(l);
            cnt_acc += 1.0;
          }
        }
        if (lane == 0) {
          s_coeff[warp * kRowsPerWarp + k] = coeff;
          s_off[warp * kRowsPerWarp + k] = off[k];
        }
      }
      __syncthreads();

      // (b) grad += coeff * x over the tile, each thread on its own
      // columns, kBatchRows loads in flight at a time.  Every tile row is
      // live or a padding row (coeff 0, offset 0: a valid row), so the
      // loads need no branch; the sum runs in row order.
      const T* xc = X + (row0 + c0) * static_cast<long long>(d);
      for (int c = tid; c < nvec; c += kThreads) {
        float a[VEC];
#pragma unroll
        for (int e = 0; e < VEC; ++e) a[e] = acc[c * VEC + e];
        for (int r0 = 0; r0 < kTileRows; r0 += kBatchRows) {
          float xv[kBatchRows][VEC];
#pragma unroll
          for (int u = 0; u < kBatchRows; ++u)
            load_vec<T, VEC>(
                xc + s_off[r0 + u] * static_cast<long long>(d) + c * VEC,
                xv[u]);
#pragma unroll
          for (int u = 0; u < kBatchRows; ++u) {
            const float cf = s_coeff[r0 + u];
#pragma unroll
            for (int e = 0; e < VEC; ++e) a[e] = fmaf(cf, xv[u][e], a[e]);
          }
        }
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[c * VEC + e] = a[e];
      }
      __syncthreads();
    }
  }

  if (lane == 0) {
    s_loss[warp] = loss_acc;
    s_cnt[warp] = cnt_acc;
  }
  float* pg = part_grad + static_cast<long long>(blockIdx.x) * d;
  for (int j = tid; j < d; j += kThreads) pg[j] = acc[j];
  __syncthreads();
  if (tid == 0) {
    double l = 0.0, c = 0.0;
    for (int k = 0; k < kWarps; ++k) {
      l += s_loss[k];
      c += s_cnt[k];
    }
    part_loss[blockIdx.x] = l;
    part_cnt[blockIdx.x] = c;
  }
}

// Sums the per-block partials in block order (deterministic).
__global__ void sums_phase2(const float* __restrict__ part_grad,
                            const double* __restrict__ part_loss,
                            const double* __restrict__ part_cnt, int blocks,
                            int d, float* __restrict__ grad,
                            float* __restrict__ loss, float* __restrict__ cnt) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j < d) {
    double s = 0.0;
    for (int b = 0; b < blocks; ++b)
      s += static_cast<double>(part_grad[static_cast<long long>(b) * d + j]);
    grad[j] = static_cast<float>(s);
  }
  if (j == 0) {
    double l = 0.0, c = 0.0;
    for (int b = 0; b < blocks; ++b) {
      l += part_loss[b];
      c += part_cnt[b];
    }
    *loss = static_cast<float>(l);
    *cnt = static_cast<float>(c);
  }
}

tsgd::LaunchCache g_launch_cache;

template <int F, typename T, bool MASK, int VEC>
cudaError_t launch(const Args& a) {
  auto kern = sums_phase1<F, T, MASK, VEC>;
  const int smem = static_cast<int>(sizeof(float)) * a.d *
                   (a.w_in_smem ? 2 : 1);
  // as many blocks as fit on the card at once, at most a.blocks (the
  // scratch rows the wrapper allocated) and at most one per tile of rows
  int resident = 0;
  cudaError_t e = g_launch_cache.get(
      kern, a.device, smem, 1,
      [&](int* out) {
        int sms = 0, per_sm = 0;
        cudaError_t err = cudaDeviceGetAttribute(
            &sms, cudaDevAttrMultiProcessorCount, a.device);
        if (err != cudaSuccess) return err;
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern,
                                                            kThreads, smem);
        *out = (per_sm > 0 ? per_sm : 1) * sms;
        return err;
      },
      &resident);
  if (e != cudaSuccess) return e;
  long long blocks = resident;
  const long long tiles = (a.rows + kTileRows - 1) / kTileRows;
  if (blocks > a.blocks) blocks = a.blocks;
  if (blocks > tiles) blocks = tiles;
  if (blocks < 1) blocks = 1;
  kern<<<static_cast<int>(blocks), kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.X), a.y, a.w, a.mask, a.start, a.start_scale,
      a.n_total, a.rows, a.d, a.w_in_smem, a.part_grad, a.part_loss,
      a.part_cnt);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  sums_phase2<<<(a.d + 255) / 256, 256, 0, a.stream>>>(
      a.part_grad, a.part_loss, a.part_cnt, static_cast<int>(blocks), a.d,
      a.grad, a.loss,
      a.cnt);
  return cudaGetLastError();
}

// vec: elements per load — 1, or 8 or 16 bytes' worth (the wrapper picks
// the widest that divides d and still gives most threads a column chunk)
template <int F, typename T, bool MASK>
cudaError_t by_vec(int vec, const Args& a) {
  constexpr int kWide = 16 / sizeof(T);
  constexpr int kHalf = 8 / sizeof(T);
  if (vec == 1) return launch<F, T, MASK, 1>(a);
  if (vec == kHalf) return launch<F, T, MASK, kHalf>(a);
  if (vec == kWide) return launch<F, T, MASK, kWide>(a);
  return cudaErrorInvalidValue;
}

template <int F, typename T>
cudaError_t by_mask(int vec, const Args& a) {
  return a.mask != nullptr ? by_vec<F, T, true>(vec, a)
                           : by_vec<F, T, false>(vec, a);
}

template <int F>
cudaError_t by_dtype(int dtype, int vec, const Args& a) {
  if (dtype == kF32) return by_mask<F, float>(vec, a);
  if (dtype == kBF16) return by_mask<F, __nv_bfloat16>(vec, a);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Launches both phases on `stream`; returns the cudaError_t of the launches
// (0 on success).  Does not synchronise.
int tsgd_fused_sums(int family, int dtype, int device, int vec, const void* X,
                    const void* y, const void* w, const void* mask,
                    const void* start, long long start_scale,
                    long long n_total, long long rows, int d, int w_in_smem,
                    int blocks, void* part_grad, void* part_loss,
                    void* part_cnt, void* grad, void* loss, void* cnt,
                    void* stream) {
  if (d <= 0 || blocks <= 0 || rows < 0) return cudaErrorInvalidValue;
  Args a{device,
         X,
         static_cast<const float*>(y),
         static_cast<const float*>(w),
         static_cast<const uint8_t*>(mask),
         static_cast<const long long*>(start),
         start_scale,
         n_total,
         rows,
         d,
         w_in_smem,
         blocks,
         static_cast<float*>(part_grad),
         static_cast<double*>(part_loss),
         static_cast<double*>(part_cnt),
         static_cast<float*>(grad),
         static_cast<float*>(loss),
         static_cast<float*>(cnt),
         static_cast<cudaStream_t>(stream)};
  switch (family) {
    case kLeastSquares: return by_dtype<kLeastSquares>(dtype, vec, a);
    case kLogistic: return by_dtype<kLogistic>(dtype, vec, a);
    case kHinge: return by_dtype<kHinge>(dtype, vec, a);
    default: return cudaErrorInvalidValue;
  }
}

const char* tsgd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
