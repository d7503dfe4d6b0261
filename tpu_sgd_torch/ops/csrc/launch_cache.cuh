// The launch state that csrc/fused_sums.cu and csrc/window_sums.cu keep per
// kernel instance and device, so that a launch makes no attribute call and
// no occupancy query after the first one of its kind.  tpu_sgd_torch/ops/
// _build.py puts this directory on nvcc's include path and hashes this
// header with every source.
#pragma once

#include <cuda_runtime.h>

#include <mutex>
#include <vector>

namespace tsgd {

class LaunchCache {
 public:
  // The figure that `compute` (a callable `cudaError_t(int*)`, called with
  // the kernel's attribute already set) gives for instance `kern` on
  // `device` at `smem` bytes of dynamic shared memory and cluster size
  // `cluster`: computed on the first call of its kind and kept.  The
  // instance's dynamic shared-memory limit is raised to `smem` first when
  // it is below it.
  template <typename K, typename F>
  cudaError_t get(K kern, int device, int smem, int cluster, F compute,
                  int* value) {
    std::lock_guard<std::mutex> lock(mutex_);
    const void* key = reinterpret_cast<const void*>(kern);
    int limit = -1;  // the limit set so far: the largest size kept
    for (const Entry& e : entries_) {
      if (e.kernel != key || e.device != device) continue;
      if (e.smem == smem && e.cluster == cluster) {
        *value = e.value;
        return cudaSuccess;
      }
      if (e.smem > limit) limit = e.smem;
    }
    cudaError_t err;
    if (limit < smem) {
      err = cudaFuncSetAttribute(
          kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err != cudaSuccess) return err;
    }
    int v = 0;
    if ((err = compute(&v)) != cudaSuccess) return err;
    entries_.push_back(Entry{key, device, smem, cluster, v});
    *value = v;
    return cudaSuccess;
  }

 private:
  struct Entry {
    const void* kernel;
    int device;
    int smem;
    int cluster;
    int value;
  };
  std::mutex mutex_;
  std::vector<Entry> entries_;
};

}  // namespace tsgd
