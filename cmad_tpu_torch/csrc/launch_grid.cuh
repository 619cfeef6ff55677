// The grids of the stride-loop kernels of j2_radial_return.cu and
// segment_sum.cu: as many blocks as fill every SM at the kernel's
// occupancy, and no more than the work needs.
//
// The SM count and a kernel's resident blocks per SM are asked of the
// runtime once per device and kept (FullGrid, one per kernel instance):
// a launch makes no query but cudaGetDevice. Asked on every launch, the
// attribute and occupancy queries were part of each wrapper's host time,
// and the FE path is paced by the host's launches.
#pragma once

#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

namespace {

constexpr int kMaxDevices = 64;

// The blocks of `threads` threads of one kernel that fill every SM of the
// current device. A kernel that stages through shared memory asks first
// for the largest carveout (prefer_shared), so that as many of its blocks
// fit on an SM as its registers allow.
class FullGrid {
 public:
  template <typename Kernel>
  int64_t blocks(Kernel kernel, int threads, bool prefer_shared = false) {
    int device = 0;
    cudaGetDevice(&device);
    const bool kept = device >= 0 && device < kMaxDevices;
    int full = kept ? full_[device].load(std::memory_order_relaxed) : 0;
    if (full > 0) return full;
    if (prefer_shared) {
      cudaFuncSetAttribute(kernel,
                           cudaFuncAttributePreferredSharedMemoryCarveout,
                           cudaSharedmemCarveoutMaxShared);
    }
    int sms = 0, per_sm = 0;
    const bool ok =
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                               device) == cudaSuccess &&
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      threads, 0) ==
            cudaSuccess;
    full = (sms > 0 ? sms : 1) * (per_sm > 0 ? per_sm : 1);
    // a failed query is asked again at the next launch (whose own launch
    // error the caller reports)
    if (ok && kept) full_[device].store(full, std::memory_order_relaxed);
    return full;
  }

 private:
  std::atomic<int> full_[kMaxDevices] = {};
};

// The full grid, and no more blocks than `needed`; the kernels' stride
// loops cover the rest.
inline int grid_for(int64_t full, int64_t needed) {
  return static_cast<int>(needed < full ? needed : full);
}

// The grid of a stride loop over `needed` block-sized pieces of work,
// with every block taking the same number of pieces: as many rounds as
// the full grid needs, and no more blocks than those rounds need. A full
// grid that leaves a last round to a few blocks (8192 pieces on 264
// blocks: 31 rounds and 8 blocks alone in a 32nd) runs that round with
// the card nearly idle.
inline int balanced_grid(int64_t full, int64_t needed) {
  const int64_t rounds = (needed + full - 1) / full;
  return static_cast<int>((needed + rounds - 1) / rounds);
}

}  // namespace
