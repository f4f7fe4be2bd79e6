// One cached number per CUDA device of the process.
//
// A kernel's function attributes (its dynamic shared memory limit, set by
// cudaFuncSetAttribute) belong to the device that is current when they
// are set, and a library is loaded once per process, however many cards
// launch it. So what a launch caches on its first call (the attribute
// set, the blocks that fit on an SM) is kept per device: the first launch
// on each card sets that card's attribute and fills its own slot.
#pragma once

#include <cuda_runtime.h>

constexpr int kMaxDevices = 64;

// The current device's slot of cache[kMaxDevices]. A device past the
// table (or a failed query) gets a scratch slot that starts at 0 each
// call, so the caller recomputes its value every time.
inline int& device_slot(int* cache)
{
    int dev = -1;
    if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= kMaxDevices) {
        thread_local int scratch;
        scratch = 0;
        return scratch;
    }
    return cache[dev];
}
