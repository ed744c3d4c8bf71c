// Meeting point of the blocks that share one reduction (K1's anchor splits,
// K2s's and K2r's pixel splits): each block stores its partial result in a workspace
// and calls last_block_done(); the block that arrives last sees every
// partial and folds them in split order, so the result does not depend on
// which block that was. No second launch, no atomics on the data.
//
// `counter` is one unsigned per reduction, zero before the launch; the last
// block sets it back to zero, so the wrapper's cached counters need no
// clearing between launches on one stream.

#pragma once

#include <cuda_runtime.h>

// Call from every thread of the block, after the block's partials were
// written to global memory. Returns true in every thread of the one block
// that arrived last of `expected`.
//
// Ordering: the block's barrier puts every thread's partials before thread
// 0's count, and the count is one atom.acq_rel at gpu scope: its release
// publishes them (the PTX memory model's causality order runs through the
// barrier), its acquire in the last block makes the other blocks' partials
// visible to that block after its second barrier. That block reads them with
// __ldcg, from L2.
__device__ __forceinline__ bool last_block_done(unsigned* counter, unsigned expected) {
  __shared__ int is_last;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned before;
    asm volatile("atom.add.acq_rel.gpu.global.u32 %0, [%1], 1;\n"
                 : "=r"(before)
                 : "l"(counter)
                 : "memory");
    is_last = before + 1u == expected;
    if (before + 1u == expected) *counter = 0u;  // all have counted: ready for the next launch
  }
  __syncthreads();
  return is_last != 0;
}
