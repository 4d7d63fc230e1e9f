// A kernel's block as the card reports it, for the block-feasibility
// report (core/costmodel.py block_feasibility) and the shared-memory
// footprint model (analysis/smem.py) that chip_smoke.py holds to it.
#pragma once

#include <cuda_runtime.h>

// Cells of the out array of every repro_*_block_attrs entry point.
constexpr int ATTR_CELLS = 7;

// out [ATTR_CELLS]: threads a block, static shared bytes, registers a
// thread, local bytes a thread, blocks resident per SM at `dynamic` bytes
// of dynamic shared memory, the SMs, and `dynamic` itself (what the
// launcher requests).  A kernel above 48 KB of dynamic shared memory gets
// the opt-in its launcher sets before the occupancy query.
inline cudaError_t repro_block_attrs(const void* kernel, int threads,
                                     int dynamic, int* out) {
  cudaFuncAttributes a;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaSuccess;
  if (dynamic > 0)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, dynamic);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&a, kernel);
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        threads, dynamic);
  if (err != cudaSuccess) return err;
  out[0] = threads;
  out[1] = (int)a.sharedSizeBytes;
  out[2] = a.numRegs;
  out[3] = (int)a.localSizeBytes;
  out[4] = per_sm;
  out[5] = sms;
  out[6] = dynamic;
  return cudaSuccess;
}
