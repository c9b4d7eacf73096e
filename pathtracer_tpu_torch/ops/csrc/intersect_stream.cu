// Stream closest-hit kernel for Hopper (sm_90a), bound through a plain C
// interface (ops/intersect_stream.py loads it with ctypes).
//
// Replaces pathtracer_tpu/ops/intersect_stream.py:_stream_kernel (launched
// by _stream_impl): one round of the stream route's walk. Per 512-ray block
// it continues, from each ray's carried-in best t and slot, the ordered walk
// of a K-candidate window of the block's near-first list, and returns the
// new best t, slot and the clusters visited. A block whose count is 0 (a
// block the wrapper has already resolved) copies its carried values and
// visits nothing. The wrapper (closest_hit_stream) runs rounds until every
// block is resolved, which keeps the result exact for any candidate list.
//
// Design. The walk is visit_mma.cuh's walk_block, the cluster kernel's: as
// the TPU kernel, each visit is the bf16 hi/lo split product of the
// cluster's table block and the block's rays, the table streamed from
// device memory; one CTA of 8 warps per 512-ray block, each warp 64 rays on
// the tensor cores, each candidate's 32 KB block bulk-copied into a
// shared-memory ring ahead of the visit, the ordered early exit voted by
// the CTA, and the per-warp cluster-box skip. The kernel and its plain
// version (stream_hit_plain on the split table) differ only in the
// summation order inside an mma k-step.
//
// What bounds it: per (ray, triangle) 4 x 30 x 2 = 240 bf16 tensor-core
// operations and a 6-operation f32 epilogue, against 32 KB staged per
// visit for 65,536 pairs (about 480 operations per byte, so arithmetic,
// even with the table far above the 50 MB L2). The route culls only at
// super-cluster granularity, so a block's window holds many clusters off
// most of its rays: the per-warp box skip drops those visits, and the early
// exit bounds the rest.

#include <cuda_runtime.h>

#include "visit_mma.cuh"

namespace {

__global__ void __launch_bounds__(mma_visit::kWalkThreads,
                                  mma_visit::kWalkCtasPerSm)
stream_hit_kernel(const mma_visit::WalkArgs args) {
  extern __shared__ __align__(128) unsigned char smem[];
  mma_visit::walk_block(args, smem);
}

}  // namespace

// Launches one CTA of 256 threads per ray block on `stream`; allocates
// nothing. Shapes: cand/tnear (n_blocks, n_cand_max), count (n_blocks,),
// rayf (11, n_rays) with n_rays = 512 * n_blocks, t_in/slot_in (n_rays,),
// table (n_clusters, 512, 32) bf16 split columns, 16-byte aligned,
// box_lo/box_hi (n_clusters, 3); outputs t/slot (n_rays,),
// visits/warp_visits (n_blocks,). Returns cudaGetLastError() after the
// launch.
extern "C" int stream_hit_launch(const void* cand, const void* count,
                                 const void* tnear, const void* rayf,
                                 const void* t_in, const void* slot_in,
                                 const void* table, const void* box_lo,
                                 const void* box_hi, void* t_out,
                                 void* slot_out, void* visits_out,
                                 void* warp_visits_out, int n_blocks,
                                 int n_cand_max, int n_clusters, int n_rays,
                                 void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      stream_hit_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      mma_visit::kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  mma_visit::WalkArgs args{
      static_cast<const int*>(cand),
      static_cast<const int*>(count),
      static_cast<const float*>(tnear),
      static_cast<const float*>(rayf),
      static_cast<const float*>(t_in),
      static_cast<const int*>(slot_in),
      static_cast<const unsigned char*>(table),
      static_cast<const float*>(box_lo),
      static_cast<const float*>(box_hi),
      static_cast<float*>(t_out),
      static_cast<int*>(slot_out),
      static_cast<int*>(visits_out),
      static_cast<int*>(warp_visits_out),
      n_cand_max,
      n_clusters,
      n_rays};
  stream_hit_kernel<<<n_blocks, mma_visit::kWalkThreads,
                      mma_visit::kSmemBytes,
                      static_cast<cudaStream_t>(stream)>>>(args);
  return static_cast<int>(cudaGetLastError());
}
