// Cluster closest-hit kernel for Hopper (sm_90a), bound through a plain C
// interface (ops/intersect_cluster.py loads it with ctypes).
//
// Replaces pathtracer_tpu/ops/intersect_cluster.py:_make_cluster_kernel
// (the Pallas kernel _cluster_kernel): per 512-ray block, the near-first
// walk of the block's candidate clusters with the ordered early exit, each
// visit the bf16 hi/lo split product of the cluster's table block and the
// block's rays plus the Moller-Trumbore epilogue, and the min (t, slot).
// It computes what that kernel computes, not block for block: the walk is
// visit_mma.cuh's walk_block, the stream kernel's, run once over the whole
// candidate list from t = the ray's bound (feature row 10) and slot -1. The
// TPU kernel's 127-ulp row encoding of t is not copied: the kernel takes the
// exact min of the split product's t. It and its plain version
// (cluster_hit_plain on the split table) differ only in the summation order
// inside an mma k-step.
//
// What bounds it: per (ray, triangle) 4 x 30 x 2 = 240 bf16 tensor-core
// operations and a 6-operation f32 epilogue, against 32 KB staged per visit
// for 65,536 pairs; the bench's whole split table (2 MB) sits in the 50 MB
// L2, so the work is arithmetic. The design takes the product to the tensor
// cores (mma.sync), stages each candidate with cp.async.bulk into a ring
// ahead of the visit, and cuts the work the block's candidate union puts on
// each ray: a warp skips a candidate whose box none of its 64 rays crosses
// before its best t (with a slack for the split's t error), and the CTA
// stops at the ordered early exit.

#include <cuda_runtime.h>

#include "visit_mma.cuh"

namespace {

__global__ void __launch_bounds__(mma_visit::kWalkThreads,
                                  mma_visit::kWalkCtasPerSm)
cluster_hit_kernel(const mma_visit::WalkArgs args) {
  extern __shared__ __align__(128) unsigned char smem[];
  mma_visit::walk_block(args, smem);
}

}  // namespace

// Launches one CTA of 256 threads per ray block on `stream`; allocates
// nothing. Shapes: cand/tnear (n_blocks, n_cand_max), count (n_blocks,),
// rayf (11, n_rays) with n_rays = 512 * n_blocks, table (n_clusters, 512,
// 32) bf16 split columns, 16-byte aligned, box_lo/box_hi (n_clusters, 3);
// outputs t/slot (n_rays,), visits/warp_visits (n_blocks,). Returns
// cudaGetLastError() after the launch.
extern "C" int cluster_hit_launch(const void* cand, const void* count,
                                  const void* tnear, const void* rayf,
                                  const void* table, const void* box_lo,
                                  const void* box_hi, void* t_out,
                                  void* slot_out, void* visits_out,
                                  void* warp_visits_out, int n_blocks,
                                  int n_cand_max, int n_clusters, int n_rays,
                                  void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      cluster_hit_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      mma_visit::kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const float* features = static_cast<const float*>(rayf);
  mma_visit::WalkArgs args{
      static_cast<const int*>(cand),
      static_cast<const int*>(count),
      static_cast<const float*>(tnear),
      features,
      // Row 10: t_max clipped to the scene-box exit; hits must be nearer.
      features + static_cast<long long>(visit::kFeatUsed) * n_rays,
      nullptr,
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
  cluster_hit_kernel<<<n_blocks, mma_visit::kWalkThreads,
                       mma_visit::kSmemBytes,
                       static_cast<cudaStream_t>(stream)>>>(args);
  return static_cast<int>(cudaGetLastError());
}
