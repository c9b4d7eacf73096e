// Cluster closest-hit kernel for Hopper (sm_90a), bound through a plain C
// interface (ops/intersect_cluster.py loads it with ctypes).
//
// Replaces pathtracer_tpu/ops/intersect_cluster.py:_make_cluster_kernel
// (the Pallas kernel _cluster_kernel). It computes what that kernel
// computes, not block for block: one CTA walks the near-first candidate
// clusters of one 512-ray block, one thread per ray, with the ordered early
// exit; each visit tests all 128 triangles of a cluster (visit.cuh: the
// walk is shared with the stream kernel, the visit also with the pair
// kernel). The TPU kernel's bf16 hi/lo matmul and its 127-ulp
// encoded min were there to fit the MXU; this kernel takes the exact f32
// min, rounded so that it equals the plain PyTorch version,
// cluster_hit_plain, bit for bit: that is what lets a check demand equal
// hit masks for shadow rays whose hit lies within an ulp of their t_max.
//
// What bounds it: per ray and triangle, 40 multiplies + 36 adds + ~12
// predicate ops in f32 on the CUDA cores, fed by 40 shared-memory floats.
// The design stages one cluster's 128 x 4 x 10 coefficients (20 KB f32) in
// shared memory per visit with coalesced 2 KB row loads, transposed so
// that each triangle's 40 coefficients are contiguous: every thread then
// reads them as 10 broadcast 16-byte loads, so shared-memory issue stays
// below the arithmetic. No tensor cores, TMA or pipelining yet.

#include <cuda_runtime.h>

#include "visit.cuh"

namespace {

constexpr int kRayBlock = 512;  // rays per CTA = cull block

__global__ void __launch_bounds__(kRayBlock)
cluster_hit_kernel(const int* __restrict__ cand,
                   const int* __restrict__ count,
                   const float* __restrict__ tnear,
                   const float* __restrict__ rayf,
                   const float* __restrict__ feat,
                   float* __restrict__ t_out,
                   int* __restrict__ slot_out,
                   int* __restrict__ visits_out,
                   int n_cand_max, int n_clusters, int n_rays) {
  __shared__ __align__(16) float tri[visit::kClusterTris * visit::kTriStride];

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const long long ray = static_cast<long long>(b) * kRayBlock + tid;

  float r[visit::kFeatUsed];
#pragma unroll
  for (int i = 0; i < visit::kFeatUsed; ++i) {
    r[i] = rayf[static_cast<long long>(i) * n_rays + ray];
  }
  // Row 10: t_max clipped to the scene-box exit; hits must be nearer.
  float t_best =
      rayf[static_cast<long long>(visit::kFeatUsed) * n_rays + ray];
  int best = -1;

  const long long feat_row =
      static_cast<long long>(n_clusters) * visit::kClusterCols;
  const long long cand_row = static_cast<long long>(b) * n_cand_max;
  const int n_cand = min(count[b], n_cand_max);
  const int k = visit::walk_ordered(tri, cand + cand_row, tnear + cand_row,
                                    n_cand, feat, feat_row, n_clusters, r,
                                    t_best, best, tid, kRayBlock);
  t_out[ray] = t_best;
  slot_out[ray] = best;
  if (tid == 0) visits_out[b] = k;
}

}  // namespace

// Launches one CTA of 512 threads per ray block on `stream`; allocates
// nothing. Shapes: cand/tnear (n_blocks, n_cand_max), count (n_blocks,),
// rayf (11, n_rays) with n_rays = 512 * n_blocks, feat (16, n_clusters*512)
// row-major; outputs t/slot (n_rays,), visits (n_blocks,). Returns
// cudaGetLastError() after the launch.
extern "C" int cluster_hit_launch(const void* cand, const void* count,
                                  const void* tnear, const void* rayf,
                                  const void* feat, void* t_out,
                                  void* slot_out, void* visits_out,
                                  int n_blocks, int n_cand_max,
                                  int n_clusters, int n_rays, void* stream) {
  cluster_hit_kernel<<<n_blocks, kRayBlock, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(cand), static_cast<const int*>(count),
      static_cast<const float*>(tnear), static_cast<const float*>(rayf),
      static_cast<const float*>(feat), static_cast<float*>(t_out),
      static_cast<int*>(slot_out), static_cast<int*>(visits_out),
      n_cand_max, n_clusters, n_rays);
  return static_cast<int>(cudaGetLastError());
}
