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
// Design. The TPU kernel kept the table in HBM and double-buffered each
// candidate cluster into VMEM by DMA, reading its candidates through an
// (8, K) SMEM row window and writing broadcast (8, R) outputs. Here the
// table is in device memory as for every kernel of the port, and the walk
// and visit are the cluster kernel's (visit.cuh: one CTA per block, one
// thread per ray, each visit staging 20 KB of a cluster's f32 columns in
// shared memory, per-triangle test rounded as the plain version rounds), so
// kernel and plain version (stream_hit_plain) agree bit for bit. Only the
// carried-in state and the skipping of resolved blocks are this kernel's.
//
// What bounds it: as the cluster kernel, f32 CUDA-core work of ~90
// operations per (ray, triangle), 5.9 M per visit against 20 KB staged
// (about 290 operations per byte, so arithmetic, not the table's bytes,
// even when a large scene's 10-row table is far above the 50 MB L2). The
// early exit bounds the visits. No cp.async/TMA double buffer yet.

#include <cuda_runtime.h>

#include "visit.cuh"

namespace {

constexpr int kRayBlock = 512;  // rays per CTA = cull block

__global__ void __launch_bounds__(kRayBlock)
stream_hit_kernel(const int* __restrict__ cand,
                  const int* __restrict__ count,
                  const float* __restrict__ tnear,
                  const float* __restrict__ rayf,
                  const float* __restrict__ t_in,
                  const int* __restrict__ slot_in,
                  const float* __restrict__ feat,
                  float* __restrict__ t_out,
                  int* __restrict__ slot_out,
                  int* __restrict__ visits_out,
                  int n_cand_max, int n_clusters, int n_rays) {
  __shared__ __align__(16) float tri[visit::kClusterTris * visit::kTriStride];

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const long long ray = static_cast<long long>(b) * kRayBlock + tid;
  float t_best = t_in[ray];
  int best = slot_in[ray];
  const int n_cand = min(count[b], n_cand_max);  // the same for the block
  int k = 0;
  if (n_cand > 0) {
    float r[visit::kFeatUsed];
#pragma unroll
    for (int i = 0; i < visit::kFeatUsed; ++i) {
      r[i] = rayf[static_cast<long long>(i) * n_rays + ray];
    }
    const long long feat_row =
        static_cast<long long>(n_clusters) * visit::kClusterCols;
    const long long cand_row = static_cast<long long>(b) * n_cand_max;
    k = visit::walk_ordered(tri, cand + cand_row, tnear + cand_row, n_cand,
                            feat, feat_row, n_clusters, r, t_best, best, tid,
                            kRayBlock);
  }
  t_out[ray] = t_best;
  slot_out[ray] = best;
  if (tid == 0) visits_out[b] = k;
}

}  // namespace

// Launches one CTA of 512 threads per ray block on `stream`; allocates
// nothing. Shapes: cand/tnear (n_blocks, n_cand_max), count (n_blocks,),
// rayf (11, n_rays) with n_rays = 512 * n_blocks, t_in/slot_in (n_rays,),
// feat (16, n_clusters*512) row-major; outputs t/slot (n_rays,), visits
// (n_blocks,). Returns cudaGetLastError() after the launch.
extern "C" int stream_hit_launch(const void* cand, const void* count,
                                 const void* tnear, const void* rayf,
                                 const void* t_in, const void* slot_in,
                                 const void* feat, void* t_out,
                                 void* slot_out, void* visits_out,
                                 int n_blocks, int n_cand_max,
                                 int n_clusters, int n_rays, void* stream) {
  stream_hit_kernel<<<n_blocks, kRayBlock, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(cand), static_cast<const int*>(count),
      static_cast<const float*>(tnear), static_cast<const float*>(rayf),
      static_cast<const float*>(t_in), static_cast<const int*>(slot_in),
      static_cast<const float*>(feat), static_cast<float*>(t_out),
      static_cast<int*>(slot_out), static_cast<int*>(visits_out),
      n_cand_max, n_clusters, n_rays);
  return static_cast<int>(cudaGetLastError());
}
