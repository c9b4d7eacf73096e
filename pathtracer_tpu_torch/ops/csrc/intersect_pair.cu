// Pair closest-hit kernel for Hopper (sm_90a), bound through a plain C
// interface (ops/intersect_grid.py loads it with ctypes).
//
// Replaces pathtracer_tpu/ops/intersect_grid.py:_pair_kernel (launched by
// _pair_full). The grid glue sorts (ray, cell) pairs by cell; a block of
// consecutive pairs then shares a few morton-adjacent cells, and its
// candidate list is the concatenation of those cells' cluster ranges. Per
// pair this kernel computes the minimum, over every triangle of every
// cluster of its block's list, of the Moller-Trumbore t below the pair's
// carried bound, and the winning padded slot (-1 if none), plus each
// block's visit count. The per-triangle test is the cluster kernel's
// (visit.cuh), so kernel and plain version (pair_hit_plain) agree bit for
// bit.
//
// Design. The TPU kernel read its candidates through an (8, K) SMEM window
// in rounds of K and DMA'd each cluster into a 4-slot VMEM pipeline. Here a
// block walks its whole CSR list (offsets[b] .. offsets[b+1]) in one
// launch: one CTA per pair block, one thread per pair, each visit staging
// the cluster's 20 KB of f32 columns in shared memory as the cluster kernel
// does. Each thread reads its pair's ray features from the per-ray (11, R)
// table through the pair -> ray index, instead of from (16, P) pair rows
// gathered by the glue: a pair block's rays are scattered, but the kernel
// reads those 11 floats once and then computes over tens of clusters, while
// pair rows would cost the glue an 11 x P gather and 184 MB per phase at
// config 5's 4.2M pairs.
//
// What bounds it: f32 CUDA-core work, ~90 operations per (pair, triangle),
// times 128 triangles per visit, times the block's whole list: there is no
// early exit, since the list is a few cells of one phase, and every pair of
// a block pays for every cell of the block. The cell sort keeps that list
// short (typically one or two cells); the staged cluster is read by all
// the block's threads as broadcast loads. No tensor cores, TMA or
// pipelining yet.

#include <cuda_runtime.h>

#include "visit.cuh"

namespace {

constexpr int kMaxPairBlock = 512;  // threads per CTA at most

__global__ void __launch_bounds__(kMaxPairBlock)
pair_hit_kernel(const int* __restrict__ offsets,
                const int* __restrict__ cand,
                const int* __restrict__ pair_ray,
                const float* __restrict__ rayf,
                const float* __restrict__ feat,
                float* __restrict__ t_out,
                int* __restrict__ slot_out,
                int* __restrict__ visits_out,
                int n_pairs, int n_clusters, int n_rays) {
  __shared__ __align__(16) float tri[visit::kClusterTris * visit::kTriStride];

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int n_threads = blockDim.x;
  const long long pair = static_cast<long long>(b) * n_threads + tid;
  const bool active = pair < n_pairs;

  float r[visit::kFeatUsed];
  float t_best = 0.0f;
  int best = -1;
  if (active) {
    const long long ray = min(max(pair_ray[pair], 0), n_rays - 1);
#pragma unroll
    for (int i = 0; i < visit::kFeatUsed; ++i) {
      r[i] = rayf[static_cast<long long>(i) * n_rays + ray];
    }
    // Row 10: the ray's current best t; hits must be nearer.
    t_best = rayf[static_cast<long long>(visit::kFeatUsed) * n_rays + ray];
  }

  const long long feat_row =
      static_cast<long long>(n_clusters) * visit::kClusterCols;
  const int begin = offsets[b];
  const int end = offsets[b + 1];
  for (int k = begin; k < end; ++k) {
    const int cid = min(max(cand[k], 0), n_clusters - 1);
    __syncthreads();  // the previous visit's readers are done with tri
    visit::stage_cluster(tri, feat, feat_row, cid, tid, n_threads);
    __syncthreads();
    if (active) visit::visit_cluster(tri, r, cid, t_best, best);
  }
  if (active) {
    t_out[pair] = t_best;
    slot_out[pair] = best;
  }
  if (tid == 0) visits_out[b] = end - begin;
}

}  // namespace

// Launches one CTA of pair_block threads (a multiple of 32, at most 512) per
// pair block on `stream`; allocates nothing. Shapes: offsets (n_blocks+1,),
// cand (offsets[n_blocks],), pair_ray (n_pairs,) with n_pairs <=
// pair_block * n_blocks, rayf (11, n_rays), feat (16, n_clusters*512)
// row-major; outputs t/slot (n_pairs,), visits (n_blocks,). Returns
// cudaGetLastError() after the launch.
extern "C" int pair_hit_launch(const void* offsets, const void* cand,
                               const void* pair_ray, const void* rayf,
                               const void* feat, void* t_out, void* slot_out,
                               void* visits_out, int n_blocks, int pair_block,
                               int n_pairs, int n_clusters, int n_rays,
                               void* stream) {
  pair_hit_kernel<<<n_blocks, pair_block, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(offsets), static_cast<const int*>(cand),
      static_cast<const int*>(pair_ray), static_cast<const float*>(rayf),
      static_cast<const float*>(feat), static_cast<float*>(t_out),
      static_cast<int*>(slot_out), static_cast<int*>(visits_out), n_pairs,
      n_clusters, n_rays);
  return static_cast<int>(cudaGetLastError());
}
