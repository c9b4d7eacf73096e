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
// block's visit count.
//
// Design. As the TPU kernel, each visit is the bf16 hi/lo split product on
// the matrix unit, here the tensor cores (visit_mma.cuh): a block walks its
// whole CSR list (offsets[b] .. offsets[b+1]) in one launch, each
// candidate's 32 KB block bulk-copied into a two-stage shared-memory ring
// one candidate ahead of the visit. The CTA is sized to its pair block, a
// warp per 64 pairs (a 32-pair block is one warp of two m16 tiles), so no
// warp idles on the narrow blocks of the later eras. Each warp reads its
// pairs' ray features from the per-ray (11, R) table through the pair ->
// ray index and splits them once: a pair block's rays are scattered, but
// the 11 floats are read once for tens of visits, while pair rows would
// cost the glue an 11 x P gather per phase. The kernel and its plain
// version (pair_hit_plain on the split table) differ only in the summation
// order inside an mma k-step.
//
// What bounds it: per (pair, triangle) 4 x 30 x 2 = 240 bf16 tensor-core
// operations and a 6-operation f32 epilogue, times 128 triangles per
// visit, times the block's whole list: there is no early exit, since the
// list is a few cells of one phase, and every pair of a block pays for
// every cell of the block. The cell sort keeps that list short (typically
// one or two cells).

#include <cuda_runtime.h>

#include "visit_mma.cuh"

namespace {

constexpr int kMaxPairBlock = 512;
constexpr int kMaxThreads = kMaxPairBlock / mma_visit::kWarpRays * 32;  // 256

__global__ void __launch_bounds__(kMaxThreads, 2)
pair_hit_kernel(const int* __restrict__ offsets,
                const int* __restrict__ cand,
                const int* __restrict__ pair_ray,
                const float* __restrict__ rayf,
                const unsigned char* __restrict__ table,
                float* __restrict__ t_out,
                int* __restrict__ slot_out,
                int* __restrict__ visits_out,
                int pair_block, int n_pairs, int n_clusters, int n_rays) {
  extern __shared__ __align__(128) unsigned char smem[];
  using namespace mma_visit;

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  // pair_block is a multiple of 32: a warp has 4 m tiles, or 2 at the end.
  const int tiles_m = min(kTilesM, (pair_block - warp * kWarpRays) / 16);
  const long long warp_pair =
      static_cast<long long>(b) * pair_block + warp * kWarpRays;
  const auto pair_of = [&](int m, int h) {
    return warp_pair + 16 * m + g + 8 * h;
  };
  const auto active = [&](int m, int h) {
    return m < tiles_m && pair_of(m, h) < n_pairs;
  };

  long long ray[kTilesM][2];
  float t_best[kTilesM][2];
  int best[kTilesM][2];
#pragma unroll
  for (int m = 0; m < kTilesM; ++m) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      ray[m][h] = active(m, h)
                      ? min(max(pair_ray[pair_of(m, h)], 0), n_rays - 1)
                      : -1;
      // Row 10: the ray's current best t; hits must be nearer.
      t_best[m][h] = ray[m][h] < 0 ? 0.0f
                                   : rayf[static_cast<long long>(kFeat) *
                                              n_rays + ray[m][h]];
      best[m][h] = -1;
    }
  }

  const int begin = offsets[b];
  const int n = offsets[b + 1] - begin;
  const auto cid_of = [&](int k) {
    return min(max(cand[begin + k], 0), n_clusters - 1);
  };
  if (n > 0) {
    const Ring ring(smem);
    ring.init();
    if (tid == 0) ring.issue(table, cid_of(0), 0);
    Rays r;
    load_rays(r, [&](int m, int h, int i) {
      return ray[m][h] < 0
                 ? 0.0f
                 : rayf[static_cast<long long>(i) * n_rays + ray[m][h]];
    }, t);
    for (int k = 0; k < n; ++k) {
      __syncthreads();  // the previous visit's readers are done with its stage
      if (tid == 0 && k + 1 < n) ring.issue(table, cid_of(k + 1), k + 1);
      visit_cluster(ring.wait(k), r, tiles_m, cid_of(k), t_best, best, g, t);
    }
  }
  if (t == 0) {  // a quad's lanes hold the same rows' results
#pragma unroll
    for (int m = 0; m < kTilesM; ++m) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (active(m, h)) {
          t_out[pair_of(m, h)] = t_best[m][h];
          slot_out[pair_of(m, h)] = best[m][h];
        }
      }
    }
  }
  if (tid == 0) visits_out[b] = n;
}

}  // namespace

// Launches one CTA of a warp per 64 pairs (pair_block a multiple of 32, at
// most 512) per pair block on `stream`; allocates nothing. Shapes: offsets
// (n_blocks+1,), cand (offsets[n_blocks],), pair_ray (n_pairs,) with
// n_pairs <= pair_block * n_blocks, rayf (11, n_rays), table (n_clusters,
// 512, 32) bf16 split columns, 16-byte aligned; outputs t/slot (n_pairs,),
// visits (n_blocks,). Returns cudaGetLastError() after the launch.
extern "C" int pair_hit_launch(const void* offsets, const void* cand,
                               const void* pair_ray, const void* rayf,
                               const void* table, void* t_out, void* slot_out,
                               void* visits_out, int n_blocks, int pair_block,
                               int n_pairs, int n_clusters, int n_rays,
                               void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      pair_hit_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      mma_visit::kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int warps = (pair_block + mma_visit::kWarpRays - 1) /
                    mma_visit::kWarpRays;
  pair_hit_kernel<<<n_blocks, 32 * warps, mma_visit::kSmemBytes,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(offsets), static_cast<const int*>(cand),
      static_cast<const int*>(pair_ray), static_cast<const float*>(rayf),
      static_cast<const unsigned char*>(table), static_cast<float*>(t_out),
      static_cast<int*>(slot_out), static_cast<int*>(visits_out), pair_block,
      n_pairs, n_clusters, n_rays);
  return static_cast<int>(cudaGetLastError());
}
