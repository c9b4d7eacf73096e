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
// Design. As the TPU kernel, each visit is the bf16 hi/lo split product of
// the cluster's table block and the block's rays, the table streamed from
// device memory: one CTA of 8 warps per 512-ray block, each warp 64 rays on
// the tensor cores, each candidate's 32 KB block bulk-copied into a
// two-stage shared-memory ring one candidate ahead of the visit
// (visit_mma.cuh). Before each visit the CTA votes: once no ray's
// best t lies beyond the candidate's entry bound, no later candidate can
// improve any ray, and the walk stops (the prefetch it abandons is waited
// out). The kernel and its plain version (stream_hit_plain on the split
// table) differ only in the summation order inside an mma k-step.
//
// What bounds it: per (ray, triangle) 4 x 30 x 2 = 240 bf16 tensor-core
// operations and a 6-operation f32 epilogue, against 32 KB staged per
// visit for 65,536 pairs (about 480 operations per byte, so arithmetic,
// even with the table far above the 50 MB L2); the early exit bounds the
// visits. The epilogue runs on the CUDA cores beside the mma issue.

#include <cuda_runtime.h>

#include "visit_mma.cuh"

namespace {

constexpr int kRayBlock = 512;  // rays per CTA = cull block
constexpr int kThreads = kRayBlock / mma_visit::kWarpRays * 32;  // 256

__global__ void __launch_bounds__(kThreads, 2)
stream_hit_kernel(const int* __restrict__ cand,
                  const int* __restrict__ count,
                  const float* __restrict__ tnear,
                  const float* __restrict__ rayf,
                  const float* __restrict__ t_in,
                  const int* __restrict__ slot_in,
                  const unsigned char* __restrict__ table,
                  float* __restrict__ t_out,
                  int* __restrict__ slot_out,
                  int* __restrict__ visits_out,
                  int n_cand_max, int n_clusters, int n_rays) {
  extern __shared__ __align__(128) unsigned char smem[];
  using namespace mma_visit;

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid % 32, g = lane / 4, t = lane % 4;
  const long long warp_ray =
      static_cast<long long>(b) * kRayBlock + (tid / 32) * kWarpRays;
  const auto ray_of = [&](int m, int h) {
    return warp_ray + 16 * m + g + 8 * h;
  };

  float t_best[kTilesM][2];
  int best[kTilesM][2];
#pragma unroll
  for (int m = 0; m < kTilesM; ++m) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      t_best[m][h] = t_in[ray_of(m, h)];
      best[m][h] = slot_in[ray_of(m, h)];
    }
  }
  const int n_cand = min(count[b], n_cand_max);  // the same for the block
  const int* cand_b = cand + static_cast<long long>(b) * n_cand_max;
  const float* tnear_b = tnear + static_cast<long long>(b) * n_cand_max;
  const auto cid_of = [&](int k) {
    return min(max(cand_b[k], 0), n_clusters - 1);
  };
  int k = 0;
  if (n_cand > 0) {
    const Ring ring(smem);
    ring.init();
    if (tid == 0) ring.issue(table, cid_of(0), 0);
    Rays r;
    load_rays(r, [&](int m, int h, int i) {
      return rayf[static_cast<long long>(i) * n_rays + ray_of(m, h)];
    }, t);
    for (; k < n_cand; ++k) {
      bool done = true;
#pragma unroll
      for (int m = 0; m < kTilesM; ++m) {
        done = done && t_best[m][0] <= tnear_b[k] &&
               t_best[m][1] <= tnear_b[k];
      }
      // The vote is also the barrier that keeps the previous visit's
      // readers ahead of the copy into their stage.
      if (__syncthreads_and(done)) break;
      if (tid == 0 && k + 1 < n_cand) ring.issue(table, cid_of(k + 1), k + 1);
      visit_cluster(ring.wait(k), r, kTilesM, cid_of(k), t_best, best, g, t);
    }
    if (k < n_cand) ring.wait(k);  // the prefetch the early exit abandoned
  }
  if (t == 0) {  // a quad's lanes hold the same rows' results
#pragma unroll
    for (int m = 0; m < kTilesM; ++m) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        t_out[ray_of(m, h)] = t_best[m][h];
        slot_out[ray_of(m, h)] = best[m][h];
      }
    }
  }
  if (tid == 0) visits_out[b] = k;
}

}  // namespace

// Launches one CTA of 256 threads per ray block on `stream`; allocates
// nothing. Shapes: cand/tnear (n_blocks, n_cand_max), count (n_blocks,),
// rayf (11, n_rays) with n_rays = 512 * n_blocks, t_in/slot_in (n_rays,),
// table (n_clusters, 512, 32) bf16 split columns, 16-byte aligned; outputs
// t/slot (n_rays,), visits (n_blocks,). Returns cudaGetLastError() after
// the launch.
extern "C" int stream_hit_launch(const void* cand, const void* count,
                                 const void* tnear, const void* rayf,
                                 const void* t_in, const void* slot_in,
                                 const void* table, void* t_out,
                                 void* slot_out, void* visits_out,
                                 int n_blocks, int n_cand_max,
                                 int n_clusters, int n_rays, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      stream_hit_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      mma_visit::kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  stream_hit_kernel<<<n_blocks, kThreads, mma_visit::kSmemBytes,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(cand), static_cast<const int*>(count),
      static_cast<const float*>(tnear), static_cast<const float*>(rayf),
      static_cast<const float*>(t_in), static_cast<const int*>(slot_in),
      static_cast<const unsigned char*>(table), static_cast<float*>(t_out),
      static_cast<int*>(slot_out), static_cast<int*>(visits_out),
      n_cand_max, n_clusters, n_rays);
  return static_cast<int>(cudaGetLastError());
}
