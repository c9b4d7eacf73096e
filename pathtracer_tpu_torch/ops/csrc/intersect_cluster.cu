// Cluster closest-hit kernel for Hopper (sm_90a), bound through a plain C
// interface (ops/intersect_cluster.py loads it with ctypes).
//
// Replaces pathtracer_tpu/ops/intersect_cluster.py:_make_cluster_kernel
// (the Pallas kernel _cluster_kernel). It computes what that kernel
// computes, not block for block: one CTA walks the near-first candidate
// clusters of one 512-ray block, one thread per ray, with the ordered early
// exit; each visit tests all 128 triangles of a cluster.
//
// Per (ray, triangle) the feature algebra of accel/clusters.py gives det,
// u*det, v*det and t*det as dot products of the ray's 10 feature rows with
// the triangle's 4 feature columns, then the sign-canonical multiply-form
// Moller-Trumbore predicate and a strict-less min update (ties keep the
// lower row and the earlier visit). The TPU kernel's bf16 hi/lo matmul and
// its 127-ulp encoded min were there to fit the MXU; this kernel takes the
// exact f32 min. Products and sums are rounded one at a time
// (__fmul_rn/__fadd_rn, no FMA contraction) in the order of the plain
// PyTorch version, cluster_hit_plain, so the two agree bit for bit: that is
// what lets a check demand equal hit masks for shadow rays whose hit lies
// within an ulp of their t_max.
//
// What bounds it: per ray and triangle, 40 multiplies + 36 adds + ~12
// predicate ops in f32 on the CUDA cores, fed by 40 shared-memory floats.
// The design stages one cluster's 128 x 4 x 10 coefficients (20 KB f32) in
// shared memory per visit with coalesced 2 KB row loads, transposed so
// that each triangle's 40 coefficients are contiguous: every thread then
// reads them as 10 broadcast 16-byte loads, so shared-memory issue stays
// below the arithmetic. No tensor cores, TMA or pipelining yet.

#include <cuda_runtime.h>

namespace {

constexpr int kRayBlock = 512;      // rays per CTA = cull block
constexpr int kClusterTris = 128;   // triangle slots per cluster
constexpr int kClusterCols = 512;   // feature columns per cluster (4 x 128)
constexpr int kFeatUsed = 10;       // feature rows that pair with the table
constexpr int kTriStride = 40;      // staged floats per triangle (4 x 10)
constexpr float kDetEps = 1e-9f;    // constants.DET_EPS
constexpr float kTMin = 1e-4f;      // constants.T_MIN
constexpr float kDenomFloor = 1e-30f;

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
  __shared__ __align__(16) float tri[kClusterTris * kTriStride];

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const long long ray = static_cast<long long>(b) * kRayBlock + tid;

  float r[kFeatUsed];
#pragma unroll
  for (int i = 0; i < kFeatUsed; ++i) {
    r[i] = rayf[static_cast<long long>(i) * n_rays + ray];
  }
  // Row 10: t_max clipped to the scene-box exit; hits must be nearer.
  float t_best = rayf[static_cast<long long>(kFeatUsed) * n_rays + ray];
  int best = -1;

  const long long feat_row = static_cast<long long>(n_clusters) * kClusterCols;
  const long long cand_row = static_cast<long long>(b) * n_cand_max;
  const int n_cand = min(count[b], n_cand_max);
  // This thread stages feature column tid = q * 128 + j of each visit.
  const int q_col = tid / kClusterTris;
  const int j_col = tid % kClusterTris;
  float* stage = tri + j_col * kTriStride + q_col * kFeatUsed;

  int k = 0;
  for (; k < n_cand; ++k) {
    // Ordered early exit: candidates are sorted by a lower bound of their
    // entry distance, so once no ray's best hit lies beyond it, no later
    // cluster can improve any ray. The vote is also the barrier that keeps
    // the previous visit's readers ahead of the next stage.
    if (__syncthreads_and(t_best <= tnear[cand_row + k])) break;
    const int cid = min(max(cand[cand_row + k], 0), n_clusters - 1);
    const float* src = feat + static_cast<long long>(cid) * kClusterCols + tid;
#pragma unroll
    for (int i = 0; i < kFeatUsed; ++i) stage[i] = src[i * feat_row];
    __syncthreads();

    for (int j = 0; j < kClusterTris; ++j) {
      const float4* c4 = reinterpret_cast<const float4*>(tri + j * kTriStride);
      float v[kTriStride];
#pragma unroll
      for (int m = 0; m < kTriStride / 4; ++m) {
        const float4 x = c4[m];
        v[4 * m + 0] = x.x;
        v[4 * m + 1] = x.y;
        v[4 * m + 2] = x.z;
        v[4 * m + 3] = x.w;
      }
      float q[4];
#pragma unroll
      for (int qq = 0; qq < 4; ++qq) {
        float acc = __fmul_rn(r[0], v[qq * kFeatUsed]);
#pragma unroll
        for (int i = 1; i < kFeatUsed; ++i) {
          acc = __fadd_rn(acc, __fmul_rn(r[i], v[qq * kFeatUsed + i]));
        }
        q[qq] = acc;
      }
      // Sign-canonical form: fold sign(det) into the numerators and
      // compare against |det|.
      const float s = q[0] < 0.0f ? -1.0f : 1.0f;
      const float adet = __fmul_rn(q[0], s);
      const float un = __fmul_rn(q[1], s);
      const float vn = __fmul_rn(q[2], s);
      const float tn = __fmul_rn(q[3], s);
      const bool valid = adet > kDetEps && un >= 0.0f && vn >= 0.0f &&
                         __fadd_rn(un, vn) <= adet &&
                         tn > __fmul_rn(adet, kTMin);
      if (valid) {
        const float tc = __fdiv_rn(tn, fmaxf(adet, kDenomFloor));
        if (tc < t_best) {
          t_best = tc;
          best = cid * kClusterTris + j;
        }
      }
    }
  }
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
