// The cluster kernel's visit (intersect_cluster.cu): stage a cluster's f32
// feature columns in shared memory, then test its 128 triangles against one
// ray; and the ordered walk of a block's near-first candidate list. Its
// constants and per-triangle predicate are also those of the stream and
// pair kernels' tensor-core visit (visit_mma.cuh).
//
// Per (ray, triangle) the feature algebra of accel/clusters.py gives det,
// u*det, v*det and t*det as dot products of the ray's 10 feature rows with
// the triangle's 4 feature columns, then the sign-canonical multiply-form
// Moller-Trumbore predicate and a strict-less min update (ties keep the
// lower row and the earlier visit). Products and sums are rounded one at a
// time (__fmul_rn/__fadd_rn, no FMA contraction) in the order of the plain
// PyTorch version (ops/intersect_cluster.py:visit_plain), and the division
// is IEEE, so kernel and plain version agree bit for bit.

#pragma once

#include <cuda_runtime.h>

namespace visit {

constexpr int kClusterTris = 128;   // triangle slots per cluster
constexpr int kClusterCols = 512;   // feature columns per cluster (4 x 128)
constexpr int kFeatUsed = 10;       // feature rows that pair with the table
constexpr int kTriStride = 40;      // staged floats per triangle (4 x 10)
constexpr float kDetEps = 1e-9f;    // constants.DET_EPS
constexpr float kTMin = 1e-4f;      // constants.T_MIN
constexpr float kDenomFloor = 1e-30f;

// Stages the used rows of cluster `cid` of the row-major (16, C*512) table
// into tri[128 * 40], transposed so that triangle j's 40 coefficients
// (quantity-major, 10 rows each) are contiguous. Thread tid stages columns
// tid, tid + n_threads, ...: each of the 10 row reads is a coalesced run of
// the block's threads. The caller synchronises before and after.
__device__ __forceinline__ void stage_cluster(float* tri,
                                              const float* __restrict__ feat,
                                              long long feat_row, int cid,
                                              int tid, int n_threads) {
  const float* src = feat + static_cast<long long>(cid) * kClusterCols;
  for (int col = tid; col < kClusterCols; col += n_threads) {
    float* dst = tri + (col % kClusterTris) * kTriStride +
                 (col / kClusterTris) * kFeatUsed;
#pragma unroll
    for (int i = 0; i < kFeatUsed; ++i) dst[i] = src[col + i * feat_row];
  }
}

// Tests the 128 staged triangles of cluster `cid` against ray features r;
// a strictly nearer valid hit replaces (t_best, best = cid * 128 + j).
// Each triangle's coefficients are read as 10 broadcast 16-byte loads.
__device__ __forceinline__ void visit_cluster(const float* tri,
                                              const float (&r)[kFeatUsed],
                                              int cid, float& t_best,
                                              int& best) {
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
    // Sign-canonical form: fold sign(det) into the numerators and compare
    // against |det|.
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

// Walks a block's first n_cand candidates (cand/tnear: the block's row,
// sorted by a lower bound of the entry distance) with the ordered early
// exit: once no ray's best hit lies beyond the next entry bound, no later
// cluster can improve any ray. The vote is also the barrier that keeps the
// previous visit's readers ahead of the next stage. Every thread of the
// block calls it with the same n_cand; returns the clusters visited.
__device__ __forceinline__ int walk_ordered(
    float* tri, const int* __restrict__ cand, const float* __restrict__ tnear,
    int n_cand, const float* __restrict__ feat, long long feat_row,
    int n_clusters, const float (&r)[kFeatUsed], float& t_best, int& best,
    int tid, int n_threads) {
  int k = 0;
  for (; k < n_cand; ++k) {
    if (__syncthreads_and(t_best <= tnear[k])) break;
    const int cid = min(max(cand[k], 0), n_clusters - 1);
    stage_cluster(tri, feat, feat_row, cid, tid, n_threads);
    __syncthreads();
    visit_cluster(tri, r, cid, t_best, best);
  }
  return k;
}

}  // namespace visit
