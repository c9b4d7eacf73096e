// The cluster query's per-ray line cull for Hopper (sm_90a), bound through
// a plain C interface (ops/intersect_cluster.py loads it with ctypes).
//
// It replaces no TPU kernel: the reference's cull
// (pathtracer_tpu/ops/intersect_cluster.py:ray_cluster_mask) is jnp glue
// that XLA fuses. The port's plain version (intersect_cluster.py:
// ray_cluster_mask_plain) slab-tests every ray against every cluster box
// with (R, C) f32 tensors on three axes, t_in, t_out, t0, t1 and their
// min/max temporaries, before it reduces them to the (B, C) block mask: at
// a 1024^2 frame and 64 clusters each such tensor is 268 MB, and a call
// streams about 17 GB through device memory.
//
// This kernel gives each 512-ray block (RAY_BLOCK) a CTA and each ray a
// thread. The C inflated cluster boxes (C <= 512, 16 KB) are staged once in
// shared memory; each thread slab-tests its ray against every box, and a
// cluster's bit is OR-ed over the block with one __any_sync per warp into a
// shared flag. Nothing of size (R, C) is ever stored.
//
// What bounds it: f32 issue. It reads 28 bytes a ray and writes C bytes a
// block, about 9 us at 1M rays; the R * C slab tests take 25 f32
// operations each (roofline.py:OPS_PER_SLAB_TEST: six differences and six
// products, six min/max of t0 and t1, four for t_in and t_out, the clamp
// and two compares), 25 us at 1M rays and 64 clusters at the f32 peak, and
// about twice that at the issue rate of instructions that are no FMA.
//
// Exactness. The mask equals the plain version's bit for bit: the inverse
// direction follows _safe_inverse (the 1e-20 floor, then an IEEE 1/d), each
// difference and product is rounded on its own (__fsub_rn, __fmul_rn), so
// the compiler cannot contract them into a fused multiply-add, and min,
// max and the clamp propagate NaN as torch.minimum, torch.maximum and
// torch.clamp do (PTX min.NaN / max.NaN). Only comparisons of these values
// reach the mask, so the sign of a zero result does not matter.

#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 512;  // intersect_cluster.py:RAY_BLOCK
constexpr int kMaxClusters = 512;  // intersect_cluster.py:RAY_CULL_MAX_C

__device__ __forceinline__ float nan_min(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ float nan_max(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__global__ void __launch_bounds__(kBlock)
cluster_cull_kernel(const float* __restrict__ o, const float* __restrict__ d,
                    const float* __restrict__ t_max,
                    const float* __restrict__ box_lo,
                    const float* __restrict__ box_hi,
                    unsigned char* __restrict__ mask, int n_clusters,
                    float t_min) {
  __shared__ float4 s_lo[kMaxClusters];
  __shared__ float4 s_hi[kMaxClusters];
  __shared__ int s_any[kMaxClusters];
  for (int c = threadIdx.x; c < n_clusters; c += kBlock) {
    s_lo[c] = make_float4(box_lo[3 * c], box_lo[3 * c + 1],
                          box_lo[3 * c + 2], 0.0f);
    s_hi[c] = make_float4(box_hi[3 * c], box_hi[3 * c + 1],
                          box_hi[3 * c + 2], 0.0f);
    s_any[c] = 0;
  }
  __syncthreads();

  const long long r =
      static_cast<long long>(blockIdx.x) * kBlock + threadIdx.x;
  const float tiny = 1e-20f;
  float oo[3], inv[3];
  for (int i = 0; i < 3; ++i) {
    oo[i] = o[3 * r + i];
    const float dv = d[3 * r + i];
    const float dd = fabsf(dv) < tiny ? (dv < 0.0f ? -tiny : tiny) : dv;
    inv[i] = __fdiv_rn(1.0f, dd);
  }
  const float tm = t_max[r];
  const bool lane0 = (threadIdx.x & 31) == 0;

#pragma unroll 4
  for (int c = 0; c < n_clusters; ++c) {
    const float4 lo = s_lo[c], hi = s_hi[c];
    const float l[3] = {lo.x, lo.y, lo.z}, h[3] = {hi.x, hi.y, hi.z};
    // The plain version starts t_in at -inf and t_out at +inf; the max of
    // -inf and the first axis' value is that value (NaN included), so the
    // first axis starts them here.
    float t_in = 0.0f, t_out = 0.0f;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const float t0 = __fmul_rn(__fsub_rn(l[i], oo[i]), inv[i]);
      const float t1 = __fmul_rn(__fsub_rn(h[i], oo[i]), inv[i]);
      const float t_near = nan_min(t0, t1), t_far = nan_max(t0, t1);
      t_in = i == 0 ? t_near : nan_max(t_in, t_near);
      t_out = i == 0 ? t_far : nan_min(t_out, t_far);
    }
    const bool crossed = t_out >= nan_max(t_in, t_min) && t_in <= tm;
    if (__any_sync(0xffffffffu, crossed) && lane0) s_any[c] = 1;
  }
  __syncthreads();
  unsigned char* row = mask + static_cast<long long>(blockIdx.x) * n_clusters;
  for (int c = threadIdx.x; c < n_clusters; c += kBlock) {
    row[c] = static_cast<unsigned char>(s_any[c]);
  }
}

}  // namespace

// Launches one 512-thread block per 512-ray block on `stream`; allocates
// nothing. Shapes: o, d (n_blocks * 512, 3) f32, t_max (n_blocks * 512,)
// f32, box_lo and box_hi (n_clusters, 3) f32, the boxes already inflated
// (intersect_cluster.py:_inflate); mask (n_blocks, n_clusters) bytes of 0
// or 1 (a torch.bool tensor). Refuses n_clusters outside [1, 512] and a
// negative n_blocks. Returns cudaGetLastError() after the launch.
extern "C" int cluster_cull_launch(const void* o, const void* d,
                                   const void* t_max, const void* box_lo,
                                   const void* box_hi, void* mask,
                                   int n_blocks, int n_clusters, float t_min,
                                   void* stream) {
  if (n_clusters < 1 || n_clusters > kMaxClusters || n_blocks < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_blocks == 0) return static_cast<int>(cudaSuccess);
  cluster_cull_kernel<<<n_blocks, kBlock, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(o), static_cast<const float*>(d),
      static_cast<const float*>(t_max), static_cast<const float*>(box_lo),
      static_cast<const float*>(box_hi), static_cast<unsigned char*>(mask),
      n_clusters, t_min);
  return static_cast<int>(cudaGetLastError());
}
