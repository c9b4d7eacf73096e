// BVH closest-hit kernel for Hopper (sm_90a), bound through a plain C
// interface (ops/traverse_bvh.py loads it with ctypes).
//
// Replaces pathtracer_tpu/ops/traverse_pallas.py:_traverse_kernel (launched
// by _traverse_impl). Both compute what accel/traverse.py computes: per ray
// the closest Moller-Trumbore t over the triangles of the leaves its
// skip-link walk reaches, and that triangle's index (-1 on a miss), with the
// same visit order and the same strict-less tie-break. The TPU kernel walks
// a 512-ray block with one shared cursor and fetches each node and triangle
// as a 128-aligned block reduced by a one-hot lane select, because Mosaic
// cannot gather per lane. Here each thread walks its own ray with its own
// cursor, reading a node as two 16-byte __ldg loads and a triangle as three,
// from tables packed once per scene (ops/traverse_bvh.py:pack_tables).
// Products, sums and divisions round one at a time (__fmul_rn, __fadd_rn,
// __fsub_rn, __fdiv_rn; no FMA contraction) in the plain version's order,
// so kernel and plain version (bvh_hit_plain) agree bit for bit.
//
// What bounds it: dependent loads. Every step of a walk waits for its node
// (32 bytes) before it knows the next one, and rays of a warp diverge onto
// different nodes, so the kernel runs at memory latency: from L1/L2 for the
// Cornell scenes (4,095 nodes and 5,132 triangles: 377 KB of tables), from
// HBM for big_mesh (about 128 MB of tables, above the 50 MB L2). The design
// keeps each step to one round trip (both node words in one 32-byte sector)
// and keeps enough warps resident (256 threads, no shared memory beyond one
// counter) to hide part of it. No ray sorting, packets or wide BVH yet.

#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 256;       // rays per CTA (ops/traverse_bvh.py)
constexpr float kTMin = 1e-4f;    // constants.T_MIN
constexpr float kTFar = 1e8f;     // constants.T_FAR
constexpr float kDetEps = 1e-9f;  // constants.DET_EPS
constexpr float kTiny = 1e-20f;   // sign-preserving clamp of d

__device__ __forceinline__ float safe_inverse(float x) {
  const float dd = fabsf(x) < kTiny ? (x < 0.0f ? -kTiny : kTiny) : x;
  return __fdiv_rn(1.0f, dd);
}

// a0*b0 + a1*b1 + a2*b2, left to right, each step rounded.
__device__ __forceinline__ float dot3(float a0, float a1, float a2, float b0,
                                      float b1, float b2) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a0, b0), __fmul_rn(a1, b1)),
                   __fmul_rn(a2, b2));
}

// a*b - c*e, each step rounded.
__device__ __forceinline__ float cross_term(float a, float b, float c,
                                            float e) {
  return __fsub_rn(__fmul_rn(a, b), __fmul_rn(c, e));
}

__global__ void __launch_bounds__(kBlock)
bvh_hit_kernel(const float4* __restrict__ nodes,
               const float4* __restrict__ tris,
               const float* __restrict__ o, const float* __restrict__ d,
               float* __restrict__ t_out, int* __restrict__ tri_out,
               int* __restrict__ visits_out, int n_nodes, int n_tris,
               int n_rays, int max_leaf) {
  __shared__ int block_visits;
  const int tid = threadIdx.x;
  const long long ray = static_cast<long long>(blockIdx.x) * kBlock + tid;
  if (tid == 0) block_visits = 0;
  __syncthreads();

  int visits = 0;
  if (ray < n_rays) {
    const float o0 = o[3 * ray], o1 = o[3 * ray + 1], o2 = o[3 * ray + 2];
    const float d0 = d[3 * ray], d1 = d[3 * ray + 1], d2 = d[3 * ray + 2];
    const float i0 = safe_inverse(d0), i1 = safe_inverse(d1),
                i2 = safe_inverse(d2);
    float t_best = kTFar;
    int best = -1;
    int cursor = 0;
    while (cursor < n_nodes) {
      // [lo.x lo.y lo.z skip] [hi.x hi.y hi.z first*8+count]
      const float4 a = __ldg(nodes + 2LL * cursor);
      const float4 b = __ldg(nodes + 2LL * cursor + 1);
      ++visits;
      const float t0x = __fmul_rn(__fsub_rn(a.x, o0), i0);
      const float t0y = __fmul_rn(__fsub_rn(a.y, o1), i1);
      const float t0z = __fmul_rn(__fsub_rn(a.z, o2), i2);
      const float t1x = __fmul_rn(__fsub_rn(b.x, o0), i0);
      const float t1y = __fmul_rn(__fsub_rn(b.y, o1), i1);
      const float t1z = __fmul_rn(__fsub_rn(b.z, o2), i2);
      const float tnear =
          fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)), fminf(t0z, t1z));
      const float tfar =
          fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)), fmaxf(t0z, t1z));
      // Slab test, culled against the current best hit.
      const bool hit_box = tfar >= fmaxf(tnear, kTMin) && tnear < t_best;
      const int leaf = __float_as_int(b.w);
      const int count = leaf & 7;
      if (hit_box && count > 0) {
        const int first = leaf >> 3;
        const int n_test = min(count, max_leaf);
        for (int k = 0; k < n_test; ++k) {
          const int idx = min(first + k, n_tris - 1);
          // [v0.x v0.y v0.z e1.x] [e1.y e1.z e2.x e2.y] [e2.z 0 0 0]
          const float4 p = __ldg(tris + 3LL * idx);
          const float4 q = __ldg(tris + 3LL * idx + 1);
          const float4 r = __ldg(tris + 3LL * idx + 2);
          const float e1x = p.w, e1y = q.x, e1z = q.y;
          const float e2x = q.z, e2y = q.w, e2z = r.x;
          const float pv0 = cross_term(d1, e2z, d2, e2y);  // d x e2
          const float pv1 = cross_term(d2, e2x, d0, e2z);
          const float pv2 = cross_term(d0, e2y, d1, e2x);
          const float det = dot3(e1x, e1y, e1z, pv0, pv1, pv2);
          const bool big = fabsf(det) > kDetEps;
          const float inv = big ? __fdiv_rn(1.0f, det) : 0.0f;
          const float tv0 = __fsub_rn(o0, p.x);
          const float tv1 = __fsub_rn(o1, p.y);
          const float tv2 = __fsub_rn(o2, p.z);
          const float uu = __fmul_rn(dot3(tv0, tv1, tv2, pv0, pv1, pv2), inv);
          const float qv0 = cross_term(tv1, e1z, tv2, e1y);  // tvec x e1
          const float qv1 = cross_term(tv2, e1x, tv0, e1z);
          const float qv2 = cross_term(tv0, e1y, tv1, e1x);
          const float vv = __fmul_rn(dot3(d0, d1, d2, qv0, qv1, qv2), inv);
          const float t = __fmul_rn(dot3(e2x, e2y, e2z, qv0, qv1, qv2), inv);
          const bool ok = big && uu >= 0.0f && vv >= 0.0f &&
                          __fadd_rn(uu, vv) <= 1.0f && t > kTMin && t < kTFar;
          if (ok && t < t_best) {  // strict: ties keep the earlier hit
            t_best = t;
            best = idx;
          }
        }
      }
      cursor = (hit_box && count == 0) ? cursor + 1 : __float_as_int(a.w);
    }
    t_out[ray] = t_best;
    tri_out[ray] = best;
  }
  const int warp_visits = __reduce_add_sync(0xffffffffu, visits);
  if ((tid & 31) == 0) atomicAdd(&block_visits, warp_visits);
  __syncthreads();
  if (tid == 0) visits_out[blockIdx.x] = block_visits;
}

}  // namespace

// Launches ceil(n_rays / 256) CTAs of 256 threads on `stream`; allocates
// nothing. Shapes: nodes (n_nodes, 8) and tris (n_tris, 12) f32, 16-byte
// aligned, as ops/traverse_bvh.py:pack_tables lays them out (every skip link
// points forward, so each walk ends); o/d (n_rays, 3) f32; outputs t/tri
// (n_rays,), visits (ceil(n_rays / 256),). Returns cudaGetLastError() after
// the launch.
extern "C" int bvh_hit_launch(const void* nodes, const void* tris,
                              const void* o, const void* d, void* t_out,
                              void* tri_out, void* visits_out, int n_nodes,
                              int n_tris, int n_rays, int max_leaf,
                              void* stream) {
  const int n_blocks = (n_rays + kBlock - 1) / kBlock;
  bvh_hit_kernel<<<n_blocks, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(nodes), static_cast<const float4*>(tris),
      static_cast<const float*>(o), static_cast<const float*>(d),
      static_cast<float*>(t_out), static_cast<int*>(tri_out),
      static_cast<int*>(visits_out), n_nodes, n_tris, n_rays, max_leaf);
  return static_cast<int>(cudaGetLastError());
}
