// BVH closest-hit kernel for Hopper (sm_90a), bound through a plain C
// interface (ops/traverse_bvh.py loads it with ctypes).
//
// Replaces pathtracer_tpu/ops/traverse_pallas.py:_traverse_kernel (launched
// by _traverse_impl). Both compute what accel/traverse.py computes: per ray
// the closest Moller-Trumbore t over the triangles of the leaves it
// reaches, and that triangle's index (-1 and T_FAR on a miss). Every
// triangle of a leaf is tested, as many as its word's count (at most 7);
// the TPU kernel tests at most max_leaf (4) of them. The TPU kernel walks
// the skip links with one cursor shared by a 512-ray block and fetches each
// node and triangle as a 128-aligned block reduced by a one-hot lane
// select, because Mosaic cannot gather per lane. Here each thread walks
// its own ray over the child-pair table (ops/traverse_bvh.py:pack_tables),
// near child first.
// Products, sums and divisions round one at a time (__fmul_rn, __fadd_rn,
// __fsub_rn, __fdiv_rn; no FMA contraction) in the plain versions' order,
// so t equals the skip-link walk's wherever the same triangle wins, and the
// kernel equals its plain mirror (bvh_hit_ordered_plain) bit for bit.
//
// What bounds it: dependent loads. A walk cannot name its next node before
// the current one has arrived, and the rays of a warp diverge onto
// different nodes, so the kernel runs at memory latency: from L1/L2 on the
// Cornell scenes (4,095 nodes), from HBM on big_mesh (627k pair entries
// and 2M triangles: 136 MB, above the 50 MB L2). What the design does
// about it:
//   - one 64-byte entry tests both children of a node (four 16-byte loads
//     issued together, two sectors of one line): one round trip per level
//     instead of one per node;
//   - near child first, the far one pushed with its entry distance on a
//     per-thread stack (local memory, STACK_DEPTH entries, the tree's depth
//     checked when the table is packed and here) and dropped on pop once
//     the best t is nearer: the best t falls early and culls more of the
//     tree than the skip-link order (left child always first) could;
//   - 256 threads per CTA and no shared memory beyond two counters, so
//     many warps stay resident to hide the rest of the latency;
//   - a while-while loop, interior steps then leaf steps, which keeps the
//     warp's rays on one kind of step at a time (it measured faster than
//     one loop that takes either step per iteration, with the same visits).
// No ray reordering or wide (4- or 8-child) nodes.

#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 256;       // rays per CTA (ops/traverse_bvh.py)
constexpr int kStack = 64;        // ops/traverse_bvh.py:STACK_DEPTH
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

struct Ray {
  float o0, o1, o2, d0, d1, d2, i0, i1, i2;
};

// The slab test of the box [lo.xyz, hi.xyz], culled against the best hit;
// its entry distance in tnear.
__device__ __forceinline__ bool box_hit(const Ray& r, float4 lo, float4 hi,
                                        float t_best, float& tnear) {
  const float t0x = __fmul_rn(__fsub_rn(lo.x, r.o0), r.i0);
  const float t0y = __fmul_rn(__fsub_rn(lo.y, r.o1), r.i1);
  const float t0z = __fmul_rn(__fsub_rn(lo.z, r.o2), r.i2);
  const float t1x = __fmul_rn(__fsub_rn(hi.x, r.o0), r.i0);
  const float t1y = __fmul_rn(__fsub_rn(hi.y, r.o1), r.i1);
  const float t1z = __fmul_rn(__fsub_rn(hi.z, r.o2), r.i2);
  tnear = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)), fminf(t0z, t1z));
  const float tfar =
      fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)), fmaxf(t0z, t1z));
  return tfar >= fmaxf(tnear, kTMin) && tnear < t_best;
}

// Moller-Trumbore against triangle idx; a strictly nearer hit replaces the
// best (ties keep the earlier triangle).
__device__ __forceinline__ void tri_test(const Ray& r,
                                         const float4* __restrict__ tris,
                                         int idx, float& t_best, int& best) {
  // [v0.x v0.y v0.z e1.x] [e1.y e1.z e2.x e2.y] [e2.z 0 0 0]
  const float4 p = __ldg(tris + 3LL * idx);
  const float4 q = __ldg(tris + 3LL * idx + 1);
  const float4 s = __ldg(tris + 3LL * idx + 2);
  const float e1x = p.w, e1y = q.x, e1z = q.y;
  const float e2x = q.z, e2y = q.w, e2z = s.x;
  const float pv0 = cross_term(r.d1, e2z, r.d2, e2y);  // d x e2
  const float pv1 = cross_term(r.d2, e2x, r.d0, e2z);
  const float pv2 = cross_term(r.d0, e2y, r.d1, e2x);
  const float det = dot3(e1x, e1y, e1z, pv0, pv1, pv2);
  const bool big = fabsf(det) > kDetEps;
  const float inv = big ? __fdiv_rn(1.0f, det) : 0.0f;
  const float tv0 = __fsub_rn(r.o0, p.x);
  const float tv1 = __fsub_rn(r.o1, p.y);
  const float tv2 = __fsub_rn(r.o2, p.z);
  const float uu = __fmul_rn(dot3(tv0, tv1, tv2, pv0, pv1, pv2), inv);
  const float qv0 = cross_term(tv1, e1z, tv2, e1y);  // tvec x e1
  const float qv1 = cross_term(tv2, e1x, tv0, e1z);
  const float qv2 = cross_term(tv0, e1y, tv1, e1x);
  const float vv = __fmul_rn(dot3(r.d0, r.d1, r.d2, qv0, qv1, qv2), inv);
  const float t = __fmul_rn(dot3(e2x, e2y, e2z, qv0, qv1, qv2), inv);
  const bool ok = big && uu >= 0.0f && vv >= 0.0f &&
                  __fadd_rn(uu, vv) <= 1.0f && t > kTMin && t < kTFar;
  if (ok && t < t_best) {
    t_best = t;
    best = idx;
  }
}

// Pops the stack until an entry nearer than the best hit, which becomes
// word; false once the stack is empty (the walk has ended).
__device__ __forceinline__ bool pop(const int2 (&stack)[kStack], int& sp,
                                    float t_best, int& word) {
  while (sp > 0) {
    const int2 top = stack[--sp];
    if (__int_as_float(top.y) < t_best) {
      word = top.x;
      return true;
    }
  }
  return false;
}

__global__ void __launch_bounds__(kBlock)
bvh_hit_kernel(const float4* __restrict__ pairs,
               const float4* __restrict__ tris, const float* __restrict__ o,
               const float* __restrict__ d, float* __restrict__ t_out,
               int* __restrict__ tri_out, int* __restrict__ visits_out,
               int* __restrict__ tests_out, int n_tris, int n_rays) {
  __shared__ int block_visits, block_tests;
  const int tid = threadIdx.x;
  const long long ray = static_cast<long long>(blockIdx.x) * kBlock + tid;
  if (tid == 0) block_visits = block_tests = 0;
  __syncthreads();

  int visits = 0, tests = 0;
  if (ray < n_rays) {
    Ray r;
    r.o0 = o[3 * ray], r.o1 = o[3 * ray + 1], r.o2 = o[3 * ray + 2];
    r.d0 = d[3 * ray], r.d1 = d[3 * ray + 1], r.d2 = d[3 * ray + 2];
    r.i0 = safe_inverse(r.d0), r.i1 = safe_inverse(r.d1),
    r.i2 = safe_inverse(r.d2);
    float t_best = kTFar;
    int best = -1;
    int2 stack[kStack];  // {child word, its tnear's bits}
    int sp = 0;
    // A child word: entry * 8 (an interior node; entry 0 is the
    // pseudo-entry holding the root) or first * 8 + count (a leaf).
    int word = 0;
    // While-while (Aila & Laine 2009): a warp walks interior entries until
    // each of its rays holds a leaf (or has ended), then tests the leaves
    // together, so that the two kinds of step do not alternate inside it.
    bool done = false;
    while (!done) {
      while ((word & 7) == 0) {
        // [L.lo L.word] [L.hi depth-or-0] [R.lo R.word] [R.hi 0]
        const float4* e = pairs + 4LL * (word >> 3);
        const float4 l_lo = __ldg(e), l_hi = __ldg(e + 1);
        const float4 r_lo = __ldg(e + 2), r_hi = __ldg(e + 3);
        ++visits;
        if (word == 0 && __float_as_int(l_hi.w) > kStack) __trap();
        float tn_l, tn_r;
        const bool hit_l = box_hit(r, l_lo, l_hi, t_best, tn_l);
        const bool hit_r = box_hit(r, r_lo, r_hi, t_best, tn_r);
        const int w_l = __float_as_int(l_lo.w), w_r = __float_as_int(r_lo.w);
        if (hit_l && hit_r) {
          const bool right_first = tn_r < tn_l;  // ties: the left child
          stack[sp++] = right_first ? make_int2(w_l, __float_as_int(tn_l))
                                    : make_int2(w_r, __float_as_int(tn_r));
          word = right_first ? w_r : w_l;
        } else if (hit_l || hit_r) {
          word = hit_l ? w_l : w_r;
        } else if (!pop(stack, sp, t_best, word)) {
          done = true;
          break;
        }
      }
      if (done) break;
      const int first = word >> 3;
      const int n_test = word & 7;
      for (int k = 0; k < n_test; ++k) {
        tri_test(r, tris, min(first + k, n_tris - 1), t_best, best);
      }
      tests += n_test;
      done = !pop(stack, sp, t_best, word);
    }
    t_out[ray] = t_best;
    tri_out[ray] = best;
  }
  const int warp_visits = __reduce_add_sync(0xffffffffu, visits);
  const int warp_tests = __reduce_add_sync(0xffffffffu, tests);
  if ((tid & 31) == 0) {
    atomicAdd(&block_visits, warp_visits);
    atomicAdd(&block_tests, warp_tests);
  }
  __syncthreads();
  if (tid == 0) {
    visits_out[blockIdx.x] = block_visits;
    tests_out[blockIdx.x] = block_tests;
  }
}

}  // namespace

// Launches ceil(n_rays / 256) CTAs of 256 threads on `stream`; allocates
// nothing. Shapes: pairs (n_entries, 16) f32, 64-byte aligned, and tris
// (n_tris, 12) f32, 16-byte aligned, as ops/traverse_bvh.py:pack_tables
// lays them out (a binary tree at most kStack levels deep); o/d (n_rays, 3)
// f32; outputs t/tri (n_rays,), visits and tests (ceil(n_rays / 256),).
// Returns cudaGetLastError() after the launch.
extern "C" int bvh_hit_launch(const void* pairs, const void* tris,
                              const void* o, const void* d, void* t_out,
                              void* tri_out, void* visits_out,
                              void* tests_out, int n_tris, int n_rays,
                              void* stream) {
  const int n_blocks = (n_rays + kBlock - 1) / kBlock;
  bvh_hit_kernel<<<n_blocks, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(pairs), static_cast<const float4*>(tris),
      static_cast<const float*>(o), static_cast<const float*>(d),
      static_cast<float*>(t_out), static_cast<int*>(tri_out),
      static_cast<int*>(visits_out), static_cast<int*>(tests_out), n_tris,
      n_rays);
  return static_cast<int>(cudaGetLastError());
}
