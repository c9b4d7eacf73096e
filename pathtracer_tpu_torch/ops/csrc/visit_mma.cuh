// The tensor-core cluster visit, and the ordered walk built on it, of the
// cluster kernel (intersect_cluster.cu, K1), the stream kernel
// (intersect_stream.cu, K3) and, the visit only, the pair kernel
// (intersect_pair.cu, K2). Each candidate cluster's 32 KB block of the split
// table is bulk-copied into a shared-memory ring, and the visit computes
// det, u*det, v*det and t*det of its 128 triangles against a warp's rays as
// the reference's bf16 hi/lo split product on the tensor cores, then the
// sign-canonical multiply-form Moller-Trumbore test on each lane's own
// products.
//
// The product. accel/clusters.py:split_table stores every column as
// SPLIT_K = 32 bf16, the table side [hi(10); hi(10); lo(10); 0; 0] of the
// used feature rows; a ray's side is [hi(10); lo(10); hi(10); 0; 0]. One
// column's q is then hi*hi + lo*hi + hi*lo summed over the 10 rows (the
// reference's visit_q without its 6 zero rows and the lo*lo term it drops
// too): two k-steps of mma.sync.m16n8k16 bf16 with f32 accumulation. Each
// product of two bf16 is exact; only the tensor cores' summation inside a
// k-step differs from the plain version (ops/intersect_cluster.py:
// visit_split_plain).
//
// The tiling. A warp owns 64 rays as four m16 tiles (the A operand), split
// once per CTA into registers that stay for the whole walk (32 registers).
// The staged cluster is the B operand: for each of the 16 tiles of 8
// triangles the four quantity tiles (columns q*128 + 8*tile + 0..7) are
// multiplied together, so every lane holds all four quantities of its own
// (ray, triangle) pairs (C rows g and g + 8, columns 2t and 2t + 1, with
// g = lane / 4, t = lane % 4) and the predicate, the division and the min
// are lane-local. The next m tile's products are issued before each m
// tile's epilogue, so the tensor cores and the CUDA cores overlap. A lane
// reads its four B registers of a quantity tile as one 16-byte shared load
// (split_table's word order); the 8 columns x 4 lanes of a load phase cover
// 128 consecutive bytes, so the loads are free of bank conflicts.
//
// The tie rule. Within a visit a lane takes strictly nearer hits in
// triangle order, and the quad then takes the lexicographic min of
// (t, row), so equal t keeps the lowest row; across visits a strictly
// nearer hit replaces the best, so equal t keeps the earlier visit: the
// rule of the plain versions.
//
// The staging. One thread issues cp.async.bulk (TMA without a tensor map)
// of each candidate's block into the ring kStages - 1 candidates ahead of
// the visit; completion is counted in bytes by one mbarrier per stage. A
// barrier of the whole CTA before each issue keeps the readers of the
// stage's previous visit ahead of the copy that overwrites it. A walk that
// stops early only abandons its prefetches, and waits for them before the
// CTA exits.
//
// The walk (walk_block). One CTA of 8 warps per 512-ray block walks the
// block's near-first candidate list with the ordered early exit: before
// each visit the CTA votes, and once no ray's best t lies beyond the
// candidate's entry bound no later candidate can improve any ray. The
// candidate list is the union of the block's rays' lines, so many of its
// clusters lie off most of a warp's rays: before a warp multiplies a
// candidate's 16 tiles it slab-tests its 64 rays against the cluster's box,
// inflated as ops/intersect_cluster.py:ray_cluster_mask inflates it, within
// [T_MIN, the ray's best t x (1 + 2^-12)] (lane t tests the rows g and
// g + 8 of m tile t), and skips the visit when no ray crosses it. A
// triangle whose exact hit is nearer than that lies inside the box. The
// slack covers the split product's error in t: where two clusters share an
// edge, the first one's split t may lie a little before the exact hit, and
// so before the second one's box, whose triangle the walk without the skip
// would still test and might take at a split t nearer still. The split's q
// errs by about 2^-17 of its terms' magnitudes, so its t errs by far less
// than 2^-12 unless det or t*det cancel deeply; only such a hit, at such a
// seam, could be skipped. The CTA still stages every candidate, and votes
// on every one.
//
// The ring depth (2) and the occupancy (2 CTAs of 256 threads per SM) are
// the fastest of the depths 2-4 x 1-3 CTAs per SM timed on the bench frame
// (PERF.md, PR 6).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "visit.cuh"

namespace mma_visit {

constexpr int kTris = visit::kClusterTris;      // triangles per cluster
constexpr int kFeat = visit::kFeatUsed;         // feature rows used
constexpr int kColBytes = 64;                   // 32 bf16 per column
constexpr int kClusterBytes = visit::kClusterCols * kColBytes;  // 32 KB
constexpr int kStages = 2;                      // ring depth
constexpr int kTilesM = 4;                      // m16 tiles per warp
constexpr int kWarpRays = 16 * kTilesM;         // 64
constexpr int kTilesN = kTris / 8;              // 16 tiles of 8 triangles
// Dynamic shared memory of a CTA: the ring, then one mbarrier per stage.
constexpr int kSmemBytes = kStages * kClusterBytes + kStages * 8;

// ---- the ring -------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

struct Ring {
  unsigned char* stage;  // kStages x 32 KB, 128-byte aligned
  uint64_t* full;        // one mbarrier per stage

  __device__ explicit Ring(unsigned char* smem)
      : stage(smem),
        full(reinterpret_cast<uint64_t*>(smem + kStages * kClusterBytes)) {}

  // Every thread of the CTA calls it (it synchronises the CTA).
  __device__ void init() const {
    if (threadIdx.x == 0) {
      for (int s = 0; s < kStages; ++s) {
        asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                         smem_addr(full + s))
                     : "memory");
      }
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
  }

  // One thread: copy cluster cid's block of `table` into the stage of the
  // k-th visit.
  __device__ void issue(const unsigned char* table, int cid, int k) const {
    const int s = k % kStages;
    const uint32_t bar = smem_addr(full + s);
    asm volatile(
        "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
        "r"(kClusterBytes)
        : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(stage + s * kClusterBytes)),
        "l"(table + static_cast<long long>(cid) * kClusterBytes),
        "r"(kClusterBytes), "r"(bar)
        : "memory");
  }

  // Waits until the k-th visit's block has landed and returns it.
  __device__ const unsigned char* wait(int k) const {
    const int s = k % kStages;
    const uint32_t bar = smem_addr(full + s);
    const uint32_t parity = (k / kStages) & 1;
    uint32_t done = 0;
    while (!done) {
      asm volatile(
          "{\n"
          ".reg .pred p;\n"
          "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
          "selp.u32 %0, 1, 0, p;\n"
          "}\n"
          : "=r"(done)
          : "r"(bar), "r"(parity)
          : "memory");
    }
    return stage + s * kClusterBytes;
  }
};

// ---- the rays (A operand) -------------------------------------------------

// mma.m16n8k16 fragments (PTX ISA, "Matrix fragments for mma.m16n8k16"):
// A register j of k-step s holds row g + 8 * (j & 1) and the k pair
// 16 s + 2t + 8 (j >> 1); B register j holds column g and the k pair
// 16 s + 2t + 8 j; C holds rows g (c0, c1) and g + 8 (c2, c3), columns 2t
// and 2t + 1. The lower k of a pair is the low half of its register.
struct Rays {
  uint32_t a[kTilesM][2][4];  // [m tile][k-step][register]
};

// The ray side of the split product at k: [hi(10); lo(10); hi(10); 0; 0]
// of the ray's features x(i), as bf16 bits (round to nearest even, as the
// reference's split_bf16).
template <class Feat>
__device__ __forceinline__ uint32_t ray_k(const Feat& x, int k) {
  if (k >= 3 * kFeat) return 0u;
  const float v = x(k % kFeat);
  const __nv_bfloat16 hi = __float2bfloat16_rn(v);
  if (k / kFeat != 1) return __bfloat16_as_ushort(hi);
  return __bfloat16_as_ushort(__float2bfloat16_rn(v - __bfloat162float(hi)));
}

// Splits the features of the lane's rows into A fragments: feat(m, h, i) is
// feature i of the ray of row g + 8h of m tile m (0 for a row without a
// ray, whose products are then 0: det = 0 never hits).
template <class FeatOf>
__device__ __forceinline__ void load_rays(Rays& r, const FeatOf& feat,
                                          int t) {
#pragma unroll
  for (int m = 0; m < kTilesM; ++m) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const auto x = [&](int i) { return feat(m, h, i); };
#pragma unroll
      for (int p = 0; p < 4; ++p) {  // k pair 2t + 8p
        const int k = 2 * t + 8 * p;
        r.a[m][p >> 1][h + 2 * (p & 1)] =
            ray_k(x, k) | (ray_k(x, k + 1) << 16);
      }
    }
  }
}

// ---- the visit --------------------------------------------------------------

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The four quantity tiles of one m tile against the B fragments b of one
// tile of 8 triangles: c[q] holds quantity q's C fragment.
__device__ __forceinline__ void product(float (&c)[4][4],
                                        const uint32_t (&a)[2][4],
                                        const uint4 (&b)[4]) {
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    c[q][0] = c[q][1] = c[q][2] = c[q][3] = 0.0f;
    mma_bf16(c[q], a[0], b[q].x, b[q].y);
    mma_bf16(c[q], a[1], b[q].z, b[q].w);
  }
}

// The per-triangle test on the lane's four (det, u*det, v*det,
// t*det) of c: element e is row g + 8 (e >> 1), triangle j0 + (e & 1); a
// valid hit strictly nearer than tv[e >> 1] replaces it and its row. The
// sign fold flips sign bits instead of multiplying by sign(det): the same
// values (a multiply by -1 is exact), except at det = -0, which fails
// |det| > DET_EPS either way. The divisions run only when some lane of the
// warp has a valid hit.
__device__ __forceinline__ void epilogue(const float (&c)[4][4], int j0,
                                         float (&tv)[2], int (&sv)[2]) {
  bool valid[4];
  float tn[4], adet[4];
  bool any = false;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const unsigned sign = __float_as_uint(c[0][e]) & 0x80000000u;
    const float un = __uint_as_float(__float_as_uint(c[1][e]) ^ sign);
    const float vn = __uint_as_float(__float_as_uint(c[2][e]) ^ sign);
    tn[e] = __uint_as_float(__float_as_uint(c[3][e]) ^ sign);
    adet[e] = fabsf(c[0][e]);
    valid[e] = adet[e] > visit::kDetEps && un >= 0.0f && vn >= 0.0f &&
               __fadd_rn(un, vn) <= adet[e] &&
               tn[e] > __fmul_rn(adet[e], visit::kTMin);
    any = any || valid[e];
  }
  if (!__any_sync(0xffffffffu, any)) return;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    if (valid[e]) {
      const float tc = __fdiv_rn(tn[e], fmaxf(adet[e], visit::kDenomFloor));
      if (tc < tv[e >> 1]) {
        tv[e >> 1] = tc;
        sv[e >> 1] = j0 + (e & 1);
      }
    }
  }
}

// Tests the 128 triangles of the staged cluster `tab` (split_table's block
// of cluster cid) against the warp's first tiles_m m tiles (uniform across
// the warp) and takes strictly nearer hits into (t_best, best), the rows'
// best t and padded slot, identical across each quad on return. Within a
// tile of 8 triangles, the next m tile's products go to the tensor cores
// before this m tile's epilogue runs on the CUDA cores.
__device__ __forceinline__ void visit_cluster(const unsigned char* tab,
                                              const Rays& r, int tiles_m,
                                              int cid,
                                              float (&t_best)[kTilesM][2],
                                              int (&best)[kTilesM][2], int g,
                                              int t) {
  float tv[kTilesM][2];
  int sv[kTilesM][2];
#pragma unroll
  for (int m = 0; m < kTilesM; ++m) {
    tv[m][0] = tv[m][1] = INFINITY;
    sv[m][0] = sv[m][1] = 0;
  }
  const unsigned char* lane_col = tab + g * kColBytes + t * 16;
#pragma unroll 1
  for (int nt = 0; nt < kTilesN; ++nt) {
    uint4 b[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      b[q] = *reinterpret_cast<const uint4*>(
          lane_col + (q * kTris + nt * 8) * kColBytes);
    }
    float c[2][4][4];
    product(c[0], r.a[0], b);
#pragma unroll
    for (int m = 0; m < kTilesM; ++m) {
      if (m >= tiles_m) break;
      if (m + 1 < kTilesM && m + 1 < tiles_m) {
        product(c[(m + 1) & 1], r.a[m + 1], b);
      }
      epilogue(c[m & 1], nt * 8 + 2 * t, tv[m], sv[m]);
    }
  }
#pragma unroll
  for (int m = 0; m < kTilesM; ++m) {
    if (m >= tiles_m) break;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float tq = tv[m][h];
      int sq = sv[m][h];
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        const float to = __shfl_xor_sync(0xffffffffu, tq, off);
        const int so = __shfl_xor_sync(0xffffffffu, sq, off);
        if (to < tq || (to == tq && so < sq)) {
          tq = to;
          sq = so;
        }
      }
      if (tq < t_best[m][h]) {
        t_best[m][h] = tq;
        best[m][h] = cid * kTris + sq;
      }
    }
  }
}

// ---- the per-warp cluster-box skip ------------------------------------------

// ops/intersect_cluster.py:_safe_inverse.
__device__ __forceinline__ float safe_inverse(float d) {
  constexpr float kTiny = 1e-20f;
  return __fdiv_rn(1.0f, fabsf(d) < kTiny ? (d < 0.0f ? -kTiny : kTiny) : d);
}

// A lane's two rays of the box test, the rows g and g + 8 of m tile t:
// origins and safe inverse directions.
struct BoxRays {
  float o[2][3];
  float inv[2][3];
};

// Whether the ray (o, inv) crosses the box [lo, hi] within [T_MIN, t_max]:
// ray_cluster_mask's slab test, rounded as it rounds (no contraction).
__device__ __forceinline__ bool crosses(const float (&o)[3],
                                        const float (&inv)[3],
                                        const float (&lo)[3],
                                        const float (&hi)[3], float t_max) {
  float t_in = -INFINITY, t_out = INFINITY;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float t0 = __fmul_rn(__fsub_rn(lo[a], o[a]), inv[a]);
    const float t1 = __fmul_rn(__fsub_rn(hi[a], o[a]), inv[a]);
    t_in = fmaxf(t_in, fminf(t0, t1));
    t_out = fminf(t_out, fmaxf(t0, t1));
  }
  return t_out >= fmaxf(t_in, visit::kTMin) && t_in <= t_max;
}

// The skip's slack on the best t (ops/intersect_cluster.py:SKIP_T_SLACK).
constexpr float kSkipTSlack = 1.000244140625f;  // 1 + 2^-12

// Whether some ray of the warp crosses cluster cid's box, inflated by
// ray_cluster_mask's pad, before its best t x kSkipTSlack (uniform across
// the warp).
__device__ __forceinline__ bool warp_crosses(const BoxRays& br,
                                             const float* __restrict__ box_lo,
                                             const float* __restrict__ box_hi,
                                             int cid,
                                             const float (&t_best)[kTilesM][2],
                                             int t) {
  float lo[3], hi[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float l = __ldg(box_lo + 3 * cid + a);
    const float h = __ldg(box_hi + 3 * cid + a);
    const float pad =
        __fadd_rn(__fmul_rn(1e-6f, fmaxf(fabsf(l), fabsf(h))), 1e-7f);
    lo[a] = __fsub_rn(l, pad);
    hi[a] = __fadd_rn(h, pad);
  }
  bool any = false;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float tb = t_best[0][h];
#pragma unroll
    for (int m = 1; m < kTilesM; ++m) tb = t == m ? t_best[m][h] : tb;
    any = any ||
          crosses(br.o[h], br.inv[h], lo, hi, __fmul_rn(tb, kSkipTSlack));
  }
  return __any_sync(0xffffffffu, any);
}

// ---- the walk ---------------------------------------------------------------

constexpr int kRayBlock = 512;                           // rays per CTA
constexpr int kWalkThreads = kRayBlock / kWarpRays * 32;  // 256
constexpr int kWalkCtasPerSm = 2;

// One walk's arguments. Shapes: cand/tnear (n_blocks, n_cand_max), count
// (n_blocks,), rayf (11, n_rays) with n_rays = 512 * n_blocks, t_in/slot_in
// (n_rays,) (slot_in null: every ray starts at -1), table (n_clusters, 512,
// 32) bf16 split columns, 16-byte aligned, box_lo/box_hi (n_clusters, 3);
// outputs t/slot (n_rays,), visits/warp_visits (n_blocks,).
struct WalkArgs {
  const int* cand;
  const int* count;
  const float* tnear;
  const float* rayf;
  const float* t_in;
  const int* slot_in;
  const unsigned char* table;
  const float* box_lo;
  const float* box_hi;
  float* t_out;
  int* slot_out;
  int* visits_out;
  int* warp_visits_out;
  int n_cand_max;
  int n_clusters;
  int n_rays;
};

// The CTA of block blockIdx.x continues, from each ray's t_in and slot_in,
// the ordered walk of the block's first min(count, n_cand_max) candidates,
// and writes the new best t and slot, the candidates it walked and the
// visits its warps computed (the skip's savings are the difference to 8
// per candidate). Every thread of the CTA calls it; smem holds the ring.
__device__ __forceinline__ void walk_block(const WalkArgs& a,
                                           unsigned char* smem) {
  __shared__ int warp_visits_sum;
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid % 32, g = lane / 4, t = lane % 4;
  const long long warp_ray =
      static_cast<long long>(b) * kRayBlock + (tid / 32) * kWarpRays;
  const auto ray_of = [&](int m, int h) {
    return warp_ray + 16 * m + g + 8 * h;
  };
  const auto feat = [&](int i, long long ray) {
    return a.rayf[static_cast<long long>(i) * a.n_rays + ray];
  };

  float t_best[kTilesM][2];
  int best[kTilesM][2];
#pragma unroll
  for (int m = 0; m < kTilesM; ++m) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      t_best[m][h] = a.t_in[ray_of(m, h)];
      best[m][h] = a.slot_in ? a.slot_in[ray_of(m, h)] : -1;
    }
  }
  if (tid == 0) warp_visits_sum = 0;
  const int n_cand = min(a.count[b], a.n_cand_max);  // the same for the CTA
  const int* cand_b = a.cand + static_cast<long long>(b) * a.n_cand_max;
  const float* tnear_b = a.tnear + static_cast<long long>(b) * a.n_cand_max;
  const auto cid_of = [&](int k) {
    return min(max(cand_b[k], 0), a.n_clusters - 1);
  };
  int k = 0, warp_visits = 0;
  if (n_cand > 0) {
    const Ring ring(smem);
    ring.init();
    if (tid == 0) {
      for (int j = 0; j < kStages - 1 && j < n_cand; ++j) {
        ring.issue(a.table, cid_of(j), j);
      }
    }
    Rays r;
    load_rays(r, [&](int m, int h, int i) { return feat(i, ray_of(m, h)); },
              t);
    BoxRays br;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int ax = 0; ax < 3; ++ax) {
        br.o[h][ax] = feat(6 + ax, ray_of(t, h));  // rows 6-8: o
        br.inv[h][ax] = safe_inverse(feat(ax, ray_of(t, h)));  // rows 0-2: d
      }
    }
    for (; k < n_cand; ++k) {
      bool done = true;
#pragma unroll
      for (int m = 0; m < kTilesM; ++m) {
        done = done && t_best[m][0] <= tnear_b[k] &&
               t_best[m][1] <= tnear_b[k];
      }
      // The vote is also the barrier that keeps the readers of visit k - 1
      // ahead of the copy into its stage.
      if (__syncthreads_and(done)) break;
      if (tid == 0 && k + kStages - 1 < n_cand) {
        ring.issue(a.table, cid_of(k + kStages - 1), k + kStages - 1);
      }
      const int cid = cid_of(k);
      const bool need = warp_crosses(br, a.box_lo, a.box_hi, cid, t_best, t);
      // Every warp waits, so that each copy is complete before its stage is
      // issued again.
      const unsigned char* tab = ring.wait(k);
      if (need) {
        visit_cluster(tab, r, kTilesM, cid, t_best, best, g, t);
        ++warp_visits;
      }
    }
    // The prefetches the early exit abandoned.
    for (int j = k; j < k + kStages - 1 && j < n_cand; ++j) ring.wait(j);
  }
  if (t == 0) {  // a quad's lanes hold the same rows' results
#pragma unroll
    for (int m = 0; m < kTilesM; ++m) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        a.t_out[ray_of(m, h)] = t_best[m][h];
        a.slot_out[ray_of(m, h)] = best[m][h];
      }
    }
  }
  __syncthreads();  // warp_visits_sum is 0
  if (lane == 0) atomicAdd(&warp_visits_sum, warp_visits);
  __syncthreads();
  if (tid == 0) {
    a.visits_out[b] = k;
    a.warp_visits_out[b] = warp_visits_sum;
  }
}

}  // namespace mma_visit
