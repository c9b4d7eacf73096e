// The tensor-core cluster visit shared by the stream kernel
// (intersect_stream.cu) and the pair kernel (intersect_pair.cu): each
// candidate cluster's 32 KB block of the split table is bulk-copied into a
// shared-memory ring, and the visit computes det, u*det, v*det and t*det of
// its 128 triangles against a warp's rays as the reference's bf16 hi/lo
// split product on the tensor cores, then the Moller-Trumbore epilogue of
// csrc/visit.cuh on each lane's own products.
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
// rule of visit.cuh and of the plain versions.
//
// The staging. One thread issues cp.async.bulk (TMA without a tensor map)
// of candidate k + 1's block into the other stage of a two-stage ring
// before the CTA computes on candidate k; completion is counted in bytes
// by one mbarrier per stage. A barrier of the whole CTA before each issue
// keeps the previous visit's readers ahead of the copy that overwrites
// their stage. A walk that stops early only abandons a prefetch, and waits
// for it before the CTA exits.

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

// visit.cuh's per-triangle test on the lane's four (det, u*det, v*det,
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

}  // namespace mma_visit
