// Visit-arithmetic probes for Hopper (sm_90a), bound through a plain C
// interface (ops/visit_probe.py loads it with ctypes).
//
// Replace the three Pallas kernels of scripts/_probe_compile.py: kern_f32
// (K5), kern_split_in (K6) and kern_split_pre (K7). Each computes, for every
// ray r of a (16, R) feature block, the minimum over the 512 columns of every
// enabled cluster k of the product feat[:, k*512 + j] . rayf[:, r], starting
// from 1e9; cluster k is enabled for the 512-ray block b when
// mask[b % 8][k] > 0. That is the arithmetic of one cluster visit of the
// render kernels (visit.cuh) without the hit predicate, so the three forms
// say what the visit would cost on each unit of the card:
//
//   K5 probe_f32: f32 on the CUDA cores. Bound: 16 FMAs per (ray, column),
//       the card's f32 rate. One thread per two rays (32 features in
//       registers); each enabled cluster's 16 x 512 block is staged once per
//       CTA in shared memory (32 KB), column-major, so that a column is read
//       as four broadcast 16-byte loads and feeds 32 FMAs.
//   K6 probe_split_in: the bf16 hi/lo error split on the tensor cores,
//       x*y ~= hi(x)hi(y) + lo(x)hi(y) + hi(x)lo(y), in the reference's
//       stacking (rays [hi; lo; hi] against the table [hi; hi; lo]: one
//       K = 48 product, three k-steps of mma.sync.m16n8k16 accumulating in
//       f32). Bound: 3 x 16 x 2 operations per (ray, column) at the bf16
//       tensor rate. Each warp keeps the hi and lo fragments of its 64 rays
//       in registers and walks every column of the staged cluster (hi and lo
//       bf16 pairs, 80 bytes per column with a pad that keeps the fragment
//       loads free of bank conflicts); the min over columns is the epilogue
//       of each product tile (two fminf per tile, then a quad shuffle at the
//       end: a warp owns its rays, so no shared-memory pass is needed). The
//       f32 inputs are split in the kernel with __float2bfloat16_rn (round
//       to nearest even, as torch and JAX cast). Stage, synchronise,
//       compute: no TMA, wgmma or pipelining.
//   K7 probe_split_pre: the same product from operands split beforehand,
//       on wgmma fed by TMA. Bound: the same 96 tensor operations per (ray,
//       column) (3.34 ms at full width on the bench table), with the
//       epilogue's one fminf per (ray, column) on the CUDA cores as a
//       co-bound (at 64 per clock per SM about two thirds of it), so the
//       two must overlap. The design: the enabled clusters' 64-column
//       tiles (16 rows x 128 bytes, hi and lo, read from the (16, n) tables
//       as they are; the 128-byte swizzle is the TMA's) stream through a
//       four-stage ring of 256 columns by TMA copies with full and empty
//       mbarriers; thread 0 issues them, refilling each slot two stages
//       after the CTA freed it (a separate producer warp would put five
//       warps on one of the SM's four register files and cap every thread
//       at 96 registers, which spills the accumulators). Four warpgroups
//       own 128 rays each, as two m64 tiles whose hi/lo A fragments stay in
//       registers; per 64-column tile each issues wgmma.m64n64k16 three
//       times per m tile (hi.hi, lo.hi, hi.lo; B from shared memory,
//       MN-major) and folds both accumulator sets with fminf once they are
//       complete, so that one warpgroup's epilogue overlaps the other
//       warpgroups' products on the SM's tensor cores.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

namespace {

constexpr int kRayBlock = 512;   // rays per CTA = the probe's ray block
constexpr int kThreads = 256;    // 8 warps
constexpr int kCols = 512;       // table columns per cluster
constexpr int kFeat = 16;        // feature rows
constexpr int kMaskRows = 8;     // mask rows, picked by block % 8
constexpr float kInit = 1e9f;    // the TPU kernels' initial minimum

// ---- K5: f32 on the CUDA cores --------------------------------------------

__global__ void __launch_bounds__(kThreads)
probe_f32_kernel(const int* __restrict__ mask, const float* __restrict__ rayf,
                 const float* __restrict__ feat, float* __restrict__ out,
                 int n_clusters, int n_rays) {
  __shared__ __align__(16) float tab[kCols * kFeat];  // tab[col * 16 + i]

  const int tid = threadIdx.x;
  const long long ray0 = static_cast<long long>(blockIdx.x) * kRayBlock + tid;
  const long long ray1 = ray0 + kThreads;
  const long long n_cols = static_cast<long long>(n_clusters) * kCols;
  float r0[kFeat], r1[kFeat];
#pragma unroll
  for (int i = 0; i < kFeat; ++i) {
    r0[i] = rayf[i * static_cast<long long>(n_rays) + ray0];
    r1[i] = rayf[i * static_cast<long long>(n_rays) + ray1];
  }
  float best0 = kInit, best1 = kInit;
  const int* enabled = mask + (blockIdx.x % kMaskRows) * n_clusters;
  for (int c = 0; c < n_clusters; ++c) {
    if (enabled[c] <= 0) continue;  // the same for the whole CTA
    __syncthreads();
    const float* src = feat + static_cast<long long>(c) * kCols;
    for (int col = tid; col < kCols; col += kThreads) {
#pragma unroll
      for (int i = 0; i < kFeat; ++i) {
        tab[col * kFeat + i] = src[i * n_cols + col];
      }
    }
    __syncthreads();
    const float4* t4 = reinterpret_cast<const float4*>(tab);
#pragma unroll 2
    for (int col = 0; col < kCols; ++col) {
      float f[kFeat];
#pragma unroll
      for (int m = 0; m < kFeat / 4; ++m) {
        const float4 x = t4[col * (kFeat / 4) + m];
        f[4 * m + 0] = x.x;
        f[4 * m + 1] = x.y;
        f[4 * m + 2] = x.z;
        f[4 * m + 3] = x.w;
      }
      float q0 = r0[0] * f[0], q1 = r1[0] * f[0];
#pragma unroll
      for (int i = 1; i < kFeat; ++i) {
        q0 = fmaf(r0[i], f[i], q0);
        q1 = fmaf(r1[i], f[i], q1);
      }
      best0 = fminf(best0, q0);
      best1 = fminf(best1, q1);
    }
  }
  out[ray0] = best0;
  out[ray1] = best1;
}

// ---- K6: bf16 hi/lo split on the tensor cores, mma.sync ------------------

constexpr int kTilesM = 4;            // 16-ray m-tiles per warp: 64 rays
constexpr int kColWords = 20;         // 32-bit words per staged column:
                                      // hi pairs 8 | lo pairs 8 | pad 4
constexpr int kLoWord = 8;

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 a,
                                              __nv_bfloat16 b) {
  // a in the low half: the lower k index of an mma fragment pair.
  return static_cast<uint32_t>(__bfloat16_as_ushort(a)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(b)) << 16);
}

__device__ __forceinline__ void split(float x, __nv_bfloat16& hi,
                                      __nv_bfloat16& lo) {
  hi = __float2bfloat16_rn(x);
  lo = __float2bfloat16_rn(x - __bfloat162float(hi));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The operands as the kernel reads them: f32 split here. get(idx) yields
// the (hi, lo) bf16 pair of element idx of a (16, n) row-major table.
struct SplitF32 {
  const float* x;
  __device__ __forceinline__ void get(long long idx, __nv_bfloat16& hi,
                                      __nv_bfloat16& lo) const {
    split(x[idx], hi, lo);
  }
};

// mma.m16n8k16 fragments (PTX ISA, "Matrix fragments for mma.m16n8k16"):
// with g = lane / 4 and t = lane % 4, A register j holds row g + 8 * (j & 1)
// and k pair 2t + 8 * (j >> 1); B register j holds column g and k pair
// 2t + 8j; C holds rows g (c0, c1) and g + 8 (c2, c3), columns 2t, 2t + 1.
template <class Src>
__global__ void __launch_bounds__(kThreads)
probe_split_kernel(const int* __restrict__ mask, Src rays, Src table,
                   float* __restrict__ out, int n_clusters, int n_rays) {
  __shared__ __align__(16) uint32_t tab[kCols * kColWords];  // 40 KB

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const long long n_cols = static_cast<long long>(n_clusters) * kCols;
  const long long warp_ray =
      static_cast<long long>(blockIdx.x) * kRayBlock + warp * (16 * kTilesM);

  uint32_t a_hi[kTilesM][4], a_lo[kTilesM][4];
#pragma unroll
  for (int m = 0; m < kTilesM; ++m) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const long long ray = warp_ray + m * 16 + g + 8 * (j & 1);
      const int k = 2 * t + 8 * (j >> 1);
      __nv_bfloat16 h0, l0, h1, l1;
      rays.get(k * static_cast<long long>(n_rays) + ray, h0, l0);
      rays.get((k + 1) * static_cast<long long>(n_rays) + ray, h1, l1);
      a_hi[m][j] = pack_bf16(h0, h1);
      a_lo[m][j] = pack_bf16(l0, l1);
    }
  }
  float best[kTilesM][2];
#pragma unroll
  for (int m = 0; m < kTilesM; ++m) best[m][0] = best[m][1] = kInit;

  const int* enabled = mask + (blockIdx.x % kMaskRows) * n_clusters;
  for (int c = 0; c < n_clusters; ++c) {
    if (enabled[c] <= 0) continue;  // the same for the whole CTA
    __syncthreads();
    for (int col = tid; col < kCols; col += kThreads) {
      const long long base = static_cast<long long>(c) * kCols + col;
#pragma unroll
      for (int p = 0; p < kFeat / 2; ++p) {
        __nv_bfloat16 h0, l0, h1, l1;
        table.get((2 * p) * n_cols + base, h0, l0);
        table.get((2 * p + 1) * n_cols + base, h1, l1);
        tab[col * kColWords + p] = pack_bf16(h0, h1);
        tab[col * kColWords + kLoWord + p] = pack_bf16(l0, l1);
      }
    }
    __syncthreads();
    for (int nt = 0; nt < kCols / 8; ++nt) {
      const uint32_t* colw = tab + (nt * 8 + g) * kColWords;
      const uint32_t b_hi0 = colw[t], b_hi1 = colw[4 + t];
      const uint32_t b_lo0 = colw[kLoWord + t], b_lo1 = colw[kLoWord + 4 + t];
#pragma unroll
      for (int m = 0; m < kTilesM; ++m) {
        float q[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        mma_bf16(q, a_hi[m], b_hi0, b_hi1);  // hi . hi
        mma_bf16(q, a_lo[m], b_hi0, b_hi1);  // lo(ray) . hi(table)
        mma_bf16(q, a_hi[m], b_lo0, b_lo1);  // hi(ray) . lo(table)
        best[m][0] = fminf(best[m][0], fminf(q[0], q[1]));
        best[m][1] = fminf(best[m][1], fminf(q[2], q[3]));
      }
    }
  }
  // The four lanes of a quad hold the same rays' minima over other columns.
#pragma unroll
  for (int m = 0; m < kTilesM; ++m) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float v = best[m][h];
      v = fminf(v, __shfl_xor_sync(0xffffffffu, v, 1));
      v = fminf(v, __shfl_xor_sync(0xffffffffu, v, 2));
      if (t == 0) out[warp_ray + m * 16 + g + 8 * h] = v;
    }
  }
}

// ---- K7: bf16 hi/lo split on wgmma, fed by TMA ----------------------------

constexpr int kGroups = 4;             // warpgroups of 128 rays (2 m tiles)
constexpr int kK7Warps = 4 * kGroups;
constexpr int kK7Threads = 32 * kK7Warps;  // 512: 128 registers a thread
constexpr int kTileN = 64;             // columns per wgmma: a 128-byte row
constexpr int kTileBytes = kFeat * kTileN * 2;         // 2 KB per operand
constexpr int kStageTiles = 4;         // 256 columns per stage
constexpr int kStageBytes = 2 * kStageTiles * kTileBytes;  // hi + lo: 16 KB
constexpr int kK7Stages = 4;
constexpr int kRefillLag = 2;          // stage k refills stage k - 2's slot
constexpr int kK7Smem = kK7Stages * kStageBytes + 1024;  // + alignment
constexpr int kK7StagesPerCluster = kCols / (kStageTiles * kTileN);

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_wait(uint32_t bar, uint32_t parity) {
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
}

// One thread: the TMA copy of the 64-column tile at `col` (all 16 rows)
// into shared memory at dst, completing on the mbarrier bar.
__device__ __forceinline__ void tma_tile(uint32_t dst, const CUtensorMap* map,
                                         int col, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(0), "r"(bar)
      : "memory");
}

// wgmma's shared-memory descriptor of one B tile: 16 k rows (features) of
// 64 n (columns), each row 128 bytes, MN-major, in the 128-byte swizzle
// that the TMA writes. The stride between the two groups of 8 k rows is
// 1024 bytes; the tile holds one 64-wide n block, so the n-block stride is
// not read (set to the same 1024).
__device__ __forceinline__ uint64_t tile_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1024 >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

// d (+)= a . B on a warpgroup: m64n64k16, bf16 in, f32 accumulate, A from
// registers (mma.m16n8k16's A fragment per warp, the warp's 16 rows), B
// MN-major from shared memory. accumulate = 0 overwrites d.
__device__ __forceinline__ void wgmma_tile(float (&d)[32],
                                           const uint32_t (&a)[4],
                                           uint64_t b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// Pins the accumulators after the wait that completes their wgmma, so that
// the epilogue's reads stay after it (the compiler sees no dependence
// through the wait).
__device__ __forceinline__ void fence_acc(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// The accumulator of m64nN: register 4j + {0, 1} holds row g and
// 4j + {2, 3} row g + 8 of the warp's 16 (columns differ, which the min
// does not see).
__device__ __forceinline__ void fold_min(const float (&d)[32],
                                         float (&best)[2]) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    best[0] = fminf(best[0], fminf(d[4 * j], d[4 * j + 1]));
    best[1] = fminf(best[1], fminf(d[4 * j + 2], d[4 * j + 3]));
  }
}

__global__ void __launch_bounds__(kK7Threads, 1)
probe_split_pre_kernel(const __grid_constant__ CUtensorMap map_hi,
                       const __grid_constant__ CUtensorMap map_lo,
                       const int* __restrict__ mask,
                       const __nv_bfloat16* __restrict__ ray_hi,
                       const __nv_bfloat16* __restrict__ ray_lo,
                       float* __restrict__ out, int n_clusters, int n_rays) {
  extern __shared__ __align__(1024) unsigned char dsmem[];
  __shared__ __align__(8) uint64_t full[kK7Stages], empty[kK7Stages];
  const uint32_t base = smem_u32(dsmem);
  const uint32_t ring = base + ((1024 - (base & 1023)) & 1023);
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int* enabled = mask + (blockIdx.x % kMaskRows) * n_clusters;
  if (tid == 0) {
    for (int s = 0; s < kK7Stages; ++s) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                       smem_u32(full + s))
                   : "memory");
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                       smem_u32(empty + s)),
                   "r"(kK7Warps)
                   : "memory");
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // The producer, thread 0: copies stage kp (the enabled clusters' columns
  // in order, 256 at a time) into slot kp % kK7Stages once every warp has
  // freed the slot's previous stage.
  int pc = 0, ph = 0;  // the next stage to copy: cluster, quarter
  auto produce = [&](int kp) {
    while (pc < n_clusters && enabled[pc] <= 0) ++pc;
    if (pc >= n_clusters) return;
    const int s = kp % kK7Stages;
    if (kp >= kK7Stages) {
      bar_wait(smem_u32(empty + s), (kp / kK7Stages - 1) & 1);
    }
    const uint32_t bar = smem_u32(full + s);
    asm volatile(
        "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
        "r"(kStageBytes)
        : "memory");
    const int col0 = (pc * kK7StagesPerCluster + ph) * kStageTiles * kTileN;
    for (int j = 0; j < kStageTiles; ++j) {
      const uint32_t dst = ring + s * kStageBytes + 2 * j * kTileBytes;
      tma_tile(dst, &map_hi, col0 + j * kTileN, bar);
      tma_tile(dst + kTileBytes, &map_lo, col0 + j * kTileN, bar);
    }
    if (++ph == kK7StagesPerCluster) {
      ph = 0;
      ++pc;
    }
  };
  if (tid == 0) {
    for (int kp = 0; kp < kK7Stages; ++kp) produce(kp);
  }

  // Warpgroup wg owns rays [128 wg, 128 wg + 128) of the block, as m tiles
  // of 64; this warp the 16 rows 16 * (warp % 4) of each.
  const int g = lane / 4, t = lane % 4;
  const long long ray0 = static_cast<long long>(blockIdx.x) * kRayBlock +
                         (warp / 4) * 128 + (warp % 4) * 16;
  uint32_t a_hi[2][4], a_lo[2][4];
#pragma unroll
  for (int m = 0; m < 2; ++m) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const long long ray = ray0 + m * 64 + g + 8 * (j & 1);
      const long long k0 = (2 * t + 8 * (j >> 1)) * static_cast<long long>(
                                                         n_rays) + ray;
      const long long k1 = k0 + n_rays;
      a_hi[m][j] = pack_bf16(ray_hi[k0], ray_hi[k1]);
      a_lo[m][j] = pack_bf16(ray_lo[k0], ray_lo[k1]);
    }
  }
  float acc[2][32];
  float best[2][2];
#pragma unroll
  for (int m = 0; m < 2; ++m) best[m][0] = best[m][1] = kInit;

  int k = 0;
  for (int c = 0; c < n_clusters; ++c) {
    if (enabled[c] <= 0) continue;  // the same for the whole CTA
    for (int h = 0; h < kK7StagesPerCluster; ++h, ++k) {
      const int s = k % kK7Stages;
      bar_wait(smem_u32(full + s), (k / kK7Stages) & 1);
      const uint32_t stage = ring + s * kStageBytes;
#pragma unroll
      for (int j = 0; j < kStageTiles; ++j) {
        const uint64_t b_hi = tile_desc(stage + 2 * j * kTileBytes);
        const uint64_t b_lo = tile_desc(stage + (2 * j + 1) * kTileBytes);
        // Both m tiles' products in one group; the epilogue reads the
        // accumulators only once the group is complete, and meanwhile the
        // other warpgroups' products keep the tensor cores busy.
        asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          wgmma_tile(acc[m], a_hi[m], b_hi, 0);
          wgmma_tile(acc[m], a_lo[m], b_hi, 1);
          wgmma_tile(acc[m], a_hi[m], b_lo, 1);
        }
        asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
        asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          fence_acc(acc[m]);
          fold_min(acc[m], best[m]);
        }
      }
      // Every product of this stage is complete: free its slot, and let
      // the producer refill the slot freed kRefillLag stages ago (by now
      // free in every warp, so the wait is short).
      if (lane == 0) {
        asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                         smem_u32(empty + s))
                     : "memory");
      }
      if (tid == 0 && k >= kRefillLag) produce(k - kRefillLag + kK7Stages);
    }
  }
  // The four lanes of a quad hold the same rays' minima over other columns.
#pragma unroll
  for (int m = 0; m < 2; ++m) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float v = best[m][h];
      v = fminf(v, __shfl_xor_sync(0xffffffffu, v, 1));
      v = fminf(v, __shfl_xor_sync(0xffffffffu, v, 2));
      if (t == 0) out[ray0 + m * 64 + g + 8 * h] = v;
    }
  }
}

// cuTensorMapEncodeTiled from the driver the process has loaded (libcuda,
// through dlopen: no link-time dependency on the driver API).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_LOCAL);
    if (lib != nullptr) {
      fn = reinterpret_cast<EncodeTiled>(dlsym(lib, "cuTensorMapEncodeTiled"));
    }
  }
  return fn;
}

// The tensor map of a (16, n_cols) row-major bf16 table in 64-column tiles
// of all 16 rows, 128-byte swizzled. Returns false if it cannot be made.
bool table_map(CUtensorMap* map, const void* table, int n_cols) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(n_cols),
                              static_cast<cuuint64_t>(kFeat)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(n_cols) * 2};
  const cuuint32_t box[2] = {kTileN, kFeat};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                const_cast<void*>(table), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

int blocks(int n_rays) { return n_rays / kRayBlock; }

}  // namespace

// Each launcher runs one CTA per 512-ray block on `stream` (256 threads;
// K7 544 and 65 KB of dynamic shared memory) and allocates nothing.
// Shapes: mask (8, n_clusters) i32; rays (16, n_rays) and table (16,
// n_clusters * 512), row-major, f32 (K5, K6) or bf16 hi and lo (K7); out
// (n_rays,) f32; n_rays a multiple of 512. Each returns cudaGetLastError()
// after the launch.
extern "C" int probe_f32_launch(const void* mask, const void* rayf,
                                const void* feat, void* out, int n_clusters,
                                int n_rays, void* stream) {
  probe_f32_kernel<<<blocks(n_rays), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(mask), static_cast<const float*>(rayf),
      static_cast<const float*>(feat), static_cast<float*>(out), n_clusters,
      n_rays);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int probe_split_in_launch(const void* mask, const void* rayf,
                                     const void* feat, void* out,
                                     int n_clusters, int n_rays,
                                     void* stream) {
  probe_split_kernel<SplitF32><<<blocks(n_rays), kThreads, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(mask),
      SplitF32{static_cast<const float*>(rayf)},
      SplitF32{static_cast<const float*>(feat)}, static_cast<float*>(out),
      n_clusters, n_rays);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int probe_split_pre_launch(const void* mask, const void* rayf_hi,
                                      const void* rayf_lo,
                                      const void* feat_hi,
                                      const void* feat_lo, void* out,
                                      int n_clusters, int n_rays,
                                      void* stream) {
  // The tables must be 16-byte aligned (the TMA's global address).
  CUtensorMap map_hi, map_lo;
  const int n_cols = n_clusters * kCols;
  if (!table_map(&map_hi, feat_hi, n_cols) ||
      !table_map(&map_lo, feat_lo, n_cols)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t attr = cudaFuncSetAttribute(
      probe_split_pre_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kK7Smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  probe_split_pre_kernel<<<blocks(n_rays), kK7Threads, kK7Smem,
                           static_cast<cudaStream_t>(stream)>>>(
      map_hi, map_lo, static_cast<const int*>(mask),
      static_cast<const __nv_bfloat16*>(rayf_hi),
      static_cast<const __nv_bfloat16*>(rayf_lo), static_cast<float*>(out),
      n_clusters, n_rays);
  return static_cast<int>(cudaGetLastError());
}
