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
//   K6 probe_split_in and K7 probe_split_pre: the bf16 hi/lo error split on
//       the tensor cores, x*y ~= hi(x)hi(y) + lo(x)hi(y) + hi(x)lo(y), in the
//       reference's stacking (rays [hi; lo; hi] against the table
//       [hi; hi; lo]: one K = 48 product, three k-steps of
//       mma.sync.m16n8k16 accumulating in f32). Bound: 3 x 16 x 2 operations
//       per (ray, column) at the bf16 tensor rate. Each warp keeps the hi and
//       lo fragments of its 64 rays in registers and walks every column of
//       the staged cluster (hi and lo bf16 pairs, 80 bytes per column with a
//       pad that keeps the fragment loads free of bank conflicts); the min
//       over columns is the epilogue of each product tile (two fminf per
//       tile, then a quad shuffle at the end: a warp owns its rays, so no
//       shared-memory pass is needed). K6 splits the f32 inputs in the kernel
//       with __float2bfloat16_rn (round to nearest even, as torch and JAX
//       cast); K7 reads the split operands.
//
// No TMA, wgmma or pipelining: stage, synchronise, compute. Simple kernels
// that are right; speed is for the redesign of the visit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
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

// ---- K6, K7: bf16 hi/lo split on the tensor cores -------------------------

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

// The operands as the kernel reads them: f32 split here (K6), or the split
// pair read as it is (K7). get(idx) yields the (hi, lo) bf16 pair of
// element idx of a (16, n) row-major table.
struct SplitF32 {
  const float* x;
  __device__ __forceinline__ void get(long long idx, __nv_bfloat16& hi,
                                      __nv_bfloat16& lo) const {
    split(x[idx], hi, lo);
  }
};

struct PreSplit {
  const __nv_bfloat16* hi;
  const __nv_bfloat16* lo;
  __device__ __forceinline__ void get(long long idx, __nv_bfloat16& h,
                                      __nv_bfloat16& l) const {
    h = hi[idx];
    l = lo[idx];
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

int blocks(int n_rays) { return n_rays / kRayBlock; }

}  // namespace

// Each launcher runs one CTA of 256 threads per 512-ray block on `stream`
// and allocates nothing. Shapes: mask (8, n_clusters) i32; rays (16, n_rays)
// and table (16, n_clusters * 512), row-major, f32 (K5, K6) or bf16 hi and
// lo (K7); out (n_rays,) f32; n_rays a multiple of 512. Each returns
// cudaGetLastError() after the launch.
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
  probe_split_kernel<PreSplit><<<blocks(n_rays), kThreads, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(mask),
      PreSplit{static_cast<const __nv_bfloat16*>(rayf_hi),
               static_cast<const __nv_bfloat16*>(rayf_lo)},
      PreSplit{static_cast<const __nv_bfloat16*>(feat_hi),
               static_cast<const __nv_bfloat16*>(feat_lo)},
      static_cast<float*>(out), n_clusters, n_rays);
  return static_cast<int>(cudaGetLastError());
}
