// The sampler's per-pixel uniforms for Hopper (sm_90a), bound through a
// plain C interface (sampling/rng.py loads it with ctypes).
//
// It replaces no TPU kernel: the reference draws with jax.random's
// partitionable Threefry-2x32, which XLA fuses into the frame's own
// program. The port's plain version (sampling/rng.py:_per_pixel_plain)
// computes the same words in int64 tensors, one elementwise launch per
// operation of the 20 rounds, with a 32-bit mask after each, so every
// intermediate is an (N, n) int64 tensor streamed through device memory.
//
// What bounds it: integer instructions. Per pixel id it evaluates 1 + n
// threefry blocks (the key fold_in(stream_key, id), then the counter pairs
// (0, j) under it) of about 72 int32 operations each, and it reads one
// 8-byte id and writes n 4-byte floats. So the design keeps every word in
// uint32_t registers, rotates with __funnelshift_l (one SHF), unrolls the
// 20 rounds and the five key injections, and takes n (2 for the jitter, 7
// for a bounce) as a template parameter so that the draws unroll too. A
// thread writes its own row of n floats; the stores are a small share of
// the bound.
//
// Exactness. The draws equal the plain version's bit for bit: the same
// 32-bit words (fold_in's counter is (0, id mod 2^32), the draw j's is
// (0, j), the two output words xored) and the same mantissa fill, bits >> 9
// with the exponent of 1.0, minus 1.0f, which is exact in f32.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr uint32_t kParity = 0x1BD11BDAu;

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

// Four rounds of mixing with the rotations r0..r3.
__device__ __forceinline__ void mix4(uint32_t& x0, uint32_t& x1, int r0,
                                     int r1, int r2, int r3) {
  x0 += x1; x1 = rotl(x1, r0) ^ x0;
  x0 += x1; x1 = rotl(x1, r1) ^ x0;
  x0 += x1; x1 = rotl(x1, r2) ^ x0;
  x0 += x1; x1 = rotl(x1, r3) ^ x0;
}

// 20-round Threefry-2x32 of the counter (x0, x1) under the key (k0, k1),
// as jax.random's threefry2x32 (and rng.py:threefry2x32) computes it.
__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1,
                                             uint32_t& x0, uint32_t& x1) {
  const uint32_t k2 = k0 ^ k1 ^ kParity;
  x0 += k0; x1 += k1;
  mix4(x0, x1, 13, 15, 26, 6);
  x0 += k1; x1 += k2 + 1u;
  mix4(x0, x1, 17, 29, 16, 24);
  x0 += k2; x1 += k0 + 2u;
  mix4(x0, x1, 13, 15, 26, 6);
  x0 += k0; x1 += k1 + 3u;
  mix4(x0, x1, 17, 29, 16, 24);
  x0 += k1; x1 += k2 + 4u;
  mix4(x0, x1, 13, 15, 26, 6);
  x0 += k2; x1 += k0 + 5u;
}

template <int N>
__global__ void __launch_bounds__(kThreads)
threefry_uniforms_kernel(const long long* __restrict__ ids, long long n_ids,
                         uint32_t k0, uint32_t k1, float* __restrict__ out) {
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n_ids) return;
  // fold_in(key, id): the counter (0, id mod 2^32).
  uint32_t p0 = 0u, p1 = static_cast<uint32_t>(ids[i]);
  threefry2x32(k0, k1, p0, p1);
  float* row = out + i * N;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    uint32_t y0 = 0u, y1 = static_cast<uint32_t>(j);
    threefry2x32(p0, p1, y0, y1);
    const uint32_t bits = ((y0 ^ y1) >> 9) | 0x3F800000u;
    row[j] = __uint_as_float(bits) - 1.0f;
  }
}

}  // namespace

// Launches one thread per pixel id on `stream`; allocates nothing. ids:
// (n_ids,) int64, read as their low 32 bits; (k0, k1): the stream key; out:
// (n_ids, n) f32, row i the n uniforms of ids[i]. n is 2 or 7 (the jitter
// and a bounce); any other n launches nothing and returns
// cudaErrorInvalidValue, as does a negative n_ids; n_ids = 0 launches
// nothing. Returns cudaGetLastError() after the launch.
extern "C" int threefry_uniforms_launch(const void* ids, long long n_ids,
                                        int n, unsigned int k0,
                                        unsigned int k1, void* out,
                                        void* stream) {
  if ((n != 2 && n != 7) || n_ids < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_ids == 0) return static_cast<int>(cudaSuccess);
  const auto blocks =
      static_cast<unsigned int>((n_ids + kThreads - 1) / kThreads);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* id = static_cast<const long long*>(ids);
  auto* u = static_cast<float*>(out);
  if (n == 2) {
    threefry_uniforms_kernel<2><<<blocks, kThreads, 0, s>>>(id, n_ids, k0,
                                                            k1, u);
  } else {
    threefry_uniforms_kernel<7><<<blocks, kThreads, 0, s>>>(id, n_ids, k0,
                                                            k1, u);
  }
  return static_cast<int>(cudaGetLastError());
}
