// Uniform-field RNG for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel ust_run_tpu/ops/pallas_rng.py
// (_uniform_kernel, reached through _pallas_uniform / uniform_batch), which
// fills (n, S, S) float32 fields with U[0,1) values on a 2^-24 grid for the
// elastic displacement fields of the weak augmentation.
//
// The TPU kernel uses the TPU's on-chip PRNG, which Hopper does not have.
// This kernel computes a counter-based Philox4x32-10 (Salmon et al., SC'11)
// written out here, so that a plain PyTorch version
// (ust_run_tpu_torch/ops/rng.py:uniform_batch_plain) can repeat it bit for
// bit:
//   * one Philox call gives 4 words, for 4 consecutive values of one field;
//   * counter = (quad index within the field, field index, 0, 0);
//   * key = the 64-bit seed split into (low word, high word);
//   * value = (w >> 8) * 2^-24 on a uint32_t, a LOGICAL shift. (The TPU
//     kernel once shifted signed bits arithmetically, which made half the
//     draws negative and blacked out every elastic sample.)
// When S*S is not a multiple of 4, the last quad of each field writes only
// the values that exist.
//
// Bound: the kernel writes n*S*S*4 bytes and reads the 8-byte key. On
// the main path (n = 16, S = 256) that is 4.19 MB, about 1.3 us at the H100's
// 3.35 TB/s; the arithmetic (10 rounds of 2 32-bit multiply-high/low
// pairs, xors and key adds per 4 values) is below that at the card's
// integer rate. At this size the launch itself dominates. Design: one
// thread per quad, one 16-byte store per thread when the field is
// 16-byte aligned, so neighbouring threads write neighbouring addresses.
//
// The key is read from two words in device memory (low word first), so
// that a launch captured in a CUDA graph draws a new field on each replay
// after the key there is rewritten (a graph freezes host arguments). Each
// thread loads the 8 key bytes through the read-only cache before its
// Philox call.
//
// Plain C interface, built with nvcc into a shared library and called
// through ctypes. The launch goes on the caller's stream; the function
// returns cudaGetLastError() so the wrapper can raise on a refused launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr uint32_t kPhiloxM0 = 0xD2511F53u;
constexpr uint32_t kPhiloxM1 = 0xCD9E8D57u;
constexpr uint32_t kPhiloxW0 = 0x9E3779B9u;
constexpr uint32_t kPhiloxW1 = 0xBB67AE85u;
constexpr int kThreads = 256;

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint32_t k0,
                                               uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r > 0) {
      k0 += kPhiloxW0;
      k1 += kPhiloxW1;
    }
    const uint32_t hi0 = __umulhi(kPhiloxM0, c.x);
    const uint32_t lo0 = kPhiloxM0 * c.x;
    const uint32_t hi1 = __umulhi(kPhiloxM1, c.z);
    const uint32_t lo1 = kPhiloxM1 * c.z;
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
  }
  return c;
}

__device__ __forceinline__ float to_unit(uint32_t w) {
  // top 24 bits, logical shift: exact U[0,1) on a 2^-24 grid
  return static_cast<float>(w >> 8) * (1.0f / 16777216.0f);
}

__global__ void __launch_bounds__(kThreads)
uniform_fields_kernel(float* __restrict__ out, int64_t per_field,
                      int64_t quads, const uint32_t* __restrict__ key,
                      int vec) {
  const int64_t q = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (q >= quads) return;
  const uint32_t k0 = __ldg(key);
  const uint32_t k1 = __ldg(key + 1);
  const uint32_t field = blockIdx.y;
  const uint4 r = philox4x32_10(
      make_uint4(static_cast<uint32_t>(q), field, 0u, 0u), k0, k1);
  float* dst = out + static_cast<int64_t>(field) * per_field + 4 * q;
  if (vec) {
    *reinterpret_cast<float4*>(dst) =
        make_float4(to_unit(r.x), to_unit(r.y), to_unit(r.z), to_unit(r.w));
    return;
  }
  const int64_t left = per_field - 4 * q;
  dst[0] = to_unit(r.x);
  if (left > 1) dst[1] = to_unit(r.y);
  if (left > 2) dst[2] = to_unit(r.z);
  if (left > 3) dst[3] = to_unit(r.w);
}

}  // namespace

// `key`: two uint32 words on the device (low word first, as split_seed).
extern "C" int uniform_fields_launch(float* out, int n, int size,
                                     const uint32_t* key, void* stream) {
  if (n <= 0 || size <= 0) return static_cast<int>(cudaSuccess);
  if (n > 65535 || key == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t per_field = static_cast<int64_t>(size) * size;
  const int64_t quads = (per_field + 3) / 4;
  const int vec = (per_field % 4 == 0) &&
                  (reinterpret_cast<uintptr_t>(out) % 16 == 0);
  const dim3 grid(static_cast<unsigned>((quads + kThreads - 1) / kThreads),
                  static_cast<unsigned>(n));
  uniform_fields_kernel<<<grid, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      out, per_field, quads, key, vec);
  return static_cast<int>(cudaGetLastError());
}
