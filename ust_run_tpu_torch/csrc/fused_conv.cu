// Fused BN-apply + ReLU + 3x3 convolution with a per-sample moment epilogue,
// for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel ust_run_tpu/ops/fused_conv.py:_kernel
// (reached through bn_relu_conv3x3), which computes in one pass
//
//     a        = relu(y * inv_n - shift_n)         f32, rounded to y's dtype
//     out      = conv3x3_same(a, w)                f32 accumulation, stored
//                                                  in y's dtype
//     m1, m2   = per-sample mean and mean-square of the f32 accumulator
//
// y is NHWC (B, H, W, C), w is (9, C, Co) in y's dtype (HWIO with the two
// spatial axes merged), inv_n / shift_n are (B, C) f32. The 'same' padding
// is zero in the POST-BN domain: a tap outside the image adds 0, not
// relu(-shift).
//
// Design (simple and right first): an implicit GEMM with M = output pixels,
// N = Co, K = 9*C.
//   * A block owns one sample, a TH x TW = 8 x 16 tile of output pixels
//     (M = 128; a tile never straddles two samples) and BN = 64 output
//     channels, with 256 threads.
//   * For each chunk of KC input channels it loads the (TH+2) x (TW+2) halo
//     of y, applies BN+ReLU in f32 (no FMA contraction, as the plain
//     version), rounds to y's dtype and stores it in shared memory; pixels
//     outside the image and channels >= C are stored as 0. It stages the
//     matching (9, KC, BN) slice of the weights, zero past C and Co.
//   * bf16: each warp owns a 32 x 32 piece of the tile and accumulates with
//     WMMA 16x16x16 bf16 fragments into f32. Every tap is a 16-pixel row of
//     the halo at a column offset, so A fragments are read straight from the
//     halo tile (row stride = one pixel's channels).
//   * f32: plain f32 FMA (the f32 path must stay full f32, no TF32), each
//     thread 8 pixels x 4 channels.
//   * Epilogue: the accumulator tile goes through shared memory; the block
//     writes `out` (masked at the ragged image edge and past Co) and its
//     per-channel partial sums of acc and acc^2 over its valid pixels into
//     scratch (B, tiles, Co). A second small kernel reduces the tiles of
//     each sample in a fixed order and divides by H*W. No atomics: the
//     result is deterministic. (The TPU kernel instead carried the sums in a
//     VMEM block across an ordered grid; Hopper blocks run in no order.)
//
// Bound (H100 SXM: 3.35 TB/s, 989 TFLOP/s dense bf16), bytes = y read once
// + out written once, FLOPs = 2*B*H*W*9*C*Co:
//   21x256^2x64->64   352 MB -> 105 us, 101.5 GFLOP -> 103 us: 105 us bytes
//   12x256^2x64->64   201 MB ->  60 us,  58.0 GFLOP ->  59 us:  60 us bytes
//   21x128^2x128->128 176 MB ->  53 us, 101.5 GFLOP -> 103 us: 103 us FLOPs
//   21x64^2x256->256   88 MB ->  26 us, 101.5 GFLOP -> 103 us: 103 us FLOPs
// So the layers are balanced between bytes and tensor-core rate. This
// first version uses WMMA (mma.sync underneath), synchronous loads and no
// pipelining, so it cannot reach either bound; wgmma, TMA and a ring of
// stages are the next step.
//
// Plain C interface, built with nvcc into a shared library and called
// through ctypes. Launches go on the caller's stream; the launch function
// returns cudaGetLastError() so the wrapper can raise on a refused launch.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int TH = 8;                 // output rows of a tile
constexpr int TW = 16;                // output columns of a tile
constexpr int BM = TH * TW;           // output pixels of a tile
constexpr int BN = 64;                // output channels of a tile
constexpr int HALO_H = TH + 2;
constexpr int HALO_W = TW + 2;
constexpr int THREADS = 256;
constexpr int LDC = BN + 8;           // f32 epilogue tile row stride
constexpr int PIX_GROUPS = THREADS / BN;   // moment partial sums per channel

template <typename T> struct Cfg;
// bf16: KC channels per chunk; LDA/LDB keep every WMMA fragment pointer
// 32-byte aligned (row strides of 96 and 160 bytes).
template <> struct Cfg<bf16> {
  static constexpr int KC = 32, LDA = 48, LDB = BN + 16;
};
template <> struct Cfg<float> {
  static constexpr int KC = 16, LDA = 16, LDB = BN + 4;
};

template <typename T>
constexpr int smem_bytes() {
  constexpr int a = HALO_H * HALO_W * Cfg<T>::LDA * sizeof(T);
  constexpr int b = 9 * Cfg<T>::KC * Cfg<T>::LDB * sizeof(T);
  constexpr int c = BM * LDC * sizeof(float) + 2 * PIX_GROUPS * BN * sizeof(float);
  return a + b > c ? a + b : c;
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f32<bf16>(float v) {
  return __float2bfloat16_rn(v);
}

// relu(y * inv - shift) in f32 with separate roundings (no FMA), then
// rounded to T: the arithmetic of the plain version, step by step.
template <typename T>
__device__ __forceinline__ T bn_relu(T v, float inv, float shift) {
  return from_f32<T>(fmaxf(__fsub_rn(__fmul_rn(to_f32(v), inv), shift), 0.f));
}

// Halo of one channel chunk: sA[(hh * HALO_W + ww) * LDA + k] for the input
// pixel (h0 + hh - 1, w0 + ww - 1) and channel c0 + k; 0 outside the image
// and past C. Groups of VEC channels move as one 16-byte load and store.
template <typename T>
__device__ void load_halo(T* sA, const T* __restrict__ y,
                          const float* __restrict__ inv,
                          const float* __restrict__ shift, int b, int h0,
                          int w0, int c0, int H, int W, int C, bool vec_ok) {
  constexpr int KC = Cfg<T>::KC, LDA = Cfg<T>::LDA;
  constexpr int VEC = 16 / sizeof(T);
  constexpr int GROUPS = KC / VEC;
  const float* inv_b = inv + static_cast<size_t>(b) * C;
  const float* shift_b = shift + static_cast<size_t>(b) * C;
  for (int i = threadIdx.x; i < HALO_H * HALO_W * GROUPS; i += THREADS) {
    const int g = i % GROUPS;
    const int pix = i / GROUPS;
    const int h = h0 + pix / HALO_W - 1;
    const int w = w0 + pix % HALO_W - 1;
    const int c = c0 + g * VEC;
    alignas(16) T vals[VEC];
    const bool inside = h >= 0 && h < H && w >= 0 && w < W;
    if (inside) {
      const T* src = y + ((static_cast<size_t>(b) * H + h) * W + w) * C + c;
      if (vec_ok && c + VEC <= C) {
        const uint4 raw = *reinterpret_cast<const uint4*>(src);
        const T* rv = reinterpret_cast<const T*>(&raw);
#pragma unroll
        for (int k = 0; k < VEC; ++k)
          vals[k] = bn_relu(rv[k], inv_b[c + k], shift_b[c + k]);
      } else {
#pragma unroll
        for (int k = 0; k < VEC; ++k)
          vals[k] = c + k < C ? bn_relu(src[k], inv_b[c + k], shift_b[c + k])
                              : from_f32<T>(0.f);
      }
    } else {
#pragma unroll
      for (int k = 0; k < VEC; ++k) vals[k] = from_f32<T>(0.f);
    }
    *reinterpret_cast<uint4*>(sA + pix * LDA + g * VEC) =
        *reinterpret_cast<const uint4*>(vals);
  }
}

// Weights of one channel chunk: sB[(tap * KC + k) * LDB + n] = w[tap][c0 + k]
// [n0 + n], 0 past C and Co.
template <typename T>
__device__ void load_weights(T* sB, const T* __restrict__ w, int c0, int n0,
                             int C, int Co, bool vec_ok) {
  constexpr int KC = Cfg<T>::KC, LDB = Cfg<T>::LDB;
  constexpr int VEC = 16 / sizeof(T);
  constexpr int GROUPS = BN / VEC;
  for (int i = threadIdx.x; i < 9 * KC * GROUPS; i += THREADS) {
    const int g = i % GROUPS;
    const int row = i / GROUPS;             // tap * KC + k
    const int c = c0 + row % KC;
    const int tap = row / KC;
    const int n = n0 + g * VEC;
    alignas(16) T vals[VEC];
    if (c < C) {
      const T* src = w + (static_cast<size_t>(tap) * C + c) * Co + n;
      if (vec_ok && n + VEC <= Co) {
        *reinterpret_cast<uint4*>(vals) = *reinterpret_cast<const uint4*>(src);
      } else {
#pragma unroll
        for (int k = 0; k < VEC; ++k)
          vals[k] = n + k < Co ? src[k] : from_f32<T>(0.f);
      }
    } else {
#pragma unroll
      for (int k = 0; k < VEC; ++k) vals[k] = from_f32<T>(0.f);
    }
    *reinterpret_cast<uint4*>(sB + row * LDB + g * VEC) =
        *reinterpret_cast<const uint4*>(vals);
  }
}

// The chunk's products, bf16 on the tensor cores: warp (wm, wn) owns tile
// rows 2*wm, 2*wm+1 (pixels 32*wm .. 32*wm+31) and channels 32*wn .. +31.
__device__ __forceinline__ void mma_chunk(
    const bf16* sA, const bf16* sB,
    nvcuda::wmma::fragment<nvcuda::wmma::accumulator, 16, 16, 16, float> (&acc)[2][2]) {
  using namespace nvcuda;
  constexpr int KC = Cfg<bf16>::KC, LDA = Cfg<bf16>::LDA, LDB = Cfg<bf16>::LDB;
  const int warp = threadIdx.x / 32;
  const int wm = warp % 4, wn = warp / 4;
#pragma unroll 1
  for (int tap = 0; tap < 9; ++tap) {
    const int di = tap / 3, dj = tap % 3;
#pragma unroll
    for (int kk = 0; kk < KC; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bm[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(
            a[i], sA + ((wm * 2 + i + di) * HALO_W + dj) * LDA + kk, LDA);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(
            bm[j], sB + (tap * KC + kk) * LDB + wn * 32 + j * 16, LDB);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(acc[i][j], a[i], bm[j], acc[i][j]);
    }
  }
}

// The chunk's products in f32 FMA: thread (tm, tn) owns tile column tm
// (all TH rows) and channels 4*tn .. 4*tn+3.
__device__ __forceinline__ void fma_chunk(const float* sA, const float* sB,
                                          float (&acc)[TH][4]) {
  constexpr int KC = Cfg<float>::KC, LDA = Cfg<float>::LDA, LDB = Cfg<float>::LDB;
  const int tn = threadIdx.x % 16, tm = threadIdx.x / 16;
#pragma unroll 1
  for (int tap = 0; tap < 9; ++tap) {
    const int di = tap / 3, dj = tap % 3;
#pragma unroll 4
    for (int k = 0; k < KC; ++k) {
      const float4 bv =
          *reinterpret_cast<const float4*>(sB + (tap * KC + k) * LDB + tn * 4);
#pragma unroll
      for (int r = 0; r < TH; ++r) {
        const float a = sA[((r + di) * HALO_W + tm + dj) * LDA + k];
        acc[r][0] = fmaf(a, bv.x, acc[r][0]);
        acc[r][1] = fmaf(a, bv.y, acc[r][1]);
        acc[r][2] = fmaf(a, bv.z, acc[r][2]);
        acc[r][3] = fmaf(a, bv.w, acc[r][3]);
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
bn_relu_conv3x3_kernel(const T* __restrict__ y, const float* __restrict__ inv,
                       const float* __restrict__ shift,
                       const T* __restrict__ w, T* __restrict__ out,
                       float* __restrict__ part, int B, int H, int W, int C,
                       int Co, int tiles_w, int vec_c, int vec_co) {
  constexpr int KC = Cfg<T>::KC, LDA = Cfg<T>::LDA;
  extern __shared__ __align__(128) unsigned char smem[];
  T* sA = reinterpret_cast<T*>(smem);
  T* sB = sA + HALO_H * HALO_W * LDA;
  float* sC = reinterpret_cast<float*>(smem);       // reused after the loop
  float* sRed = sC + BM * LDC;

  const int tile = blockIdx.x;
  const int n0 = blockIdx.y * BN;
  const int b = blockIdx.z;
  const int h0 = (tile / tiles_w) * TH;
  const int w0 = (tile % tiles_w) * TW;
  const int tiles = gridDim.x;

  if constexpr (sizeof(T) == 2) {
    using namespace nvcuda;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);
    for (int c0 = 0; c0 < C; c0 += KC) {
      __syncthreads();
      load_halo(sA, y, inv, shift, b, h0, w0, c0, H, W, C, vec_c);
      load_weights(sB, w, c0, n0, C, Co, vec_co);
      __syncthreads();
      mma_chunk(sA, sB, acc);
    }
    __syncthreads();
    const int warp = threadIdx.x / 32;
    const int wm = warp % 4, wn = warp / 4;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::store_matrix_sync(sC + (wm * 32 + i * 16) * LDC + wn * 32 + j * 16,
                                acc[i][j], LDC, wmma::mem_row_major);
  } else {
    float acc[TH][4];
#pragma unroll
    for (int r = 0; r < TH; ++r)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[r][j] = 0.f;
    for (int c0 = 0; c0 < C; c0 += KC) {
      __syncthreads();
      load_halo(sA, y, inv, shift, b, h0, w0, c0, H, W, C, vec_c);
      load_weights(sB, w, c0, n0, C, Co, vec_co);
      __syncthreads();
      fma_chunk(sA, sB, acc);
    }
    __syncthreads();
    const int tn = threadIdx.x % 16, tm = threadIdx.x / 16;
#pragma unroll
    for (int r = 0; r < TH; ++r)
#pragma unroll
      for (int j = 0; j < 4; ++j) sC[(r * TW + tm) * LDC + tn * 4 + j] = acc[r][j];
  }
  __syncthreads();

  // out, in y's dtype, masked at the ragged edge and past Co
  for (int i = threadIdx.x; i < BM * BN; i += THREADS) {
    const int n = i % BN, p = i / BN;
    const int h = h0 + p / TW, x = w0 + p % TW;
    if (h < H && x < W && n0 + n < Co)
      out[((static_cast<size_t>(b) * H + h) * W + x) * Co + n0 + n] =
          from_f32<T>(sC[p * LDC + n]);
  }

  // per-channel partial sums of acc and acc^2 over the tile's valid pixels,
  // in a fixed order: PIX_GROUPS groups of BM / PIX_GROUPS pixels, then the
  // groups in order
  {
    const int n = threadIdx.x % BN, g = threadIdx.x / BN;
    constexpr int PER = BM / PIX_GROUPS;
    float s1 = 0.f, s2 = 0.f;
    for (int p = g * PER; p < (g + 1) * PER; ++p) {
      if (h0 + p / TW < H && w0 + p % TW < W) {
        const float v = sC[p * LDC + n];
        s1 += v;
        s2 = fmaf(v, v, s2);
      }
    }
    sRed[g * BN + n] = s1;
    sRed[(PIX_GROUPS + g) * BN + n] = s2;
  }
  __syncthreads();
  if (threadIdx.x < BN && n0 + threadIdx.x < Co) {
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int g = 0; g < PIX_GROUPS; ++g) {
      s1 += sRed[g * BN + threadIdx.x];
      s2 += sRed[(PIX_GROUPS + g) * BN + threadIdx.x];
    }
    const size_t at = (static_cast<size_t>(b) * tiles + tile) * Co + n0 + threadIdx.x;
    part[at] = s1;
    part[static_cast<size_t>(B) * tiles * Co + at] = s2;
  }
}

// m1[b][n] = sum over tiles (in order) of part1[b][t][n] / (H*W); m2 alike.
__global__ void moments_reduce_kernel(const float* __restrict__ part,
                                      float* __restrict__ m1,
                                      float* __restrict__ m2, int B, int tiles,
                                      int Co, float hw) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B * Co) return;
  const int b = i / Co, n = i % Co;
  const float* p1 = part + static_cast<size_t>(b) * tiles * Co + n;
  const float* p2 = p1 + static_cast<size_t>(B) * tiles * Co;
  float s1 = 0.f, s2 = 0.f;
  for (int t = 0; t < tiles; ++t) {
    s1 += p1[static_cast<size_t>(t) * Co];
    s2 += p2[static_cast<size_t>(t) * Co];
  }
  m1[i] = s1 / hw;
  m2[i] = s2 / hw;
}

template <typename T>
int launch(const void* y, const float* inv, const float* shift, const void* w,
           void* out, float* m1, float* m2, float* part, int B, int H, int W,
           int C, int Co, cudaStream_t stream) {
  constexpr int kSmem = smem_bytes<T>();
  static const cudaError_t attr = cudaFuncSetAttribute(
      bn_relu_conv3x3_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  constexpr int VEC = 16 / sizeof(T);
  const int tiles_h = (H + TH - 1) / TH;
  const int tiles_w = (W + TW - 1) / TW;
  const dim3 grid(static_cast<unsigned>(tiles_h * tiles_w),
                  static_cast<unsigned>((Co + BN - 1) / BN),
                  static_cast<unsigned>(B));
  const int vec_c = C % VEC == 0 && reinterpret_cast<uintptr_t>(y) % 16 == 0;
  const int vec_co = Co % VEC == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  bn_relu_conv3x3_kernel<T><<<grid, THREADS, kSmem, stream>>>(
      static_cast<const T*>(y), inv, shift, static_cast<const T*>(w),
      static_cast<T*>(out), part, B, H, W, C, Co, tiles_w, vec_c, vec_co);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n = B * Co;
  moments_reduce_kernel<<<(n + 255) / 256, 256, 0, stream>>>(
      part, m1, m2, B, tiles_h * tiles_w, Co, static_cast<float>(H) * W);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Number of output tiles per sample: the wrapper allocates the moment
// scratch as (2, B, tiles, Co) f32.
int bn_relu_conv3x3_tiles(int H, int W) {
  return ((H + TH - 1) / TH) * ((W + TW - 1) / TW);
}

// dtype: 0 = float32, 1 = bfloat16. All pointers are device pointers of
// contiguous tensors: y (B,H,W,C), inv/shift (B,C) f32, w (9,C,Co), out
// (B,H,W,Co), m1/m2 (B,Co) f32, part (2,B,tiles,Co) f32 scratch.
int bn_relu_conv3x3_launch(int dtype, const void* y, const float* inv,
                           const float* shift, const void* w, void* out,
                           float* m1, float* m2, float* part, int B, int H,
                           int W, int C, int Co, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || Co <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(y, inv, shift, w, out, m1, m2, part, B, H, W, C, Co, s);
  if (dtype == 1)
    return launch<bf16>(y, inv, shift, w, out, m1, m2, part, B, H, W, C, Co, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
