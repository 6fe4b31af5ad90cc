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
// y is NHWC (B, H, W, C), inv_n / shift_n are (B, C) f32. The 'same'
// padding is zero in the POST-BN domain: a tap outside the image adds 0,
// not relu(-shift). Both routes are an implicit GEMM with M = output
// pixels, N = Co, K = 9*C, and write per-(sample, tile) partial sums of
// the f32 accumulator and its square into scratch; moments_reduce_kernel
// then sums the tiles of each sample in a fixed order and divides by H*W.
// No atomics: the moments are deterministic whatever order blocks run in.
// (The TPU kernel carried the sums in VMEM across an ordered grid; Hopper
// blocks run in no order.)
//
// Two routes, chosen by shape before the launch (bn_relu_conv3x3_route):
//
// Route 1, "tma_wgmma": bf16 with C % 8 == 0 and Co % 8 == 0 (the row
// strides a TMA tensor map needs to be 16-byte multiples). The product is
// taken transposed, out^T = W^T a^T: the wgmma M side is output channels
// (w comes as (9, Co, C), K-major), the N side is pixels.
//   * Tile: TH x TW = 16 x 16 output pixels by BN = 64 (Co <= 64) or 128
//     output channels. K goes in chunks of KC = 64 channels: one 128-byte
//     row per pixel, the span of the 128-byte swizzle.
//   * Persistent grid: one block per SM (183-216 KB of shared memory) walks
//     the (sample, pixel tile, N tile) list in a fixed order, N tile
//     fastest, so blocks that share a halo run at the same time and the
//     second read of it hits L2.
//   * Warp specialisation: one producer thread keeps TMA loads in flight
//     with full/empty mbarriers:
//       - the raw y halo, (TH+2) x (TW+2) pixels x KC channels (41 KB),
//         through a 4-D tensor map over (C, W, H, B) whose start
//         coordinates are -1 at the top and left edge; TMA fills
//         everything outside the tensor with 0. One stage: it is free as
//         soon as the consumers have transformed it, so the next chunk's
//         load overlaps this chunk's products;
//       - the weight slice of one tap, BN x KC, through a 3-D tensor map
//         over (C, Co, 9), in a ring of 4 stages. The weights (0.07-1.2
//         MB) stream from L2, one read per 256-pixel tile (0.4 GB per
//         microbench call). Keeping L1's 74 KB resident measured no
//         faster: the taps, not the weight stream, bound it.
//   * The BN prologue against TMA's zero fill: TMA writes a raw 0 outside
//     the image, and BN would turn it into relu(-shift). So the two
//     consumer warpgroups transform each halo stage once: relu(y*inv -
//     shift) with __fmul_rn/__fsub_rn and __float2bfloat16_rn (the plain
//     version's rounding), an explicit 0 for every halo pixel outside the
//     image, and inv = shift = 0 for every channel >= C, so the zero-filled
//     channels stay 0 (their weights are zero-filled too).
//   * A tap shifted by dj = 1 or 2 pixels starts off the 8-row core-matrix
//     grid of the raw halo, so no wgmma descriptor can address it there.
//     The transform therefore writes three activated copies (36 KB each),
//     copy[dj] row hh*16 + c = halo pixel (hh, c + dj), in the 128-byte
//     swizzle. Tap (di, dj) is then the 256 consecutive rows of copy[dj]
//     from row 16*di: a plain K-major B operand, 1024-byte aligned. Both
//     operands come from shared memory, so the nine taps' wgmma groups run
//     back to back (wait_group 1 releases the previous tap's weight stage).
//     Feeding A from registers through ldmatrix instead needs a wait for
//     every tap's group (ptxas lets the next tap's loads reuse registers
//     an in-flight wgmma still reads), and its ldmatrix traffic plus four
//     reads of each weight tile match the tensor time: 23-28% of the
//     bound on the card.
//   * Warpgroup g: BN = 128, channels 64g..64g+63 for all 256 pixels
//     (m64n256k16, 128 f32 accumulators a thread); BN = 64, all 64
//     channels for pixels 128g..128g+127 (m64n128k16).
//   * Epilogue: per-channel sums of acc and acc^2 over the valid pixels in
//     registers, then across the 4 lanes of a row by shuffles, then (BN =
//     64) the two warpgroups' halves in order through shared memory; `out`
//     rounded to bf16 goes through a [pixel][channel] tile in the copies'
//     space and leaves as 16-byte vector stores. (stmatrix.trans for that
//     tile measured slower: it pushed the BN = 64 variant into spills.)
//   * Tensor maps are encoded on the host for every launch with
//     cuTensorMapEncodeTiled, reached through the runtime's driver entry
//     point (no -lcuda), and passed as __grid_constant__ parameters.
//
// Route 0, "wmma": f32 at every shape (FMA, no TF32, 1e-4 parity with the
// plain version) and bf16 where C or Co is not a multiple of 8. A block
// owns one sample, TH x TW = 8 x 16 output pixels and BN = 64 channels;
// for each chunk of channels it loads the halo of y with BN+ReLU applied
// and the weight slice into shared memory, synchronously, and multiplies
// with WMMA 16x16x16 bf16 fragments (mma.sync) or f32 FMA.
//
// Bound (H100 SXM: 3.35 TB/s, 989 TFLOP/s dense bf16), bytes = y read once
// + out written once, FLOPs = 2*B*H*W*9*C*Co:
//   21x256^2x64->64   352 MB -> 105 us, 101.5 GFLOP -> 103 us: 105 us bytes
//   12x256^2x64->64   201 MB ->  60 us,  58.0 GFLOP ->  59 us:  60 us bytes
//   21x128^2x128->128 176 MB ->  53 us, 101.5 GFLOP -> 103 us: 103 us FLOPs
//   21x64^2x256->256   88 MB ->  26 us, 101.5 GFLOP -> 103 us: 103 us FLOPs
// Route 1 at these shapes runs 672-5376 work items over 132 SMs (5.1 to
// 40.7 rounds; L3's 672 leave the last round 9% full), reads the halo
// 1.27x over (18x18 pixels per 16x16 tile) and, at L2/L3, the weights
// from L2 once per tile. On an H100 it takes 0.40 / 0.25 / 0.27 / 0.27 ms
// at these shapes: 24-38% of the bound, the tensor cores at 230-380
// TFLOP/s. The BN+ReLU copies and the epilogue do not overlap the
// products, for want of shared memory to double buffer the copies (a
// 32-channel chunk with the 64-byte swizzle made room for that, but its
// wgmma ran at half the rate).
//
// ptxas (CUDA 12.8, sm_90a, -Xptxas -v), shared memory per block:
//   conv_kernel<128>: 168 registers (the cap for 9 warps), 44 bytes of
//                     spill stores, 221,264 bytes of dynamic shared memory
//   conv_kernel<64>:  159 registers, no spills, 187,472 bytes
//   route 0 (bf16 / f32): 64 / 90 registers, no spills, 63,360 / 50,688
//   moments_reduce_kernel: 38 registers
//
// Plain C interface, built with nvcc into a shared library and called
// through ctypes. Launches go on the caller's stream; the launch function
// returns cudaGetLastError() so the wrapper can raise on a refused launch.

#include <cuda.h>            // CUtensorMap and its enums; header only
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
           void* out, float* part, int B, int H, int W, int C, int Co,
           cudaStream_t stream) {
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
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// Route 1: TMA + mbarrier ring + wgmma (bf16, C % 8 == 0, Co % 8 == 0)
// ---------------------------------------------------------------------------
namespace tma {

constexpr int TH = 16, TW = 16;            // output pixels of a tile
constexpr int BM = TH * TW;                // 256
constexpr int HH = TH + 2, HW = TW + 2;    // halo rows, columns
constexpr int KC = 64;                     // channels per chunk: 128 bytes
constexpr int ROW = KC * 2;                // bytes of one pixel's chunk
constexpr int HALO_BYTES = HH * HW * ROW;  // 41,472
constexpr int HALO_STAGE = (HALO_BYTES + 1023) / 1024 * 1024;
constexpr int COPY_ROWS = HH * TW;         // 288 pixels of one shifted copy
constexpr int COPY_BYTES = COPY_ROWS * ROW;  // 36,864 = 36 x 1024
constexpr int CONSUMERS = 256;             // two warpgroups
constexpr int THREADS = CONSUMERS + 32;    // and one producer warp
constexpr int SPIN_LIMIT = 1 << 24;        // see mbar_wait

// BN = output channels of a tile. BN = 64: both warpgroups hold the 64
// channels, each for 128 of the 256 pixels (m64n128). BN = 128: each
// warpgroup holds 64 channels for all 256 pixels (m64n256).
template <int BN> struct Cfg {
  static constexpr int NPIX = BN == 64 ? 128 : 256;   // pixels a wgmma spans
  static constexpr int ACC = NPIX / 2;                // f32 per thread
  static constexpr int W_STAGE = BN * ROW;
  static constexpr int W_STAGES = 4;                  // weight ring
  static constexpr int OUT_LD = BN * 2 + 16;          // staging row, bytes
  // shared memory: raw halo | 3 shifted activated copies (also the `out`
  // staging tile after the last chunk) | weight ring | moment scratch |
  // mbarriers
  static constexpr int halo = 0;
  static constexpr int copies = halo + HALO_STAGE;
  static constexpr int w = copies + 3 * COPY_BYTES;
  static constexpr int red = w + W_STAGES * W_STAGE;
  static constexpr int bars = red + 2 * BN * 2 * 4;
  static constexpr int bytes = bars + 2 * (1 + W_STAGES) * 8;
  static_assert(bytes + 1024 <= 232448, "fits the 227 KB a block may use");
  static constexpr int alloc = bytes + 1024;          // base alignment slack
  static_assert(BM * OUT_LD <= 3 * COPY_BYTES, "out staging fits the copies");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

// Waits until the barrier's phase differs from `parity`. A wait that never
// ends (a lost arrival) traps, so a fault ends the launch with an error
// instead of holding the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  for (int spins = 0;; ++spins) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if (spins == SPIN_LIMIT) __trap();
  }
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3) : "memory");
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2) : "memory");
}

__device__ __forceinline__ void named_sync_consumers() {
  asm volatile("bar.sync 1, %0;" ::"n"(CONSUMERS) : "memory");
}

// Shared-memory descriptor of a K-major, 128-byte-swizzled operand: rows of
// 128 bytes, 8-row groups 1024 bytes apart (SBO), layout type 1 (B128).
__device__ __forceinline__ uint64_t desc_b128(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}
// Keeps the compiler from moving reads or writes of an accumulator across
// the wgmma fence and wait instructions.
template <int N>
__device__ __forceinline__ void fence_operands(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d += A (64x16, shared memory) * B (16x128, shared memory), both K-major
// with the 128-byte swizzle: wgmma m64n128k16, f32 accumulators.
__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t desc_a,
                                           uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(1)
      : "memory");
}

// d += A (64x16, shared memory) * B (16x256, shared memory), both K-major
// with the 128-byte swizzle: wgmma m64n256k16, f32 accumulators.
__device__ __forceinline__ void wgmma_n256(float (&d)[128], uint64_t desc_a,
                                           uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71,"
      "%72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87,"
      "%88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103,"
      "%104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119,"
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
        "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "l"(desc_a), "l"(desc_b), "r"(1)
      : "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_tile(float (&d)[N / 2], uint64_t desc_a,
                                           uint64_t desc_b) {
  if constexpr (N == 128) wgmma_n128(d, desc_a, desc_b);
  else wgmma_n256(d, desc_a, desc_b);
}

__device__ __forceinline__ uint32_t bn_relu_pair(uint32_t raw, float i0,
                                                 float s0, float i1,
                                                 float s1) {
  const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(&raw);
  const __nv_bfloat162 r = __halves2bfloat162(
      __float2bfloat16_rn(fmaxf(__fsub_rn(__fmul_rn(__low2float(v), i0), s0), 0.f)),
      __float2bfloat16_rn(fmaxf(__fsub_rn(__fmul_rn(__high2float(v), i1), s1), 0.f)));
  return *reinterpret_cast<const uint32_t*>(&r);
}

template <int BN>
__global__ void __launch_bounds__(THREADS, 1)
conv_kernel(const __grid_constant__ CUtensorMap ymap,
            const __grid_constant__ CUtensorMap wmap,
            const float* __restrict__ inv, const float* __restrict__ shift,
            bf16* __restrict__ out, float* __restrict__ part, int B, int H,
            int W, int C, int Co, int tiles_w, int tiles, int n_tiles,
            int items) {
  using S = Cfg<BN>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t base = smem_u32(smem);
  const uint32_t halo_full = base + S::bars;
  const uint32_t halo_empty = halo_full + 8;
  const uint32_t w_full = halo_empty + 8;
  const uint32_t w_empty = w_full + S::W_STAGES * 8;
  const int chunks = (C + KC - 1) / KC;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(halo_full, 1);
    mbar_init(halo_empty, CONSUMERS / 32);
    for (int s = 0; s < S::W_STAGES; ++s) {
      mbar_init(w_full + 8 * s, 1);
      mbar_init(w_empty + 8 * s, CONSUMERS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == CONSUMERS / 32) {
    // producer: one thread keeps the halo stage and the weight ring full
    if (lane != 0) return;
    int ws = 0;
    uint32_t hphase = 0, wphase = 0;
    for (int item = blockIdx.x; item < items; item += gridDim.x) {
      const int n0 = (item % n_tiles) * BN;
      const int t = item / n_tiles;
      const int tile = t % tiles, b = t / tiles;
      const int h0 = (tile / tiles_w) * TH, w0 = (tile % tiles_w) * TW;
      for (int k = 0; k < chunks; ++k) {
        mbar_wait(halo_empty, hphase ^ 1);
        mbar_expect_tx(halo_full, HALO_BYTES);
        tma_load_4d(base + S::halo, &ymap, halo_full, k * KC, w0 - 1, h0 - 1,
                    b);
        hphase ^= 1;
        for (int tap = 0; tap < 9; ++tap) {
          mbar_wait(w_empty + 8 * ws, wphase ^ 1);
          mbar_expect_tx(w_full + 8 * ws, S::W_STAGE);
          tma_load_3d(base + S::w + ws * S::W_STAGE, &wmap, w_full + 8 * ws,
                      k * KC, n0, tap);
          if (++ws == S::W_STAGES) { ws = 0; wphase ^= 1; }
        }
      }
    }
    return;
  }

  // consumers. Warpgroup g multiplies the channel block mrow (64 rows of
  // the weight stage) by pixels pix0 .. pix0 + NPIX - 1 of the tile.
  const int tid = threadIdx.x;
  const int g = warp / 4, wq = warp % 4;
  const int mrow = BN == 64 ? 0 : 64 * g;
  const int pix0 = BN == 64 ? 128 * g : 0;
  const int tj = tid % 8;                 // this thread's 16-byte chunk
  int ws = 0;
  uint32_t hphase = 0, wphase = 0;
  float* red = reinterpret_cast<float*>(smem + S::red);

  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const int n0 = (item % n_tiles) * BN;
    const int t = item / n_tiles;
    const int tile = t % tiles, b = t / tiles;
    const int h0 = (tile / tiles_w) * TH, w0 = (tile % tiles_w) * TW;

    float acc[S::ACC];
#pragma unroll
    for (int i = 0; i < S::ACC; ++i) acc[i] = 0.f;

    for (int k = 0; k < chunks; ++k) {
      // BN + ReLU of the raw halo into three copies shifted by dj = 0, 1,
      // 2 columns: copy[dj] row hh * TW + c holds halo pixel (hh, c + dj),
      // so tap (di, dj) reads the 256 consecutive rows from di * TW on. 0
      // outside the image and past C; rows keep the 128-byte swizzle.
      float iv[8], sh[8];
      const int c0 = k * KC + tj * 8;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const bool in = c0 + e < C;
        iv[e] = in ? inv[static_cast<size_t>(b) * C + c0 + e] : 0.f;
        sh[e] = in ? shift[static_cast<size_t>(b) * C + c0 + e] : 0.f;
      }
      mbar_wait(halo_full, hphase);
      hphase ^= 1;
      for (int q = tid / 8; q < HH * HW; q += CONSUMERS / 8) {
        const int hh = q / HW, ww = q % HW;
        const int h = h0 - 1 + hh, x = w0 - 1 + ww;
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (h >= 0 && h < H && x >= 0 && x < W) {
          const uint4 raw = *reinterpret_cast<const uint4*>(
              smem + S::halo + q * ROW + ((tj ^ (q & 7)) << 4));
          v.x = bn_relu_pair(raw.x, iv[0], sh[0], iv[1], sh[1]);
          v.y = bn_relu_pair(raw.y, iv[2], sh[2], iv[3], sh[3]);
          v.z = bn_relu_pair(raw.z, iv[4], sh[4], iv[5], sh[5]);
          v.w = bn_relu_pair(raw.w, iv[6], sh[6], iv[7], sh[7]);
        }
#pragma unroll
        for (int dj = 0; dj < 3; ++dj) {
          const int c = ww - dj;
          if (c >= 0 && c < TW) {
            const int row = hh * TW + c;
            *reinterpret_cast<uint4*>(smem + S::copies + dj * COPY_BYTES +
                                      row * ROW + ((tj ^ (row & 7)) << 4)) = v;
          }
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(halo_empty);   // the next chunk may land
      // generic-proxy writes, read next by wgmma (async proxy)
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      named_sync_consumers();

      fence_operands(acc);
      wgmma_fence();
      int prev_ws = -1;
#pragma unroll 1
      for (int tap = 0; tap < 9; ++tap) {
        const int di = tap / 3, dj = tap % 3;
        const uint32_t bsrc = base + S::copies + dj * COPY_BYTES +
                              (di * TW + pix0) * ROW;
        mbar_wait(w_full + 8 * ws, wphase);
        const uint32_t asrc = base + S::w + ws * S::W_STAGE + mrow * ROW;
#pragma unroll
        for (int ks = 0; ks < 4; ++ks)
          wgmma_tile<S::NPIX>(acc, desc_b128(asrc + ks * 32),
                              desc_b128(bsrc + ks * 32));
        wgmma_commit();
        // the previous tap's group is done: release its weight stage
        wgmma_wait<1>();
        if (prev_ws >= 0) {
          __syncwarp();
          if (lane == 0) mbar_arrive(w_empty + 8 * prev_ws);
        }
        prev_ws = ws;
        if (++ws == S::W_STAGES) { ws = 0; wphase ^= 1; }
      }
      wgmma_wait<0>();
      fence_operands(acc);
      __syncwarp();
      if (lane == 0) mbar_arrive(w_empty + 8 * prev_ws);
      // every warpgroup is done with the copies before they are rewritten
      named_sync_consumers();
    }

    // epilogue. acc[4j + e]: channel row crow (+8 for e >= 2), tile pixel
    // pix0 + 8j + 2 (lane%4) + (e & 1); `out` goes in bf16 into a
    // [pixel][channel] tile in the copies' space
    float s1[2] = {0.f, 0.f}, s2[2] = {0.f, 0.f};
    uint8_t* stage = smem + S::copies;
    const int crow = mrow + 16 * wq + lane / 4;
#pragma unroll
    for (int j = 0; j < S::NPIX / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int p = pix0 + 8 * j + 2 * (lane % 4) + (e & 1);
        const float v = acc[4 * j + e];
        if (h0 + p / TW < H && w0 + p % TW < W) {
          s1[e >> 1] += v;
          s2[e >> 1] = fmaf(v, v, s2[e >> 1]);
        }
        *reinterpret_cast<bf16*>(stage + p * S::OUT_LD +
                                 (crow + 8 * (e >> 1)) * 2) =
            __float2bfloat16_rn(v);
      }
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
#pragma unroll
      for (int o = 1; o < 4; o <<= 1) {
        s1[hf] += __shfl_xor_sync(0xffffffffu, s1[hf], o);
        s2[hf] += __shfl_xor_sync(0xffffffffu, s2[hf], o);
      }
    if (lane % 4 == 0) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int n = crow + 8 * hf;
        red[(g * BN + n) * 2] = s1[hf];
        red[(g * BN + n) * 2 + 1] = s2[hf];
      }
    }
    named_sync_consumers();

    // moments: BN = 128 has each channel in one warpgroup; BN = 64 adds the
    // two warpgroups' pixel halves, first then second
    if (tid < BN && n0 + tid < Co) {
      float m1 = red[tid * 2], m2 = red[tid * 2 + 1];
      if (BN == 64) {
        m1 += red[(BN + tid) * 2];
        m2 += red[(BN + tid) * 2 + 1];
      } else if (tid >= 64) {
        m1 = red[(BN + tid) * 2];
        m2 = red[(BN + tid) * 2 + 1];
      }
      const size_t at = (static_cast<size_t>(b) * tiles + tile) * Co + n0 + tid;
      part[at] = m1;
      part[static_cast<size_t>(B) * tiles * Co + at] = m2;
    }
    // out: 16-byte stores of each pixel's BN channels
    constexpr int PER_ROW = BN / 8;
    for (int i = tid; i < BM * PER_ROW; i += CONSUMERS) {
      const int p = i / PER_ROW, ch = i % PER_ROW;
      const int h = h0 + p / TW, x = w0 + p % TW, n = n0 + ch * 8;
      if (h < H && x < W && n < Co)
        *reinterpret_cast<uint4*>(
            out + ((static_cast<size_t>(b) * H + h) * W + x) * Co + n) =
            *reinterpret_cast<const uint4*>(stage + p * S::OUT_LD + ch * 16);
    }
    // the staging tile and `red` are free before the next transform
    named_sync_consumers();
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the runtime already loaded, so
// the library links no -lcuda.
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                     cudaEnableDefault, &q);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                            &q);
#endif
    return q == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiled>(p)
                                            : nullptr;
  }();
  return fn;
}

int sm_count() {
  static const int n = [] {
    int dev = 0, count = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
    return count > 0 ? count : 1;
  }();
  return n;
}

template <int BN>
int launch(const void* y, const float* inv, const float* shift, const void* w,
           void* out, float* part, int B, int H, int W, int C, int Co,
           cudaStream_t stream) {
  using S = Cfg<BN>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      conv_kernel<BN>, cudaFuncAttributeMaxDynamicSharedMemorySize, S::alloc);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorSymbolNotFound);

  // y as (C, W, H, B), innermost first; boxes of KC x (TW+2) x (TH+2) x 1
  CUtensorMap ymap, wmap;
  const cuuint64_t ydim[4] = {static_cast<cuuint64_t>(C),
                              static_cast<cuuint64_t>(W),
                              static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t ystride[3] = {static_cast<cuuint64_t>(C) * 2,
                                 static_cast<cuuint64_t>(W) * C * 2,
                                 static_cast<cuuint64_t>(H) * W * C * 2};
  const cuuint32_t ybox[4] = {KC, HW, HH, 1};
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  CUresult r = encode(&ymap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                      const_cast<void*>(y), ydim, ystride, ybox, ones,
                      CU_TENSOR_MAP_INTERLEAVE_NONE,
                      CU_TENSOR_MAP_SWIZZLE_128B,
                      CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return static_cast<int>(cudaErrorInvalidValue);
  // w as (C, Co, 9): one tap's BN x KC slice, K-major
  const cuuint64_t wdim[3] = {static_cast<cuuint64_t>(C),
                              static_cast<cuuint64_t>(Co), 9};
  const cuuint64_t wstride[2] = {static_cast<cuuint64_t>(C) * 2,
                                 static_cast<cuuint64_t>(Co) * C * 2};
  const cuuint32_t wbox[3] = {KC, BN, 1};
  r = encode(&wmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(w),
             wdim, wstride, wbox, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return static_cast<int>(cudaErrorInvalidValue);

  const int tiles_w = (W + TW - 1) / TW;
  const int tiles = ((H + TH - 1) / TH) * tiles_w;
  const int n_tiles = (Co + BN - 1) / BN;
  const long long items = static_cast<long long>(B) * tiles * n_tiles;
  if (items > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const int grid = static_cast<int>(items < sm_count() ? items : sm_count());
  conv_kernel<BN><<<grid, THREADS, S::alloc, stream>>>(
      ymap, wmap, inv, shift, static_cast<bf16*>(out), part, B, H, W, C, Co,
      tiles_w, tiles, n_tiles, static_cast<int>(items));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tma

// Route and tile geometry: route 1 (TMA + wgmma) takes bf16 where C and Co
// are multiples of 8, route 0 (WMMA / f32 FMA) everything else.
int route_of(int dtype, int C, int Co) {
  return dtype == 1 && C % 8 == 0 && Co % 8 == 0 ? 1 : 0;
}
int tile_h(int route) { return route == 1 ? tma::TH : TH; }
int tile_w(int route) { return route == 1 ? tma::TW : TW; }
int tile_n(int route, int Co) { return route == 1 && Co > 64 ? 128 : 64; }
int tile_k(int dtype, int route) {
  return route == 1 ? tma::KC : dtype == 0 ? Cfg<float>::KC : Cfg<bf16>::KC;
}
int tiles_of(int route, int H, int W) {
  return ((H + tile_h(route) - 1) / tile_h(route)) *
         ((W + tile_w(route) - 1) / tile_w(route));
}

}  // namespace

extern "C" {

// The route a launch takes: 1 = TMA + wgmma, 0 = WMMA / f32 FMA.
int bn_relu_conv3x3_route(int dtype, int C, int Co) {
  return route_of(dtype, C, Co);
}

// Output rows and columns of one tile of `route`.
int bn_relu_conv3x3_tile_h(int route) { return tile_h(route); }
int bn_relu_conv3x3_tile_w(int route) { return tile_w(route); }

// Output channels of one tile, and input channels of one K chunk (the
// last chunk of a C that is no multiple of it is partial).
int bn_relu_conv3x3_tile_n(int route, int Co) { return tile_n(route, Co); }
int bn_relu_conv3x3_tile_k(int dtype, int route) {
  return tile_k(dtype, route);
}

// Number of output tiles per sample on `route`: the wrapper allocates the
// moment scratch as (2, B, tiles, Co) f32.
int bn_relu_conv3x3_tiles(int route, int H, int W) {
  return tiles_of(route, H, W);
}

// dtype: 0 = float32, 1 = bfloat16. All pointers are device pointers of
// contiguous tensors: y (B,H,W,C), inv/shift (B,C) f32, w (9,C,Co) on
// route 0 and (9,Co,C) on route 1 (y and w 16-byte aligned there), out
// (B,H,W,Co), m1/m2 (B,Co) f32, part (2,B,tiles,Co) f32 scratch.
int bn_relu_conv3x3_launch(int dtype, const void* y, const float* inv,
                           const float* shift, const void* w, void* out,
                           float* m1, float* m2, float* part, int B, int H,
                           int W, int C, int Co, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || Co <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype != 0 && dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int route = route_of(dtype, C, Co);
  int err;
  if (route == 1) {
    if (reinterpret_cast<uintptr_t>(y) % 16 || reinterpret_cast<uintptr_t>(w) % 16)
      return static_cast<int>(cudaErrorMisalignedAddress);
    err = tile_n(route, Co) == 64
        ? tma::launch<64>(y, inv, shift, w, out, part, B, H, W, C, Co, s)
        : tma::launch<128>(y, inv, shift, w, out, part, B, H, W, C, Co, s);
  } else {
    if (B > 65535) return static_cast<int>(cudaErrorInvalidValue);
    err = dtype == 0
        ? launch<float>(y, inv, shift, w, out, part, B, H, W, C, Co, s)
        : launch<bf16>(y, inv, shift, w, out, part, B, H, W, C, Co, s);
  }
  if (err != 0) return err;
  const int n = B * Co;
  moments_reduce_kernel<<<(n + 255) / 256, 256, 0, s>>>(
      part, m1, m2, B, tiles_of(route, H, W), Co, static_cast<float>(H) * W);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
