// GroupedBatchNorm (+ReLU) train-mode passes for Hopper (sm_90a).
//
// Replaces no Pallas kernel. The JAX package writes GroupedBatchNorm
// (ust_run_tpu/models/layers.py) as plain jnp code and leaves it to XLA,
// which fuses the moments, the affine, the ReLU and their gradients into a
// few passes over each activation. PyTorch runs the same code as one
// kernel per operator: a float32 copy and its square, two moment
// reductions, two bf16 affine passes, a ReLU, and as many backward passes
// and adds, most of them PyTorch's non-vectorised broadcast fallback (a
// (n,c,1,1) tensor over a channels_last activation). These kernels are the
// passes XLA would have fused, written by hand
// (ust_run_tpu_torch/ops/grouped_bn.py is the autograd Function around
// them and holds their plain PyTorch versions):
//
//   sums (moments)  s1 = sum_hw x, s2 = sum_hw x^2          per sample
//   apply           y = x * inv[g] - shift[g], relu           in one rounding
//   sums (grad)     a = sum dy', b = sum dy' x                per group
//   input_grad      dx = dy' * inv[g] + ds1 + 2 x ds2         in one rounding
//
// where g = seg[sample], the sample's group, and dy' = dy masked where the
// ReLU's output is <= 0 (or dy without the ReLU). Statistics and the
// affine's arithmetic are float32 over bf16 or float32 activations; each
// output is rounded once to the activation's type.
//
// Layout: x, y, dy, dx are (n, c, h, w) channels_last in memory, i.e.
// (n, hw, c) rows of c channels; c a multiple of 8 (bf16) or 4 (float32) so
// that each thread moves 16 bytes along c; every pointer 16-byte aligned.
// inv and shift are (groups, c) float32, ds1 and ds2 (n, c) float32, seg
// (n,) int32, off (groups + 1,) int32 (group g is samples off[g] to
// off[g+1] - 1: groups are contiguous slices of the batch).
//
// Bound: bytes. Each pass reads its operands once and writes its output
// once, with a few flops an element (the card would need ~295 flops a byte
// to be bound by arithmetic): 2 B an element (bf16) for the moments, 4 for
// the apply, 4-6 for the gradient sums and 6-8 for the input gradient;
// ~6 B forward and ~14 B backward with the ReLU, against ~32 and ~80 B for
// PyTorch's operator chain. Measured on an H100 80GB HBM3 at 700 W (device
// time of captured calls, chip_smoke.py phase 3; PERF.md §6), share of the
// 3.35 TB/s byte bound: at the UNet's L1 student call (21x64x256^2 bf16)
// moments 68.6%, apply 85.6%, gradient sums 74.0%, input gradient 88.5%;
// at an R101 layer-3 call (21x1024x32^2 float32) 70.2%, 84.3%, 81.2%,
// 89.2%; at the UNet's 12x1024x16^2 teacher call, where a launch's latency
// is most of the time, 27.7-55.9%. The sums pay for their second pass and
// the slab partials; the elementwise passes come within 11-16% of the
// bound.
//
// Design. The reductions are two-stage and run in a fixed order with no
// float atomics, so that a step is bit-equal run to run
// (--deterministic 1): a block sums a slab of rows of one sample for a
// tile of channels, its threads each summing every ty-th row of the slab
// with 16-byte loads along c, then the block's ty partial rows in order in
// shared memory; the slabs' partials go to a scratch buffer the wrapper
// allocates, and `finish_kernel` sums them, sample by sample and slab by
// slab, per sample (moments) or per group (gradient sums). The tile and
// slab counts follow c (64-2048) and h*w (256-65536) so that even the
// smallest layers fill the 132 SMs (the wrapper's `plan`). The
// elementwise passes walk 16-byte vectors of one sample per grid row.
//
// Plain C interface, built with nvcc into a shared library and called
// through ctypes. Launches go on the caller's stream; each function returns
// cudaGetLastError() (cudaErrorInvalidValue for arguments it refuses) so
// the wrapper can raise on a refused launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kElementwiseBlocks = 4096;  // a few waves of 132 SMs x 8

template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void load(const float* p, float* v) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x;
    v[1] = t.y;
    v[2] = t.z;
    v[3] = t.w;
  }
  __device__ __forceinline__ static void store(float* p, const float* v) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void load(const __nv_bfloat16* p,
                                              float* v) {
    const uint4 t = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&t);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
  __device__ __forceinline__ static void store(__nv_bfloat16* p,
                                               const float* v) {
    uint4 t;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&t);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = t;
  }
};

// dy where the ReLU passed its input, as PyTorch's threshold_backward on
// the ReLU's output: 0 where y <= 0.
__device__ __forceinline__ float relu_grad(float g, float y) {
  return y <= 0.f ? 0.f : g;
}

// One block: rows [slab * rows, (slab + 1) * rows) of sample blockIdx.z,
// channels of tile blockIdx.y (tx threads x V channels). MODE 0: (x, x^2);
// MODE 1: (dy', dy' x). Writes part[slab][k][sample][channel].
template <typename T, int MODE>
__global__ void __launch_bounds__(kThreads)
sums_kernel(const T* __restrict__ x, const T* __restrict__ dy,
            const T* __restrict__ y, float* __restrict__ part, int n,
            int hw, int c, int tx, int rows, int relu) {
  constexpr int V = Vec<T>::N;
  extern __shared__ float smem[];  // [2][ty][tx * V]
  const int ty = kThreads / tx;
  const int width = tx * V;
  const int lx = threadIdx.x % tx;
  const int ly = threadIdx.x / tx;
  const int slab = blockIdx.x, tile = blockIdx.y, sample = blockIdx.z;
  const int vi = tile * tx + lx;  // this thread's 16-byte vector along c
  float a[V], b[V];
#pragma unroll
  for (int j = 0; j < V; ++j) a[j] = b[j] = 0.f;
  if (ly < ty && vi * V < c) {
    const int r0 = slab * rows;
    const int r1 = min(hw, r0 + rows);
    const int64_t base = static_cast<int64_t>(sample) * hw * c + vi * V;
#pragma unroll 4
    for (int r = r0 + ly; r < r1; r += ty) {
      const int64_t at = base + static_cast<int64_t>(r) * c;
      float xv[V];
      Vec<T>::load(x + at, xv);
      if (MODE == 0) {
#pragma unroll
        for (int j = 0; j < V; ++j) {
          a[j] += xv[j];
          b[j] += xv[j] * xv[j];
        }
      } else {
        float g[V];
        Vec<T>::load(dy + at, g);
        if (relu) {
          float yv[V];
          Vec<T>::load(y + at, yv);
#pragma unroll
          for (int j = 0; j < V; ++j) g[j] = relu_grad(g[j], yv[j]);
        }
#pragma unroll
        for (int j = 0; j < V; ++j) {
          a[j] += g[j];
          b[j] += g[j] * xv[j];
        }
      }
    }
  }
  if (ly < ty) {
#pragma unroll
    for (int j = 0; j < V; ++j) {
      smem[ly * width + lx * V + j] = a[j];
      smem[(ty + ly) * width + lx * V + j] = b[j];
    }
  }
  __syncthreads();
  // the block's ty partial rows, summed in order
  for (int o = threadIdx.x; o < 2 * width; o += kThreads) {
    const int k = o / width, cc = o % width;
    const int ch = tile * width + cc;
    if (ch >= c) continue;
    float s = 0.f;
    for (int t = 0; t < ty; ++t) s += smem[(k * ty + t) * width + cc];
    part[((static_cast<int64_t>(slab) * 2 + k) * n + sample) * c + ch] = s;
  }
}

// out[k][g][ch] = sum over the samples i of g (off[g] .. off[g+1] - 1, or
// i = g without off) and over the slabs s, in that order, of
// part[s][k][i][ch].
__global__ void __launch_bounds__(kThreads)
finish_kernel(const float* __restrict__ part, float* __restrict__ out,
              int slabs, int n, int c, const int* __restrict__ off,
              int groups) {
  const int64_t total = 2LL * groups * c;
  for (int64_t o = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       o < total; o += static_cast<int64_t>(gridDim.x) * kThreads) {
    const int k = static_cast<int>(o / (static_cast<int64_t>(groups) * c));
    const int rem = static_cast<int>(o % (static_cast<int64_t>(groups) * c));
    const int g = rem / c, ch = rem % c;
    const int i0 = off ? off[g] : g;
    const int i1 = off ? off[g + 1] : g + 1;
    float s = 0.f;
    for (int i = i0; i < i1; ++i)
      for (int sl = 0; sl < slabs; ++sl)
        s += part[((static_cast<int64_t>(sl) * 2 + k) * n + i) * c + ch];
    out[o] = s;
  }
}

// y = x * inv[g] - shift[g] (relu: then clamped at 0, NaN kept), one
// rounding. Grid row blockIdx.y is the sample.
template <typename T>
__global__ void __launch_bounds__(kThreads)
apply_kernel(const T* __restrict__ x, T* __restrict__ y,
             const float* __restrict__ inv, const float* __restrict__ shift,
             const int* __restrict__ seg, int hw, int c, int relu) {
  constexpr int V = Vec<T>::N;
  const int sample = blockIdx.y;
  const int cv = c / V;
  const int64_t per = static_cast<int64_t>(hw) * cv;
  const int64_t row = static_cast<int64_t>(__ldg(seg + sample)) * c;
  const int64_t start = static_cast<int64_t>(sample) * hw * c;
  for (int64_t v = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       v < per; v += static_cast<int64_t>(gridDim.x) * kThreads) {
    const int ch = static_cast<int>(v % cv) * V;
    float xv[V];
    Vec<T>::load(x + start + v * V, xv);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const float z = xv[j] * __ldg(inv + row + ch + j)
                      - __ldg(shift + row + ch + j);
      xv[j] = (relu && z < 0.f) ? 0.f : z;
    }
    Vec<T>::store(y + start + v * V, xv);
  }
}

// dx = dy' * inv[g] + ds1 + 2 x ds2, one rounding (ds1, ds2 per sample:
// the gradients of the sums s1 and s2).
template <typename T>
__global__ void __launch_bounds__(kThreads)
input_grad_kernel(const T* __restrict__ dy, const T* __restrict__ y,
                  const T* __restrict__ x, T* __restrict__ dx,
                  const float* __restrict__ inv,
                  const int* __restrict__ seg,
                  const float* __restrict__ ds1,
                  const float* __restrict__ ds2, int hw, int c, int relu) {
  constexpr int V = Vec<T>::N;
  const int sample = blockIdx.y;
  const int cv = c / V;
  const int64_t per = static_cast<int64_t>(hw) * cv;
  const int64_t row = static_cast<int64_t>(__ldg(seg + sample)) * c;
  const int64_t own = static_cast<int64_t>(sample) * c;
  const int64_t start = static_cast<int64_t>(sample) * hw * c;
  for (int64_t v = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       v < per; v += static_cast<int64_t>(gridDim.x) * kThreads) {
    const int ch = static_cast<int>(v % cv) * V;
    const int64_t at = start + v * V;
    float g[V], xv[V];
    Vec<T>::load(dy + at, g);
    Vec<T>::load(x + at, xv);
    if (relu) {
      float yv[V];
      Vec<T>::load(y + at, yv);
#pragma unroll
      for (int j = 0; j < V; ++j) g[j] = relu_grad(g[j], yv[j]);
    }
#pragma unroll
    for (int j = 0; j < V; ++j)
      g[j] = g[j] * __ldg(inv + row + ch + j) + __ldg(ds1 + own + ch + j)
             + 2.f * xv[j] * __ldg(ds2 + own + ch + j);
    Vec<T>::store(dx + at, g);
  }
}

int vec_of(int dtype) { return dtype == 1 ? 8 : 4; }

bool shape_ok(int dtype, int n, int hw, int c) {
  return (dtype == 0 || dtype == 1) && n > 0 && n <= 65535 && hw > 0 &&
         c > 0 && c % vec_of(dtype) == 0;
}

dim3 elementwise_grid(int n, int hw, int c, int dtype) {
  const int64_t per = static_cast<int64_t>(hw) * (c / vec_of(dtype));
  const int64_t want = (per + kThreads - 1) / kThreads;
  const int64_t cap = (kElementwiseBlocks + n - 1) / n;
  return dim3(static_cast<unsigned>(want < cap ? want : cap),
              static_cast<unsigned>(n));
}

template <typename T, int MODE>
void launch_sums(const void* x, const void* dy, const void* y, float* dst,
                 int n, int hw, int c, int tx, int slabs, int rows, int relu,
                 cudaStream_t stream) {
  const int ty = kThreads / tx;
  const int tiles = (c / Vec<T>::N + tx - 1) / tx;
  const size_t smem = 2u * ty * tx * Vec<T>::N * sizeof(float);
  sums_kernel<T, MODE><<<dim3(slabs, tiles, n), kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy),
      static_cast<const T*>(y), dst, n, hw, c, tx, rows, relu);
}

}  // namespace

// Sums over h*w of (x, x^2) (mode 0) or (dy', dy' x) (mode 1) into out:
// (2, n, c) per sample without `off`, (2, groups, c) per group with it.
// dtype 0: float32, 1: bf16. The plan (tx threads along c, `slabs` slabs
// of `rows` rows) is the wrapper's; `part` is its (slabs, 2, n, c) float32
// scratch, or null when slabs == 1 and off is null (the block sums go to
// out directly).
extern "C" int gbn_sums_launch(int mode, int dtype, const void* x,
                               const void* dy, const void* y, float* part,
                               float* out, const int* off, int groups, int n,
                               int hw, int c, int tx, int slabs, int rows,
                               int relu, void* stream) {
  if (!shape_ok(dtype, n, hw, c) || (mode != 0 && mode != 1) || tx < 1 ||
      tx > 32 || slabs < 1 || slabs > 65535 || rows < 1 ||
      static_cast<int64_t>(slabs) * rows < hw ||
      (c / vec_of(dtype) + tx - 1) / tx > 65535 ||
      (part == nullptr && (slabs != 1 || off != nullptr)) ||
      (off != nullptr && groups < 1) || (mode == 1 && dy == nullptr) ||
      (mode == 1 && relu && y == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* dst = part ? part : out;
  if (dtype == 1) {
    if (mode == 0)
      launch_sums<__nv_bfloat16, 0>(x, dy, y, dst, n, hw, c, tx, slabs,
                                    rows, relu, s);
    else
      launch_sums<__nv_bfloat16, 1>(x, dy, y, dst, n, hw, c, tx, slabs,
                                    rows, relu, s);
  } else {
    if (mode == 0)
      launch_sums<float, 0>(x, dy, y, dst, n, hw, c, tx, slabs, rows, relu,
                            s);
    else
      launch_sums<float, 1>(x, dy, y, dst, n, hw, c, tx, slabs, rows, relu,
                            s);
  }
  if (part != nullptr) {
    const int out_groups = off ? groups : n;
    const int64_t total = 2LL * out_groups * c;
    const int64_t blocks = (total + kThreads - 1) / kThreads;
    finish_kernel<<<static_cast<unsigned>(blocks < 4096 ? blocks : 4096),
                    kThreads, 0, s>>>(part, out, slabs, n, c, off,
                                      out_groups);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int gbn_apply_launch(int dtype, const void* x, void* y,
                                const float* inv, const float* shift,
                                const int* seg, int n, int hw, int c,
                                int relu, void* stream) {
  if (!shape_ok(dtype, n, hw, c))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid = elementwise_grid(n, hw, c, dtype);
  if (dtype == 1)
    apply_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(y),
        inv, shift, seg, hw, c, relu);
  else
    apply_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<float*>(y), inv, shift,
        seg, hw, c, relu);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int gbn_input_grad_launch(int dtype, const void* dy,
                                     const void* y, const void* x, void* dx,
                                     const float* inv, const int* seg,
                                     const float* ds1, const float* ds2,
                                     int n, int hw, int c, int relu,
                                     void* stream) {
  if (!shape_ok(dtype, n, hw, c) || (relu && y == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid = elementwise_grid(n, hw, c, dtype);
  if (dtype == 1)
    input_grad_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(dy),
        static_cast<const __nv_bfloat16*>(y),
        static_cast<const __nv_bfloat16*>(x),
        static_cast<__nv_bfloat16*>(dx), inv, seg, ds1, ds2, hw, c, relu);
  else
    input_grad_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(dy), static_cast<const float*>(y),
        static_cast<const float*>(x), static_cast<float*>(dx), inv, seg,
        ds1, ds2, hw, c, relu);
  return static_cast<int>(cudaGetLastError());
}
