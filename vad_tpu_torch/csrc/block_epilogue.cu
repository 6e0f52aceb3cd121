// The end of a folded encoder block or decoder layer of the ConvLSTM video
// autoencoder, for Hopper (sm_90a), plain C interface: kernel 7.
//
// Replaces no Pallas kernel.  In the JAX package XLA fuses the bias add,
// the inference BatchNorm, the max-pool and the activation into the
// convolution's epilogue; PyTorch's eager path ran them as separate passes
// over the convolution's output (a broadcast bias add, BatchNorm's
// channels-last transform, max-pool, the activation), each reading and
// rewriting a whole activation.  With inference BatchNorm folded into the
// convolution's weights and bias (ops/block_epilogue.py `fold_blocks`),
// what is left after cuDNN returns is one pass:
//     ENCODER  out = leaky(max_2x2(y) + b)      (blocks 2-4; the pool
//              comes first: b is constant per channel and the BatchNorm
//              scale's sign is already in the weight)
//     DECODER  out = relu(y + b)                (decoder layers 1-3)
//     LAST     out = tanh(y + b)                (the 3-channel output)
// y is the bias-free convolution output, NHWC (channels-last), f32 or
// bf16; every operation runs in f32 and the result is rounded once to y's
// type.
//
// Bound: a handful of operations per byte, so the bytes bound it: y read
// once and the result written once.  At the serving shape (256 frames of
// 256x256, bf16) the seven calls of a chunk move 2.23 GB, 0.67 ms at
// 3.35 TB/s (benchmark/counts_epilogue.py).  So:
// - in the vector modes a thread owns 8 channels of one output pixel and
//   moves them as 16-byte words (two for f32), neighbouring threads on
//   neighbouring channel groups, so a warp's loads are whole 128-byte
//   lines; in ENCODER mode it loads the four inputs of its 2x2 window;
// - each thread keeps 4 words of loads in flight (ENCODER: its window;
//   DECODER: 4 pixels a grid stride apart), enough to cover the memory
//   latency at full occupancy;
// - a grid-stride loop whose stride is a multiple of the channel groups
//   (of 3 in LAST mode), so a thread's channels never change and its bias
//   stays in registers;
// - LAST mode (3 channels, no 16-byte pixel) uses scalar accesses, 8 in
//   flight a thread.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int VEC = 8;             // channels a thread in the vector modes
constexpr int IN_FLIGHT = 4;       // 16-byte words of loads a thread keeps in flight
constexpr int SCALAR_UNROLL = 8;   // scalar loads in flight a thread (LAST)
constexpr int BLOCKS_PER_SM = 8;   // 2,048 threads: a full SM

enum Mode { ENCODER = 0, DECODER = 1, LAST = 2 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// 8 values as 16-byte words: one for bf16, two for f32.
template <typename T> struct Words { static constexpr int n = VEC * (int)sizeof(T) / 16; };

template <typename T>
__device__ __forceinline__ void load8(const T* __restrict__ src, uint4 (&w)[Words<T>::n]) {
#pragma unroll
  for (int i = 0; i < Words<T>::n; ++i) w[i] = __ldg(reinterpret_cast<const uint4*>(src) + i);
}

template <typename T>
__device__ __forceinline__ void unpack8(const uint4 (&w)[Words<T>::n], float (&v)[VEC]) {
  const T* e = reinterpret_cast<const T*>(w);
#pragma unroll
  for (int j = 0; j < VEC; ++j) v[j] = to_f32(e[j]);
}

template <typename T>
__device__ __forceinline__ void store8(T* __restrict__ dst, const float (&v)[VEC]) {
  uint4 w[Words<T>::n];
  T* e = reinterpret_cast<T*>(w);
#pragma unroll
  for (int j = 0; j < VEC; ++j) e[j] = from_f32<T>(v[j]);
#pragma unroll
  for (int i = 0; i < Words<T>::n; ++i) reinterpret_cast<uint4*>(dst)[i] = w[i];
}

__device__ __forceinline__ float max_nan(float m, float v) {
  return (v > m || v != v) ? v : m;  // a NaN sticks, as PyTorch's max-pool
}

__device__ __forceinline__ float leaky(float v, float slope) { return v > 0.0f ? v : v * slope; }
__device__ __forceinline__ float relu(float v) { return v < 0.0f ? 0.0f : v; }  // NaN stays

// ENCODER: units are (output pixel, channel group) of [F, H/2, W/2, C];
// x is [F, H, W, C].  One window a thread per grid step.
template <typename T>
__global__ void __launch_bounds__(THREADS)
    block_epilogue_kernel_encoder(const T* __restrict__ x, const float* __restrict__ bias,
                                  T* __restrict__ out, int units, int Wo, int C, float slope) {
  const int groups = C / VEC;
  const int stride = gridDim.x * THREADS;  // a multiple of groups (the host's grid)
  int u = blockIdx.x * THREADS + threadIdx.x;
  const int k = (u % groups) * VEC;
  float b[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) b[j] = bias[k + j];
  const long long row_elems = 2LL * Wo * C;  // one input row
  for (; u < units; u += stride) {
    const int p = u / groups;  // (f*Ho + py)*Wo + px
    const int px = p % Wo;
    const long long o0 = (2LL * (p / Wo) * row_elems) + 2LL * px * C + k;
    uint4 w[4][Words<T>::n];
    load8<T>(x + o0, w[0]);
    load8<T>(x + o0 + C, w[1]);
    load8<T>(x + o0 + row_elems, w[2]);
    load8<T>(x + o0 + row_elems + C, w[3]);
    float m[VEC], v[VEC];
    unpack8<T>(w[0], m);
#pragma unroll
    for (int q = 1; q < 4; ++q) {
      unpack8<T>(w[q], v);
#pragma unroll
      for (int j = 0; j < VEC; ++j) m[j] = max_nan(m[j], v[j]);
    }
#pragma unroll
    for (int j = 0; j < VEC; ++j) m[j] = leaky(m[j] + b[j], slope);
    store8<T>(out + (long long)p * C + k, m);
  }
}

// DECODER: units are (pixel, channel group) of [F, H, W, C], in and out.
// UNROLL pixels a grid stride apart a thread per grid step.
template <typename T>
__global__ void __launch_bounds__(THREADS)
    block_epilogue_kernel_decoder(const T* __restrict__ x, const float* __restrict__ bias,
                                  T* __restrict__ out, int units, int C) {
  constexpr int UNROLL = IN_FLIGHT / Words<T>::n;
  const int groups = C / VEC;
  const int stride = gridDim.x * THREADS;  // a multiple of groups
  int u = blockIdx.x * THREADS + threadIdx.x;
  const int k = (u % groups) * VEC;
  float b[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) b[j] = bias[k + j];
  for (; u < units; u += UNROLL * stride) {
    uint4 w[UNROLL][Words<T>::n];
#pragma unroll
    for (int r = 0; r < UNROLL; ++r) {
      const int ur = u + r * stride;
      if (ur < units) load8<T>(x + (long long)(ur / groups) * C + k, w[r]);
    }
#pragma unroll
    for (int r = 0; r < UNROLL; ++r) {
      const int ur = u + r * stride;
      if (ur >= units) break;
      float v[VEC];
      unpack8<T>(w[r], v);
#pragma unroll
      for (int j = 0; j < VEC; ++j) v[j] = relu(v[j] + b[j]);
      store8<T>(out + (long long)(ur / groups) * C + k, v);
    }
  }
}

// LAST: elements of [F, H, W, C] with C small (3); scalar accesses.
template <typename T>
__global__ void __launch_bounds__(THREADS)
    block_epilogue_kernel_last(const T* __restrict__ x, const float* __restrict__ bias,
                               T* __restrict__ out, long long n, int C) {
  const long long stride = (long long)gridDim.x * THREADS;  // a multiple of C
  long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  const float b = bias[i % C];
  for (; i < n; i += SCALAR_UNROLL * stride) {
    T v[SCALAR_UNROLL];
#pragma unroll
    for (int r = 0; r < SCALAR_UNROLL; ++r) {
      const long long ir = i + r * stride;
      if (ir < n) v[r] = x[ir];
    }
#pragma unroll
    for (int r = 0; r < SCALAR_UNROLL; ++r) {
      const long long ir = i + r * stride;
      if (ir >= n) break;
      out[ir] = from_f32<T>(tanhf(to_f32(v[r]) + b));
    }
  }
}

int sm_count() {
  static int count = 0;
  if (count == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
        count <= 0)
      count = 132;
  }
  return count;
}

int gcd_int(int a, int b) { return b == 0 ? a : gcd_int(b, a % b); }

// Blocks for `work` thread-tasks, at most a full card's worth, rounded up to
// a multiple that makes the grid stride a multiple of `period`.
unsigned grid_for(long long work, int period) {
  const int step = period / gcd_int(period, THREADS);
  long long blocks = (work + THREADS - 1) / THREADS;
  const long long cap = (long long)sm_count() * BLOCKS_PER_SM;
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;
  blocks = (blocks + step - 1) / step * step;
  return (unsigned)blocks;
}

template <typename T>
void launch(int mode, const void* x, const void* bias, void* out, int F, int H, int W, int C,
            float slope, cudaStream_t st) {
  const auto* xt = static_cast<const T*>(x);
  const auto* bt = static_cast<const float*>(bias);
  auto* ot = static_cast<T*>(out);
  if (mode == ENCODER) {
    const int units = F * (H / 2) * (W / 2) * (C / VEC);
    block_epilogue_kernel_encoder<T><<<grid_for(units, C / VEC), THREADS, 0, st>>>(
        xt, bt, ot, units, W / 2, C, slope);
  } else if (mode == DECODER) {
    const int units = F * H * W * (C / VEC);
    constexpr int UNROLL = IN_FLIGHT / Words<T>::n;
    block_epilogue_kernel_decoder<T><<<grid_for((units + UNROLL - 1) / UNROLL, C / VEC),
                                       THREADS, 0, st>>>(xt, bt, ot, units, C);
  } else {
    const long long n = (long long)F * H * W * C;
    block_epilogue_kernel_last<T><<<grid_for((n + SCALAR_UNROLL - 1) / SCALAR_UNROLL, C),
                                    THREADS, 0, st>>>(xt, bt, ot, n, C);
  }
}

}  // namespace

extern "C" {

// x [F,H,W,C] (the bias-free convolution output, NHWC) and out in x's type,
// dtype 0 = f32, 1 = bf16; bias [C] f32.  out is [F,H/2,W/2,C] in ENCODER
// mode (0), [F,H,W,C] in DECODER (1) and LAST (2).  The vector modes need
// C % 8 == 0 and 16-byte aligned x and out, ENCODER even H and W, and all
// the vector modes fewer than 2^30 channel groups; anything else returns
// cudaErrorInvalidValue and launches nothing.
int block_epilogue_forward(const void* x, const void* bias, void* out, int F, int H, int W,
                           int C, int mode, int dtype, float slope, void* stream) {
  const bool vector = mode == ENCODER || mode == DECODER;
  const long long elems = (long long)F * H * W * C;
  if (F < 0 || H < 0 || W < 0 || C < 1 || (mode != ENCODER && mode != DECODER && mode != LAST) ||
      (dtype != 0 && dtype != 1) ||
      (vector && (C % VEC != 0 || elems / VEC >= (1LL << 30) ||
                  ((uintptr_t)x | (uintptr_t)out) % 16 != 0)) ||
      (mode == ENCODER && (H % 2 || W % 2)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (elems == 0) return static_cast<int>(cudaGetLastError());
  const auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    launch<__nv_bfloat16>(mode, x, bias, out, F, H, W, C, slope, st);
  else
    launch<float>(mode, x, bias, out, F, H, W, C, slope, st);
  return static_cast<int>(cudaGetLastError());
}

const char* block_epilogue_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
