// 2x2/2 max-pool backward that splits the gradient across ties, for Hopper
// (sm_90a), plain C interface: kernel 5.
//
// Replaces: tools/probe_pool_bwd.py `make_pool_bwd(rb, cnt_mode)` ->
// `_kern` (the JAX probe of a Pallas pool backward).
//
// For NHWC x [N,H,W,C] and g [N,H/2,W/2,C], per 2x2 window and channel,
// formula for formula as `_kern`:
//     m   = max of the window, in x's type (NaN if any entry is NaN)
//     eq  = x == m
//     cnt = number of tied entries, in f32
//     dx  = eq ? (float(g) / cnt -> x's type) : 0        (COUNT)
//     dx  = eq ? g : 0                                   (no COUNT: ties
//                                                         double-count)
// The division is IEEE (no fast math), so dx equals the plain PyTorch
// version (ops/pool_bwd.py) bit for bit.  PyTorch's own max-pool backward
// sends g to one index per window instead; the two agree only on windows
// without ties.
//
// Design.  The TPU kernel walks row blocks and finds each W-neighbour with
// a sublane rotate.  Here one thread owns one pooled pixel and one vector
// of V channels: it reads the window's four V-vectors and g's one, and
// writes four.  V is the widest of 16/8/4/2 bytes (at most 16 bytes) that
// divides a pixel's C channels and the pointers' alignment, so any C runs
// aligned (C=20 bf16: 8-byte vectors; odd C: one element).
//
// Bound: it moves 2|x| + |g| bytes and does a handful of operations per
// byte, so the memory rate bounds it: 0.36 ms at 3.35 TB/s for block 1 of
// the encoder at B*T = 128 frames ([128,256,256,32] bf16).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

template <int BYTES> struct Word;
template <> struct Word<16> { using type = uint4; };
template <> struct Word<8> { using type = uint2; };
template <> struct Word<4> { using type = uint32_t; };
template <> struct Word<2> { using type = uint16_t; };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T, int V>
__device__ __forceinline__ void load(const T* src, T (&dst)[V]) {
  using W = typename Word<V * sizeof(T)>::type;
  *reinterpret_cast<W*>(dst) = *reinterpret_cast<const W*>(src);
}

template <typename T, int V>
__device__ __forceinline__ void store(T* dst, const T (&src)[V]) {
  using W = typename Word<V * sizeof(T)>::type;
  *reinterpret_cast<W*>(dst) = *reinterpret_cast<const W*>(src);
}

template <typename T, int V, bool COUNT>
__global__ void __launch_bounds__(THREADS)
    pool_bwd_kernel(const T* __restrict__ x, const T* __restrict__ g, T* __restrict__ dx,
                    int total, int Wp, int C) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= total) return;
  const int nv = C / V;
  const int k = (i % nv) * V;  // first channel of this thread's vector
  const int p = i / nv;        // pooled pixel (n*Hp + py)*Wp + px
  const int px = p % Wp;
  const long long row = 2LL * (p / Wp);  // n*H + 2py: the window's top input row
  const long long W = 2LL * Wp;
  const long long o0 = (row * W + 2 * px) * C + k;
  const long long off[4] = {o0, o0 + C, o0 + W * C, o0 + W * C + C};

  alignas(V * sizeof(T)) T a[4][V];
  alignas(V * sizeof(T)) T gv[V];
#pragma unroll
  for (int q = 0; q < 4; ++q) load<T, V>(x + off[q], a[q]);
  load<T, V>(g + (long long)p * C + k, gv);

  alignas(V * sizeof(T)) T d[4][V];
  const T zero = from_f32<T>(0.0f);
#pragma unroll
  for (int j = 0; j < V; ++j) {
    float v[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) v[q] = to_f32(a[q][j]);
    float m = v[0];
#pragma unroll
    for (int q = 1; q < 4; ++q) m = (v[q] > m || v[q] != v[q]) ? v[q] : m;  // NaN sticks
    bool eq[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) eq[q] = v[q] == m;
    T val = gv[j];
    if constexpr (COUNT) {
      const float cnt = (float)eq[0] + (float)eq[1] + (float)eq[2] + (float)eq[3];
      val = from_f32<T>(__fdiv_rn(to_f32(gv[j]), cnt));
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) d[q][j] = eq[q] ? val : zero;
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) store<T, V>(dx + off[q], d[q]);
}

template <typename T, int V>
void launch(const void* x, const void* g, void* dx, int pixels, int Wp, int C, int count,
            cudaStream_t stream) {
  const int total = pixels * (C / V);
  const unsigned blocks = (unsigned)((total + THREADS - 1) / THREADS);
  const auto* xt = static_cast<const T*>(x);
  const auto* gt = static_cast<const T*>(g);
  auto* dt = static_cast<T*>(dx);
  if (count)
    pool_bwd_kernel<T, V, true><<<blocks, THREADS, 0, stream>>>(xt, gt, dt, total, Wp, C);
  else
    pool_bwd_kernel<T, V, false><<<blocks, THREADS, 0, stream>>>(xt, gt, dt, total, Wp, C);
}

// The widest vector (elements) of at most 16 bytes that divides C and
// every pointer's alignment.
template <typename T>
int vector_width(const void* x, const void* g, const void* dx, int C) {
  const uintptr_t addr = (uintptr_t)x | (uintptr_t)g | (uintptr_t)dx;
  int v = 16 / sizeof(T);
  while (v > 1 && (C % v != 0 || addr % (v * sizeof(T)) != 0)) v /= 2;
  return v;
}

template <typename T>
void dispatch(const void* x, const void* g, void* dx, int pixels, int Wp, int C, int count,
              cudaStream_t st) {
  switch (vector_width<T>(x, g, dx, C)) {
    case 8:
      if constexpr (sizeof(T) == 2) launch<T, 8>(x, g, dx, pixels, Wp, C, count, st);
      break;
    case 4: launch<T, 4>(x, g, dx, pixels, Wp, C, count, st); break;
    case 2: launch<T, 2>(x, g, dx, pixels, Wp, C, count, st); break;
    default: launch<T, 1>(x, g, dx, pixels, Wp, C, count, st); break;
  }
}

}  // namespace

extern "C" {

// x [N,H,W,C] and dx (same shape, written) in x's type; g [N,H/2,W/2,C].
// dtype 0 = f32, 1 = bf16; count 1 = split ties, 0 = give each tie all of
// g.  H and W must be even, and N*H/2*W/2*C below 2^31; anything else
// returns cudaErrorInvalidValue and launches nothing.
int pool_bwd_forward(const void* x, const void* g, void* dx, int N, int H, int W, int C,
                     int dtype, int count, void* stream) {
  const long long pixels = (long long)N * (H / 2) * (W / 2);
  if (H % 2 || W % 2 || N < 0 || C < 1 || pixels * C >= (1LL << 31) ||
      (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (pixels == 0) return static_cast<int>(cudaGetLastError());
  const auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    dispatch<__nv_bfloat16>(x, g, dx, (int)pixels, W / 2, C, count, st);
  else
    dispatch<float>(x, g, dx, (int)pixels, W / 2, C, count, st);
  return static_cast<int>(cudaGetLastError());
}

const char* pool_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
