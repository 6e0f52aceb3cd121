// Fused first encoder block on raw uint8 frames for Hopper (sm_90a), plain
// C interface.
//
// Replaces: vad_tpu/ops/encoder_pallas.py `_first_block_kernel` (reached
// through `fused_first_block`).
//
// Computes, for NHWC u8 frames [F,H,W,3]:
//     x/127.5 - 1 -> conv3x3 SAME (3 -> 32) -> inference BatchNorm
//     -> 2x2 max-pool -> LeakyReLU(0.2)
// and writes NHWC [F,H/2,W/2,32].  The input affine and the BatchNorm are
// folded into one f32 weight [3,3,3,32] and bias [32] that act on the raw
// byte values (ops/encoder_fused.py fold_first_block).  SAME zero padding
// of the *normalized* input is the raw value 127.5, so out-of-frame taps
// read `pad_u` (127.5), not 0.  LeakyReLU is monotone, so the max-pool
// runs before it and the bias is added once after the max.
//
// Design.  The TPU kernel spends its effort on lane layout (a banded
// matmul over 32-pixel lane groups and a relayout at the NHWC boundary).
// None of that applies here: one block stages an 18 x 34 pixel u8 window
// (an 8 x 16 tile of pooled outputs plus its halo) in shared memory as
// f32, and each thread computes one pooled pixel for 8 of the 32 output
// channels from its 4 x 4 x 3 input patch (4 conv taps x 27 MACs x 8
// channels).  Four neighbouring threads write one pixel's 32 channels, so
// a warp's stores are contiguous NHWC, which is already the channels-last
// layout block 2's convolution reads: the hand-off costs no copy.
//
// Bound on an H100 SXM at the serving shape (F=256 frames of 256x256, bf16
// out): 50.3 MB read + 268 MB written -> 95 us at 3.35 TB/s; 29 GFLOP
// -> 29 us on the tensor cores.  This version runs the MACs as f32 FMAs
// on the CUDA cores (14.5 G of them: 0.43 ms at the 67 TFLOP/s f32 peak),
// so the FMA rate, not the memory, bounds it.  Moving the 27-deep dot products onto
// the tensor cores is the next step toward the bytes bound.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int C1 = 32;                  // output channels
constexpr int CPT = 8;                  // output channels per thread
constexpr int TPH = 8;                  // pooled rows per block
constexpr int TPW = 16;                 // pooled columns per block
constexpr int IN_H = 2 * TPH + 2;       // staged input rows (with halo)
constexpr int IN_W = 2 * TPW + 2;       // staged input pixels per row
constexpr int THREADS = TPH * TPW * (C1 / CPT);  // 512

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    first_block_kernel(const uint8_t* __restrict__ x, const float* __restrict__ w,
                       const float* __restrict__ bias, T* __restrict__ out, int H, int W,
                       float pad_u, float slope) {
  __shared__ float xs[IN_H][IN_W * 3];
  __shared__ __align__(16) float ws[27][C1];  // [(dy*3+dx)*3+ci][co]
  __shared__ float bs[C1];

  const int tid = threadIdx.x;
  const int f = blockIdx.z;
  const int py0 = blockIdx.y * TPH, px0 = blockIdx.x * TPW;
  const int Hp = H / 2, Wp = W / 2;

  for (int i = tid; i < 27 * C1; i += THREADS) ws[i / C1][i % C1] = w[i];
  if (tid < C1) bs[tid] = bias[tid];

  // Stage the window: rows 2*py0-1 .., pixels 2*px0-1 .., bytes interleaved
  // RGB exactly as in memory (consecutive threads read consecutive bytes).
  const uint8_t* frame = x + (size_t)f * H * W * 3;
  const int gy0 = 2 * py0 - 1, gx0 = 2 * px0 - 1;
  for (int i = tid; i < IN_H * IN_W * 3; i += THREADS) {
    const int r = i / (IN_W * 3);
    const int q = i - r * (IN_W * 3);
    const int gy = gy0 + r, gx = gx0 + q / 3;
    float v = pad_u;
    if (gy >= 0 && gy < H && gx >= 0 && gx < W) v = frame[((size_t)gy * W + gx) * 3 + q % 3];
    xs[r][q] = v;
  }
  __syncthreads();

  const int cg = (tid & 3) * CPT;  // first of this thread's channels
  const int pp = tid >> 2;
  const int ty = pp / TPW, tx = pp % TPW;
  const int py = py0 + ty, px = px0 + tx;
  if (py >= Hp || px >= Wp) return;

  float patch[4][4][3];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int ci = 0; ci < 3; ++ci) patch[r][c][ci] = xs[2 * ty + r][(2 * tx + c) * 3 + ci];

  float acc[4][CPT];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int k = 0; k < CPT; ++k) acc[a][k] = 0.0f;

#pragma unroll
  for (int dy = 0; dy < 3; ++dy)
#pragma unroll
    for (int dx = 0; dx < 3; ++dx)
#pragma unroll
      for (int ci = 0; ci < 3; ++ci) {
        const float4 w0 = *reinterpret_cast<const float4*>(&ws[(dy * 3 + dx) * 3 + ci][cg]);
        const float4 w1 = *reinterpret_cast<const float4*>(&ws[(dy * 3 + dx) * 3 + ci][cg + 4]);
        const float wk[CPT] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
        for (int a = 0; a < 4; ++a) {  // conv tap (2py + a/2, 2px + a%2)
          const float v = patch[a / 2 + dy][a % 2 + dx][ci];
#pragma unroll
          for (int k = 0; k < CPT; ++k) acc[a][k] = fmaf(v, wk[k], acc[a][k]);
        }
      }

  alignas(16) T res[CPT];
#pragma unroll
  for (int k = 0; k < CPT; ++k) {
    float m = fmaxf(fmaxf(acc[0][k], acc[1][k]), fmaxf(acc[2][k], acc[3][k])) + bs[cg + k];
    m = m >= 0.0f ? m : slope * m;
    res[k] = from_f32<T>(m);
  }
  T* dst = out + (((size_t)f * Hp + py) * Wp + px) * C1 + cg;
  constexpr int VEC = CPT * sizeof(T) / 16;  // 16-byte stores
#pragma unroll
  for (int v = 0; v < VEC; ++v)
    reinterpret_cast<uint4*>(dst)[v] = reinterpret_cast<const uint4*>(res)[v];
}

}  // namespace

extern "C" {

// x [F,H,W,3] u8; w [3,3,3,32] f32 (HWIO, folded); bias [32] f32 (folded);
// out [F,H/2,W/2,32], bf16 when out_bf16 else f32.  H and W must be even.
int first_block_forward(const void* x, const void* w, const void* bias, void* out, int F,
                        int H, int W, float pad_u, float slope, int out_bf16, void* stream) {
  const dim3 grid((W / 2 + TPW - 1) / TPW, (H / 2 + TPH - 1) / TPH, F);
  auto st = static_cast<cudaStream_t>(stream);
  const auto* xu = static_cast<const uint8_t*>(x);
  const auto* wf = static_cast<const float*>(w);
  const auto* bf = static_cast<const float*>(bias);
  if (out_bf16)
    first_block_kernel<__nv_bfloat16><<<grid, THREADS, 0, st>>>(
        xu, wf, bf, static_cast<__nv_bfloat16*>(out), H, W, pad_u, slope);
  else
    first_block_kernel<float><<<grid, THREADS, 0, st>>>(xu, wf, bf, static_cast<float*>(out),
                                                         H, W, pad_u, slope);
  return static_cast<int>(cudaGetLastError());
}

const char* first_block_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
