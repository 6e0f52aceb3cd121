// ConvLSTM serving recurrence for Hopper (sm_90a), plain C interface.
//
// Replaces: vad_tpu/ops/convlstm_pallas.py `_serving_kernel` (reached
// through `_run_serving_forward`, the primal of `convlstm_recurrence_pallas`).
//
// For t in 0..T-1:
//     gates = gates_x[:, t] + conv3x3_SAME(h, Wh)          (i, f, g, o order)
//     c = sigmoid(f) * c + sigmoid(i) * tanh(g)
//     h = sigmoid(o) * tanh(c)
// with c carried in f32, h cast to the weights' type before the conv,
// h_seq written in the gates' type and the final (h, c) in f32.
//
// Design.  The TPU kernel runs the T grid axis in order and keeps (h, c)
// in VMEM between steps.  CUDA blocks run in no order, so here the time
// loop is a host loop of one launch per step (T launches per call, all on
// the caller's stream, which orders them).  Each launch is an implicit
// GEMM over the whole batch: M = B*H*W pixels, K = 9*C (3x3 taps of h),
// N = 4*C gate columns.  A block owns 64 pixels and 32 hidden channels
// with all four of their gates (128 columns), so the gate math runs in the
// GEMM's epilogue and c is updated in place (each element is read and
// written by one thread only).  The conv's input at step t is h_{t-1} in
// the weights' type, which is exactly h_seq[:, t-1]: the kernel reads it
// from there (h0 cast once for t = 0), so no f32 copy of h is kept between
// steps and only the last step writes the f32 final h.  Taps outside the
// frame read zeros (the TPU kernel masks rolled rows for the same
// purpose), so any H, W, C the model produces is taken.
//
// Tiles stream through a 3-stage cp.async ring (16-byte copies, zero-fill
// outside the frame) when C % 8 == 0, else through plain loads.
//
// Bound on an H100 SXM at the serving shape (B=16, T=16, 16x16, C=128,
// bf16): 77.3 GFLOP per call -> 78 us at 989 TFLOP/s, against ~93 MB of
// traffic -> 28 us at 3.35 TB/s, so the tensor cores bound it.  bf16 runs
// the product on the tensor cores through WMMA (16x16x16, f32 accumulate);
// f32 runs it as register-blocked FMAs, so an f32 reference comparison is
// not rounded to TF32.  Not yet done: wgmma/TMA, and keeping h on chip
// across steps (one persistent launch instead of T).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;       // pixels per block
constexpr int CG = 32;       // hidden channels per block (x4 gates)
constexpr int BN = 4 * CG;   // gate columns per block
constexpr int THREADS = 256;
constexpr int NSTAGE = 3;
constexpr int LDC = BN + 4;  // f32 epilogue tile [BM][LDC]

// Per element type: K chunk of 64 bytes, 16-byte copy chunks, rows padded
// by one chunk.  Both types give 256 A chunks and 512 B chunks per stage.
template <typename T> struct Tiles {
  static constexpr int CE = 16 / sizeof(T);  // elements per 16-byte chunk
  static constexpr int BK = 64 / sizeof(T);  // K per stage (32 bf16, 16 f32)
  static constexpr int LDA = BK + CE;        // A tile [BM][LDA]
  static constexpr int LDB = BN + CE;        // B tile [BK][LDB]
  static constexpr int STAGE = BM * LDA + BK * LDB;  // elements
};

constexpr int SMEM_STAGES = NSTAGE * Tiles<__nv_bfloat16>::STAGE * 2 >
                                    NSTAGE * Tiles<float>::STAGE * 4
                                ? NSTAGE * Tiles<__nv_bfloat16>::STAGE * 2
                                : NSTAGE * Tiles<float>::STAGE * 4;
constexpr int SMEM_BYTES = SMEM_STAGES > BM * LDC * 4 ? SMEM_STAGES : BM * LDC * 4;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ float sigmoid(float x) { return 1.0f / (1.0f + expf(-x)); }

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

struct Shape {
  int B, T, H, W, C;
};

// Stage K chunk `kk` (tap, channel offset k0) of A (64 pixels of h at that
// tap) and B (the matching rows of Wh, the block's 128 gate columns).
template <typename T, bool VEC>
__device__ __forceinline__ void load_stage(T* As, T* Bs, const T* __restrict__ h_in,
                                           size_t h_bstride, const T* __restrict__ w_h,
                                           const Shape& s, int m0, int cb, int kk,
                                           int kchunks) {
  using L = Tiles<T>;
  const int tid = threadIdx.x;
  const int tap = kk / kchunks;
  const int k0 = (kk - tap * kchunks) * L::BK;
  const int hw = s.H * s.W;
  {  // A: one 16-byte chunk per thread
    const int row = tid / (L::BK / L::CE);
    const int c0 = (tid % (L::BK / L::CE)) * L::CE;
    const int r = m0 + row;
    bool valid = r < s.B * hw;
    const T* src = h_in;
    if (valid) {
      const int b = r / hw, p = r - b * hw;
      const int y = p / s.W + tap / 3 - 1, x = p % s.W + tap % 3 - 1;
      valid = y >= 0 && y < s.H && x >= 0 && x < s.W;
      src = h_in + b * h_bstride + (size_t)(y * s.W + x) * s.C + k0 + c0;
    }
    T* dst = As + row * L::LDA + c0;
    if (VEC) {
      cp_async16(dst, valid && k0 + c0 < s.C ? src : h_in, valid && k0 + c0 < s.C);
    } else {
#pragma unroll
      for (int e = 0; e < L::CE; ++e)
        dst[e] = (valid && k0 + c0 + e < s.C) ? src[e] : from_f32<T>(0.0f);
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {  // B: two 16-byte chunks per thread
    const int q = tid + i * THREADS;
    const int kr = q / (BN / L::CE);
    const int col = (q % (BN / L::CE)) * L::CE;
    const int gate = col / CG;
    const int ch = cb + col % CG;
    const int k = k0 + kr;
    const T* src = w_h + (size_t)(tap * s.C + k) * (4 * s.C) + gate * s.C + ch;
    T* dst = Bs + kr * L::LDB + col;
    if (VEC) {
      const bool valid = k < s.C && ch < s.C;
      cp_async16(dst, valid ? src : w_h, valid);
    } else {
#pragma unroll
      for (int e = 0; e < L::CE; ++e)
        dst[e] = (k < s.C && ch + e < s.C) ? src[e] : from_f32<T>(0.0f);
    }
  }
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(THREADS)
    convlstm_step_kernel(const T* __restrict__ gates_x, const T* __restrict__ w_h,
                         const T* __restrict__ h0, float* __restrict__ c_state,
                         T* __restrict__ h_seq, float* __restrict__ h_final, Shape s, int t) {
  using L = Tiles<T>;
  __shared__ __align__(128) unsigned char smem[SMEM_BYTES];
  float* Cs = reinterpret_cast<float*>(smem);
  T* stages = reinterpret_cast<T*>(smem);

  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * BM;
  const int cb = blockIdx.y * CG;
  const int hw = s.H * s.W;
  const int kchunks = (s.C + L::BK - 1) / L::BK;
  const int KT = 9 * kchunks;
  // the conv's input: h0 (in T) at t = 0, else h_seq[:, t-1]
  const T* h_in = t == 0 ? h0 : h_seq + (size_t)(t - 1) * hw * s.C;
  const size_t h_bstride = (size_t)(t == 0 ? 1 : s.T) * hw * s.C;

#pragma unroll
  for (int st = 0; st < NSTAGE - 1; ++st) {
    if (st < KT) {
      T* base = stages + st * L::STAGE;
      load_stage<T, VEC>(base, base + BM * L::LDA, h_in, h_bstride, w_h, s, m0, cb, st, kchunks);
    }
    cp_async_commit();
  }

  if constexpr (sizeof(T) == 2) {
    using namespace nvcuda;
    const int warp = tid >> 5;
    const int wm = (warp >> 2) * 32;  // 2 x 4 warps, 32 x 32 each
    const int wn = (warp & 3) * 32;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

    for (int kk = 0; kk < KT; ++kk) {
      cp_async_wait<NSTAGE - 2>();
      __syncthreads();  // stage kk landed; stage kk-1 is free for reuse
      const int nxt = kk + NSTAGE - 1;
      if (nxt < KT) {
        T* base = stages + (nxt % NSTAGE) * L::STAGE;
        load_stage<T, VEC>(base, base + BM * L::LDA, h_in, h_bstride, w_h, s, m0, cb, nxt,
                           kchunks);
      }
      cp_async_commit();
      const T* As = stages + (kk % NSTAGE) * L::STAGE;
      const T* Bs = As + BM * L::LDA;
#pragma unroll
      for (int ks = 0; ks < L::BK; ks += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a[2];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b[2];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          wmma::load_matrix_sync(a[i], As + (wm + i * 16) * L::LDA + ks, L::LDA);
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::load_matrix_sync(b[j], Bs + ks * L::LDB + wn + j * 16, L::LDB);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
      }
    }
    cp_async_wait<0>();
    __syncthreads();  // the epilogue tile aliases the stages
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::store_matrix_sync(Cs + (wm + i * 16) * LDC + wn + j * 16, acc[i][j], LDC,
                                wmma::mem_row_major);
  } else {
    const int tr = (tid >> 4) * 4;  // 4 rows
    const int tc = tid & 15;        // columns tc + 16*j, j < 8
    float acc[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

    for (int kk = 0; kk < KT; ++kk) {
      cp_async_wait<NSTAGE - 2>();
      __syncthreads();
      const int nxt = kk + NSTAGE - 1;
      if (nxt < KT) {
        T* base = stages + (nxt % NSTAGE) * L::STAGE;
        load_stage<T, VEC>(base, base + BM * L::LDA, h_in, h_bstride, w_h, s, m0, cb, nxt,
                           kchunks);
      }
      cp_async_commit();
      const T* As = stages + (kk % NSTAGE) * L::STAGE;
      const T* Bs = As + BM * L::LDA;
#pragma unroll
      for (int k = 0; k < L::BK; ++k) {
        float a[4], b[8];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = to_f32(As[(tr + i) * L::LDA + k]);
#pragma unroll
        for (int j = 0; j < 8; ++j) b[j] = to_f32(Bs[k * L::LDB + tc + 16 * j]);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
    }
    cp_async_wait<0>();
    __syncthreads();  // the epilogue tile aliases the stages
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) Cs[(tr + i) * LDC + tc + 16 * j] = acc[i][j];
  }
  __syncthreads();

  // Epilogue: gate math for the block's 64 pixels x 32 channels.
  for (int e = tid; e < BM * CG; e += THREADS) {
    const int row = e / CG;
    const int j = e - row * CG;
    const int r = m0 + row;
    const int ch = cb + j;
    if (r >= s.B * hw || ch >= s.C) continue;
    const int b = r / hw, p = r - b * hw;
    const size_t bt = (size_t)b * s.T + t;
    const T* gx = gates_x + (bt * hw + p) * (4 * s.C) + ch;
    const float* acc = Cs + row * LDC + j;
    const float gi = acc[0 * CG] + to_f32(gx[0 * s.C]);
    const float gf = acc[1 * CG] + to_f32(gx[1 * s.C]);
    const float gg = acc[2 * CG] + to_f32(gx[2 * s.C]);
    const float go = acc[3 * CG] + to_f32(gx[3 * s.C]);
    const size_t sidx = (size_t)r * s.C + ch;
    const float c_new = sigmoid(gf) * c_state[sidx] + sigmoid(gi) * tanhf(gg);
    const float h_new = sigmoid(go) * tanhf(c_new);
    c_state[sidx] = c_new;
    h_seq[(bt * hw + p) * s.C + ch] = from_f32<T>(h_new);
    if (t == s.T - 1) h_final[sidx] = h_new;
  }
}

template <typename T, bool VEC>
int run(const void* gates_x, const void* w_h, const void* h0, float* c, void* h_seq,
        float* h_final, Shape s, cudaStream_t stream) {
  const dim3 grid((s.B * s.H * s.W + BM - 1) / BM, (s.C + CG - 1) / CG);
  for (int t = 0; t < s.T; ++t) {
    convlstm_step_kernel<T, VEC><<<grid, THREADS, 0, stream>>>(
        static_cast<const T*>(gates_x), static_cast<const T*>(w_h), static_cast<const T*>(h0),
        c, static_cast<T*>(h_seq), h_final, s, t);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

template <typename T>
int run_t(const void* gates_x, const void* w_h, const void* h0, float* c, void* h_seq,
          float* h_final, Shape s, cudaStream_t stream) {
  if (s.C % 8 == 0) return run<T, true>(gates_x, w_h, h0, c, h_seq, h_final, s, stream);
  return run<T, false>(gates_x, w_h, h0, c, h_seq, h_final, s, stream);
}

}  // namespace

extern "C" {

// gates_x [B,T,H,W,4C], w_h [3,3,C,4C], h0 [B,H,W,C] and h_seq [B,T,H,W,C]
// in one type (bf16 when is_bf16, else f32); c [B,H,W,C] f32 holds c0 and
// is updated in place; h_final [B,H,W,C] f32 receives h_T.  All contiguous.
// Launches T kernels on `stream`; returns the first launch error, or 0.
int convlstm_serving_forward(const void* gates_x, const void* w_h, const void* h0, void* c,
                             void* h_seq, void* h_final, int B, int T, int H, int W, int C,
                             int is_bf16, void* stream) {
  const Shape s{B, T, H, W, C};
  auto st = static_cast<cudaStream_t>(stream);
  auto* cf = static_cast<float*>(c);
  auto* hf = static_cast<float*>(h_final);
  if (is_bf16) return run_t<__nv_bfloat16>(gates_x, w_h, h0, cf, h_seq, hf, s, st);
  return run_t<float>(gates_x, w_h, h0, cf, h_seq, hf, s, st);
}

const char* convlstm_serving_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
