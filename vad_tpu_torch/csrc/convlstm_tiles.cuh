// Shared tile machinery of the ConvLSTM kernels (convlstm_serving.cu,
// kernels 1 and 2; convlstm_backward.cu, kernel 3): one implicit-GEMM
// tile of BM x BN outputs accumulated over K in 64-byte stages that
// stream through a 3-stage cp.async ring, on the tensor cores (WMMA
// 16x16x16, f32 accumulate) for bf16 and as register-blocked f32 FMAs for
// f32, and the loader of the recurrence's own GEMM (3x3 taps of h_{t-1}
// against Wh).  Everything is in an anonymous namespace: each source that
// includes it gets its own copy.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int BM = 64;       // output rows per block
constexpr int BN = 128;      // output columns per block
constexpr int CG = BN / 4;   // hidden channels per block of the recurrence's GEMM (x4 gates)
constexpr int THREADS = 256;
constexpr int NSTAGE = 3;
constexpr int LDC = BN + 4;  // f32 epilogue tile [BM][LDC]

// Per element type: K chunk of 64 bytes, 16-byte copy chunks, rows padded
// by one chunk.  A is stored row-major [BM][LDA] (K contiguous) or, for
// kernel 3's dWh GEMM, K-major [BK][LDAT]; B is [BK][LDB].
template <typename T> struct Tiles {
  static constexpr int CE = 16 / sizeof(T);  // elements per 16-byte chunk
  static constexpr int BK = 64 / sizeof(T);  // K per stage (32 bf16, 16 f32)
  static constexpr int LDA = BK + CE;
  static constexpr int LDAT = BM + CE;
  static constexpr int LDB = BN + CE;
  static constexpr int A_ELEMS = BM * LDA > BK * LDAT ? BM * LDA : BK * LDAT;
  static constexpr int STAGE = A_ELEMS + BK * LDB;  // elements
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

// One 16-byte chunk (CE elements) from src to shared dst: by cp.async when
// VEC (then `valid` covers the whole chunk), else element by element with
// ok(e) saying whether element e exists.
template <typename T, bool VEC, class Ok>
__device__ __forceinline__ void copy_chunk(T* dst, const T* src, const T* any_valid, bool valid,
                                           Ok ok) {
  if constexpr (VEC) {
    cp_async16(dst, valid ? src : any_valid, valid);
  } else {
#pragma unroll
    for (int e = 0; e < Tiles<T>::CE; ++e) dst[e] = ok(e) ? src[e] : from_f32<T>(0.0f);
  }
}

struct Shape {
  int B, T, H, W, C;
};

// ------------------------------------------------------------- GEMM core
//
// Accumulates one BM x BN output tile over KT stages of K into the f32
// epilogue tile at the start of `smem` ([BM][LDC], aliasing the stages).
// `load(As, Bs, kk)` issues stage kk's copies.  Ends synchronized.
template <typename T, bool A_KMAJOR, class Load>
__device__ __forceinline__ void gemm_tile(const Load& load, int KT, unsigned char* smem) {
  using L = Tiles<T>;
  T* stages = reinterpret_cast<T*>(smem);
  float* Cs = reinterpret_cast<float*>(smem);
  const int tid = threadIdx.x;

#pragma unroll
  for (int st = 0; st < NSTAGE - 1; ++st) {
    if (st < KT) load(stages + st * L::STAGE, stages + st * L::STAGE + L::A_ELEMS, st);
    cp_async_commit();
  }

  if constexpr (sizeof(T) == 2) {
    using namespace nvcuda;
    using ALayout = std::conditional_t<A_KMAJOR, wmma::col_major, wmma::row_major>;
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
        load(base, base + L::A_ELEMS, nxt);
      }
      cp_async_commit();
      const T* As = stages + (kk % NSTAGE) * L::STAGE;
      const T* Bs = As + L::A_ELEMS;
#pragma unroll
      for (int ks = 0; ks < L::BK; ks += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, ALayout> a[2];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          if constexpr (A_KMAJOR)
            wmma::load_matrix_sync(a[i], As + ks * L::LDAT + wm + i * 16, L::LDAT);
          else
            wmma::load_matrix_sync(a[i], As + (wm + i * 16) * L::LDA + ks, L::LDA);
        }
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
        load(base, base + L::A_ELEMS, nxt);
      }
      cp_async_commit();
      const T* As = stages + (kk % NSTAGE) * L::STAGE;
      const T* Bs = As + L::A_ELEMS;
#pragma unroll
      for (int k = 0; k < L::BK; ++k) {
        float a[4], b[8];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          a[i] = to_f32(A_KMAJOR ? As[k * L::LDAT + tr + i] : As[(tr + i) * L::LDA + k]);
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
}

// Stage kk of the forward's GEMM: A = 64 pixels of h_{t-1} at one tap and
// channel chunk; B = the matching rows of Wh for the block's 32 channels
// of each gate (columns gate*CG + j -> Wh column gate*C + cb + j).
template <typename T, bool VEC> struct GateLoad {
  const T* h_in;     // h0 (t = 0) or h_seq[:, t-1]
  size_t h_bstride;  // elements between batch rows of h_in
  const T* w_h;
  Shape s;
  int m0, cb, kchunks;

  __device__ __forceinline__ void operator()(T* As, T* Bs, int kk) const {
    using L = Tiles<T>;
    const int tid = threadIdx.x;
    const int tap = kk / kchunks;
    const int k0 = (kk - tap * kchunks) * L::BK;
    const int hw = s.H * s.W;
    {  // A: one chunk per thread
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
      const int kc = k0 + c0;
      copy_chunk<T, VEC>(As + row * L::LDA + c0, src, h_in, valid && kc < s.C,
                         [&](int e) { return valid && kc + e < s.C; });
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {  // B: two chunks per thread
      const int q = tid + i * THREADS;
      const int kr = q / (BN / L::CE);
      const int col = (q % (BN / L::CE)) * L::CE;
      const int gate = col / CG;
      const int ch = cb + col % CG;
      const int k = k0 + kr;
      const T* src = w_h + (size_t)(tap * s.C + k) * (4 * s.C) + gate * s.C + ch;
      copy_chunk<T, VEC>(Bs + kr * L::LDB + col, src, w_h, k < s.C && ch < s.C,
                         [&](int e) { return k < s.C && ch + e < s.C; });
    }
  }
};

}  // namespace
