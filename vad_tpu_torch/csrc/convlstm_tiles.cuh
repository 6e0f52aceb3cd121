// Shared machinery of the ConvLSTM kernels (convlstm_serving.cu, kernels
// 1 and 2; convlstm_backward.cu, kernel 3), in two parts:
//
// - the stepwise core: one implicit-GEMM tile of BM x BN outputs
//   accumulated over K in 64-byte stages that stream through a 3-stage
//   cp.async ring, on the tensor cores (WMMA 16x16x16, f32 accumulate) for
//   bf16 and as register-blocked f32 FMAs for f32, and the loader of the
//   recurrence's own GEMM (3x3 taps of h_{t-1} against Wh);
// - the Hopper core (namespace hopper, sm_90a): padded frames staged by
//   TMA, wgmma on shared-memory descriptors, mbarriers, cluster barriers
//   and distributed shared memory, and the gate GEMM's column layout.
//
// Everything sits in anonymous namespaces: each source that includes it
// gets its own copy.
#pragma once

#include <cuda.h>  // CUtensorMap (types only: the encoder is looked up at run time)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
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

// B of stage (tap, k0) of the recurrence's gate GEMM: rows k0.. of Wh[tap]
// for the block's CG channels of each gate (columns gate*CG + j -> Wh
// column gate*C + cb + j), two chunks per thread.
template <typename T, bool VEC>
__device__ __forceinline__ void load_gate_cols(T* Bs, const T* w_h, const Shape& s, int cb,
                                               int tap, int k0) {
  using L = Tiles<T>;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int q = threadIdx.x + i * THREADS;
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
    load_gate_cols<T, VEC>(Bs, w_h, s, cb, tap, k0);
  }
};

}  // namespace

// ============================================================ Hopper core
//
// The bf16 path of kernels 1-3 on sm_90a: operands resident in shared
// memory for a whole call (or a whole frame), staged by TMA, multiplied by
// wgmma (m64n64k16, f32 accumulate in registers).
//
// Frames.  A hidden frame [H, W, C] lives in shared memory as C/8 planes,
// plane j = [(H+2) x (W+2) padded pixels][8 channels] (16 bytes a pixel),
// the planes FRAME_PLANE(H, W) bytes apart.  One TMA box {8, W+2, H+2, 1}
// at coordinates (8j, -1, -1, frame) writes plane j with its one-pixel
// zero border (TMA fills out-of-bounds elements with zeros), so SAME
// padding costs nothing.  Eight consecutive padded pixels of one plane are
// 128 contiguous bytes: one wgmma "core matrix" (no swizzle).  So a 3x3
// tap of an 8x8 pixel tile is a plain descriptor into the frame:
//   K-major A (rows = pixels, K = channels): start = pixel (y0+dy, x0+dx),
//     LBO = plane stride (next 8 channels), SBO = (W+2)*16 (next row);
//   MN-major A (rows = channels, K = pixels): start as above, SBO = plane
//     stride (next 8 channels), LBO = 16 pixels' bytes apart (next 8
//     pixels of the same row; W % 16 == 0).
// The 64 rows of an m64 tile are 8 image rows x 8 columns.
//
// Accumulator layout of m64nNk16 (PTX ISA, wgmma D fragments): thread
// `lane` of warp w (0-3) in the warpgroup holds d[i], i < N/2, at row
// 16w + lane/4 + 8*((i/2)%2) and column 8*(i/4) + 2*(lane%4) + i%2.
namespace {
namespace hopper {

constexpr int WG_THREADS = 128;
constexpr int NT = 64;                       // wgmma N of every GEMM here
constexpr int SMEM_LIMIT = 232448;           // dynamic shared memory per block on sm_90

__host__ __device__ constexpr int frame_plane_bytes(int H, int W) {
  return ((H + 2) * (W + 2) * 16 + 127) / 128 * 128;  // TMA destinations are 128-byte aligned
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// wgmma shared-memory descriptor, no swizzle; byte offsets, 16-byte units.
__device__ __forceinline__ uint64_t desc(const void* smem, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((smem_u32(smem) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// d += A . B, m64n64k16, bf16 in, f32 accumulate.  TA / TB: 1 when the
// operand is MN-major (transposed), 0 when K-major.
template <int TA, int TB>
__device__ __forceinline__ void mma(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

// Generic-proxy writes to shared memory made visible to wgmma / TMA.
__device__ __forceinline__ void fence_async() { asm volatile("fence.proxy.async;\n" ::: "memory"); }

// ---------------------------------------------------------- mbarrier, TMA
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t phase) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(phase)
        : "memory");
  } while (!done);
}
// One 4-D TMA box into shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load4(void* dst, const CUtensorMap* map, int c0, int c1, int c2,
                                          int c3, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3),
      "r"(smem_u32(bar))
      : "memory");
}

// Bytes one padded frame of `planes` planes brings to its barrier.
__host__ __device__ constexpr uint32_t frame_tx_bytes(int planes, int H, int W) {
  return static_cast<uint32_t>(planes * (H + 2) * (W + 2) * 16);
}
// Frame `f` of `map` (a [N, H, W, C] bf16 tensor with boxes {8, W+2, H+2,
// 1}) into the padded planes at `dst`, one box per plane, completing on
// `bar`; one thread issues, after its mbar_expect_tx.
__device__ __forceinline__ void tma_frame(unsigned char* dst, const CUtensorMap* map, int f,
                                          int planes, int H, int W, uint64_t* bar) {
  for (int j = 0; j < planes; ++j)
    tma_load4(dst + j * frame_plane_bytes(H, W), map, 8 * j, -1, -1, f, bar);
}

// ---------------------------------------------------------------- cluster
__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_sync() {
  cluster_arrive();
  cluster_wait();
}
// Address of `p` in the shared memory of cluster CTA `rank`.
__device__ __forceinline__ uint32_t peer(const void* p, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(smem_u32(p)), "r"(rank));
  return r;
}
__device__ __forceinline__ void st_peer(uint32_t addr, uint2 v) {
  asm volatile("st.shared::cluster.v2.u32 [%0], {%1, %2};\n" ::"r"(addr), "r"(v.x), "r"(v.y)
               : "memory");
}
__device__ __forceinline__ float4 ld_peer(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}

// Four bf16 <-> four floats, 8 bytes.
__device__ __forceinline__ uint2 pack4(float a, float b, float c, float d) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(a, b), hi = __floats2bfloat162_rn(c, d);
  return make_uint2(*reinterpret_cast<uint32_t*>(&lo), *reinterpret_cast<uint32_t*>(&hi));
}
__device__ __forceinline__ float4 unpack4(uint2 v) {
  const float2 lo = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&v.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&v.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}
// The resident design's activations (bf16 only): the hardware tanh, one
// MUFU op with a relative error below 2^-10.9, and sigmoid(x) = (1 +
// tanh(x/2)) / 2.  IEEE expf / tanhf cost ~4 us of a ~15 us recurrence step
// at 16x16, C=128; the approximation is far inside bf16's 2^-8.
__device__ __forceinline__ float tanh_fast(float x) {
  float y;
  asm("tanh.approx.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ float sigmoid_fast(float x) {
  return fmaf(0.5f, tanh_fast(0.5f * x), 0.5f);
}

// Component i (a compile-time constant after unrolling) of v.
__device__ __forceinline__ float lane_of(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// --------------------------------------------------- the recurrence GEMM
//
// acc[64 pixels of tile `tile`, 64 columns] = sum over the 3x3 taps and C
// channels of frame[pixel shifted by the tap] . Bs[(tap, channel), column].
// Bs holds K = 9*C rows K-major ([K/8][64 columns][8], 1 KB per 8 rows).
// SIGN = +1: the forward's conv (source pixel (y+dy-1, x+dx-1)); SIGN = -1:
// the backward's correlation with the taps reversed (source (y+1-dy,
// x+1-dx)).  Issues, commits and waits; acc is overwritten.
template <int SIGN>
__device__ __forceinline__ void frame_gemm(float (&acc)[32], const unsigned char* frame,
                                           const unsigned char* Bs, int tile, int H, int W, int C) {
  const int plane = frame_plane_bytes(H, W);
  const int y0 = tile / (W / 8) * 8, x0 = tile % (W / 8) * 8;
  const int kc = C / 16;
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.0f;
  wgmma_fence();
  for (int tap = 0; tap < 9; ++tap) {
    const int dy = SIGN > 0 ? tap / 3 : 2 - tap / 3;
    const int dx = SIGN > 0 ? tap % 3 : 2 - tap % 3;
    const unsigned char* a0 = frame + ((y0 + dy) * (W + 2) + x0 + dx) * 16;
    const unsigned char* b0 = Bs + tap * C / 8 * (NT * 16);
    for (int k = 0; k < kc; ++k)
      mma<0, 0>(acc, desc(a0 + 2 * k * plane, plane, (W + 2) * 16),
                desc(b0 + 2 * k * (NT * 16), NT * 16, 128));
  }
  wgmma_commit();
  wgmma_wait<0>();
}

// The frame pixel (y, x) of an accumulator row: tile `tile` of 8x8 tiles,
// row m of the m64 tile is (m / 8, m % 8) within it.
__device__ __forceinline__ int tile_pixel(int tile, int m, int W) {
  const int y = tile / (W / 8) * 8 + m / 8, x = tile % (W / 8) * 8 + m % 8;
  return y * W + x;
}
// Offset of pixel p (unpadded index), channel ch, in a padded frame.
__device__ __forceinline__ int frame_offset(int p, int ch, int H, int W) {
  const int y = p / W, x = p - y * W;
  return ch / 8 * frame_plane_bytes(H, W) + ((y + 1) * (W + 2) + x + 1) * 16 + (ch % 8) * 2;
}

// ------------------------------------------- the gate GEMM's columns
//
// A block of the recurrence's gate GEMM owns 16 hidden channels [cb, cb +
// 16) with their four gates: 64 columns.  Column n (n8 block jb = n / 8,
// r = n % 8) is gate jb / 2 of channel cb + 4 (r / 2) + 2 (jb % 2) + r % 2,
// so accumulator lane q (= lane % 4) holds channels cb + 4q .. cb + 4q + 3
// of all four gates for each of its two rows, and the gate math needs no
// exchange between threads.

constexpr int THREADS_R = 512;  // four warpgroups, one 8x8 pixel tile each
using bf16 = __nv_bfloat16;

// Dynamic shared memory of a block with a padded frame, the 9C x 64 slice of
// Wh and one mbarrier.
__host__ __device__ inline int smem_bytes(int H, int W, int C) {
  return C / 8 * frame_plane_bytes(H, W) + 9 * C * NT * 2 + 16;
}

// Wh column (gate * C + channel offset within the block) of block column n.
__device__ __forceinline__ int column_of(int n, int C) {
  const int jb = n / 8, r = n % 8;
  return jb / 2 * C + 4 * (r / 2) + 2 * (jb % 2) + r % 2;
}

// acc index of (gate G, row half rr, channel c4 of the lane's four).
__device__ __forceinline__ constexpr int acc_index(int G, int rr, int c4) {
  return (2 * G + c4 / 2) * 4 + rr * 2 + c4 % 2;
}

// Rows k = tap * C + j of w_t ([9, 4C, C]) for the 64 columns whose Wh
// column is col0 + column_of(n): K-major [K/8][64][8] at Bs.
__device__ __forceinline__ void load_wh_slice(unsigned char* Bs, const bf16* w_t, int col0, int C) {
  for (int e = threadIdx.x; e < 9 * C / 8 * NT; e += blockDim.x) {
    const int kg = e / NT, n = e % NT;
    const int tap = kg / (C / 8), j0 = kg % (C / 8) * 8;
    const bf16* src = w_t + ((size_t)tap * 4 * C + col0 + column_of(n, C)) * C + j0;
    *reinterpret_cast<uint4*>(Bs + kg * (NT * 16) + n * 16) = *reinterpret_cast<const uint4*>(src);
  }
}

// The accumulator row pixels of this thread (rows 16 warp + lane/4 and +8
// of its warpgroup's tile).
__device__ __forceinline__ void thread_pixels(int (&pix)[2], int W) {
  const int wg = threadIdx.x / WG_THREADS, lane = threadIdx.x % 32;
  const int warp = threadIdx.x % WG_THREADS / 32;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) pix[rr] = tile_pixel(wg, 16 * warp + lane / 4 + 8 * rr, W);
}

// ------------------------------------------------------------ host side
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the process already runs on (no
// link against libcuda).
inline EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (lib == nullptr) lib = dlopen("libcuda.so.1", RTLD_NOW);
    return lib != nullptr ? reinterpret_cast<EncodeTiled>(dlsym(lib, "cuTensorMapEncodeTiled"))
                          : nullptr;
  }();
  return fn;
}

// A TMA map over a contiguous bf16 [N, H, W, C] tensor with boxes of 8
// channels x box_w x box_h pixels x 1 frame.
inline cudaError_t frame_map(CUtensorMap* map, const void* base, int N, int H, int W, int C,
                             int box_h, int box_w) {
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return cudaErrorSharedObjectSymbolNotFound;
  const cuuint64_t dims[4] = {(cuuint64_t)C, (cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)N};
  const cuuint64_t strides[3] = {(cuuint64_t)C * 2, (cuuint64_t)W * C * 2,
                                 (cuuint64_t)H * W * C * 2};
  const cuuint32_t box[4] = {8, (cuuint32_t)box_w, (cuuint32_t)box_h, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
                         strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

inline cudaLaunchConfig_t launch_config(dim3 grid, int threads, int smem, int cluster,
                                        cudaStream_t stream, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Launch `kernel` with `smem` bytes of dynamic shared memory in clusters of
// `cluster` blocks along x; returns the launch's error.
template <typename... KArgs, typename... Args>
cudaError_t launch(void (*kernel)(KArgs...), dim3 grid, int threads, int smem, int cluster,
                   cudaStream_t stream, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = launch_config(grid, threads, smem, cluster, stream, &attr);
  err = cudaLaunchKernelEx(&cfg, kernel, static_cast<KArgs>(args)...);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// How many clusters of `kernel`'s launch can be resident at once (0 if
// none fits).
template <typename... KArgs>
int max_active_clusters(void (*kernel)(KArgs...), dim3 grid, int threads, int smem, int cluster) {
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem) !=
      cudaSuccess)
    return -1;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = launch_config(grid, threads, smem, cluster, nullptr, &attr);
  int n = 0;
  return cudaOccupancyMaxActiveClusters(&n, kernel, &cfg) == cudaSuccess ? n : -1;
}

}  // namespace hopper
}  // namespace
