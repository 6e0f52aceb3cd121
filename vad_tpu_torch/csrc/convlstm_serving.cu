// ConvLSTM serving and training-forward recurrence for Hopper (sm_90a),
// plain C interface.
//
// Replaces: vad_tpu/ops/convlstm_pallas.py `_serving_kernel` (reached
// through `_run_serving_forward`, the primal of `convlstm_recurrence_pallas`;
// entry point `convlstm_serving_forward`, kernel 1) and `_forward_kernel`
// (reached through `_run_forward(with_cell_seq=True)`, the `_fwd` of its
// custom VJP; entry point `convlstm_train_forward`, kernel 2).  Kernel 2 is
// kernel 1 built with STORE_CELL: the step's epilogue also writes
// c_seq[:, t] in the gates' type, as `_forward_kernel` stores it.
//
// For t in 0..T-1:
//     gates = gates_x[:, t] + conv3x3_SAME(h, Wh)          (i, f, g, o order)
//     c = sigmoid(f) * c + sigmoid(i) * tanh(g)
//     h = sigmoid(o) * tanh(c)
// with c carried in f32, h cast to the weights' type before the conv,
// h_seq written in the gates' type and the final (h, c) in f32.
//
// Design.  The TPU kernel runs the T grid axis in order and keeps (h, c)
// in VMEM between steps.  Here ops/convlstm.py's plan picks one of two
// designs from the shape and type:
//
// Resident (bf16, H and W multiples of 8, H*W <= 256, C a multiple of 16
// up to 128): one launch per call.  A thread-block cluster of C/16 blocks
// owns one batch element for all T steps and gives h_t to its blocks
// through distributed shared memory, so h never leaves the chip between
// steps and Wh is read from device memory once per block per call (the
// `resident` namespace below says how).
//
// Stepwise (f32, and every other shape): a host loop of one launch per
// step (T per call, on the caller's stream, which orders them).  Each
// launch is an implicit GEMM over the whole batch: M = B*H*W pixels, K =
// 9*C (3x3 taps of h), N = 4*C gate columns.  A block owns 64 pixels and
// 32 hidden channels with all four of their gates (128 columns), so the
// gate math runs in the GEMM's epilogue and c is updated in place (each
// element is read and written by one thread only).  The conv's input at
// step t is h_{t-1} in the weights' type, which is exactly h_seq[:, t-1]:
// the kernel reads it from there (h0 cast once for t = 0), so no f32 copy
// of h is kept between steps.  Taps outside the frame read zeros (the TPU
// kernel masks rolled rows for the same purpose), so any H, W, C is taken.
// Tiles stream through a 3-stage cp.async ring (16-byte copies) when
// C % 8 == 0, else through plain loads; bf16 runs WMMA 16x16x16, f32
// register-blocked FMAs, so an f32 comparison is not rounded to TF32.
//
// Bound on an H100 SXM at the serving shape (B=16, T=16, 16x16, C=128,
// bf16): 77.3 GFLOP per call -> 78 us at 989 TFLOP/s, against ~93 MB of
// traffic -> 28 us at 3.35 TB/s, so the tensor cores bound it.  Kernel 2
// at the training shape (B=8): 38.65 GFLOP -> 39 us against ~56 MB -> 17
// us.  What holds the resident design above its bound: each wgmma
// (m64n64k16) reads 4 KB of operands from shared memory for 131 kFLOP, so
// shared memory bandwidth and the tensor cores tie at about 32 clocks an
// instruction; two cluster barriers, the gate math and the writes of h_t
// to every block sit between steps; and at B=16 only 15 clusters of 8 fit at once
// (cudaOccupancyMaxActiveClusters at 231,440 bytes a block), so the 16th
// batch element runs in a second wave.
//
// Measured by chip_smoke.py on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md
// §6): kernel 1 at the serving shape 0.457 ms per call, one launch (169
// TFLOP/s; bound 0.078 ms; the stepwise design 0.88 ms, 16 launches);
// kernel 2 at the training shape 0.238 ms, one launch (162 TFLOP/s; bound
// 0.039 ms); f32 (stepwise) 3.10 and 1.92 ms.

#include "convlstm_tiles.cuh"

namespace {

template <typename T, bool VEC, bool STORE_CELL>
__global__ void __launch_bounds__(THREADS)
    convlstm_step_kernel(const T* __restrict__ gates_x, const T* __restrict__ w_h,
                         const T* __restrict__ h0, float* __restrict__ c_state,
                         T* __restrict__ h_seq, T* __restrict__ c_seq,
                         float* __restrict__ h_final, Shape s, int t) {
  using L = Tiles<T>;
  __shared__ __align__(128) unsigned char smem[SMEM_BYTES];
  const float* Cs = reinterpret_cast<const float*>(smem);
  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * BM;
  const int cb = blockIdx.y * CG;
  const int hw = s.H * s.W;
  const int kchunks = (s.C + L::BK - 1) / L::BK;
  // the conv's input: h0 (in T) at t = 0, else h_seq[:, t-1]
  const GateLoad<T, VEC> load{t == 0 ? h0 : h_seq + (size_t)(t - 1) * hw * s.C,
                              (size_t)(t == 0 ? 1 : s.T) * hw * s.C, w_h, s, m0, cb, kchunks};
  gemm_tile<T, false>(load, 9 * kchunks, smem);

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
    if constexpr (STORE_CELL) c_seq[(bt * hw + p) * s.C + ch] = from_f32<T>(c_new);
    if (t == s.T - 1) h_final[sidx] = h_new;
  }
}

// ------------------------------------------------------ resident design
//
// One launch per call (bf16).  A cluster of C/16 blocks owns one batch
// element for all T steps; block `rank` owns hidden channels [16 rank,
// 16 rank + 16) with their four gates: 64 GEMM columns, whose rows of Wh
// (K = 9C) stay in its shared memory for the whole call (147,456 bytes at
// C = 128).  Beside them sits the padded frame of h_{t-1} (16 planes,
// 83,968 bytes at 16x16, C = 128): TMA brings h0 with its zero border, and
// every later frame arrives from the cluster's blocks through distributed
// shared memory.  Each warpgroup owns one 8x8 pixel tile (H*W <= 256), so
// a step is 9 * C/16 wgmma (m64n64k16) per warpgroup, the gate math runs
// on the accumulators in registers (hardware tanh: tanh_fast and
// sigmoid_fast in convlstm_tiles.cuh), and c stays in registers in f32.
// Per step: GEMM; arrive on the cluster barrier (my frame is read); gate
// math, h_seq / c_seq stores; wait (every frame is read); write h_t into
// every block's frame; cluster barrier.
//
// The block's 64 columns follow column_of (convlstm_tiles.cuh): lane q of
// an accumulator row holds channels 4q..4q+3 of all four gates.
namespace resident {
using namespace hopper;

template <bool STORE_CELL>
__global__ void __launch_bounds__(THREADS_R, 1)
    recurrence_kernel(const __grid_constant__ CUtensorMap h0_map, const bf16* __restrict__ gates_x,
                      const bf16* __restrict__ w_t, float* __restrict__ c_state,
                      bf16* __restrict__ h_seq, bf16* __restrict__ c_seq,
                      float* __restrict__ h_final, Shape s) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int H = s.H, W = s.W, C = s.C, hw = H * W;
  const int planes = C / 8;
  unsigned char* frame = smem;
  unsigned char* Bs = smem + planes * frame_plane_bytes(H, W);
  uint64_t* bar = reinterpret_cast<uint64_t*>(Bs + 9 * C * NT * 2);
  const int ncta = gridDim.x, b = blockIdx.y, cb = blockIdx.x * 16;
  const int tid = threadIdx.x, wg = tid / WG_THREADS, lane = tid % 32;
  const int warp = tid % WG_THREADS / 32, q = lane % 4;
  const bool active = wg < (H / 8) * (W / 8);

  if (tid == 0) {
    mbar_init(bar, 1);
    mbar_expect_tx(bar, frame_tx_bytes(planes, H, W));
    tma_frame(frame, &h0_map, b, planes, H, W, bar);
  }
  load_wh_slice(Bs, w_t, cb, C);
  fence_async();
  __syncthreads();

  int pix[2];
  float c[2][4];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    pix[rr] = active ? tile_pixel(wg, 16 * warp + lane / 4 + 8 * rr, W) : 0;
    const float4 v = active ? *reinterpret_cast<const float4*>(
                                  c_state + ((size_t)b * hw + pix[rr]) * C + cb + 4 * q)
                            : make_float4(0.f, 0.f, 0.f, 0.f);
    c[rr][0] = v.x, c[rr][1] = v.y, c[rr][2] = v.z, c[rr][3] = v.w;
  }
  mbar_wait(bar, 0);

  float acc[32];
  for (int t = 0; t < s.T; ++t) {
    const size_t row0 = ((size_t)b * s.T + t) * hw;
    uint2 gx[4][2];
    if (active) {
#pragma unroll
      for (int G = 0; G < 4; ++G)
#pragma unroll
        for (int rr = 0; rr < 2; ++rr)
          gx[G][rr] = *reinterpret_cast<const uint2*>(
              gates_x + (row0 + pix[rr]) * 4 * C + G * C + cb + 4 * q);
      frame_gemm<1>(acc, frame, Bs, wg, H, W, C);
    }
    cluster_arrive();  // this block's frame is read
    uint2 hv[2];
    if (active) {
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        float4 g4[4];
#pragma unroll
        for (int G = 0; G < 4; ++G) g4[G] = unpack4(gx[G][rr]);
        float h[4];
#pragma unroll
        for (int c4 = 0; c4 < 4; ++c4) {
          const float gi = acc[acc_index(0, rr, c4)] + lane_of(g4[0], c4);
          const float gf = acc[acc_index(1, rr, c4)] + lane_of(g4[1], c4);
          const float gg = acc[acc_index(2, rr, c4)] + lane_of(g4[2], c4);
          const float go = acc[acc_index(3, rr, c4)] + lane_of(g4[3], c4);
          c[rr][c4] = sigmoid_fast(gf) * c[rr][c4] + sigmoid_fast(gi) * tanh_fast(gg);
          h[c4] = sigmoid_fast(go) * tanh_fast(c[rr][c4]);
        }
        hv[rr] = pack4(h[0], h[1], h[2], h[3]);
        const size_t o = (row0 + pix[rr]) * C + cb + 4 * q;
        *reinterpret_cast<uint2*>(h_seq + o) = hv[rr];
        if constexpr (STORE_CELL)
          *reinterpret_cast<uint2*>(c_seq + o) = pack4(c[rr][0], c[rr][1], c[rr][2], c[rr][3]);
        if (t == s.T - 1) {
          const size_t f = ((size_t)b * hw + pix[rr]) * C + cb + 4 * q;
          *reinterpret_cast<float4*>(h_final + f) = make_float4(h[0], h[1], h[2], h[3]);
          *reinterpret_cast<float4*>(c_state + f) =
              make_float4(c[rr][0], c[rr][1], c[rr][2], c[rr][3]);
        }
      }
    }
    cluster_wait();  // every block's frame is read
    if (t == s.T - 1) break;
    if (active) {
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const unsigned char* dst = frame + frame_offset(pix[rr], cb + 4 * q, H, W);
        for (int r = 0; r < ncta; ++r) st_peer(peer(dst, r), hv[rr]);
      }
    }
    fence_async();
    cluster_sync();  // h_t is in every frame
  }
}

template <bool STORE_CELL>
int run_resident(const void* gates_x, const void* w_t, const void* h0, float* c, void* h_seq,
                 void* c_seq, float* h_final, Shape s, cudaStream_t stream) {
  CUtensorMap h0_map;
  const cudaError_t err = frame_map(&h0_map, h0, s.B, s.H, s.W, s.C, s.H + 2, s.W + 2);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch(recurrence_kernel<STORE_CELL>, dim3(s.C / 16, s.B), THREADS_R,
                                 smem_bytes(s.H, s.W, s.C), s.C / 16, stream, h0_map,
                                 static_cast<const bf16*>(gates_x), static_cast<const bf16*>(w_t),
                                 c, static_cast<bf16*>(h_seq), static_cast<bf16*>(c_seq), h_final,
                                 s));
}

}  // namespace resident

// ------------------------------------------------------ stepwise design

template <typename T, bool VEC, bool STORE_CELL>
int run(const void* gates_x, const void* w_h, const void* h0, float* c, void* h_seq,
        void* c_seq, float* h_final, Shape s, cudaStream_t stream) {
  const dim3 grid((s.B * s.H * s.W + BM - 1) / BM, (s.C + CG - 1) / CG);
  for (int t = 0; t < s.T; ++t) {
    convlstm_step_kernel<T, VEC, STORE_CELL><<<grid, THREADS, 0, stream>>>(
        static_cast<const T*>(gates_x), static_cast<const T*>(w_h), static_cast<const T*>(h0),
        c, static_cast<T*>(h_seq), static_cast<T*>(c_seq), h_final, s, t);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

template <typename T, bool STORE_CELL>
int run_t(const void* gates_x, const void* w_h, const void* h0, float* c, void* h_seq,
          void* c_seq, float* h_final, Shape s, cudaStream_t stream) {
  if (s.C % 8 == 0)
    return run<T, true, STORE_CELL>(gates_x, w_h, h0, c, h_seq, c_seq, h_final, s, stream);
  return run<T, false, STORE_CELL>(gates_x, w_h, h0, c, h_seq, c_seq, h_final, s, stream);
}

// design 1: resident (bf16 only, the shapes ops/convlstm.py's plan admits);
// design 0: stepwise, T launches.
template <bool STORE_CELL>
int run_dtype(const void* gates_x, const void* w_h, const void* w_t, const void* h0, void* c,
              void* h_seq, void* c_seq, void* h_final, Shape s, int is_bf16, int design,
              void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  auto* cf = static_cast<float*>(c);
  auto* hf = static_cast<float*>(h_final);
  if (design == 1) {
    if (!is_bf16) return static_cast<int>(cudaErrorInvalidValue);
    return resident::run_resident<STORE_CELL>(gates_x, w_t, h0, cf, h_seq, c_seq, hf, s, st);
  }
  if (is_bf16)
    return run_t<__nv_bfloat16, STORE_CELL>(gates_x, w_h, h0, cf, h_seq, c_seq, hf, s, st);
  return run_t<float, STORE_CELL>(gates_x, w_h, h0, cf, h_seq, c_seq, hf, s, st);
}

}  // namespace

extern "C" {

// gates_x [B,T,H,W,4C], w_h [3,3,C,4C], w_t [9,4C,C] (w_h per tap
// transposed), h0 [B,H,W,C] and h_seq [B,T,H,W,C] in one type (bf16 when
// is_bf16, else f32); c [B,H,W,C] f32 holds c0 and is updated in place;
// h_final [B,H,W,C] f32 receives h_T.  All contiguous.  design 1 launches
// one kernel (resident; bf16), design 0 launches T (stepwise), on
// `stream`; returns the first launch error, or 0.
int convlstm_serving_forward(const void* gates_x, const void* w_h, const void* w_t,
                             const void* h0, void* c, void* h_seq, void* h_final, int B, int T,
                             int H, int W, int C, int is_bf16, int design, void* stream) {
  return run_dtype<false>(gates_x, w_h, w_t, h0, c, h_seq, nullptr, h_final,
                          Shape{B, T, H, W, C}, is_bf16, design, stream);
}

// As convlstm_serving_forward, and c_seq [B,T,H,W,C] (the gates' type)
// receives every step's cell state.
int convlstm_train_forward(const void* gates_x, const void* w_h, const void* w_t, const void* h0,
                           void* c, void* h_seq, void* c_seq, void* h_final, int B, int T, int H,
                           int W, int C, int is_bf16, int design, void* stream) {
  return run_dtype<true>(gates_x, w_h, w_t, h0, c, h_seq, c_seq, h_final, Shape{B, T, H, W, C},
                         is_bf16, design, stream);
}

// Clusters of the resident design's launch at (B, H, W, C) that fit on the
// card at once (-1 if the query fails).
int convlstm_serving_active_clusters(int B, int H, int W, int C, int store_cell) {
  const dim3 grid(C / 16, B);
  const int smem = resident::smem_bytes(H, W, C);
  return store_cell
             ? hopper::max_active_clusters(resident::recurrence_kernel<true>, grid,
                                           resident::THREADS_R, smem, C / 16)
             : hopper::max_active_clusters(resident::recurrence_kernel<false>, grid,
                                           resident::THREADS_R, smem, C / 16);
}

const char* convlstm_serving_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
