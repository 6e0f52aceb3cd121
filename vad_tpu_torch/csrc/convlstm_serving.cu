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
// outside the frame) when C % 8 == 0, else through plain loads; the tile
// machinery is convlstm_tiles.cuh, shared with kernel 3.
//
// Kernel 2 at the training shape (B=8, T=16, 16x16, C=128, bf16): 38.65
// GFLOP per call -> 39 us at 989 TFLOP/s against ~56 MB -> 17 us, so the
// tensor cores bound it too; it adds c_seq's 8.4 MB of stores to kernel 1.
//
// Bound on an H100 SXM at the serving shape (B=16, T=16, 16x16, C=128,
// bf16): 77.3 GFLOP per call -> 78 us at 989 TFLOP/s, against ~93 MB of
// traffic -> 28 us at 3.35 TB/s, so the tensor cores bound it.  bf16 runs
// the product on the tensor cores through WMMA (16x16x16, f32 accumulate);
// f32 runs it as register-blocked FMAs, so an f32 reference comparison is
// not rounded to TF32.  Not yet done: wgmma/TMA, and keeping h on chip
// across steps (one persistent launch instead of T).

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

template <bool STORE_CELL>
int run_dtype(const void* gates_x, const void* w_h, const void* h0, void* c, void* h_seq,
              void* c_seq, void* h_final, Shape s, int is_bf16, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  auto* cf = static_cast<float*>(c);
  auto* hf = static_cast<float*>(h_final);
  if (is_bf16)
    return run_t<__nv_bfloat16, STORE_CELL>(gates_x, w_h, h0, cf, h_seq, c_seq, hf, s, st);
  return run_t<float, STORE_CELL>(gates_x, w_h, h0, cf, h_seq, c_seq, hf, s, st);
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
  return run_dtype<false>(gates_x, w_h, h0, c, h_seq, nullptr, h_final, Shape{B, T, H, W, C},
                          is_bf16, stream);
}

// As convlstm_serving_forward, and c_seq [B,T,H,W,C] (the gates' type)
// receives every step's cell state.
int convlstm_train_forward(const void* gates_x, const void* w_h, const void* h0, void* c,
                           void* h_seq, void* c_seq, void* h_final, int B, int T, int H, int W,
                           int C, int is_bf16, void* stream) {
  return run_dtype<true>(gates_x, w_h, h0, c, h_seq, c_seq, h_final, Shape{B, T, H, W, C},
                         is_bf16, stream);
}

const char* convlstm_serving_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
