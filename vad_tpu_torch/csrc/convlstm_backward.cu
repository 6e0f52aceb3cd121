// ConvLSTM training backward for Hopper (sm_90a), plain C interface.
//
// Replaces: vad_tpu/ops/convlstm_pallas.py `_backward_kernel` (reached
// through `_run_backward`, the `_bwd` of `convlstm_recurrence_pallas`'s
// custom VJP).  Kernel 3 of the port.
//
// Reverse time, carrying (dh, dc) in f32, recomputing the gates from the
// stored h_seq (c_seq holds the cell states):
//     gates  = gates_x[t] + conv3x3_SAME(h_{t-1}, Wh)     (h_{-1} = h0)
//     dh_tot = dh_seq[t] + dh;  dc_tot = dc + dh_tot * o * (1 - tanh(c_t)^2)
//     d(i,f,g,o) = (dc_tot g i(1-i), dc_tot c_{t-1} f(1-f),
//                   dc_tot i (1-g^2), dh_tot tanh(c_t) o(1-o))
//     dh = full correlation of dgates with Wh (taps reversed);  dc = dc_tot f
//     dWh += im2col(h_{t-1})^T . dgates                    (over B, T, pixels)
//
// Design.  The TPU kernel walks the (B, T) grid in order with the carries
// and dWh resident in VMEM.  CUDA blocks have no order, and the one
// ordering constraint is that dh_{t-1} needs all of step t.  So the work
// splits into three implicit GEMMs of equal size (2*B*T*H*W*9C*4C FLOP
// each), launched on the caller's stream, 2T+1 launches per call:
//   (a) gate_step, for t = T-1..0: the forward's GEMM (M = B*H*W pixels,
//       K = 9C taps of h_{t-1}, N = 4C), a block owning 64 pixels x 32
//       channels x 4 gates, so the whole gate gradient is its epilogue:
//       it writes dgates_x[t] in the gates' type and updates dc in place;
//   (b) dh_step, for the same t: dh = sum_taps shift(dgates_x[t]) .
//       Wh[tap]^T (M = B*H*W, K = 9*4C, N = C), with Wh^T per tap passed
//       in pre-transposed ([9, 4C, C]) and out-of-frame taps zero-filled;
//   (c) dw, once after the loop: dWh = sum_m im2col(h)[m]^T dgates[m]
//       (M = 9C rows in [3,3,C,4C] order, N = 4C, K = B*T*H*W).  Each block
//       owns one output tile and walks all of K, so the sum is
//       deterministic and needs no atomics.
// (b) and (c) read the stored dgates_x, so under bf16 they multiply the
// bf16-rounded gate gradients on the tensor cores while the carries stay
// f32.  Every operand streams through a 3-stage cp.async ring (16-byte
// copies, zero-fill outside the frame) when C % 8 == 0, else plain loads;
// bf16 runs WMMA (16x16x16, f32 accumulate), f32 register-blocked FMAs so
// an f32 comparison is not rounded to TF32.  Any B, T, H, W, C is taken.
//
// Bound on an H100 SXM at the training shape (B=8, T=16, 16x16, C=128,
// bf16): 3 x 38.65 = 116 GFLOP per call -> 117 us at 989 TFLOP/s, against
// ~96 MB of traffic -> 29 us at 3.35 TB/s: the tensor cores bound it.  In
// f32 (no tensor cores) the floor is 1.73 ms at 67 TFLOP/s.  Not yet done:
// wgmma/TMA, fewer launches, and more blocks for (b) and (c), which at
// that shape fill only 32 and 72 of the 132 SMs.

#include "convlstm_tiles.cuh"

namespace {

// --------------------------------------------------------- (a) gate step

template <typename T, bool VEC>
__global__ void __launch_bounds__(THREADS)
    gate_step_kernel(const T* __restrict__ gates_x, const T* __restrict__ w_h,
                     const T* __restrict__ h0, const float* __restrict__ c0,
                     const T* __restrict__ h_seq, const T* __restrict__ c_seq,
                     const T* __restrict__ dh_seq, const float* __restrict__ dh_carry,
                     float* __restrict__ dc_carry, T* __restrict__ dgates_x, Shape s, int t) {
  using L = Tiles<T>;
  __shared__ __align__(128) unsigned char smem[SMEM_BYTES];
  const float* Cs = reinterpret_cast<const float*>(smem);
  const int hw = s.H * s.W;
  const int m0 = blockIdx.x * BM;
  const int cb = blockIdx.y * CG;
  const int kchunks = (s.C + L::BK - 1) / L::BK;
  const GateLoad<T, VEC> load{t == 0 ? h0 : h_seq + (size_t)(t - 1) * hw * s.C,
                              (size_t)(t == 0 ? 1 : s.T) * hw * s.C, w_h, s, m0, cb, kchunks};
  gemm_tile<T, false>(load, 9 * kchunks, smem);

  for (int e = threadIdx.x; e < BM * CG; e += THREADS) {
    const int row = e / CG;
    const int j = e - row * CG;
    const int r = m0 + row;
    const int ch = cb + j;
    if (r >= s.B * hw || ch >= s.C) continue;
    const int b = r / hw, p = r - b * hw;
    const size_t cell = ((size_t)b * s.T + t) * hw + p;  // (b, t, p)
    const T* gx = gates_x + cell * (4 * s.C) + ch;
    const float* acc = Cs + row * LDC + j;
    const float i = sigmoid(acc[0 * CG] + to_f32(gx[0 * s.C]));
    const float f = sigmoid(acc[1 * CG] + to_f32(gx[1 * s.C]));
    const float g = tanhf(acc[2 * CG] + to_f32(gx[2 * s.C]));
    const float o = sigmoid(acc[3 * CG] + to_f32(gx[3 * s.C]));
    const size_t sidx = (size_t)r * s.C + ch;
    const size_t cidx = cell * s.C + ch;
    const float tanh_ct = tanhf(to_f32(c_seq[cidx]));
    const float c_prev = t == 0 ? c0[sidx] : to_f32(c_seq[cidx - (size_t)hw * s.C]);
    const float dh_total = to_f32(dh_seq[cidx]) + dh_carry[sidx];
    const float dc_total = dc_carry[sidx] + dh_total * o * (1.0f - tanh_ct * tanh_ct);
    T* dg = dgates_x + cell * (4 * s.C) + ch;
    dg[0 * s.C] = from_f32<T>(dc_total * g * i * (1.0f - i));
    dg[1 * s.C] = from_f32<T>(dc_total * c_prev * f * (1.0f - f));
    dg[2 * s.C] = from_f32<T>(dc_total * i * (1.0f - g * g));
    dg[3 * s.C] = from_f32<T>(dh_total * tanh_ct * o * (1.0f - o));
    dc_carry[sidx] = dc_total * f;
  }
}

// ----------------------------------------------------------- (b) dh step

// Stage kk: A = 64 output pixels' dgates_x[t] at source pixel
// (y + 1 - dy, x + 1 - dx) for tap (dy, dx), one chunk of its 4C; B = rows
// of Wh[tap]^T ([4C, C]) for the block's 128 hidden channels.
template <typename T, bool VEC> struct DhLoad {
  const T* dg_t;  // dgates_x[:, t]
  const T* w_t;   // [9, 4C, C]
  Shape s;
  int m0, cb, kchunks;

  __device__ __forceinline__ void operator()(T* As, T* Bs, int kk) const {
    using L = Tiles<T>;
    const int tid = threadIdx.x;
    const int tap = kk / kchunks;
    const int k0 = (kk - tap * kchunks) * L::BK;
    const int hw = s.H * s.W;
    const int four_c = 4 * s.C;
    {  // A: one chunk per thread
      const int row = tid / (L::BK / L::CE);
      const int c0 = (tid % (L::BK / L::CE)) * L::CE;
      const int r = m0 + row;
      bool valid = r < s.B * hw;
      const T* src = dg_t;
      if (valid) {
        const int b = r / hw, p = r - b * hw;
        const int y = p / s.W + 1 - tap / 3, x = p % s.W + 1 - tap % 3;
        valid = y >= 0 && y < s.H && x >= 0 && x < s.W;
        src = dg_t + ((size_t)b * s.T * hw + y * s.W + x) * four_c + k0 + c0;
      }
      const int kc = k0 + c0;
      copy_chunk<T, VEC>(As + row * L::LDA + c0, src, dg_t, valid && kc < four_c,
                         [&](int e) { return valid && kc + e < four_c; });
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {  // B: two chunks per thread
      const int q = tid + i * THREADS;
      const int kr = q / (BN / L::CE);
      const int col = (q % (BN / L::CE)) * L::CE;
      const int n = k0 + kr;
      const int k = cb + col;
      const T* src = w_t + ((size_t)tap * four_c + n) * s.C + k;
      copy_chunk<T, VEC>(Bs + kr * L::LDB + col, src, w_t, n < four_c && k < s.C,
                         [&](int e) { return n < four_c && k + e < s.C; });
    }
  }
};

template <typename T, bool VEC>
__global__ void __launch_bounds__(THREADS)
    dh_step_kernel(const T* __restrict__ dgates_x, const T* __restrict__ w_t,
                   float* __restrict__ dh_carry, Shape s, int t) {
  using L = Tiles<T>;
  __shared__ __align__(128) unsigned char smem[SMEM_BYTES];
  const float* Cs = reinterpret_cast<const float*>(smem);
  const int hw = s.H * s.W;
  const int m0 = blockIdx.x * BM;
  const int cb = blockIdx.y * BN;
  const int kchunks = (4 * s.C + L::BK - 1) / L::BK;
  const DhLoad<T, VEC> load{dgates_x + (size_t)t * hw * 4 * s.C, w_t, s, m0, cb, kchunks};
  gemm_tile<T, false>(load, 9 * kchunks, smem);

  for (int e = threadIdx.x; e < BM * BN; e += THREADS) {
    const int row = e / BN;
    const int col = e - row * BN;
    const int r = m0 + row;
    const int k = cb + col;
    if (r < s.B * hw && k < s.C) dh_carry[(size_t)r * s.C + k] = Cs[row * LDC + col];
  }
}

// ---------------------------------------------------------------- (c) dw

// Stage kk: BK pixels m (over B, T, H, W).  A (K-major) = im2col(h_{t-1})
// at those pixels for the block's 64 rows (tap, k) of [9C]; B = their
// dgates_x rows for the block's 128 gate columns.
template <typename T, bool VEC> struct DwLoad {
  const T* h0;  // [B, H, W, C], h_{-1}
  const T* h_seq;
  const T* dgates_x;
  Shape s;
  int rb, nb;

  // h_{t-1}[b, (y, x) + tap offset, k] for pixel m, or nullptr outside
  __device__ __forceinline__ const T* h_at(int m, int tap, int k) const {
    const int hw = s.H * s.W;
    const int b = m / (s.T * hw);
    const int rem = m - b * s.T * hw;
    const int t = rem / hw, p = rem - t * hw;
    const int y = p / s.W + tap / 3 - 1, x = p % s.W + tap % 3 - 1;
    if (y < 0 || y >= s.H || x < 0 || x >= s.W) return nullptr;
    const size_t pix = (size_t)y * s.W + x;
    if (t == 0) return h0 + ((size_t)b * hw + pix) * s.C + k;
    return h_seq + (((size_t)b * s.T + t - 1) * hw + pix) * s.C + k;
  }

  __device__ __forceinline__ void operator()(T* As, T* Bs, int kk) const {
    using L = Tiles<T>;
    const int tid = threadIdx.x;
    const int m_total = s.B * s.T * s.H * s.W;
    const int rows = 9 * s.C;
    const int four_c = 4 * s.C;
    const int m0 = kk * L::BK;
    {  // A: one chunk (CE consecutive rows of one pixel) per thread
      const int kr = tid / (BM / L::CE);
      const int c0 = (tid % (BM / L::CE)) * L::CE;
      const int m = m0 + kr;
      const int row = rb + c0;
      T* dst = As + kr * L::LDAT + c0;
      if (VEC) {  // C % 8 == 0: the chunk's rows share one tap
        const T* src = (m < m_total && row < rows) ? h_at(m, row / s.C, row % s.C) : nullptr;
        cp_async16(dst, src != nullptr ? src : h0, src != nullptr);
      } else {
#pragma unroll
        for (int e = 0; e < L::CE; ++e) {
          const T* src = (m < m_total && row + e < rows)
                             ? h_at(m, (row + e) / s.C, (row + e) % s.C)
                             : nullptr;
          dst[e] = src != nullptr ? *src : from_f32<T>(0.0f);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {  // B: two chunks per thread
      const int q = tid + i * THREADS;
      const int kr = q / (BN / L::CE);
      const int col = (q % (BN / L::CE)) * L::CE;
      const int m = m0 + kr;
      const int n = nb + col;
      const T* src = dgates_x + (size_t)m * four_c + n;
      copy_chunk<T, VEC>(Bs + kr * L::LDB + col, src, dgates_x, m < m_total && n < four_c,
                         [&](int e) { return m < m_total && n + e < four_c; });
    }
  }
};

template <typename T, bool VEC>
__global__ void __launch_bounds__(THREADS)
    dw_kernel(const T* __restrict__ h0, const T* __restrict__ h_seq,
              const T* __restrict__ dgates_x, float* __restrict__ dw, Shape s) {
  using L = Tiles<T>;
  __shared__ __align__(128) unsigned char smem[SMEM_BYTES];
  const float* Cs = reinterpret_cast<const float*>(smem);
  const int rb = blockIdx.x * BM;
  const int nb = blockIdx.y * BN;
  const int m_total = s.B * s.T * s.H * s.W;
  const DwLoad<T, VEC> load{h0, h_seq, dgates_x, s, rb, nb};
  gemm_tile<T, true>(load, (m_total + L::BK - 1) / L::BK, smem);

  for (int e = threadIdx.x; e < BM * BN; e += THREADS) {
    const int row = e / BN;
    const int col = e - row * BN;
    const int r = rb + row;
    const int n = nb + col;
    if (r < 9 * s.C && n < 4 * s.C) dw[(size_t)r * 4 * s.C + n] = Cs[row * LDC + col];
  }
}

struct Args {
  const void *gates_x, *w_h, *w_t, *h0, *c0, *h_seq, *c_seq, *dh_seq;
  void *dh_carry, *dc_carry, *dgates_x, *dw;
};

template <typename T, bool VEC>
int run(const Args& a, Shape s, cudaStream_t stream) {
  const int pixels = s.B * s.H * s.W;
  const dim3 gate_grid((pixels + BM - 1) / BM, (s.C + CG - 1) / CG);
  const dim3 dh_grid((pixels + BM - 1) / BM, (s.C + BN - 1) / BN);
  const dim3 dw_grid((9 * s.C + BM - 1) / BM, (4 * s.C + BN - 1) / BN);
  const T* gx = static_cast<const T*>(a.gates_x);
  const T* h0 = static_cast<const T*>(a.h0);
  const T* hs = static_cast<const T*>(a.h_seq);
  T* dg = static_cast<T*>(a.dgates_x);
  auto* dh = static_cast<float*>(a.dh_carry);
  for (int t = s.T - 1; t >= 0; --t) {
    gate_step_kernel<T, VEC><<<gate_grid, THREADS, 0, stream>>>(
        gx, static_cast<const T*>(a.w_h), h0, static_cast<const float*>(a.c0), hs,
        static_cast<const T*>(a.c_seq), static_cast<const T*>(a.dh_seq), dh,
        static_cast<float*>(a.dc_carry), dg, s, t);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    dh_step_kernel<T, VEC><<<dh_grid, THREADS, 0, stream>>>(
        dg, static_cast<const T*>(a.w_t), dh, s, t);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  dw_kernel<T, VEC><<<dw_grid, THREADS, 0, stream>>>(h0, hs, dg, static_cast<float*>(a.dw), s);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int run_t(const Args& a, Shape s, cudaStream_t stream) {
  if (s.C % 8 == 0) return run<T, true>(a, s, stream);
  return run<T, false>(a, s, stream);
}

}  // namespace

extern "C" {

// gates_x [B,T,H,W,4C], w_h [3,3,C,4C], w_t [9,4C,C] (w_h per tap
// transposed), h0 [B,H,W,C], h_seq, c_seq, dh_seq [B,T,H,W,C] and the
// output dgates_x [B,T,H,W,4C] in one type (bf16 when is_bf16, else f32);
// c0 [B,H,W,C] f32.  dh_carry, dc_carry [B,H,W,C] f32 hold the final
// states' cotangents on entry and dh0, dc0 on return; dw [3,3,C,4C] f32
// receives dWh.  All contiguous.  Launches 2T+1 kernels on `stream`;
// returns the first launch error, or 0.
int convlstm_backward(const void* gates_x, const void* w_h, const void* w_t, const void* h0,
                      const void* c0, const void* h_seq, const void* c_seq, const void* dh_seq,
                      void* dh_carry, void* dc_carry, void* dgates_x, void* dw, int B, int T,
                      int H, int W, int C, int is_bf16, void* stream) {
  const Args a{gates_x, w_h, w_t, h0, c0, h_seq, c_seq, dh_seq, dh_carry, dc_carry,
               dgates_x, dw};
  const Shape s{B, T, H, W, C};
  auto st = static_cast<cudaStream_t>(stream);
  if (is_bf16) return run_t<__nv_bfloat16>(a, s, st);
  return run_t<float>(a, s, st);
}

const char* convlstm_backward_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
