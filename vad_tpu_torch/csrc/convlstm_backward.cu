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
// and dWh resident in VMEM.  Three GEMMs of equal size (2*B*T*H*W*9C*4C
// FLOP each) make the work.  Only the dh product sits on the recurrence's
// critical path: the gate recompute reads only the stored h_seq / h0, and
// dWh only h and the stored dgates.  So both leave the time loop, and
// ops/convlstm.py's plan picks one of two designs:
//
// Resident (bf16, 8 | H, 16 | W, H*W <= 256, C in {64, 128}): 4 launches.
//   (a) gate_kernel: the forward's GEMM over all B*T frames at once, on
//       the Hopper core (convlstm_tiles.cuh): a block keeps its 64 columns
//       of Wh (9C x 64) in shared memory and walks a group of frames, each
//       frame's padded h_{t-1} brought by TMA; it writes the gate
//       activations (sigmoid / tanh applied) in f32 to a scratch
//       [B,T,H,W,4C] (67 MB at B=8, T=16, 16x16, C=128), which the wrapper
//       allocates and frees.
//   (b) loop_kernel: the reverse loop in one launch.  A cluster of C/16
//       blocks owns one batch element for all T steps; block (gate g,
//       half h) keeps Wh^T's rows for gate g and 64 of the C outputs (9C x
//       64, 147,456 bytes) resident.  Per step: every block computes the
//       dgates / dc of its 1/(C/16) of the frame's pixels from the scratch
//       and its f32 carries in registers, stores dgates_x, and sends each
//       gate's dgates to that gate's blocks through distributed shared
//       memory, into a padded frame; cluster barrier; each block runs the
//       correlation of its gate's frame with its Wh^T slice on wgmma (a
//       partial dh over one gate); the partials cross the cluster again
//       and each block sums the four, in gate order, for its pixels.
//   (c) dw_kernel_res + dw_reduce_kernel: dWh with its K = B*T*H*W split
//       over frame groups: block (tap row, 64 gate columns, split) keeps
//       the accumulators of its three taps x C rows in registers, walks
//       its frames (h_{t-1} and dgates by TMA; both operands MN-major),
//       and writes an f32 partial; a second pass sums the partials in
//       split order.  No atomics: the sum is deterministic.
// Stepwise_tc (f32 with C % 4 == 0; bf16 with C % 8 == 0 where the
//   resident design refuses the frame, such as the 32x32 latent of 512x512
//   frames): the stepwise design's T + 3 launches with every GEMM on the
//   tensor cores (convlstm_tiles.cuh): the gate recompute and the per-step
//   dh product on the wgmma tile over grids that fill the card (the `tc`
//   namespace below).  f32 in 3xTF32, dWh and dh0 on the cp.async ring's
//   mma.sync path (staged as the stepwise design stages them; dWh's
//   operands are both pixel-major in device memory, where wgmma's TF32 form
//   would need them K-major, and dh0 is one product of T + 1).  bf16 on
//   bf16 wgmma throughout: dWh reads both operands MN-major (tc::dw_tc,
//   units of 128 pixels through a cp.async ring, its K split into f32
//   partials), and the last launch (tc::finish_tc) runs dh0 on the reverse
//   loop's tile and sums dWh's partials in split order.
// Stepwise (bf16 with C % 8 != 0 beyond the resident frames; either type
//   when named; f32 with C % 4 != 0): T + 3
//   launches on the cp.async / WMMA / FMA core: the same gate launch over
//   all frames (gate_all_kernel); per step t one launch (step_kernel)
//   computing dh_t = correlation of dgates[t+1] for a 64-pixel x
//   128-channel tile and, in the same block, dgates[t] and dc for those
//   pixels and channels (so dh never leaves the block); dWh with K split
//   over the plan's `splits` (dw_kernel, f32 partials); one last launch
//   (finish_kernel) whose first blocks compute dh0 and whose others sum
//   the partials in split order.
//
// Bound on an H100 SXM at the training shape (B=8, T=16, 16x16, C=128,
// bf16): 3 x 38.65 = 116 GFLOP per call -> 117 us at 989 TFLOP/s, against
// ~96 MB of compulsory traffic -> 29 us at 3.35 TB/s: the tensor cores
// bound it.  In f32, as 3xTF32 on the tensor cores (three TF32 products a
// multiply-add at 494.7 TFLOP/s), the floor is 0.703 ms (1.73 ms on the
// FMA cores at 67 TFLOP/s).  The activations scratch adds 2 x 67 MB of
// traffic.
//
// bf16 on a 32x32 latent (B=8, T=16, C=128): 3 x 154.6 = 463.8 GFLOP ->
// 0.469 ms at 989 TFLOP/s; the tensor cores bound it too.
//
// Measured by chip_smoke.py on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md
// §6), training shape: bf16 resident 0.735 ms per call, 4 launches (158
// TFLOP/s; parts: loop 0.31, dWh 0.20, gate 0.17 ms); bf16 stepwise 2.92
// ms; f32 stepwise 10.10 ms, 19 launches (11.5 TFLOP/s against 67).  f32
// stepwise_tc, and bf16 stepwise_tc at 32x32, by part beside stepwise,
// from one run: PERF.md §6.
// What holds the resident loop above its bound: three cluster barriers a
// step and a GEMM of one gate at a time (M = H*W, N = 64, K = 9C).

#include "convlstm_tiles.cuh"

namespace {

__device__ __forceinline__ float4 load_act(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// V consecutive elements as floats (V = 4: one 16-byte f32 or 8-byte bf16
// access; V = 1: one element).
template <typename T, int V> __device__ __forceinline__ void load_v(float (&out)[V], const T* p) {
  if constexpr (V == 4 && sizeof(T) == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    out[0] = v.x, out[1] = v.y, out[2] = v.z, out[3] = v.w;
  } else if constexpr (V == 4) {
    const float4 v = hopper::unpack4(*reinterpret_cast<const uint2*>(p));
    out[0] = v.x, out[1] = v.y, out[2] = v.z, out[3] = v.w;
  } else {
#pragma unroll
    for (int v = 0; v < V; ++v) out[v] = to_f32(p[v]);
  }
}
template <typename T, int V> __device__ __forceinline__ void store_v(T* p, const float (&in)[V]) {
  if constexpr (V == 4 && sizeof(T) == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(in[0], in[1], in[2], in[3]);
  } else if constexpr (V == 4) {
    *reinterpret_cast<uint2*>(p) = hopper::pack4(in[0], in[1], in[2], in[3]);
  } else {
#pragma unroll
    for (int v = 0; v < V; ++v) p[v] = from_f32<T>(in[v]);
  }
}

// d(i, f, g, o) and the new dc of one element, from its activations and
// tanh(c_t).
struct GateGrad {
  float di, df, dg, do_, dc;
};
__device__ __forceinline__ GateGrad gate_grad(float i, float f, float g, float o, float tanh_ct,
                                              float c_prev, float dh_total, float dc) {
  const float dc_total = dc + dh_total * o * (1.0f - tanh_ct * tanh_ct);
  return {dc_total * g * i * (1.0f - i), dc_total * c_prev * f * (1.0f - f),
          dc_total * i * (1.0f - g * g), dh_total * tanh_ct * o * (1.0f - o), dc_total * f};
}

// =================================================== resident design

namespace resident {
using namespace hopper;

// (a) Gate activations of frames blockIdx.y, + gridDim.y, ... for the 16
// channels x 4 gates of block x.
__global__ void __launch_bounds__(THREADS_R, 1)
    gate_kernel(const __grid_constant__ CUtensorMap h0_map,
                const __grid_constant__ CUtensorMap hseq_map, const bf16* __restrict__ gates_x,
                const bf16* __restrict__ w_t, float* __restrict__ act, Shape s) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int H = s.H, W = s.W, C = s.C, hw = H * W, planes = C / 8;
  unsigned char* frame = smem;
  unsigned char* Bs = smem + planes * frame_plane_bytes(H, W);
  uint64_t* bar = reinterpret_cast<uint64_t*>(Bs + 9 * C * NT * 2);
  const int cb = blockIdx.x * 16, tid = threadIdx.x, q = tid % 4;
  const bool active = tid / WG_THREADS < (H / 8) * (W / 8);
  if (tid == 0) mbar_init(bar, 1);
  load_wh_slice(Bs, w_t, cb, C);
  fence_async();
  __syncthreads();
  int pix[2];
  thread_pixels(pix, W);

  float acc[32];
  int it = 0;
  for (int f = blockIdx.y; f < s.B * s.T; f += gridDim.y, ++it) {
    const int t = f % s.T;
    if (tid == 0) {
      mbar_expect_tx(bar, frame_tx_bytes(planes, H, W));
      tma_frame(frame, t == 0 ? &h0_map : &hseq_map, t == 0 ? f / s.T : f - 1, planes, H, W,
                bar);
    }
    uint2 gx[4][2];
    if (active) {
#pragma unroll
      for (int G = 0; G < 4; ++G)
#pragma unroll
        for (int rr = 0; rr < 2; ++rr)
          gx[G][rr] = *reinterpret_cast<const uint2*>(
              gates_x + ((size_t)f * hw + pix[rr]) * 4 * C + G * C + cb + 4 * q);
    }
    mbar_wait(bar, it & 1);
    if (active) {
      frame_gemm<1>(acc, frame, Bs, threadIdx.x / WG_THREADS, H, W, C);
#pragma unroll
      for (int rr = 0; rr < 2; ++rr)
#pragma unroll
        for (int G = 0; G < 4; ++G) {
          const float4 x = unpack4(gx[G][rr]);
          float a[4];
#pragma unroll
          for (int c4 = 0; c4 < 4; ++c4) {
            const float v = acc[acc_index(G, rr, c4)] + lane_of(x, c4);
            a[c4] = G == 2 ? tanh_fast(v) : sigmoid_fast(v);
          }
          *reinterpret_cast<float4*>(act + ((size_t)f * hw + pix[rr]) * 4 * C + G * C + cb +
                                     4 * q) = make_float4(a[0], a[1], a[2], a[3]);
        }
    }
    __syncthreads();  // the frame is free for the next box
  }
}

// Shared memory of loop_kernel: the padded frame, which also holds the
// block's f32 partial dh ([H*W][64]) between steps, then Wh^T's slice.
__host__ __device__ inline int loop_region(int H, int W, int C) {
  const int frame = C / 8 * frame_plane_bytes(H, W), exch = H * W * NT * 4;
  return frame > exch ? frame : exch;
}
__host__ __device__ inline int loop_smem(int H, int W, int C) {
  return loop_region(H, W, C) + 9 * C * NT * 2;
}

// Zero the one-pixel border of this block's padded frame.
__device__ __forceinline__ void zero_border(unsigned char* frame, int planes, int H, int W) {
  const int nb = 2 * (W + 2) + 2 * H, plane = frame_plane_bytes(H, W);
  for (int e = threadIdx.x; e < planes * nb; e += blockDim.x) {
    const int j = e / nb, k = e % nb;
    const int pp = k < W + 2       ? k
                   : k < 2 * (W + 2) ? (H + 1) * (W + 2) + k - (W + 2)
                   : k < 2 * (W + 2) + H ? (k - 2 * (W + 2) + 1) * (W + 2)
                                         : (k - 2 * (W + 2) - H + 1) * (W + 2) + W + 1;
    *reinterpret_cast<uint4*>(frame + j * plane + pp * 16) = make_uint4(0, 0, 0, 0);
  }
}

// (b) The reverse loop of batch element blockIdx.y.  Cluster of C/16
// blocks; block rank = g * (C/64) + half.  dh_carry / dc_carry hold the
// final states' cotangents on entry, dh0 / dc0 on return.
__global__ void __launch_bounds__(THREADS_R, 1)
    loop_kernel(const bf16* __restrict__ w_h, const float* __restrict__ act,
                const bf16* __restrict__ c_seq, const float* __restrict__ c0,
                const bf16* __restrict__ dh_seq, float* __restrict__ dh_carry,
                float* __restrict__ dc_carry, bf16* __restrict__ dgates_x, Shape s) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int H = s.H, W = s.W, C = s.C, hw = H * W, planes = C / 8;
  unsigned char* frame = smem;
  float* exch = reinterpret_cast<float*>(smem);
  unsigned char* Bs = smem + loop_region(H, W, C);
  const int rank = blockIdx.x, b = blockIdx.y, halves = C / 64;
  const int g = rank / halves, half = rank % halves;
  const int tid = threadIdx.x, lane = tid % 32;
  const bool active = tid / WG_THREADS < (H / 8) * (W / 8);

  // B[k = tap*C + j][n] = Wh[tap][half*64 + n][g*C + j], K-major
  for (int e = tid; e < 9 * C / 8 * NT; e += blockDim.x) {
    const int kg = e / NT, n = e % NT;
    const int tap = kg / (C / 8), j0 = kg % (C / 8) * 8;
    const bf16* src = w_h + ((size_t)tap * C + half * NT + n) * 4 * C + g * C + j0;
    *reinterpret_cast<uint4*>(Bs + kg * (NT * 16) + n * 16) = *reinterpret_cast<const uint4*>(src);
  }
  for (int e = tid * 16; e < loop_region(H, W, C); e += blockDim.x * 16)
    *reinterpret_cast<uint4*>(smem + e) = make_uint4(0, 0, 0, 0);

  // This block's elementwise share: groups of 4 channels of one pixel,
  // 4 * H*W groups a block (<= 2 a thread at H*W <= 256).
  const int per_block = 4 * hw;
  int gp[2], gc[2];
  bool own[2];
  float dh[2][4], dc[2][4];
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int gi = tid + k * THREADS_R;
    own[k] = gi < per_block;
    const int G = rank * per_block + gi;
    gp[k] = own[k] ? G / (C / 4) : 0;
    gc[k] = own[k] ? G % (C / 4) * 4 : 0;
    const size_t o = ((size_t)b * hw + gp[k]) * C + gc[k];
    const float4 h4 = own[k] ? *reinterpret_cast<const float4*>(dh_carry + o) : float4{};
    const float4 c4 = own[k] ? *reinterpret_cast<const float4*>(dc_carry + o) : float4{};
    dh[k][0] = h4.x, dh[k][1] = h4.y, dh[k][2] = h4.z, dh[k][3] = h4.w;
    dc[k][0] = c4.x, dc[k][1] = c4.y, dc[k][2] = c4.z, dc[k][3] = c4.w;
  }
  fence_async();
  cluster_sync();  // every block's slice and zeroed frame are in place

  int pix[2];
  thread_pixels(pix, W);
  float acc[32];
  for (int t = s.T - 1; t >= 0; --t) {
    // dgates and dc of this block's groups, sent to their gates' frames
    if (t < s.T - 1) zero_border(frame, planes, H, W);
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      if (!own[k]) continue;
      const size_t row = ((size_t)b * s.T + t) * hw + gp[k];
      const float* a = act + row * 4 * C + gc[k];
      const float4 ai = load_act(a), af = load_act(a + C), ag = load_act(a + 2 * C),
                   ao = load_act(a + 3 * C);
      const float4 ct = unpack4(*reinterpret_cast<const uint2*>(c_seq + row * C + gc[k]));
      const float4 cp =
          t > 0 ? unpack4(*reinterpret_cast<const uint2*>(c_seq + (row - hw) * C + gc[k]))
                : *reinterpret_cast<const float4*>(c0 + ((size_t)b * hw + gp[k]) * C + gc[k]);
      const float4 dhs = unpack4(*reinterpret_cast<const uint2*>(dh_seq + row * C + gc[k]));
      float d[4][4];
#pragma unroll
      for (int c4 = 0; c4 < 4; ++c4) {
        const GateGrad gg =
            gate_grad(lane_of(ai, c4), lane_of(af, c4), lane_of(ag, c4), lane_of(ao, c4),
                      tanh_fast(lane_of(ct, c4)), lane_of(cp, c4), lane_of(dhs, c4) + dh[k][c4],
                      dc[k][c4]);
        d[0][c4] = gg.di, d[1][c4] = gg.df, d[2][c4] = gg.dg, d[3][c4] = gg.do_;
        dc[k][c4] = gg.dc;
      }
      const int off = frame_offset(gp[k], gc[k], H, W);
#pragma unroll
      for (int G = 0; G < 4; ++G) {
        const uint2 v = pack4(d[G][0], d[G][1], d[G][2], d[G][3]);
        *reinterpret_cast<uint2*>(dgates_x + row * 4 * C + G * C + gc[k]) = v;
        for (int hh = 0; hh < halves; ++hh) st_peer(peer(frame + off, G * halves + hh), v);
      }
    }
    fence_async();
    cluster_sync();  // every frame holds dgates[t] of its gate

    if (active) frame_gemm<-1>(acc, frame, Bs, tid / WG_THREADS, H, W, C);
    __syncthreads();  // the frame is read: its space takes the partial dh
    if (active) {
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        const int rr = (i / 2) % 2, col = 8 * (i / 4) + 2 * (lane % 4);
        *reinterpret_cast<float2*>(exch + pix[rr] * NT + col) = make_float2(acc[i], acc[i + 1]);
      }
    }
    cluster_sync();  // every partial is in place

#pragma unroll
    for (int k = 0; k < 2; ++k) {
      if (!own[k]) continue;
      const float* src = exch + gp[k] * NT + gc[k] % NT;
      const int hh = gc[k] / NT;
      float4 sum = ld_peer(peer(src, hh));
#pragma unroll
      for (int G = 1; G < 4; ++G) {
        const float4 v = ld_peer(peer(src, G * halves + hh));
        sum.x += v.x, sum.y += v.y, sum.z += v.z, sum.w += v.w;
      }
      dh[k][0] = sum.x, dh[k][1] = sum.y, dh[k][2] = sum.z, dh[k][3] = sum.w;
    }
    cluster_sync();  // the partials are read: the frames may be refilled
  }
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    if (!own[k]) continue;
    const size_t o = ((size_t)b * hw + gp[k]) * C + gc[k];
    *reinterpret_cast<float4*>(dh_carry + o) = make_float4(dh[k][0], dh[k][1], dh[k][2], dh[k][3]);
    *reinterpret_cast<float4*>(dc_carry + o) = make_float4(dc[k][0], dc[k][1], dc[k][2], dc[k][3]);
  }
}

// Shared memory of dw_kernel_res: the padded h frame, 8 unpadded planes of
// dgates (64 columns), one mbarrier.
__host__ __device__ inline int dw_smem(int H, int W, int C) {
  return C / 8 * frame_plane_bytes(H, W) + 8 * H * W * 16 + 16;
}
constexpr int DW_THREADS = 3 * WG_THREADS;  // one warpgroup per tap of a tap row

// (c) Partial dWh of split blockIdx.y: rows (tap dy*3 + wg, all C input
// channels) x 64 gate columns, over frames [split * per, split * per + per).
template <int MT>  // C / 64
__global__ void __launch_bounds__(DW_THREADS, 1)
    dw_kernel_res(const __grid_constant__ CUtensorMap h0_map,
                  const __grid_constant__ CUtensorMap hseq_map,
                  const __grid_constant__ CUtensorMap dg_map, float* __restrict__ part, Shape s,
                  int per) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int H = s.H, W = s.W, C = MT * 64, hw = H * W, planes = C / 8;
  const int plane = frame_plane_bytes(H, W);
  unsigned char* frame = smem;
  unsigned char* Gs = smem + planes * plane;
  uint64_t* bar = reinterpret_cast<uint64_t*>(Gs + 8 * hw * 16);
  const int ntiles = 4 * C / NT, nt = blockIdx.x % ntiles, dy = blockIdx.x / ntiles;
  const int tid = threadIdx.x, dx = tid / WG_THREADS, lane = tid % 32;
  const int warp = tid % WG_THREADS / 32, tap = dy * 3 + dx;
  if (tid == 0) mbar_init(bar, 1);
  __syncthreads();

  float acc[MT][32];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[mt][i] = 0.0f;
  const int f0 = blockIdx.y * per, f1 = min(f0 + per, s.B * s.T);
  for (int f = f0, it = 0; f < f1; ++f, ++it) {
    if (tid == 0) {
      const int t = f % s.T;
      mbar_expect_tx(bar, frame_tx_bytes(planes, H, W) + 8 * hw * 16);
      tma_frame(frame, t == 0 ? &h0_map : &hseq_map, t == 0 ? f / s.T : f - 1, planes, H, W,
                bar);
      for (int j = 0; j < 8; ++j)
        tma_load4(Gs + j * hw * 16, &dg_map, nt * NT + 8 * j, 0, 0, f, bar);
    }
    mbar_wait(bar, it & 1);
    wgmma_fence();
    for (int y = 0; y < H; ++y)
      for (int x0 = 0; x0 < W; x0 += 16) {
        const unsigned char* a = frame + ((y + dy) * (W + 2) + x0 + dx) * 16;
        const uint64_t db = desc(Gs + (y * W + x0) * 16, 128, hw * 16);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
          mma<1, 1>(acc[mt], desc(a + mt * 8 * plane, 128, plane), db);
      }
    wgmma_commit();
    wgmma_wait<0>();
    __syncthreads();  // both buffers are free for the next frame
  }
  float* out = part + (size_t)blockIdx.y * 9 * C * 4 * C;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int m = 16 * warp + lane / 4 + 8 * ((i / 2) % 2);
      const int col = 8 * (i / 4) + 2 * (lane % 4);
      *reinterpret_cast<float2*>(out + ((size_t)tap * C + mt * 64 + m) * 4 * C + nt * NT + col) =
          make_float2(acc[mt][i], acc[mt][i + 1]);
    }
}

}  // namespace resident

// dw[i] = part[0][i] + part[1][i] + ... in split order, for element i of n.
__device__ __forceinline__ void reduce_splits(const float* __restrict__ part,
                                              float* __restrict__ dw, size_t i, size_t n,
                                              int splits) {
  float a = part[i];
  for (int k = 1; k < splits; ++k) a += part[k * n + i];
  dw[i] = a;
}

__global__ void dw_reduce_kernel(const float* __restrict__ part, float* __restrict__ dw, int n,
                                 int splits) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < static_cast<size_t>(n)) reduce_splits(part, dw, i, n, splits);
}

// =================================================== stepwise design

// Stage kk of the gate GEMM over all B*T frames: as GateLoad, with rows m
// over (b, t, pixel) and h_{t-1} from h0 (t = 0) or h_seq.
template <typename T, bool VEC> struct GateAllLoad {
  const T* h0;
  const T* h_seq;
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
      bool valid = r < s.B * s.T * hw;
      const T* src = h0;
      if (valid) {
        const int bt = r / hw, p = r - bt * hw, t = bt % s.T;
        const int y = p / s.W + tap / 3 - 1, x = p % s.W + tap % 3 - 1;
        valid = y >= 0 && y < s.H && x >= 0 && x < s.W;
        const size_t pix = (size_t)y * s.W + x;
        src = (t == 0 ? h0 + ((size_t)(bt / s.T) * hw + pix) * s.C
                      : h_seq + ((size_t)(bt - 1) * hw + pix) * s.C) + k0 + c0;
      }
      const int kc = k0 + c0;
      copy_chunk<T, VEC>(As + row * L::LDA + c0, src, h0, valid && kc < s.C,
                         [&](int e) { return valid && kc + e < s.C; });
    }
    load_gate_cols<T, VEC>(Bs, w_h, s, cb, tap, k0);
  }
};

// Gate activations of every frame: M = B*T*H*W, 64 pixels x 32 channels x
// 4 gates a block, written in f32 to act.
template <typename T, bool VEC>
__global__ void __launch_bounds__(THREADS)
    gate_all_kernel(const T* __restrict__ gates_x, const T* __restrict__ w_h,
                    const T* __restrict__ h0, const T* __restrict__ h_seq, float* __restrict__ act,
                    Shape s) {
  using L = Tiles<T>;
  __shared__ __align__(128) unsigned char smem[SMEM_BYTES];
  const float* Cs = reinterpret_cast<const float*>(smem);
  const int m0 = blockIdx.x * BM, cb = blockIdx.y * CG;
  const int kchunks = (s.C + L::BK - 1) / L::BK;
  const GateAllLoad<T, VEC> load{h0, h_seq, w_h, s, m0, cb, kchunks};
  gemm_tile<T, false>(load, 9 * kchunks, smem);
  const size_t rows = (size_t)s.B * s.T * s.H * s.W;
  for (int e = threadIdx.x; e < BM * CG; e += THREADS) {
    const int row = e / CG, j = e - row * CG;
    const size_t r = m0 + row;
    const int ch = cb + j;
    if (r >= rows || ch >= s.C) continue;
#pragma unroll
    for (int G = 0; G < 4; ++G) {
      const float v = Cs[row * LDC + G * CG + j] + to_f32(gates_x[r * 4 * s.C + G * s.C + ch]);
      act[r * 4 * s.C + G * s.C + ch] = G == 2 ? tanhf(v) : sigmoid(v);
    }
  }
}

// Stage kk of the dh product: A = 64 output pixels' dgates_x[t] at source
// pixel (y + 1 - dy, x + 1 - dx) for tap (dy, dx), one chunk of its 4C;
// B = rows of Wh[tap]^T ([4C, C]) for the block's 128 hidden channels.
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

// Step t of the reverse loop for 64 pixels x 128 channels: dh_t is the
// correlation of dgates[t+1] (dh_carry's entry value at t = T-1), then
// dgates[t] and dc in the same block.
template <typename T, bool VEC>
__global__ void __launch_bounds__(THREADS)
    step_kernel(const T* __restrict__ w_t, const float* __restrict__ act,
                const T* __restrict__ c_seq, const float* __restrict__ c0,
                const T* __restrict__ dh_seq, const float* __restrict__ dh_init,
                float* __restrict__ dc_carry, T* __restrict__ dgates_x, Shape s, int t) {
  using L = Tiles<T>;
  __shared__ __align__(128) unsigned char smem[SMEM_BYTES];
  const float* Cs = reinterpret_cast<const float*>(smem);
  const int hw = s.H * s.W;
  const int m0 = blockIdx.x * BM, cb = blockIdx.y * BN;
  if (t < s.T - 1) {
    const int kchunks = (4 * s.C + L::BK - 1) / L::BK;
    const DhLoad<T, VEC> load{dgates_x + (size_t)(t + 1) * hw * 4 * s.C, w_t, s, m0, cb, kchunks};
    gemm_tile<T, false>(load, 9 * kchunks, smem);
  }
  // Groups of V channels of one pixel a thread (V = 4 when C % 8 == 0:
  // 16-byte f32 and 8-byte bf16 accesses), loads before arithmetic.
  constexpr int V = VEC ? 4 : 1;
#pragma unroll 2
  for (int e = threadIdx.x; e < BM * BN / V; e += THREADS) {
    const int row = e / (BN / V), j = (e - row * (BN / V)) * V;
    const int r = m0 + row, ch = cb + j;
    if (r >= s.B * hw || ch >= s.C) continue;
    const int b = r / hw, p = r - b * hw;
    const size_t cell = ((size_t)b * s.T + t) * hw + p;  // (b, t, p)
    const size_t sidx = (size_t)r * s.C + ch, cidx = cell * s.C + ch;
    const float* a = act + cell * 4 * s.C + ch;
    float ai[V], af[V], ag[V], ao[V], ct[V], cp[V], dhs[V], dc[V], dh[V];
    load_v<float, V>(ai, a);
    load_v<float, V>(af, a + s.C);
    load_v<float, V>(ag, a + 2 * s.C);
    load_v<float, V>(ao, a + 3 * s.C);
    load_v<T, V>(ct, c_seq + cidx);
    if (t == 0)
      load_v<float, V>(cp, c0 + sidx);
    else
      load_v<T, V>(cp, c_seq + cidx - (size_t)hw * s.C);
    load_v<T, V>(dhs, dh_seq + cidx);
    load_v<float, V>(dc, dc_carry + sidx);
    if (t < s.T - 1) {
#pragma unroll
      for (int v = 0; v < V; ++v) dh[v] = Cs[row * LDC + j + v];
    } else {
      load_v<float, V>(dh, dh_init + sidx);
    }
    float d[4][V];
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const GateGrad gg = gate_grad(ai[v], af[v], ag[v], ao[v], tanhf(ct[v]), cp[v],
                                    dhs[v] + dh[v], dc[v]);
      d[0][v] = gg.di, d[1][v] = gg.df, d[2][v] = gg.dg, d[3][v] = gg.do_;
      dc[v] = gg.dc;
    }
    T* dg = dgates_x + cell * 4 * s.C + ch;
#pragma unroll
    for (int G = 0; G < 4; ++G) store_v<T, V>(dg + G * s.C, d[G]);
    store_v<float, V>(dc_carry + sidx, dc);
  }
}

// Stage kk of dWh: BK pixels m (over B, T, H, W).  A (K-major) =
// im2col(h_{t-1}) at those pixels for the block's 64 rows (tap, k) of
// [9C]; B = their dgates_x rows for the block's 128 gate columns.
template <typename T, bool VEC> struct DwLoad {
  const T* h0;  // [B, H, W, C], h_{-1}
  const T* h_seq;
  const T* dgates_x;
  Shape s;
  int rb, nb, kk0;  // output tile, first stage of the block's K split

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
    const int m0 = (kk0 + kk) * L::BK;
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

// Partial dWh of K split blockIdx.z: sum over its `per` stages of BK pixels
// m of im2col(h)[m]^T dgates[m] (M = 9C rows in [3,3,C,4C] order, N = 4C),
// one block per output tile, into part[split].
template <typename T, bool VEC, bool TC = false>
__global__ void __launch_bounds__(THREADS)
    dw_kernel(const T* __restrict__ h0, const T* __restrict__ h_seq,
              const T* __restrict__ dgates_x, float* __restrict__ part, Shape s, int per) {
  using L = Tiles<T>;
  __shared__ __align__(128) unsigned char smem[SMEM_BYTES];
  const float* Cs = reinterpret_cast<const float*>(smem);
  const int rb = blockIdx.x * BM;
  const int nb = blockIdx.y * BN;
  const int stages = (s.B * s.T * s.H * s.W + L::BK - 1) / L::BK;
  const int kk0 = blockIdx.z * per;
  const DwLoad<T, VEC> load{h0, h_seq, dgates_x, s, rb, nb, kk0};
  gemm_tile<T, true, DwLoad<T, VEC>, TC>(load, max(0, min(per, stages - kk0)), smem);

  float* out = part + (size_t)blockIdx.z * 9 * s.C * 4 * s.C;
  for (int e = threadIdx.x; e < BM * BN; e += THREADS) {
    const int row = e / BN;
    const int col = e - row * BN;
    const int r = rb + row;
    const int n = nb + col;
    if (r < 9 * s.C && n < 4 * s.C) out[(size_t)r * 4 * s.C + n] = Cs[row * LDC + col];
  }
}

// The last launch: blocks [0, dh_blocks) compute dh0, the correlation of
// dgates[0] (dh_step_kernel's work, tile blockIdx.x over the (pixels,
// channels) grid of width tiles_x); the rest sum the dWh partials.
template <typename T, bool VEC, bool TC = false>
__global__ void __launch_bounds__(THREADS)
    finish_kernel(const T* __restrict__ dgates_x, const T* __restrict__ w_t,
                  float* __restrict__ dh_carry, const float* __restrict__ part,
                  float* __restrict__ dw, Shape s, int tiles_x, int dh_blocks, int splits) {
  if (static_cast<int>(blockIdx.x) >= dh_blocks) {
    const size_t n = (size_t)9 * s.C * 4 * s.C;
    const size_t i = (size_t)(blockIdx.x - dh_blocks) * THREADS + threadIdx.x;
    if (i < n) reduce_splits(part, dw, i, n, splits);
    return;
  }
  using L = Tiles<T>;
  __shared__ __align__(128) unsigned char smem[SMEM_BYTES];
  const float* Cs = reinterpret_cast<const float*>(smem);
  const int hw = s.H * s.W;
  const int m0 = blockIdx.x % tiles_x * BM;
  const int cb = blockIdx.x / tiles_x * BN;
  const int kchunks = (4 * s.C + L::BK - 1) / L::BK;
  const DhLoad<T, VEC> load{dgates_x, w_t, s, m0, cb, kchunks};
  gemm_tile<T, false, DhLoad<T, VEC>, TC>(load, 9 * kchunks, smem);
  for (int e = threadIdx.x; e < BM * BN; e += THREADS) {
    const int row = e / BN;
    const int col = e - row * BN;
    const int r = m0 + row;
    const int k = cb + col;
    if (r < s.B * hw && k < s.C) dh_carry[(size_t)r * s.C + k] = Cs[row * LDC + col];
  }
}

// ================================================= stepwise_tc design
//
// Step t of the reverse loop: dh_t = the correlation of dgates[t+1] with
// Wh's taps reversed, a GEMM of M = B*H*W pixels, N = C channels, K = 9
// taps x 4C (4,608 at C = 128), then dgates[t] and dc for the same pixels
// and channels.  A block owns 64 NW pixels (NW = 1 or 2 warpgroups, from
// the plan) x 64 channels; at B = 8 and 16x16 that is 16 x 2 tiles of 128
// pixels (32x32: 64 x 2), so a cluster of `ranks` blocks (gridDim.x, from
// the plan) splits K's chunks (TC_KC = 8 gate columns in f32, TC_KC_BF16 =
// 16 in bf16, at all 9 taps each), parks its f32 partials and sums them in
// rank order through distributed shared memory, block `rank` taking rows
// [64 NW rank / ranks, 64 NW (rank + 1) / ranks) of the tile for the sum and
// the elementwise epilogue (the stepwise design's, f32 carries).  A is
// dgates_x[:, t+1], read once a chunk with its halo rows: f32, split into
// TF32 terms as it is read; bf16, the stored bf16 dgates (the port's bf16
// designs read dgates back in the gates' type, where JAX's kernel forms dh
// and dWh from its f32 dgates: inside the bf16 bar, ROADMAP Queue 3 "by
// design").  B is Wh (a row per output channel, K-major for this product)
// laid out by the wrapper as each channel tile's stage images: f32 as TF32
// big and small planes, bf16 as Wh itself.
//
// bf16 also runs dWh here (dw_tc: both operands pixel-major, which bf16
// wgmma reads MN-major from shared memory) and dh0 with the split sum of
// dWh's partials (finish_tc: the reverse loop's tile over dgates[0]); f32
// keeps both on the cp.async ring's mma.sync path.
namespace tc {
using namespace hopper;

// This block's partial of the dh product over `dg` (dgates of one step,
// batch element b at b * bstride elements), parked in the block's shared
// memory as [64 NW][TC_LDX] f32.  Chunk kc of K is gate columns [KC kc, KC
// kc + KC) at all 9 taps (reversed); w_tc = [ceil(C/64) channel tiles][4C /
// KC chunks][stage image]; the block's cluster rank takes its share of the
// chunks.
template <typename T, int NW>
__device__ __forceinline__ void dh_partial(const T* w_tc, const T* dg, size_t bstride,
                                           const Shape& s, int m0, int rank, int ranks,
                                           unsigned char* smem) {
  constexpr int KC = tc_kc<T>(), PIECE = 16 / sizeof(T);
  constexpr int B_ELEMS = tc_bbytes<T>() / sizeof(T);
  const int hw = s.H * s.W, pixels = s.B * hw, four_c = 4 * s.C;
  const int chunks = four_c / KC;
  const int top = m0 - (s.W + 1);
  const T* w_tile = w_tc + (size_t)blockIdx.y * chunks * B_ELEMS;
  const auto copy = [&](int kc, unsigned char* st, uint64_t* bar) {
    tc_copy_stage<NW, T>(
        st, s.W,
        [&](int row, int piece) -> const T* {
          const int m = top + row, n = kc * KC + PIECE * piece;
          if (m < 0 || m >= pixels) return nullptr;
          const int b = m / hw;
          return dg + b * bstride + (size_t)(m - b * hw) * four_c + n;
        },
        w_tile + (size_t)kc * B_ELEMS, bar, dg);
  };
  const auto hrow = [&](int tap, int i) -> int {
    const int r = tc_frag_row(i), m = m0 + r, p = m % hw;
    const int dy = 1 - tap / 3, dx = 1 - tap % 3;  // the reversed tap's source
    const int y = p / s.W + dy, x = p % s.W + dx;
    if (m >= pixels || y < 0 || y >= s.H || x < 0 || x >= s.W) return -1;
    return r + s.W + 1 + dy * s.W + dx;
  };
  float acc[32];
  tc_gemm<NW, T>(acc, copy, hrow, rank * chunks / ranks, (rank + 1) * chunks / ranks, s.W, smem);
  tc_park(acc, reinterpret_cast<float*>(smem));
}

// Step t: grid (ranks, ceil(C/64), ceil(B*H*W/(64 NW))), clusters of ranks
// along x.  At t = T-1 dh is dh_init (no GEMM).  Blocks an SM: two in f32,
// three in bf16 (as kernels 1-2's step).
template <typename T, int NW>
__global__ void __launch_bounds__(NW * WG_THREADS, sizeof(T) == 2 ? 3 : 2)
    dh_tc_step(const T* __restrict__ w_tc, const float* __restrict__ act,
               const T* __restrict__ c_seq, const float* __restrict__ c0,
               const T* __restrict__ dh_seq, const float* __restrict__ dh_init,
               float* __restrict__ dc_carry, T* __restrict__ dgates_x, Shape s, int t) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int M = 64 * NW;
  const int ranks = gridDim.x, rank = static_cast<int>(cluster_rank());
  const int cb = blockIdx.y * 64, m0 = blockIdx.z * M;
  const int hw = s.H * s.W, pixels = s.B * hw, four_c = 4 * s.C;
  const bool gemm = t < s.T - 1;
  const float* X = reinterpret_cast<const float*>(smem);
  if (gemm)  // dgates[t+1]
    dh_partial<T, NW>(w_tc, dgates_x + (size_t)(t + 1) * hw * four_c, (size_t)s.T * hw * four_c,
                      s, m0, rank, ranks, smem);
  cluster_sync();  // every rank's partial is parked

  const int r0 = rank * M / ranks, r1 = (rank + 1) * M / ranks;
  for (int e = threadIdx.x; e < (r1 - r0) * 64; e += NW * WG_THREADS) {
    const int rr = r0 + e / 64, j = e % 64;
    const int r = m0 + rr, ch = cb + j;
    if (r >= pixels || ch >= s.C) continue;
    const int b = r / hw, p = r - b * hw;
    const size_t cell = ((size_t)b * s.T + t) * hw + p;  // (b, t, p)
    const size_t sidx = (size_t)r * s.C + ch, cidx = cell * s.C + ch;
    const float* a = act + cell * 4 * s.C + ch;
    const float dh = gemm ? tc_rank_sum(X + rr * TC_LDX + j, ranks) : dh_init[sidx];
    const float cp = t == 0 ? c0[sidx] : to_f32(c_seq[cidx - (size_t)hw * s.C]);
    const float ct = to_f32(c_seq[cidx]);
    // bf16: the hardware tanh, as the resident design's loop
    const float tanh_ct = sizeof(T) == 2 ? tanh_fast(ct) : tanhf(ct);
    const GateGrad gg = gate_grad(a[0], a[s.C], a[2 * s.C], a[3 * s.C], tanh_ct, cp,
                                  to_f32(dh_seq[cidx]) + dh, dc_carry[sidx]);
    T* dgo = dgates_x + cell * 4 * s.C + ch;
    dgo[0] = from_f32<T>(gg.di), dgo[s.C] = from_f32<T>(gg.df);
    dgo[2 * s.C] = from_f32<T>(gg.dg), dgo[3 * s.C] = from_f32<T>(gg.do_);
    dc_carry[sidx] = gg.dc;
  }
  cluster_sync();  // the partials are read: the cluster's blocks may exit
}

// The gate recompute over every frame: act = the activations of gates_x +
// conv3x3(h_{t-1}, Wh) for M = B*T*H*W pixels in (b, t, pixel) order,
// h_{t-1} from h0 (t = 0) or h_seq; kernel 1's GEMM on the same tile and
// stage images (w_fwd = [ceil(C/16)][ceil(C/KC)][stage image]), f32 out.
// Grid (ranks, ceil(C/16), ceil(M/(64 NW))), clusters of ranks along x.
template <typename T, int NW>
__global__ void __launch_bounds__(NW * WG_THREADS, sizeof(T) == 2 ? 3 : 2)
    gate_tc(const T* __restrict__ gates_x, const T* __restrict__ w_fwd,
            const T* __restrict__ h0, const T* __restrict__ h_seq, float* __restrict__ act,
            Shape s) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int M = 64 * NW, KC = tc_kc<T>(), PIECE = 16 / sizeof(T);
  constexpr int B_ELEMS = tc_bbytes<T>() / sizeof(T);
  const int ranks = gridDim.x, rank = static_cast<int>(cluster_rank());
  const int cb = blockIdx.y * 16, m0 = blockIdx.z * M;
  const int hw = s.H * s.W, rows = s.B * s.T * hw;
  const int chunks = (s.C + KC - 1) / KC;
  const int top = m0 - (s.W + 1);
  const T* w_tile = w_fwd + (size_t)blockIdx.y * chunks * B_ELEMS;
  const auto copy = [&](int kc, unsigned char* st, uint64_t* bar) {
    tc_copy_stage<NW, T>(
        st, s.W,
        [&](int row, int piece) -> const T* {
          const int m = top + row, ch = kc * KC + PIECE * piece;
          if (m < 0 || m >= rows || ch >= s.C) return nullptr;
          const int f = m / hw, p = m - f * hw;  // frame f = (b, t)
          const T* frame =
              f % s.T == 0 ? h0 + (size_t)(f / s.T) * hw * s.C : h_seq + (size_t)(f - 1) * hw * s.C;
          return frame + (size_t)p * s.C + ch;
        },
        w_tile + (size_t)kc * B_ELEMS, bar, h0);
  };
  const auto hrow = [&](int tap, int i) -> int {
    const int r = tc_frag_row(i), m = m0 + r, p = m % hw;
    const int dy = tap / 3 - 1, dx = tap % 3 - 1;
    const int y = p / s.W + dy, x = p % s.W + dx;
    if (m >= rows || y < 0 || y >= s.H || x < 0 || x >= s.W) return -1;
    return r + s.W + 1 + dy * s.W + dx;
  };
  float acc[32];
  tc_gemm<NW, T>(acc, copy, hrow, rank * chunks / ranks, (rank + 1) * chunks / ranks, s.W, smem);
  float* X = reinterpret_cast<float*>(smem);
  tc_park(acc, X);
  cluster_sync();  // every rank's partial is parked

  const int r0 = rank * M / ranks, r1 = (rank + 1) * M / ranks;
  for (int e = threadIdx.x; e < (r1 - r0) * 16; e += NW * WG_THREADS) {
    const int rr = r0 + e / 16, j = e % 16;
    const int r = m0 + rr, ch = cb + j;
    if (r >= rows || ch >= s.C) continue;
#pragma unroll
    for (int G = 0; G < 4; ++G) {
      const size_t o = (size_t)r * 4 * s.C + G * s.C + ch;
      const float v = tc_rank_sum(X + rr * TC_LDX + G * 16 + j, ranks) + to_f32(gates_x[o]);
      if constexpr (sizeof(T) == 2)  // the hardware tanh, as kernels 1-2's bf16 step
        act[o] = G == 2 ? tanh_fast(v) : sigmoid_fast(v);
      else
        act[o] = G == 2 ? tanhf(v) : sigmoid(v);
    }
  }
  cluster_sync();  // the partials are read: the cluster's blocks may exit
}

// The last launch (bf16): blocks with blockIdx.z < m_tiles compute dh0, the
// dh product over dgates[0] on the reverse loop's tile and grid, into
// dh_carry; the clusters past them sum dWh's `splits` partials in split
// order (whole clusters, so none of them waits at a cluster barrier).
template <typename T, int NW>
__global__ void __launch_bounds__(NW * WG_THREADS, sizeof(T) == 2 ? 3 : 2)
    finish_tc(const T* __restrict__ w_tc, const T* __restrict__ dgates_x,
              float* __restrict__ dh_carry, const float* __restrict__ part,
              float* __restrict__ dw, Shape s, int m_tiles, int splits) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int z = blockIdx.z;
  if (z >= m_tiles) {
    const size_t n = (size_t)9 * s.C * 4 * s.C;
    const size_t blocks = (size_t)(gridDim.z - m_tiles) * gridDim.y * gridDim.x;
    const size_t blk = ((size_t)(z - m_tiles) * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
    for (size_t i = blk * blockDim.x + threadIdx.x; i < n; i += blocks * blockDim.x)
      reduce_splits(part, dw, i, n, splits);
    return;
  }
  constexpr int M = 64 * NW;
  const int ranks = gridDim.x, rank = static_cast<int>(cluster_rank());
  const int cb = blockIdx.y * 64, m0 = z * M;
  const int hw = s.H * s.W, pixels = s.B * hw;
  dh_partial<T, NW>(w_tc, dgates_x, (size_t)s.T * hw * 4 * s.C, s, m0, rank, ranks, smem);
  cluster_sync();  // every rank's partial is parked
  const float* X = reinterpret_cast<const float*>(smem);
  const int r0 = rank * M / ranks, r1 = (rank + 1) * M / ranks;
  for (int e = threadIdx.x; e < (r1 - r0) * 64; e += NW * WG_THREADS) {
    const int rr = r0 + e / 64, j = e % 64;
    const int r = m0 + rr, ch = cb + j;
    if (r < pixels && ch < s.C)
      dh_carry[(size_t)r * s.C + ch] = tc_rank_sum(X + rr * TC_LDX + j, ranks);
  }
  cluster_sync();  // the partials are read: the cluster's blocks may exit
}

// ------------------------------------------------------------ dWh (bf16)
//
// dWh[(tap, c), n] = sum over every pixel m of every step of h_{t-1}[m
// shifted by the tap][c] . dgates[m][n]: K = B*T*H*W pixels, both operands
// pixel-major in device memory, so each is MN-major for wgmma (bf16 reads
// the transposed forms from shared memory).  A block owns one tap row dy,
// 64 MT input channels and 64 gate columns; its three warpgroups are the
// row's three taps dx, each with MT m64n64 accumulators (the resident
// design's dw_kernel_res, whose whole-frame staging fits no 32x32 frame).
// K walks units of R image rows x SW columns of one frame (SW = W rounded
// up to 16, at most 64; R = 128 / SW): the unit's h rows y + dy - 1 padded
// by a column each side and its dgates, as 8-channel planes ([R][SW + 2]
// and [R][SW] pixels of 16 bytes, plus 16 bytes so that neighbouring
// planes' copies take other banks), arrive by cp.async (zeros outside the
// frame, past C or 4C and past W) through a 3-stage ring.  Tap dx of
// pixel x reads padded column x + dx, so a 16-pixel K step is one plain
// descriptor (LBO 128: the next 8 pixels; SBO a plane: the next 8 channels
// or columns).  The units split over gridDim.y = `splits` runs of `per`;
// each split writes its f32 partial, summed in split order by finish_tc
// (no atomics: the same bits every call).
constexpr int DW_THREADS = 3 * WG_THREADS;
constexpr int DW_NSTAGE = 3;
__host__ __device__ constexpr int dw_seg(int W) {
  return (W + 15) / 16 * 16 < 64 ? (W + 15) / 16 * 16 : 64;
}
__host__ __device__ constexpr int dw_rows(int W) { return 128 / dw_seg(W); }
__host__ __device__ constexpr int dw_h_plane(int W) {
  return dw_rows(W) * (dw_seg(W) + 2) * 16 + 16;
}
__host__ __device__ constexpr int dw_g_plane(int W) { return dw_rows(W) * dw_seg(W) * 16 + 16; }
template <int MT> __host__ __device__ constexpr int dw_stage_bytes(int W) {
  return (8 * MT * dw_h_plane(W) + 8 * dw_g_plane(W) + 127) / 128 * 128;
}
template <int MT> __host__ __device__ constexpr int dw_smem(int W) {
  return DW_NSTAGE * dw_stage_bytes<MT>(W);
}

template <int MT>
__global__ void __launch_bounds__(DW_THREADS, 1)
    dw_tc(const bf16* __restrict__ h0, const bf16* __restrict__ h_seq,
          const bf16* __restrict__ dgates_x, float* __restrict__ part, Shape s, int per) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int W = s.W, SW = dw_seg(W), R = dw_rows(W);
  const int PH = dw_h_plane(W), PG = dw_g_plane(W), STAGE = dw_stage_bytes<MT>(W);
  const int hw = s.H * W, four_c = 4 * s.C;
  const int n_tiles = (four_c + 63) / 64, c_tiles = (s.C + 64 * MT - 1) / (64 * MT);
  const int nt = blockIdx.x % n_tiles, ct = blockIdx.x / n_tiles % c_tiles;
  const int dy = blockIdx.x / (n_tiles * c_tiles), dx = threadIdx.x / WG_THREADS;
  const int c_base = ct * 64 * MT, n_base = nt * 64;
  const int groups = (s.H + R - 1) / R, segs = (W + SW - 1) / SW;
  const int units = s.B * s.T * groups * segs;
  const int u0 = blockIdx.y * per, u1 = min(u0 + per, units);
  const int h_pieces = 8 * MT * R * (SW + 2), pieces = h_pieces + 8 * R * SW;

  // Unit u (frame f, row group, column segment) into the stage at st.
  const auto load = [&](int u, unsigned char* st) {
    const int f = u / (groups * segs), rem = u - f * (groups * segs);
    const int y0 = rem / segs * R, x0 = rem % segs * SW;
    const bf16* hf = f % s.T == 0 ? h0 + (size_t)(f / s.T) * hw * s.C
                                  : h_seq + (size_t)(f - 1) * hw * s.C;  // h_{t-1}
    const bf16* gf = dgates_x + (size_t)f * hw * four_c;
    for (int e = threadIdx.x; e < pieces; e += DW_THREADS) {
      if (e < h_pieces) {  // plane j (8 channels) of padded pixel px: j fastest
        const int j = e % (8 * MT), px = e / (8 * MT);
        const int r = px / (SW + 2), x = x0 + px % (SW + 2) - 1, y = y0 + r + dy - 1;
        const int ch = c_base + 8 * j;
        const bool ok = y >= 0 && y < s.H && x >= 0 && x < W && ch < s.C;
        cp_async16(st + j * PH + px * 16, ok ? hf + ((size_t)y * W + x) * s.C + ch : hf, ok);
      } else {  // plane j (8 gate columns) of pixel px
        const int q = e - h_pieces, j = q % 8, px = q / 8;
        const int y = y0 + px / SW, x = x0 + px % SW, n = n_base + 8 * j;
        const bool ok = y < s.H && x < W && n < four_c;
        cp_async16(st + 8 * MT * PH + j * PG + px * 16,
                   ok ? gf + ((size_t)y * W + x) * four_c + n : gf, ok);
      }
    }
  };

  float acc[MT][32];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[mt][i] = 0.0f;
#pragma unroll
  for (int k = 0; k < DW_NSTAGE - 1; ++k) {
    if (u0 + k < u1) load(u0 + k, smem + k * STAGE);
    cp_async_commit();
  }
  for (int u = u0, k = 0; u < u1; ++u, ++k) {
    cp_async_wait<DW_NSTAGE - 2>();
    fence_async();    // this thread's copies, visible to wgmma
    wgmma_wait<0>();  // the last unit's products are done with their stage
    __syncthreads();  // unit u is in; every warpgroup is done with the stage refilled next
    if (u + DW_NSTAGE - 1 < u1)
      load(u + DW_NSTAGE - 1, smem + (k + DW_NSTAGE - 1) % DW_NSTAGE * STAGE);
    cp_async_commit();
    const unsigned char* st = smem + k % DW_NSTAGE * STAGE;
    const unsigned char* g = st + 8 * MT * PH;
    wgmma_fence();
    for (int r = 0; r < R; ++r)
      for (int x = 0; x < SW; x += 16) {
        const uint64_t db = desc(g + (r * SW + x) * 16, 128, PG);
        const unsigned char* a = st + (r * (SW + 2) + x + dx) * 16;
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) mma<1, 1>(acc[mt], desc(a + mt * 8 * PH, 128, PH), db);
      }
    wgmma_commit();
  }
  wgmma_wait<0>();
  cp_async_wait<0>();

  float* out = part + (size_t)blockIdx.y * 9 * s.C * four_c;
  const int tap = dy * 3 + dx, warp = threadIdx.x % WG_THREADS / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int c = c_base + mt * 64 + 16 * warp + lane / 4 + 8 * ((i / 2) % 2);
      const int n = n_base + 8 * (i / 4) + 2 * (lane % 4);
      if (c < s.C && n < four_c)
        *reinterpret_cast<float2*>(out + ((size_t)tap * s.C + c) * four_c + n) =
            make_float2(acc[mt][i], acc[mt][i + 1]);
    }
}

template <typename T, int NW>
cudaError_t launch_gate(const void* gates_x, const void* w_fwd, const void* h0, const void* h_seq,
                        float* act, Shape s, int ranks, cudaStream_t stream) {
  const dim3 grid(ranks, (s.C + 15) / 16, (s.B * s.T * s.H * s.W + 64 * NW - 1) / (64 * NW));
  return launch(gate_tc<T, NW>, grid, NW * WG_THREADS, tc_smem_bytes<T>(NW, s.W), ranks, stream,
                static_cast<const T*>(gates_x), static_cast<const T*>(w_fwd),
                static_cast<const T*>(h0), static_cast<const T*>(h_seq), act, s);
}

template <typename T, int NW>
cudaError_t launch_dh_steps(const void* w_tc, const float* act, const void* c_seq, const void* c0,
                            const void* dh_seq, const float* dh_init, float* dc_carry,
                            void* dgates_x, Shape s, int ranks, cudaStream_t stream) {
  const dim3 grid(ranks, (s.C + 63) / 64, (s.B * s.H * s.W + 64 * NW - 1) / (64 * NW));
  for (int t = s.T - 1; t >= 0; --t) {
    const cudaError_t err = launch(
        dh_tc_step<T, NW>, grid, NW * WG_THREADS, tc_smem_bytes<T>(NW, s.W), ranks, stream,
        static_cast<const T*>(w_tc), act, static_cast<const T*>(c_seq),
        static_cast<const float*>(c0), static_cast<const T*>(dh_seq), dh_init, dc_carry,
        static_cast<T*>(dgates_x), s, t);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// dWh's units: B*T frames x row groups x column segments.
inline int dw_units(const Shape& s) {
  return s.B * s.T * ((s.H + dw_rows(s.W) - 1) / dw_rows(s.W)) *
         ((s.W + dw_seg(s.W) - 1) / dw_seg(s.W));
}

template <int MT>
cudaError_t launch_dw(const void* h0, const void* h_seq, const void* dgates_x, float* part,
                      Shape s, int splits, cudaStream_t stream) {
  const int per = (dw_units(s) + splits - 1) / splits;
  const int blocks = 3 * ((s.C + 64 * MT - 1) / (64 * MT)) * ((4 * s.C + 63) / 64);
  return launch(dw_tc<MT>, dim3(blocks, splits), DW_THREADS, dw_smem<MT>(s.W), 1, stream,
                static_cast<const bf16*>(h0), static_cast<const bf16*>(h_seq),
                static_cast<const bf16*>(dgates_x), part, s, per);
}

// finish_tc's grid: the reverse loop's, with z planes of split-sum
// clusters past its pixel tiles (about 8 dWh elements a thread).
template <typename T, int NW>
cudaError_t launch_finish(const void* w_tc, const void* dgates_x, float* dh_carry,
                          const float* part, float* dw, Shape s, int ranks, int splits,
                          cudaStream_t stream) {
  const int m_tiles = (s.B * s.H * s.W + 64 * NW - 1) / (64 * NW), n_tiles = (s.C + 63) / 64;
  const int n = 9 * s.C * 4 * s.C, per_plane = 8 * ranks * n_tiles * NW * WG_THREADS;
  const dim3 grid(ranks, n_tiles, m_tiles + (n + per_plane - 1) / per_plane);
  return launch(finish_tc<T, NW>, grid, NW * WG_THREADS, tc_smem_bytes<T>(NW, s.W), ranks, stream,
                static_cast<const T*>(w_tc), static_cast<const T*>(dgates_x), dh_carry, part, dw,
                s, m_tiles, splits);
}

}  // namespace tc

// ============================================================== dispatch

struct Args {
  const void *gates_x, *w_h, *w_t, *h0, *c0, *h_seq, *c_seq, *dh_seq;
  void *dh_carry, *dc_carry, *dgates_x, *dw, *act, *part;
  const void* w_tc;      // stepwise_tc: the reverse loop's stage images of Wh ("bwd")
  const void* w_tc_fwd;  // stepwise_tc: the gate recompute's (kernel 1's layout, "fwd")
};

#define RETURN_IF_ERROR(expr)                                    \
  do {                                                           \
    const cudaError_t err_ = (expr);                             \
    if (err_ != cudaSuccess) return static_cast<int>(err_);      \
  } while (0)

// dWh with its K split over `splits` (f32 partials), then the last launch:
// dh0 and the partials' fixed-order sum.  TC: both on mma.sync in 3xTF32.
template <typename T, bool VEC, bool TC>
int launch_dw_finish(const Args& a, Shape s, int splits, cudaStream_t stream) {
  const int pixels = s.B * s.H * s.W;
  const T* h0 = static_cast<const T*>(a.h0);
  const T* hs = static_cast<const T*>(a.h_seq);
  T* dg = static_cast<T*>(a.dgates_x);
  auto* part = static_cast<float*>(a.part);
  const int stages = (pixels * s.T + Tiles<T>::BK - 1) / Tiles<T>::BK;
  const int per = (stages + splits - 1) / splits;
  const dim3 dw_grid((9 * s.C + BM - 1) / BM, (4 * s.C + BN - 1) / BN, splits);
  dw_kernel<T, VEC, TC><<<dw_grid, THREADS, 0, stream>>>(h0, hs, dg, part, s, per);
  RETURN_IF_ERROR(cudaGetLastError());
  const dim3 step_grid((pixels + BM - 1) / BM, (s.C + BN - 1) / BN);
  const int dh_blocks = step_grid.x * step_grid.y;
  const int reduce_blocks = (9 * s.C * 4 * s.C + THREADS - 1) / THREADS;
  finish_kernel<T, VEC, TC><<<dh_blocks + reduce_blocks, THREADS, 0, stream>>>(
      dg, static_cast<const T*>(a.w_t), static_cast<float*>(a.dh_carry), part,
      static_cast<float*>(a.dw), s, step_grid.x, dh_blocks, splits);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool VEC>
int run_stepwise(const Args& a, Shape s, int splits, cudaStream_t stream) {
  const int pixels = s.B * s.H * s.W;
  const T* gx = static_cast<const T*>(a.gates_x);
  const T* wh = static_cast<const T*>(a.w_h);
  const T* wt = static_cast<const T*>(a.w_t);
  const T* h0 = static_cast<const T*>(a.h0);
  const T* hs = static_cast<const T*>(a.h_seq);
  T* dg = static_cast<T*>(a.dgates_x);
  auto* act = static_cast<float*>(a.act);
  auto* dh = static_cast<float*>(a.dh_carry);
  const dim3 gate_grid((pixels * s.T + BM - 1) / BM, (s.C + CG - 1) / CG);
  gate_all_kernel<T, VEC><<<gate_grid, THREADS, 0, stream>>>(gx, wh, h0, hs, act, s);
  RETURN_IF_ERROR(cudaGetLastError());
  const dim3 step_grid((pixels + BM - 1) / BM, (s.C + BN - 1) / BN);
  for (int t = s.T - 1; t >= 0; --t) {
    step_kernel<T, VEC><<<step_grid, THREADS, 0, stream>>>(
        wt, act, static_cast<const T*>(a.c_seq), static_cast<const float*>(a.c0),
        static_cast<const T*>(a.dh_seq), dh, static_cast<float*>(a.dc_carry), dg, s, t);
    RETURN_IF_ERROR(cudaGetLastError());
  }
  return launch_dw_finish<T, VEC, false>(a, s, splits, stream);
}

// The stepwise_tc launches, T + 3 in both types: the gate recompute on
// the wgmma tile (clusters of `gate_ranks` blocks of `gate_warpgroups`),
// the reverse loop's steps on it too (`ranks`, `warpgroups`), dWh, and the
// last launch (dh0 and the split sum of dWh's partials).  f32 (3xTF32):
// dWh and the last launch on the ring's mma.sync path.  bf16: dWh on
// bf16 wgmma (dw_tc, 64 MT input channels a block), the last launch on
// the reverse loop's tile (finish_tc).
template <typename T, bool VEC>
int run_stepwise_tc(const Args& a, Shape s, int splits, int ranks, int warpgroups,
                    int gate_ranks, int gate_warpgroups, cudaStream_t stream) {
  const auto bad = [](int r, int nw) { return r < 1 || r > 8 || nw < 1 || nw > 2; };
  if (s.C % (16 / sizeof(T)) != 0 || bad(ranks, warpgroups) || bad(gate_ranks, gate_warpgroups) ||
      splits < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  auto* act = static_cast<float*>(a.act);
  auto* dh = static_cast<float*>(a.dh_carry);
  auto* dc = static_cast<float*>(a.dc_carry);
  const auto gate = gate_warpgroups == 1 ? &tc::launch_gate<T, 1> : &tc::launch_gate<T, 2>;
  RETURN_IF_ERROR(gate(a.gates_x, a.w_tc_fwd, a.h0, a.h_seq, act, s, gate_ranks, stream));
  const auto steps = warpgroups == 1 ? &tc::launch_dh_steps<T, 1> : &tc::launch_dh_steps<T, 2>;
  RETURN_IF_ERROR(steps(a.w_tc, act, a.c_seq, a.c0, a.dh_seq, dh, dc, a.dgates_x, s, ranks,
                        stream));
  if constexpr (sizeof(T) == 4) {
    return launch_dw_finish<float, VEC, true>(a, s, splits, stream);
  } else {
    auto* part = static_cast<float*>(a.part);
    const auto dw = s.C > 64 ? &tc::launch_dw<2> : &tc::launch_dw<1>;
    RETURN_IF_ERROR(dw(a.h0, a.h_seq, a.dgates_x, part, s, splits, stream));
    const auto finish = warpgroups == 1 ? &tc::launch_finish<T, 1> : &tc::launch_finish<T, 2>;
    RETURN_IF_ERROR(finish(a.w_tc, a.dgates_x, dh, part, static_cast<float*>(a.dw), s, ranks,
                           splits, stream));
    return 0;
  }
}

template <typename T>
int run_stepwise_t(const Args& a, Shape s, int splits, cudaStream_t stream) {
  if (s.C % 8 == 0) return run_stepwise<T, true>(a, s, splits, stream);
  return run_stepwise<T, false>(a, s, splits, stream);
}

template <int MT>
int launch_dw(const CUtensorMap& h0_map, const CUtensorMap& hseq_map, const CUtensorMap& dg_map,
              float* part, Shape s, int splits, cudaStream_t stream) {
  const int per = (s.B * s.T + splits - 1) / splits;
  return static_cast<int>(hopper::launch(resident::dw_kernel_res<MT>,
                                         dim3(3 * 4 * s.C / hopper::NT, splits),
                                         resident::DW_THREADS, resident::dw_smem(s.H, s.W, s.C), 1,
                                         stream, h0_map, hseq_map, dg_map, part, s, per));
}

int run_resident(const Args& a, Shape s, int gate_groups, int splits, cudaStream_t stream) {
  using hopper::bf16;
  CUtensorMap h0_map, hseq_map, dg_map;
  RETURN_IF_ERROR(hopper::frame_map(&h0_map, a.h0, s.B, s.H, s.W, s.C, s.H + 2, s.W + 2));
  RETURN_IF_ERROR(
      hopper::frame_map(&hseq_map, a.h_seq, s.B * s.T, s.H, s.W, s.C, s.H + 2, s.W + 2));
  RETURN_IF_ERROR(hopper::frame_map(&dg_map, a.dgates_x, s.B * s.T, s.H, s.W, 4 * s.C, s.H, s.W));
  auto* act = static_cast<float*>(a.act);
  const int R = s.C / 16;
  RETURN_IF_ERROR(hopper::launch(resident::gate_kernel, dim3(R, gate_groups), hopper::THREADS_R,
                                 hopper::smem_bytes(s.H, s.W, s.C), 1, stream, h0_map, hseq_map,
                                 static_cast<const bf16*>(a.gates_x),
                                 static_cast<const bf16*>(a.w_t), act, s));
  RETURN_IF_ERROR(hopper::launch(
      resident::loop_kernel, dim3(R, s.B), hopper::THREADS_R, resident::loop_smem(s.H, s.W, s.C), R,
      stream, static_cast<const bf16*>(a.w_h), static_cast<const float*>(act),
      static_cast<const bf16*>(a.c_seq), static_cast<const float*>(a.c0),
      static_cast<const bf16*>(a.dh_seq), static_cast<float*>(a.dh_carry),
      static_cast<float*>(a.dc_carry), static_cast<bf16*>(a.dgates_x), s));
  auto* part = static_cast<float*>(a.part);
  const int err = s.C == 128 ? launch_dw<2>(h0_map, hseq_map, dg_map, part, s, splits, stream)
                             : launch_dw<1>(h0_map, hseq_map, dg_map, part, s, splits, stream);
  if (err != 0) return err;
  const int n = 9 * s.C * 4 * s.C;
  dw_reduce_kernel<<<(n + 255) / 256, 256, 0, stream>>>(static_cast<const float*>(a.part),
                                                        static_cast<float*>(a.dw), n, splits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// gates_x [B,T,H,W,4C], w_h [3,3,C,4C], w_t [9,4C,C] (w_h per tap
// transposed), h0 [B,H,W,C], h_seq, c_seq, dh_seq [B,T,H,W,C] and the
// output dgates_x [B,T,H,W,4C] in one type (bf16 when is_bf16, else f32);
// c0 [B,H,W,C] f32.  dh_carry, dc_carry [B,H,W,C] f32 hold the final
// states' cotangents on entry and dh0, dc0 on return; dw [3,3,C,4C] f32
// receives dWh.  act [B,T,H,W,4C] f32 is scratch; part [splits,9C,4C] f32
// is scratch of the dWh split sum.  w_tc, w_tc_fwd: design 2's stage images
// of w_h (f32: its TF32 big and small terms; bf16: w_h) for the reverse
// loop and for the gate recompute (ops/convlstm.py's tc_stage_images "bwd"
// and "fwd"; unread by the other designs).  All contiguous.  design 1
// (resident, bf16) launches 4 kernels, design 2 (stepwise_tc, f32 and
// bf16: the gate launch in clusters of `gate_groups` blocks of
// `gate_warpgroups` warpgroups, the reverse loop's and bf16's last launch
// in clusters of `cluster` blocks of `warpgroups`) T + 3, design 0
// (stepwise) T + 3, on `stream`; returns the first launch error, or 0.
int convlstm_backward(const void* gates_x, const void* w_h, const void* w_t, const void* h0,
                      const void* c0, const void* h_seq, const void* c_seq, const void* dh_seq,
                      void* dh_carry, void* dc_carry, void* dgates_x, void* dw, void* act,
                      void* part, const void* w_tc, const void* w_tc_fwd, int B, int T, int H,
                      int W, int C, int is_bf16, int design, int gate_groups, int splits,
                      int cluster, int warpgroups, int gate_warpgroups, void* stream) {
  const Args a{gates_x, w_h, w_t, h0, c0, h_seq, c_seq, dh_seq, dh_carry, dc_carry,
               dgates_x, dw, act, part, w_tc, w_tc_fwd};
  const Shape s{B, T, H, W, C};
  auto st = static_cast<cudaStream_t>(stream);
  if (design == 1) {
    if (!is_bf16) return static_cast<int>(cudaErrorInvalidValue);
    return run_resident(a, s, gate_groups, splits, st);
  }
  if (design == 2) {
    if (is_bf16)
      return run_stepwise_tc<__nv_bfloat16, true>(a, s, splits, cluster, warpgroups, gate_groups,
                                                  gate_warpgroups, st);
    return s.C % 8 == 0 ? run_stepwise_tc<float, true>(a, s, splits, cluster, warpgroups,
                                                       gate_groups, gate_warpgroups, st)
                        : run_stepwise_tc<float, false>(a, s, splits, cluster, warpgroups,
                                                        gate_groups, gate_warpgroups, st);
  }
  if (is_bf16) return run_stepwise_t<__nv_bfloat16>(a, s, splits, st);
  return run_stepwise_t<float>(a, s, splits, st);
}

// Clusters of the resident reverse loop at (B, H, W, C) that fit on the
// card at once (-1 if the query fails).
int convlstm_backward_active_clusters(int B, int H, int W, int C) {
  return hopper::max_active_clusters(resident::loop_kernel, dim3(C / 16, B), hopper::THREADS_R,
                                     resident::loop_smem(H, W, C), C / 16);
}

const char* convlstm_backward_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
