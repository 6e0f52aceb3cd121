// Fused first encoder block on raw uint8 frames for Hopper (sm_90a), plain
// C interface: kernel 4, the `FULL` mode of first_block.cuh.
//
// Replaces: vad_tpu/ops/encoder_pallas.py `_first_block_kernel` (reached
// through `fused_first_block`).
//
// The TPU kernel spends its effort on lane layout (a banded matmul over
// 32-pixel lane groups and a relayout at the NHWC boundary).  None of that
// applies here.  Bound on an H100 SXM at the serving shape (F=256 frames of
// 256x256, bf16 out): 50.3 MB read + 268 MB written -> 95 us at 3.35 TB/s;
// 29 GFLOP -> 29 us on the bf16 tensor cores (35 with K padded to 32), so
// on the tensor cores the bytes bound it.  As f32 FMAs on the CUDA cores
// the 27 x 32 MACs of each conv pixel (14.5 G a chunk) would take 0.43 ms
// even at the f32 peak, and a small tile's window staged one byte a thread
// re-reads a 1.43x halo.  So (first_block.cuh):
// - the conv is wgmma m64n32k16 (bf16 in, f32 accumulate) on exact bf16
//   bytes read as 32-bit pairs, with the f32 weight split into bf16 terms
//   (3 for f32 out, 2 for bf16): no f32 FMA is left for the MACs;
// - the 2x2 pool is in registers (the M rows are ordered so a thread holds
//   all four conv outputs of its pooled pixel);
// - staging walks bands of 8 pooled rows x 64 pooled columns (a 1.125x row
//   halo): 16-byte cp.async of the next band's bytes during the current
//   band's math, then one conflict-free pass into a bf16 window;
// - stores are 16-byte, through a per-warp shared-memory stage.
// Two bf16 terms over K = 32 are 69 us of tensor-core time at the peak, so
// at bf16 out this design cannot beat the larger of that and what staging
// and stores take alone (kernel 6's `dma-only`); PERF.md has the split.

#include "first_block.cuh"

extern "C" {

// x [F,H,W,3] u8; w_terms [TERMS,2,32,32] bf16 (first_block.cuh); bias [32]
// f32 (folded); out [F,H/2,W/2,32], bf16 when out_bf16 else f32.  H and W
// must be even.
int first_block_forward(const void* x, const void* w_terms, const void* bias, void* out, int F,
                        int H, int W, float pad_u, float slope, int out_bf16, void* stream) {
  launch_first_block<FULL>(x, w_terms, bias, out, F, H, W, pad_u, slope, out_bf16,
                           static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}

// Blocks of the persistent grid kernel 4 launches at this shape.
int first_block_grid(int F, int H, int W, int out_bf16) {
  const int items = band_items(F, H, W);
  return out_bf16 ? grid_blocks<__nv_bfloat16>(items) : grid_blocks<float>(items);
}

const char* first_block_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
