// Fused first encoder block on raw uint8 frames for Hopper (sm_90a), plain
// C interface: kernel 4, the `FULL` mode of first_block.cuh.
//
// Replaces: vad_tpu/ops/encoder_pallas.py `_first_block_kernel` (reached
// through `fused_first_block`).
//
// The TPU kernel spends its effort on lane layout (a banded matmul over
// 32-pixel lane groups and a relayout at the NHWC boundary).  None of that
// applies here; the design (an f32 window staged in shared memory, one
// thread per pooled pixel and 8 channels) is described in first_block.cuh.
//
// Bound on an H100 SXM at the serving shape (F=256 frames of 256x256, bf16
// out): 50.3 MB read + 268 MB written -> 95 us at 3.35 TB/s; 29 GFLOP
// -> 29 us on the tensor cores.  This version runs the MACs as f32 FMAs
// on the CUDA cores (14.5 G of them: 0.43 ms at the 67 TFLOP/s f32 peak),
// so the FMA rate, not the memory, bounds it.  Moving the 27-deep dot products onto
// the tensor cores is the next step toward the bytes bound.  The ablation
// (kernel 6, first_block_ablate.cu) agrees: without the FMAs the block runs
// in about a sixth of its time, without the epilogue or the pad test in
// about all of it (PERF.md, bring-up table).

#include "first_block.cuh"

extern "C" {

// x [F,H,W,3] u8; w [3,3,3,32] f32 (HWIO, folded); bias [32] f32 (folded);
// out [F,H/2,W/2,32], bf16 when out_bf16 else f32.  H and W must be even.
int first_block_forward(const void* x, const void* w, const void* bias, void* out, int F,
                        int H, int W, float pad_u, float slope, int out_bf16, void* stream) {
  launch_first_block<FULL>(x, w, bias, out, F, H, W, pad_u, slope, out_bf16,
                           static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}

const char* first_block_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
