// Ablation variants of the fused first block for Hopper (sm_90a), plain C
// interface: kernel 6.
//
// Replaces: tools/ablate_block1.py `make_kernel(mode, ...)`, the TPU
// kernel 4 with its stages stripped, which attributes kernel 4's time.
//
// Every mode of first_block.cuh (FULL, NO_EPILOGUE, NO_DOT, NO_BAND,
// DMA_ONLY; their functions are written there) is the tensor-core body of
// kernel 4 with one stage stripped, on kernel 4's persistent grid of bands,
// and reads and writes the same tensors, so the bytes bound is the same for
// all of them (95 us at the serving shape on an H100 SXM).  FULL is kernel
// 4's own instantiation: its output equals first_block.cu's bit for bit.
// The time each mode saves against FULL is what its stripped stage costs.

#include "first_block.cuh"

extern "C" {

// As first_block_forward (first_block.cu), with `mode` one of the Mode
// values.  Returns cudaErrorInvalidValue for any other mode.
int first_block_ablate_forward(int mode, const void* x, const void* w, const void* bias,
                               void* out, int F, int H, int W, float pad_u, float slope,
                               int out_bf16, void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case FULL:
      launch_first_block<FULL>(x, w, bias, out, F, H, W, pad_u, slope, out_bf16, st);
      break;
    case NO_EPILOGUE:
      launch_first_block<NO_EPILOGUE>(x, w, bias, out, F, H, W, pad_u, slope, out_bf16, st);
      break;
    case NO_DOT:
      launch_first_block<NO_DOT>(x, w, bias, out, F, H, W, pad_u, slope, out_bf16, st);
      break;
    case NO_BAND:
      launch_first_block<NO_BAND>(x, w, bias, out, F, H, W, pad_u, slope, out_bf16, st);
      break;
    case DMA_ONLY:
      launch_first_block<DMA_ONLY>(x, w, bias, out, F, H, W, pad_u, slope, out_bf16, st);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* first_block_ablate_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
