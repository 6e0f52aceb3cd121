// The fused first encoder block's kernel body, shared by first_block.cu
// (kernel 4, `FULL` only) and first_block_ablate.cu (kernel 6, every mode).
//
// Computes, for NHWC u8 frames [F,H,W,3]:
//     x/127.5 - 1 -> conv3x3 SAME (3 -> 32) -> inference BatchNorm
//     -> 2x2 max-pool -> LeakyReLU(0.2)
// and writes NHWC [F,H/2,W/2,32].  The input affine and the BatchNorm are
// folded into one weight and bias that act on the raw byte values
// (ops/encoder_fused.py fold_first_block).  SAME zero padding of the
// *normalized* input is the raw value 127.5, so out-of-frame taps read
// `pad_u` (127.5), not 0.  LeakyReLU is monotone, so the max-pool runs
// before it and the bias is added once after the max.
//
// Design: the conv as a GEMM on the tensor cores (wgmma m64n32k16, bf16
// in, f32 accumulate, A from registers, B from shared memory).
// - Operands.  A is the im2col of the staged window, in bf16: every byte
//   0-255 and the pad 127.5 are exact, so A loses nothing.  A thread reads
//   it as 32-bit pairs: row dy of a pixel's 3x3x3 patch is 9 neighbouring
//   values, read as 5 aligned pairs from the patch's first value rounded
//   down to even; 3 rows x 5 pairs and one zero pair are K = 32, and the
//   value outside the 9 gets a zero weight (ops/encoder_fused.py
//   pair_rows).  Each wgmma's 64 pixels start on one parity, so B comes in
//   two row orders, one per parity.  B is the folded weight [K=32][N=32]
//   split by the wrapper into TERMS bf16 terms (hi + mid + lo) whose sum is
//   the f32 weight: 3 for f32 output (24 significant bits; each product
//   with an exact A is exact in the f32 accumulator), 2 for bf16 output
//   (one term, JAX's numerics, misses the bf16 bar at chip_smoke.py's edge
//   frame).  A is loaded once a tile and multiplied by each term: the terms
//   stacked along K without repeating A.  The wgmma is a warpgroup's: 4
//   warps' 16-row A fragments (the m16n8k16 layout) and one B descriptor
//   (K-major, no swizzle).
// - Pool in registers.  A pool tile is 8 pooled pixels of one pooled row
//   (one warp): two m16 tiles, the left and the right conv pixels of the
//   2x2 windows; in each, fragment row g is the top conv pixel of pooled
//   pixel g and row g + 8 the bottom one.  So a thread's accumulators hold
//   all four conv outputs of its pooled pixel for channels 8j + 2q,
//   8j + 2q + 1 (j < 4): the max, the bias and LeakyReLU need no shuffle.
// - Staging.  A block walks bands of 8 pooled rows x 64 pooled columns (an
//   18 x 130 pixel window, a 1.125x row halo) in a persistent loop, one
//   pooled row per warp, three blocks an SM.  The next band's bytes arrive
//   by 16-byte cp.async into a raw u8 window while the block computes the
//   current band; then one pass converts them, four a thread, into the
//   bf16 window (exact
//   bytes, and the out-of-frame test and the pad done once here).  Both
//   passes touch shared memory in consecutive words, free of bank
//   conflicts.  Rows of W*3 bytes that are 16-byte aligned (W % 16 == 0, as
//   at 256^2) take whole chunks, each in or out of the frame; any other
//   frame takes a masked byte path over the same window (the edge frames
//   of chip_smoke.py).
// - Stores.  A thread's 8 values are not contiguous channels, so each warp
//   passes its pool tile (8 pixels x 32 channels, contiguous NHWC) through
//   a small padded shared-memory stage and writes it with 16-byte
//   streaming stores.  NHWC C=32 is the channels-last layout block 2's
//   convolution reads: the hand-off costs no copy.
//
// Ablation modes (kernel 6, the counterpart of tools/ablate_block1.py).
// Each strips one stage of this design and keeps the rest; each output
// depends on all the work its mode keeps, so the compiler cannot drop it.
// With xpad the frame padded by one pixel of 127.5 and b the folded bias:
//   FULL         the block above.
//   NO_EPILOGUE  staging and every MMA; no max, no LeakyReLU:
//                out = conv(x)[2py, 2px] + b (conv tap 0).  Taps 1-3 enter
//                as 0 * slope * (tap1 + tap2 + tap3): `slope` is a kernel
//                argument, so IEEE arithmetic (inf * 0 is NaN) forbids
//                folding that zero, and for finite inputs it adds +-0.
//   NO_DOT       staging and epilogue, no MMA; each tap takes its patch's
//                first value:
//                out = leaky(max_a xpad[2py + a/2, 2px + a%2, 0] + b).
//   NO_BAND      the out-of-frame test and pad value (the counterpart of
//                the TPU kernel's band/roll/mask assembly) replaced by
//                clamped staging: rows clamped at load, and out-of-frame
//                columns converted from the edge pixel's bytes.  FULL on an
//                edge-replicated frame.
//   DMA_ONLY     staging and a cast store: out[..., c] = x[2py, 2px, c % 3].
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum Mode : int { FULL = 0, NO_EPILOGUE = 1, NO_DOT = 2, NO_BAND = 3, DMA_ONLY = 4 };

constexpr int C1 = 32;                         // output channels
constexpr int K_PAD = 32;                      // 27 taps, padded to two k16 steps
constexpr int BAND = 8;                        // pooled rows a band (one a warp)
constexpr int SPAN = 64;                       // pooled columns a band (8 pool tiles)
constexpr int WARPS = BAND;
constexpr int THREADS = 32 * WARPS;            // 256
constexpr int WIN_H = 2 * BAND + 2;            // staged input rows (with halo)
constexpr int CHUNKS = 26;                     // 16-byte chunks a row: 130 pixels from any start
constexpr int ROW = 16 * CHUNKS;               // bytes (raw) and bf16 values (window) a row
constexpr int WIN_CHUNKS = WIN_H * CHUNKS;
static_assert(15 + 3 * (2 * SPAN + 2) <= ROW, "a row of chunks covers the band's pixels");

template <typename T> struct OutTraits;
// TERMS: bf16 terms of the weight; STG: words a pixel row of the store
// stage, padded so the fragment writes hit distinct banks
template <> struct OutTraits<float> {
  static constexpr int TERMS = 3, STG = 40;
};
template <> struct OutTraits<__nv_bfloat16> {
  static constexpr int TERMS = 2, STG = 20;
};

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

// wgmma shared-memory descriptor, no swizzle; byte offsets, 16-byte units
__device__ __forceinline__ uint64_t smem_desc(const void* smem, uint32_t lbo, uint32_t sbo) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// d (+)= A . B, m64n32k16, bf16 in, f32 accumulate: A from registers (each
// warp's 16 rows in the m16n8k16 A fragment layout), B K-major in shared
// memory; `accumulate` 0 overwrites d.
__device__ __forceinline__ void wgmma_n32(float (&d)[16], const uint32_t (&a)[4], uint64_t db,
                                          int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

// Where a band's window starts: frame f, first input row y0 (the halo row
// above), first pixel 2*px0 - 1 at in-row byte wb0; the window's rows begin
// at the 16-byte chunk cb that holds it, `off` = wb0 - cb bytes before it.
struct Band {
  int f, py0, px0, y0, cb, off;
};

// Bands of a call: F frames x ceil(H/2 / BAND) x ceil(W/2 / SPAN).
__host__ __device__ inline int band_items(int F, int H, int W) {
  return F * ((H / 2 + BAND - 1) / BAND) * ((W / 2 + SPAN - 1) / SPAN);
}

__device__ __forceinline__ Band band_of(int item, int Hp, int Wp) {
  const int spans = (Wp + SPAN - 1) / SPAN, bands = (Hp + BAND - 1) / BAND;
  Band b;
  const int rest = item / spans;
  b.px0 = (item - rest * spans) * SPAN;
  b.f = rest / bands;
  b.py0 = (rest - b.f * bands) * BAND;
  b.y0 = 2 * b.py0 - 1;
  const int wb0 = 3 * (2 * b.px0 - 1);
  b.cb = wb0 & ~15;  // floor to 16 (two's complement: -3 -> -16)
  b.off = wb0 - b.cb;
  return b;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem));
}

// Start copying band `bd`'s raw bytes into `raw` [WIN_H][ROW]: `aligned`
// (every row starts 16-byte aligned) takes whole chunks with cp.async,
// each wholly in or out of its row; any other frame takes the masked byte
// path.  Bytes out of the frame are left as they are: the conversion pads
// them.  NO_BAND clamps the row instead.
template <int MODE>
__device__ __forceinline__ void issue_window(uint8_t* raw, const uint8_t* __restrict__ x,
                                             const Band& bd, int H, int W, bool aligned) {
  const int row_bytes = 3 * W;
  if (aligned) {
    for (int i = threadIdx.x; i < WIN_CHUNKS; i += THREADS) {
      const int r = i / CHUNKS, c = i - r * CHUNKS;
      int y = bd.y0 + r;
      if constexpr (MODE == NO_BAND) y = min(max(y, 0), H - 1);
      const int b = bd.cb + 16 * c;
      if (y >= 0 && y < H && b >= 0 && b + 16 <= row_bytes)
        cp_async16(raw + r * ROW + 16 * c, x + ((size_t)bd.f * H + y) * row_bytes + b);
    }
    asm volatile("cp.async.commit_group;\n" ::);
  } else {
    for (int i = threadIdx.x; i < WIN_H * ROW; i += THREADS) {
      const int r = i / ROW, u = i - r * ROW;
      int y = bd.y0 + r;
      if constexpr (MODE == NO_BAND) y = min(max(y, 0), H - 1);
      const int b = bd.cb + u;
      if (y >= 0 && y < H && b >= 0 && b < row_bytes)
        raw[i] = x[((size_t)bd.f * H + y) * row_bytes + b];
    }
  }
}

// Convert the raw bytes of band `bd` into the bf16 window `xs`, four a
// thread at a time (conflict-free 4- and 8-byte accesses): in-frame bytes
// as their value, the rest as the pad.  NO_BAND reads the clamped pixel's
// byte instead of the pad.
template <int MODE>
__device__ __forceinline__ void convert_window(__nv_bfloat16* xs, const uint8_t* raw,
                                               const Band& bd, int H, int W,
                                               __nv_bfloat16 pad) {
  const int row_bytes = 3 * W;
  for (int i = threadIdx.x; i < WIN_H * ROW / 4; i += THREADS) {
    const int r = i / (ROW / 4), u = 4 * (i - r * (ROW / 4));
    const int y = bd.y0 + r;
    const uint32_t word = *reinterpret_cast<const uint32_t*>(raw + r * ROW + u);
    __nv_bfloat16 v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int b = bd.cb + u + e;
      const bool in_frame = b >= 0 && b < row_bytes;
      float byte = static_cast<float>((word >> (8 * e)) & 0xFFu);
      if constexpr (MODE == NO_BAND) {
        if (!in_frame) {  // the same channel of the edge pixel, where staged
          const int px = b < 0 ? -1 : b / 3, ci = b - 3 * px;
          const int src = 3 * min(max(px, 0), W - 1) + ci - bd.cb;
          byte = src >= 0 && src < ROW ? static_cast<float>(raw[r * ROW + src]) : 0.0f;
        }
        v[e] = __float2bfloat16_rn(byte);
      } else {
        v[e] = in_frame && y >= 0 && y < H ? __float2bfloat16_rn(byte) : pad;
      }
    }
    *reinterpret_cast<uint2*>(xs + r * ROW + u) =
        make_uint2(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]));
  }
}

template <typename T>
__device__ __forceinline__ void write_pair(uint32_t* stage, int word, float v0, float v1) {
  if constexpr (sizeof(T) == 2) {
    stage[word] = pack_bf16(__float2bfloat16_rn(v0), __float2bfloat16_rn(v1));
  } else {
    *reinterpret_cast<float2*>(stage + word) = make_float2(v0, v1);
  }
}

template <typename T, int MODE>
__global__ void __launch_bounds__(THREADS, 3)  // three blocks an SM: at most 80 registers
    first_block_kernel(const uint8_t* __restrict__ x, const __nv_bfloat16* __restrict__ w_terms,
                       const float* __restrict__ bias, T* __restrict__ out, int F, int H, int W,
                       float pad_u, float slope, int aligned) {
  constexpr int TERMS = OutTraits<T>::TERMS, STG = OutTraits<T>::STG;
  constexpr bool DOT = MODE != NO_DOT && MODE != DMA_ONLY;
  __shared__ __align__(16) __nv_bfloat16 xs[WIN_H * ROW];  // the band's bf16 window
  __shared__ __align__(16) uint8_t raw[WIN_H * ROW];        // the next band's bytes
  __shared__ __align__(16) uint32_t stage[WARPS][8 * STG];
  __shared__ __align__(16) float bsm[C1];
  __shared__ __align__(128) __nv_bfloat16 wsm[TERMS * 2 * K_PAD * C1];

  const int Hp = H / 2, Wp = W / 2;
  const int items = band_items(F, H, W);
  int item = blockIdx.x;
  if (item >= items) return;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, q = lane & 3;
  const __nv_bfloat16 pad = __float2bfloat16_rn(pad_u);

  // B, every term and both parities (ops/encoder_fused.py pair_rows), in
  // shared memory K-major without swizzle: [k/8][n][8] (a wgmma core
  // matrix is 8 columns x 8 k = 128 contiguous bytes)
  if constexpr (DOT) {
    for (int i = threadIdx.x; i < TERMS * 2 * K_PAD * C1; i += THREADS) {
      const int k = i / C1, n = i - k * C1;  // k over every term's and parity's rows
      wsm[((k >> 3) * C1 + n) * 8 + (k & 7)] = w_terms[i];
    }
    asm volatile("fence.proxy.async;\n" ::: "memory");  // visible to wgmma
  }
  if (threadIdx.x < C1) bsm[threadIdx.x] = bias[threadIdx.x];  // read after the first barrier
  // window offsets of this thread's A pairs (k-step ks, pair q or q + 4 of
  // the step), from the first value of a pixel's patch rounded down to even
  int poff[2][2];
#pragma unroll
  for (int ks = 0; ks < 2; ++ks)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int pair = 8 * ks + 4 * hh + q;
      poff[ks][hh] = pair < 15 ? pair / 5 * ROW + 2 * (pair % 5) : 0;
    }

  // B descriptor of term 0, parity 0, first k-step: LBO = one k-group (C1
  // x 16 bytes), SBO = 8 columns (128 bytes); other steps add to its start
  const uint64_t wdesc = smem_desc(wsm, C1 * 16, 128);
  Band bd = band_of(item, Hp, Wp);
  issue_window<MODE>(raw, x, bd, H, W, aligned);
  asm volatile("cp.async.wait_all;\n" ::);
  __syncthreads();
  convert_window<MODE>(xs, raw, bd, H, W, pad);
  __syncthreads();

  for (;;) {
    const __nv_bfloat16* win = xs;
    const int next = item + gridDim.x;
    Band nb;
    if (next < items) {  // the next band's bytes are in flight during this one's math
      nb = band_of(next, Hp, Wp);
      issue_window<MODE>(raw, x, nb, H, W, aligned);
    }

    const int py = bd.py0 + warp;
    uint32_t* stg = stage[warp];
    // every warp of a warpgroup takes each tile (the wgmma is collective);
    // a warp past the last pooled row computes on pad rows and stores nothing
    for (int tile = 0; tile < SPAN / 8; ++tile) {
      const int pxb = bd.px0 + 8 * tile;  // first pooled column of the tile
      if (pxb >= Wp) break;
      // window index of the first patch value of conv pixel (2*warp, 16*tile
      // + 2g); conv pixel (2*warp + v, 16*tile + 2g + h) starts v*ROW + 3h on
      const int base = 2 * warp * ROW + bd.off + (16 * tile + 2 * g) * 3;
      // accs[h][4j + 2v + e]: channel 8j + 2q + e of conv pixel (v, h) of
      // pooled pixel g (m-tile h: the left or right pixels of the windows;
      // fragment rows g, g + 8: the top and bottom ones; the m64nNk16
      // accumulator layout)
      float accs[2][16];
      if constexpr (DOT) {
        uint32_t a[2][2][4];  // [h][k-step]: the m16n8k16 A fragment of the warp's rows
        int parity[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          parity[h] = (base + 3 * h) & 1;  // the same for every pixel of the block
          const uint32_t* p0 =
              reinterpret_cast<const uint32_t*>(win + base + 3 * h - parity[h]);
#pragma unroll
          for (int ks = 0; ks < 2; ++ks) {
            a[h][ks][0] = p0[poff[ks][0] / 2];
            a[h][ks][1] = p0[(ROW + poff[ks][0]) / 2];
            a[h][ks][2] = p0[poff[ks][1] / 2];
            a[h][ks][3] = p0[(ROW + poff[ks][1]) / 2];
          }
        }
        wgmma_fence();
#pragma unroll
        for (int t = TERMS - 1; t >= 0; --t)  // smallest term first
#pragma unroll
          for (int ks = 0; ks < 2; ++ks)
#pragma unroll
            for (int h = 0; h < 2; ++h)  // the two accumulators alternate
              wgmma_n32(accs[h], a[h][ks],
                        wdesc + ((t * 2 + parity[h]) * 4 + 2 * ks) * (C1 * 16 >> 4),
                        t != TERMS - 1 || ks != 0);
        wgmma_commit();
        wgmma_wait0();
      } else if constexpr (MODE == NO_DOT) {
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int v = 0; v < 2; ++v) {
            const float first = __bfloat162float(win[base + v * ROW + 3 * h]);
#pragma unroll
            for (int j = 0; j < 4; ++j) accs[h][4 * j + 2 * v] = accs[h][4 * j + 2 * v + 1] = first;
          }
      }
      // per channel 8j + 2q + e of pooled pixel g: the max of its four conv
      // outputs (NO_EPILOGUE: tap 0 in mx, taps 1-3 summed in rest)
      float mx[4][2], rest[4][2];
      if constexpr (MODE != DMA_ONLY) {
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float t0 = accs[0][4 * j + e], t1 = accs[1][4 * j + e];
            const float t2 = accs[0][4 * j + 2 + e], t3 = accs[1][4 * j + 2 + e];
            if constexpr (MODE == NO_EPILOGUE) {
              mx[j][e] = t0;
              rest[j][e] = t1 + t2 + t3;
            } else {
              mx[j][e] = fmaxf(fmaxf(t0, t1), fmaxf(t2, t3));
            }
          }
      }

#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 bj = *reinterpret_cast<const float2*>(bsm + 8 * j + 2 * q);
        float m[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float bias_c = e == 0 ? bj.x : bj.y;
          if constexpr (MODE == DMA_ONLY) {
            // x[2py, 2px, c % 3], picked by value: indexing a local array
            // with the run-time c % 3 would put it in local memory
            const __nv_bfloat16* px = win + base + ROW + 3;
            const int ci = (8 * j + 2 * q + e) % 3;
            m[e] = __bfloat162float(ci == 0 ? px[0] : ci == 1 ? px[1] : px[2]);
          } else if constexpr (MODE == NO_EPILOGUE) {
            m[e] = fmaf(0.0f * slope, rest[j][e], mx[j][e] + bias_c);
          } else {
            const float v = mx[j][e] + bias_c;
            m[e] = v >= 0.0f ? v : slope * v;
          }
        }
        // channels 8j + 2q, +1 of pixel g: word 4j + q (bf16) or 8j + 2q (f32)
        write_pair<T>(stg, g * STG + (8 * j + 2 * q) * (int)sizeof(T) / 4, m[0], m[1]);
      }
      __syncwarp();
      // the tile is 8 pixels x 32 channels, contiguous in NHWC
      constexpr int LPP = 2 * (int)sizeof(T);  // lanes a pixel (16 bytes each)
      T* dst_row = out + ((size_t)bd.f * Hp + py) * Wp * C1;
#pragma unroll
      for (int pass = 0; pass < 8 * LPP / 32; ++pass) {
        const int pix = pass * (32 / LPP) + lane / LPP, part = lane % LPP;
        if (py < Hp && pxb + pix < Wp) {
          const uint4 val = *reinterpret_cast<const uint4*>(stg + pix * STG + 4 * part);
          __stcs(reinterpret_cast<uint4*>(dst_row + (size_t)(pxb + pix) * C1) + part, val);
        }
      }
      __syncwarp();
    }

    if (next >= items) break;
    asm volatile("cp.async.wait_all;\n" ::);
    __syncthreads();  // the next band's bytes are in; every warp is done with the window
    convert_window<MODE>(xs, raw, nb, H, W, pad);
    __syncthreads();
    item = next;
    bd = nb;
  }
}

// Blocks of the persistent grid: as many of kernel 4's (FULL) as are
// resident at once, at most one a band.  Every mode runs on this grid, so
// a mode's time differs from FULL's by its stripped stage alone.
template <typename T>
int grid_blocks(int items) {
  static int resident = 0;
  if (resident == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, first_block_kernel<T, FULL>, THREADS, 0);
    resident = sms * (per_sm > 0 ? per_sm : 1);
  }
  return items < resident ? items : resident;
}

// x [F,H,W,3] u8; w_terms [TERMS,2,32,32] bf16 (term, parity, K rows in
// pair_rows order, N; TERMS 3 for f32 out, 2 for bf16); bias [32] f32 (folded);
// out [F,H/2,W/2,32], bf16 when out_bf16 else f32.  H and W must be even.
template <int MODE>
void launch_first_block(const void* x, const void* w_terms, const void* bias, void* out, int F,
                        int H, int W, float pad_u, float slope, int out_bf16,
                        cudaStream_t stream) {
  const int items = band_items(F, H, W);
  if (items == 0) return;
  const auto* xu = static_cast<const uint8_t*>(x);
  const auto* wt = static_cast<const __nv_bfloat16*>(w_terms);
  const auto* bf = static_cast<const float*>(bias);
  const int aligned = (3 * W) % 16 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  if (out_bf16)
    first_block_kernel<__nv_bfloat16, MODE>
        <<<grid_blocks<__nv_bfloat16>(items), THREADS, 0, stream>>>(
            xu, wt, bf, static_cast<__nv_bfloat16*>(out), F, H, W, pad_u, slope, aligned);
  else
    first_block_kernel<float, MODE><<<grid_blocks<float>(items), THREADS, 0, stream>>>(
        xu, wt, bf, static_cast<float*>(out), F, H, W, pad_u, slope, aligned);
}

}  // namespace
