// afSTFT analysis front for Hopper (sm_90a) that emits the renderer's
// (d, g) pair: framing, analysis window, fold and rDFT of a block of hops
// for many rows (stream x channel), then the direct taps and the hybrid-FIR
// context of each output hop.
//
// Replaces: the TPU kernel `_kernel_dg`
//   (spatial_audio_framework_tpu/ops/pallas_afstft.py:173, launched by
//   `analysis_front_dg_ri` through pl.pallas_call at :254).  It computes the
//   same function; the plain PyTorch version is
//   `analysis_front_dg_ri_reference` in
//   spatial_audio_framework_tpu_torch/ops/afstft_kernels.py.
//
// What it computes, per row r of [tail | x] (t_hops + x_hops hops of 128,
// t_hops >= 9) with H = t_hops + x_hops - 15 output hops:
//   1. fold the H + 6 frames s[0 .. H+5] with the 10-hop analysis window
//      and rDFT them against C/S (256 x 129), as analysis_front_ri.cu does;
//   2. d[r, h, :] = s[h+3] on all 129 bands;
//   3. g[r, h, :] = c1 (s[h+6] - s[h]) + c2 (s[h+4] - s[h+2]) on bands
//      0..15 only (the hybrid B taps are zero above band 4).
//
// What bounds it on the H100: at the ambi_bin order-7 slice (rows = 64
// streams x 64 channels = 4096, H = 64) the rDFT is 4096 x 70 frames x 256
// x 129 x 2 (re, im) x 2 FLOP = 37.9 GFLOP per call (41.1 executed: two
// 38-frame tiles cover 76) against 4096 x 79 hops x 512 B = 166 MB of input
// and 4096 x 64 x (129 + 16) x 8 B = 304 MB of output: ~80 FLOP per byte,
// so fp32 FMA (67 TFLOP/s without tensor cores) bounds it before the
// 3.35 TB/s HBM.
//
// What the design does about it:
//   * one block per (row, tile of 32 output hops): the tile's 38 frames (32
//     + the 6-hop context) are folded from 47 input hops in shared memory
//     (68 KB; at 94 registers two blocks fit an SM) and the rDFT is
//     register-tiled as in analysis_front_ri.cu (2 x 129 band threads, 19
//     frames each, every C/S value loaded feeds 38 FMAs); the 6-frame
//     overlap between tiles is recomputed, 9 % more rDFT work at H = 64;
//   * d leaves straight from the rDFT's registers; the spectra of bands
//     0..15 also go to shared memory, where the hop-shifted reads of g cost
//     nothing (the reason the TPU kernel existed);
//   * g is written on 16 bands only, 1/8 of a full-width g's traffic;
//   * outputs are rows of 129 (d) and 16 (g) floats, stored one band per
//     thread, consecutive threads on consecutive addresses;
//   * all arithmetic is fp32 FMA, no TF32, for every precision mode; the
//     sums differ from the plain version only in their order.

#include <cuda_runtime.h>

#include "afstft_common.cuh"

namespace {

constexpr int TILE = 32;               // output hops per block
constexpr int NF = TILE + 6;           // frames per block (6-hop context)
constexpr int NHOPS_IN = NF + NT;      // input hops the frames span
constexpr int GROUPS = 2;              // frame groups per band
constexpr int FPG = NF / GROUPS;       // rDFT frames per thread
constexpr int THREADS = 288;           // >= GROUPS * NB, whole warps

static_assert(NF % GROUPS == 0, "even split");
static_assert(THREADS >= GROUPS * NB && THREADS >= FRAME, "threads");

// shared memory carve-up, in floats (each part a multiple of 4)
constexpr int SM_HOPS = NHOPS_IN * HOP;
constexpr int SM_FOLD = NF * FRAME;
constexpr int SM_G = NF * G_BANDS * 2;
constexpr int SM_FLOATS = SM_HOPS + SM_FOLD + SM_G;
static_assert(SM_HOPS % 4 == 0 && SM_FOLD % 4 == 0, "16-byte aligned parts");
static_assert(SM_FLOATS * 4 <= 232448, "fits a block's shared memory");

__global__ void __launch_bounds__(THREADS)
analysis_front_dg(const float* __restrict__ tail,   // (rows, t_hops*HOP)
                  const float* __restrict__ x,      // (rows, x_hops*HOP)
                  const float* __restrict__ w_ana,  // (10*HOP)
                  const float* __restrict__ Cm,     // (FRAME, NB)
                  const float* __restrict__ Sm,     // (FRAME, NB)
                  float* __restrict__ d_re,         // (rows, H, NB)
                  float* __restrict__ d_im,         // (rows, H, NB)
                  float* __restrict__ g_re,         // (rows, H, G_BANDS)
                  float* __restrict__ g_im,         // (rows, H, G_BANDS)
                  int t_hops, int x_hops, int H, int n_tiles) {
  extern __shared__ float4 smem4[];
  float* hop_s = reinterpret_cast<float*>(smem4);
  float* fold_s = hop_s + SM_HOPS;
  float2* spec_s = reinterpret_cast<float2*>(fold_s + SM_FOLD);  // (NF, 16)

  const int tid = threadIdx.x;
  const int row = blockIdx.x / n_tiles;
  const int h0 = (blockIdx.x % n_tiles) * TILE;

  // 1. input hops h0 .. h0+NHOPS_IN-1 of [tail | x]; zeros past the end
  load_hops(hop_s, tail + (size_t)row * t_hops * HOP, t_hops,
            x + (size_t)row * x_hops * HOP, x_hops, h0, NHOPS_IN, tid,
            THREADS);
  __syncthreads();

  // 2. window fold of the tile's NF frames (frame j is s[h0 + j])
  fold_frames(fold_s, hop_s, w_ana, NF, tid);
  __syncthreads();

  // 3. rDFT of band k for frames grp*FPG .. grp*FPG+FPG-1; frame j is the
  //    direct tap of output hop h0 + j - 3
  const int k = tid % NB;
  const int grp = tid / NB;           // >= GROUPS: idle
  if (grp < GROUPS) {
    float sr[FPG], si[FPG];
    rdft_band<FPG>(fold_s + grp * FPG * FRAME, Cm, Sm, k, sr, si);
#pragma unroll
    for (int jj = 0; jj < FPG; ++jj) {
      const int j = grp * FPG + jj;
      const int h = h0 + j - 3;
      if (j >= 3 && j < TILE + 3 && h < H) {
        const size_t o = ((size_t)row * H + h) * NB + k;
        d_re[o] = sr[jj];
        d_im[o] = si[jj];
      }
      if (k < G_BANDS) spec_s[j * G_BANDS + k] = make_float2(sr[jj], si[jj]);
    }
  }
  __syncthreads();

  // 4. hybrid context of output hops h0 .. h0+TILE-1 on bands 0..15
  for (int i = tid; i < TILE * G_BANDS; i += THREADS) {
    const int hh = i / G_BANDS, kk = i % G_BANDS;
    const int h = h0 + hh;
    if (h < H) {
      const float2 g = hybrid_context(
          spec_s[hh * G_BANDS + kk], spec_s[(hh + 2) * G_BANDS + kk],
          spec_s[(hh + 4) * G_BANDS + kk], spec_s[(hh + 6) * G_BANDS + kk]);
      const size_t o = ((size_t)row * H + h) * G_BANDS + kk;
      g_re[o] = g.x;
      g_im[o] = g.y;
    }
  }
}

}  // namespace

// C interface, loaded with ctypes.  Launches on `stream` and returns the
// CUDA error code (0 = success); allocates nothing.
extern "C" int saf_analysis_front_dg_ri(const float* tail, const float* x,
                                        const float* w_ana, const float* Cm,
                                        const float* Sm, float* d_re,
                                        float* d_im, float* g_re, float* g_im,
                                        int rows, int t_hops, int x_hops,
                                        void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int H = t_hops + x_hops - NT - 6;
  const int n_tiles = (H + TILE - 1) / TILE;
  const int smem = SM_FLOATS * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      analysis_front_dg, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  analysis_front_dg<<<rows * n_tiles, THREADS, smem, st>>>(
      tail, x, w_ana, Cm, Sm, d_re, d_im, g_re, g_im, t_hops, x_hops, H,
      n_tiles);
  return (int)cudaGetLastError();
}
