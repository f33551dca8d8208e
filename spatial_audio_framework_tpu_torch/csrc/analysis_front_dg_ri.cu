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
//      and rDFT them (256 points -> 129 bins);
//   2. d[r, h, :] = s[h+3] on all 129 bands;
//   3. g[r, h, :] = c1 (s[h+6] - s[h]) + c2 (s[h+4] - s[h+2]) on bands
//      0..15 only (the hybrid B taps are zero above band 4).
//
// What bounds it on the H100: at the ambi_bin order-7 slice (rows = 64
// streams x 64 channels = 4096, H = 64) it reads 4096 x 79 hops x 512 B =
// 166 MB and writes 4096 x 64 x (129 + 16) x 8 B = 304 MB, while the rDFT
// as an FFT costs ~5 k FLOP a frame (~2 GFLOP a call with the fold): HBM,
// 470 MB at 3.35 TB/s = 0.14 ms, bounds it.  (The dense C/S product of the
// first design cost 132 k FLOP a frame and made fp32 FMA the bound.)
//
// What the design does about it:
//   * persistent blocks (as many as fit the card) walk over (row, tile of
//     64 output hops); the tile's 79 input hops come into shared memory by
//     cp.async, the next tile's while the current one is transformed;
//   * each warp folds and transforms whole frames in registers (rdft256 in
//     afstft_common.cuh: a 128-point FFT with lane shuffles and the real
//     split; no C/S, no fold buffer), so shared memory holds only the two
//     hop buffers, the 2 KB twiddle table and the 16-band spectra: 94 KB a
//     block, two 8-warp blocks an SM;
//   * d leaves straight from the lanes as coalesced 129-float rows; bands
//     0..15 also go to shared memory, where the hop-shifted reads of g cost
//     nothing (the reason the TPU kernel existed); g is written on 16 bands;
//   * a tile transforms only the frames its hops need (H + 6 at most); the
//     6-frame context between tiles is recomputed (none at H = 64, the
//     order-7 slice: one tile a row); the window pairs each lane folds
//     with stay in registers;
//   * all arithmetic is fp32 FMA, no TF32; the sums differ from the plain
//     version (dense fold and C/S product) only in their order.

#include <cuda_runtime.h>

#include "afstft_common.cuh"

namespace {

constexpr int TILE = 64;               // output hops per tile
constexpr int NF = TILE + 6;           // frames per tile (6-hop context)
constexpr int NHOPS_IN = NF + NT;      // input hops the frames span
constexpr int HS = HOP + 4;            // hop stride in shared memory: the
                                       // two parities' reads miss each
                                       // other's banks
constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;

// shared memory carve-up, in floats (each part a multiple of 4)
constexpr int SM_HOPS = NHOPS_IN * HS;           // one hop buffer
constexpr int SM_TW = 2 * FFT_TW;
constexpr int SM_G = NF * G_BANDS * 2;
constexpr int SM_FLOATS = 2 * SM_HOPS + SM_TW + SM_G;
static_assert(SM_HOPS % 4 == 0 && SM_TW % 4 == 0, "16-byte aligned parts");
static_assert(SM_FLOATS * 4 <= 232448 / 2, "two blocks fit an SM");

__global__ void __launch_bounds__(THREADS, 2)
analysis_front_dg(const float* __restrict__ tail,   // (rows, t_hops*HOP)
                  const float* __restrict__ x,      // (rows, x_hops*HOP)
                  const float* __restrict__ w_ana,  // (10*HOP)
                  const float2* __restrict__ tw_g,  // (FFT_TW)
                  float* __restrict__ d_re,         // (rows, H, NB)
                  float* __restrict__ d_im,         // (rows, H, NB)
                  float* __restrict__ g_re,         // (rows, H, G_BANDS)
                  float* __restrict__ g_im,         // (rows, H, G_BANDS)
                  int rows, int t_hops, int x_hops, int H, int n_tiles) {
  extern __shared__ float4 smem4[];
  float* hop_s = reinterpret_cast<float*>(smem4);             // 2 buffers
  float2* tw = reinterpret_cast<float2*>(hop_s + 2 * SM_HOPS);
  float2* spec_s = tw + FFT_TW;                               // (NF, 16)

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n_items = rows * n_tiles;

  for (int i = tid; i < FFT_TW; i += THREADS) tw[i] = tw_g[i];
  float2 wr[4][TOTAL_HOPS / 2];  // this lane's window pairs
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int m = 0; m < TOTAL_HOPS / 2; ++m)
      wr[r][m] = window_pair(w_ana, HOP, lane, m, r);

  auto load = [&](int item, int buf) {
    const int row = item / n_tiles, h0 = (item % n_tiles) * TILE;
    load_hops_async(hop_s + buf * SM_HOPS, HS,
                    tail + (size_t)row * t_hops * HOP, t_hops,
                    x + (size_t)row * x_hops * HOP, x_hops, h0, NHOPS_IN, tid,
                    THREADS);
  };
  if ((int)blockIdx.x < n_items) load(blockIdx.x, 0);
  cp_async_commit();

  int it = 0;
  for (int item = blockIdx.x; item < n_items; item += gridDim.x, ++it) {
    // 1. start the next tile's hops, wait for this tile's
    if (item + (int)gridDim.x < n_items) load(item + gridDim.x, (it + 1) & 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const float* hops = hop_s + (it & 1) * SM_HOPS;
    const int row = item / n_tiles, h0 = (item % n_tiles) * TILE;

    // 2. frame j (s[h0 + j]) per warp: fold, rDFT; frame j is the direct
    //    tap of output hop h0 + j - 3
    const int nf = min(NF, H - h0 + 6);
    for (int j = warp; j < nf; j += WARPS) {
      float2 v[4];
      fold_lane(v, hops, HS, j, lane,
                [&](int m, int r) { return wr[r][m]; });
      const float nyq = rdft256(v, tw, lane);
      const int h = h0 + j - 3;
      if (j >= 3 && j < TILE + 3 && h < H) {
        const size_t o = ((size_t)row * H + h) * NB;
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          d_re[o + lane + 32 * r] = v[r].x;
          d_im[o + lane + 32 * r] = v[r].y;
        }
        if (lane == 0) {
          d_re[o + HOP] = nyq;
          d_im[o + HOP] = 0.f;
        }
      }
      if (lane < G_BANDS) spec_s[j * G_BANDS + lane] = v[0];
    }
    __syncthreads();

    // 3. hybrid context of output hops h0 .. h0+TILE-1 on bands 0..15
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
  cp_async_wait<0>();
}

}  // namespace

// C interface, loaded with ctypes.  Launches on `stream` and returns the
// CUDA error code (0 = success); allocates nothing.  tw: the FFT twiddle
// table W256^k, (256, 2) float32.
extern "C" int saf_analysis_front_dg_ri(const float* tail, const float* x,
                                        const float* w_ana, const float* tw,
                                        float* d_re, float* d_im, float* g_re,
                                        float* g_im, int rows, int t_hops,
                                        int x_hops, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int H = t_hops + x_hops - NT - 6;
  const int n_tiles = (H + TILE - 1) / TILE;
  const int smem = SM_FLOATS * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      analysis_front_dg, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, analysis_front_dg, THREADS, smem)) != cudaSuccess)
    return (int)err;
  const long long items = (long long)rows * n_tiles;
  const int blocks = (int)(items < (long long)sms * per_sm
                               ? items : (long long)sms * per_sm);
  if (blocks < 1) return (int)cudaErrorInvalidConfiguration;
  analysis_front_dg<<<blocks, THREADS, smem, st>>>(
      tail, x, w_ana, reinterpret_cast<const float2*>(tw), d_re, d_im, g_re,
      g_im, rows, t_hops, x_hops, H, n_tiles);
  return (int)cudaGetLastError();
}
