// afSTFT analysis front for Hopper (sm_90a): framing, analysis window,
// fold and rDFT of a block of hops, for many rows (stream x channel) at
// once.
//
// Replaces: the TPU kernel `_kernel`
//   (spatial_audio_framework_tpu/ops/pallas_afstft.py:82, launched by
//   `analysis_front_ri` through pl.pallas_call at :142).  It computes the
//   same function; the plain PyTorch version is
//   `analysis_front_ri_reference` in
//   spatial_audio_framework_tpu_torch/ops/afstft_kernels.py.
//
// What it computes, per row r of [tail | x] (t_hops + H hops of 128,
// t_hops >= 9), for each of the n_out = t_hops + H - 9 frames f:
//   1. fold hops f .. f+9 with the 10-hop analysis window into a
//      256-point frame (two parity accumulators);
//   2. rDFT of the frame (256 points -> 129 bins) -> re[r, f, :],
//      im[r, f, :].  Every frame is emitted, with no hop offset; a
//      low-delay bank changes only the window, which the wrapper passes.
//
// What bounds it on the H100: at the ambi_dec order 3 -> 22.x slice
// (rows = 64 streams x 16 channels = 1024, H = 64, 15-hop tail, 70
// frames) it reads 1024 x 79 hops x 512 B = 41 MB and writes 1024 x 70 x
// 129 x 8 B = 74 MB, while the rDFT as an FFT costs ~5 k FLOP a frame
// (~0.4 GFLOP a call with the fold): HBM, 115 MB at 3.35 TB/s = 0.034 ms,
// bounds it, and the writes dominate.  (The dense C/S product of the first
// design cost 132 k FLOP a frame, 9.7 GFLOP a call, and made fp32 FMA the
// bound.)
//
// What the design does about it:
//   * persistent blocks (as many as fit the card) walk over (row, tile of
//     frames); a row's frames are split into tiles of equal length, at most
//     40 (70 frames: two tiles of 35); a tile of nf frames needs nf + 9
//     hops, which arrive by cp.async into a padded hop buffer (HS = HOP +
//     4), the next tile's while this one is transformed; frames are
//     independent, so nothing is recomputed across tiles (the 9 hops two
//     tiles share are read twice, mostly from L2);
//   * each warp folds one frame into the FFT's input layout (fold_lane,
//     the window pairs in registers) and transforms it with rdft256
//     (afstft_common.cuh: a 128-point FFT in registers with lane shuffles
//     and the real split; no C/S), two 8-warp blocks an SM;
//   * the 129 bins leave straight from the lanes, consecutive lanes on
//     consecutive addresses.  A row is 516 B, so these stores straddle
//     32-byte sectors; staging a tile's rows in shared memory for 16-byte
//     stores was slower on the card (PERF.md: its store phase, behind a
//     barrier, idles the FFT; L2 merges the straddled sectors anyway), and
//     so were whole-row tiles of 70 frames and the window pairs read from
//     shared memory for three blocks an SM;
//   * all arithmetic is fp32 FMA, no TF32; the sums differ from the plain
//     version (dense fold and C/S product) only in their order.

#include <cuda_runtime.h>

#include "afstft_common.cuh"

namespace {

constexpr int NF_MAX = 40;             // frames per tile, at most
constexpr int NHOPS_MAX = NF_MAX + NT; // input hops a tile spans, at most
constexpr int HS = HOP + 4;            // hop stride in shared memory: the
                                       // two parities' reads miss each
                                       // other's banks
constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;

// shared memory carve-up, in floats (each part a multiple of 4)
constexpr int SM_HOPS = NHOPS_MAX * HS;          // one hop buffer
constexpr int SM_TW = 2 * FFT_TW;
constexpr int SM_FLOATS = 2 * SM_HOPS + SM_TW;
static_assert(SM_HOPS % 4 == 0, "16-byte aligned parts");
static_assert(SM_FLOATS * 4 <= 232448 / 2, "two blocks fit an SM");

__global__ void __launch_bounds__(THREADS, 2)
analysis_front(const float* __restrict__ tail,   // (rows, t_hops*HOP)
               const float* __restrict__ x,      // (rows, H*HOP)
               const float* __restrict__ w_ana,  // (10*HOP)
               const float2* __restrict__ tw_g,  // (FFT_TW)
               float* __restrict__ re,           // (rows, n_out, NB)
               float* __restrict__ im,           // (rows, n_out, NB)
               int rows, int t_hops, int H, int n_out, int nf, int n_tiles) {
  extern __shared__ float4 smem4[];
  float* hop_s = reinterpret_cast<float*>(smem4);             // 2 buffers
  float2* tw = reinterpret_cast<float2*>(hop_s + 2 * SM_HOPS);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n_items = rows * n_tiles;

  for (int i = tid; i < FFT_TW; i += THREADS) tw[i] = tw_g[i];
  float2 wr[4][TOTAL_HOPS / 2];  // this lane's window pairs
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int m = 0; m < TOTAL_HOPS / 2; ++m)
      wr[r][m] = window_pair(w_ana, HOP, lane, m, r);

  // tile t of a row: frames t*nf .. min((t+1)*nf, n_out) - 1
  auto frames_of = [&](int item) {
    return min(nf, n_out - (item % n_tiles) * nf);
  };
  auto load = [&](int item, int buf) {
    const int row = item / n_tiles, f0 = (item % n_tiles) * nf;
    load_hops_async(hop_s + buf * SM_HOPS, HS,
                    tail + (size_t)row * t_hops * HOP, t_hops,
                    x + (size_t)row * H * HOP, H, f0, frames_of(item) + NT,
                    tid, THREADS);
  };
  if ((int)blockIdx.x < n_items) load(blockIdx.x, 0);
  cp_async_commit();

  int it = 0;
  for (int item = blockIdx.x; item < n_items; item += gridDim.x, ++it) {
    // 1. wait for this tile's hops (the one copy in flight); after the
    //    barrier every warp is done with the other buffer, so the next
    //    tile's hops start into it
    cp_async_wait<0>();
    __syncthreads();
    if (item + (int)gridDim.x < n_items) load(item + gridDim.x, (it + 1) & 1);
    cp_async_commit();
    const float* hops = hop_s + (it & 1) * SM_HOPS;
    const int row = item / n_tiles, f0 = (item % n_tiles) * nf;
    const int n = frames_of(item);

    // 2. frame j per warp: fold, rDFT, the 129 bins straight from the lanes
    for (int j = warp; j < n; j += WARPS) {
      float2 v[4];
      fold_lane(v, hops, HS, j, lane,
                [&](int m, int r) { return wr[r][m]; });
      const float nyq = rdft256(v, tw, lane);
      const size_t o = ((size_t)row * n_out + f0 + j) * NB;
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        re[o + lane + 32 * r] = v[r].x;
        im[o + lane + 32 * r] = v[r].y;
      }
      if (lane == 0) {
        re[o + HOP] = nyq;
        im[o + HOP] = 0.f;
      }
    }
  }
  cp_async_wait<0>();
}

}  // namespace

// C interface, loaded with ctypes.  Launches on `stream` and returns the
// CUDA error code (0 = success); allocates nothing.  tw: the FFT twiddle
// table W256^k, (256, 2) float32.
extern "C" int saf_analysis_front_ri(const float* tail, const float* x,
                                     const float* w_ana, const float* tw,
                                     float* re, float* im, int rows,
                                     int t_hops, int H, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_out = t_hops + H - NT;
  // tiles of nf <= NF_MAX frames, as equal as they come; none empty
  const int nf = (n_out + (n_out + NF_MAX - 1) / NF_MAX - 1) /
                 ((n_out + NF_MAX - 1) / NF_MAX);
  const int n_tiles = (n_out + nf - 1) / nf;
  const int smem = SM_FLOATS * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      analysis_front, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, analysis_front, THREADS, smem)) != cudaSuccess)
    return (int)err;
  const long long items = (long long)rows * n_tiles;
  const int blocks = (int)(items < (long long)sms * per_sm
                               ? items : (long long)sms * per_sm);
  if (blocks < 1) return (int)cudaErrorInvalidConfiguration;
  analysis_front<<<blocks, THREADS, smem, st>>>(
      tail, x, w_ana, reinterpret_cast<const float2*>(tw), re, im, rows,
      t_hops, H, n_out, nf, n_tiles);
  return (int)cudaGetLastError();
}
