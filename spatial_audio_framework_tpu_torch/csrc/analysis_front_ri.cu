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
//   2. rDFT of the frame against C/S (256 x 129) → re[r, f, :], im[r, f, :].
//
// What bounds it on the H100: at the ambi_dec order 3 -> 22.x slice
// (rows = 64 streams x 16 channels = 1024, H = 64, 15-hop tail, 70
// frames) the rDFT is 1024 x 70 frames x 256 x 129 x 2 (re, im) x 2 FLOP
// = 9.5 GFLOP per call (9.7 executed: two 36-frame tiles cover 72) against
// 41 MB of input and 74 MB of output: ~80 FLOP per byte, so fp32 FMA
// (67 TFLOP/s without tensor cores) bounds it, not the 3.35 TB/s HBM.
//
// What the design does about it:
//   * one block per (row, tile of 36 frames): the 45 input hops and the 36
//     folded frames live in shared memory (60 KB, so three blocks fit an
//     SM); each input sample is read from device memory once per tile;
//   * the rDFT is register-tiled as in render_full_ri.cu (the same device
//     code, afstft_common.cuh): each of 2 x 129 threads owns one band and
//     18 frames, so every C/S value it loads through L1/L2 feeds 36 FMAs;
//   * an output row is 129 floats, so the stores are scalar, one band per
//     thread, consecutive threads on consecutive addresses;
//   * all arithmetic is fp32 FMA, no TF32, for every precision mode; the
//     sums differ from the plain version only in their order.
// Tensor-core rDFTs are later work.

#include <cuda_runtime.h>

#include "afstft_common.cuh"

namespace {

constexpr int GROUPS = 2;              // frame groups per band
constexpr int FPG = 18;                // rDFT frames per thread
constexpr int NF = GROUPS * FPG;       // frames per block
constexpr int NHOPS_IN = NF + NT;      // input hops the frames span
constexpr int THREADS = 288;           // >= GROUPS * NB, whole warps

static_assert(THREADS >= GROUPS * NB && THREADS >= FRAME, "threads");

// shared memory carve-up, in floats (each part a multiple of 4)
constexpr int SM_HOPS = NHOPS_IN * HOP;
constexpr int SM_FOLD = NF * FRAME;
constexpr int SM_FLOATS = SM_HOPS + SM_FOLD;
static_assert(SM_HOPS % 4 == 0, "16-byte aligned parts");
static_assert(SM_FLOATS * 4 <= 232448, "fits a block's shared memory");

__global__ void __launch_bounds__(THREADS)
analysis_front(const float* __restrict__ tail,   // (rows, t_hops*HOP)
               const float* __restrict__ x,      // (rows, H*HOP)
               const float* __restrict__ w_ana,  // (10*HOP)
               const float* __restrict__ Cm,     // (FRAME, NB)
               const float* __restrict__ Sm,     // (FRAME, NB)
               float* __restrict__ re,           // (rows, n_out, NB)
               float* __restrict__ im,           // (rows, n_out, NB)
               int t_hops, int H, int n_out, int n_tiles) {
  extern __shared__ float4 smem4[];
  float* hop_s = reinterpret_cast<float*>(smem4);
  float* fold_s = hop_s + SM_HOPS;

  const int tid = threadIdx.x;
  const int row = blockIdx.x / n_tiles;
  const int f0 = (blockIdx.x % n_tiles) * NF;

  // 1. input hops f0 .. f0+NHOPS_IN-1 of [tail | x]; zeros past the end
  load_hops(hop_s, tail + (size_t)row * t_hops * HOP, t_hops,
            x + (size_t)row * H * HOP, H, f0, NHOPS_IN, tid, THREADS);
  __syncthreads();

  // 2. window fold of the tile's NF frames
  fold_frames(fold_s, hop_s, w_ana, NF, tid);
  __syncthreads();

  // 3. rDFT: band k for frames grp*FPG .. grp*FPG+FPG-1 of the tile
  const int k = tid % NB;
  const int grp = tid / NB;           // >= GROUPS: idle
  if (grp < GROUPS) {
    float sr[FPG], si[FPG];
    rdft_band<FPG>(fold_s + grp * FPG * FRAME, Cm, Sm, k, sr, si);
#pragma unroll
    for (int jj = 0; jj < FPG; ++jj) {
      const int f = f0 + grp * FPG + jj;
      if (f < n_out) {
        const size_t o = ((size_t)row * n_out + f) * NB + k;
        re[o] = sr[jj];
        im[o] = si[jj];
      }
    }
  }
}

}  // namespace

// C interface, loaded with ctypes.  Launches on `stream` and returns the
// CUDA error code (0 = success); allocates nothing.
extern "C" int saf_analysis_front_ri(const float* tail, const float* x,
                                     const float* w_ana, const float* Cm,
                                     const float* Sm, float* re, float* im,
                                     int rows, int t_hops, int H,
                                     void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_out = t_hops + H - NT;
  const int n_tiles = (n_out + NF - 1) / NF;
  const int smem = SM_FLOATS * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      analysis_front, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  analysis_front<<<rows * n_tiles, THREADS, smem, st>>>(
      tail, x, w_ana, Cm, Sm, re, im, t_hops, H, n_out, n_tiles);
  return (int)cudaGetLastError();
}
