// afSTFT synthesis back end for Hopper (sm_90a): hybrid inverse, irDFT,
// synthesis window, overlap-add and tail merge of a block of hops, for
// many rows (stream x output channel) at once.
//
// Replaces: the TPU kernel `_syn_kernel`
//   (spatial_audio_framework_tpu/ops/pallas_afstft.py:851, launched by
//   `synthesis_back_ri` through pl.pallas_call at :913).  It computes the
//   same function; the plain PyTorch version is
//   `synthesis_back_ri_reference` in
//   spatial_audio_framework_tpu_torch/ops/afstft_kernels.py.
//
// What it computes, per row r (H hops of packed spectra [re | im], K =
// 2 x 133 floats for hybrid banks, 2 x 129 non-hybrid):
//   1. frames[r, h, :] = spec[r, h, :] @ AB, AB = [P.A; P.B] (K x 256):
//      the hybrid inverse P (band pairs summed back to uniform bands), the
//      low-delay odd-bin sign and the irDFT, folded into one matrix by the
//      wrapper — so hybrid / non-hybrid and normal / low-delay banks are
//      only different constants here;
//   2. synthesis window, overlap-add over 10 hops, merge of the 9-hop
//      tail → y[r, :] (H x 128) and the new tail (`overlap_add`, shared
//      with render_full_ri.cu through afstft_common.cuh).
//
// What bounds it on the H100: at the ambi_dec order 3 -> 22.x slice
// (rows = 64 streams x 22 loudspeakers = 1408, H = 64, K = 266) step 1 is
// a 90112 x 266 x 256 product, 12.3 GFLOP per call, against 96 MB of
// spectra read, 92 MB of frames written and read back, and 46 MB of output:
// ~40 FLOP per byte, so fp32 FMA (67 TFLOP/s without tensor cores) bounds
// it before the 3.35 TB/s HBM.
//
// What the design does about it:
//   * step 1 is a classic shared-memory tiled SGEMM: 128 x 128 output
//     tiles, K in steps of 8, 256 threads each holding an 8 x 8 register
//     tile, so every value read from shared memory feeds 8 FMAs;
//   * a spectrum row is 266 (or 258) floats, not a multiple of 4, so the
//     A tile is loaded with scalar loads and stored transposed; AB's rows
//     are 256 floats and load as float4;
//   * K is masked at its ragged end (266 = 33 x 8 + 2) and rows past M are
//     masked, so any row count and H >= 1 work;
//   * step 2 is a second, light launch over a frame buffer in device
//     memory; it handles H < 9 (part of the old tail carries through);
//   * all arithmetic is fp32 FMA, no TF32, for every precision mode.
// Fusing the overlap-add into the product's epilogue (keeping the frames
// out of device memory) and tensor-core products are later work.

#include <cuda_runtime.h>

#include "afstft_common.cuh"

namespace {

constexpr int BM = 128;                // output rows per block
constexpr int BN = 128;                // output columns per block
constexpr int BK = 8;                  // depth per shared-memory stage
constexpr int TM = 8;                  // rows per thread
constexpr int TN = 8;                  // columns per thread
constexpr int THREADS = (BM / TM) * (BN / TN);

static_assert(BM * BK == 4 * THREADS && BK * BN == 4 * THREADS,
              "each thread loads 4 values of each tile");
static_assert(FRAME % BN == 0, "whole column tiles");

// Launch (a): frames (M, FRAME) = spec (M, K) @ AB (K, FRAME).
__global__ void __launch_bounds__(THREADS)
spec_irdft(const float* __restrict__ spec,  // (M, K)
           const float* __restrict__ AB,    // (K, FRAME)
           float* __restrict__ frames,      // (M, FRAME)
           int M, int K) {
  __shared__ __align__(16) float As[BK][BM];  // transposed A tile
  __shared__ __align__(16) float Bs[BK][BN];

  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN);     // column group of this thread
  const int ty = tid / (BN / TN);     // row group of this thread
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;

  // loaders: A as 2 threads x 4 scalars per row, AB as one float4 each
  const int a_row = tid / 2, a_k = (tid % 2) * 4;
  const int b_k = tid / (BN / 4), b_n = (tid % (BN / 4)) * 4;
  const bool a_ok = m0 + a_row < M;
  const float* a_ptr = spec + (size_t)(a_ok ? m0 + a_row : 0) * K;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int kk = k0 + a_k + j;
      As[a_k + j][a_row] = (a_ok && kk < K) ? __ldg(a_ptr + kk) : 0.f;
    }
    {
      const int kk = k0 + b_k;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (kk < K)
        v = __ldg(reinterpret_cast<const float4*>(AB + (size_t)kk * FRAME +
                                                  n0 + b_n));
      *reinterpret_cast<float4*>(&Bs[b_k][b_n]) = v;
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[kk][ty * TM]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[kk][ty * TM + 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[kk][tx * TN]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bs[kk][tx * TN + 4]);
      const float a[TM] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[TN] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty * TM + i;
    if (m < M) {
      float4* out = reinterpret_cast<float4*>(frames + (size_t)m * FRAME +
                                              n0 + tx * TN);
      out[0] = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      out[1] = make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
    }
  }
}

}  // namespace

// C interface, loaded with ctypes.  Launches both kernels on `stream` and
// returns the first CUDA error code (0 = success); allocates nothing.
extern "C" int saf_synthesis_back_ri(const float* spec, const float* ola_tail,
                                     const float* AB, const float* w_syn,
                                     float* frames, float* y, float* new_tail,
                                     int rows, int H, int K, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int M = rows * H;
  const dim3 grid((M + BM - 1) / BM, FRAME / BN);
  spec_irdft<<<grid, THREADS, 0, st>>>(spec, AB, frames, M, K);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)launch_overlap_add(frames, w_syn, ola_tail, y, new_tail, rows,
                                 H, st);
}
