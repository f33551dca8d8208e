// afSTFT synthesis back end for Hopper (sm_90a): hybrid inverse, irDFT,
// synthesis window, overlap-add and tail merge of a block of hops, for
// many rows (stream x output channel) at once, in one launch.
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
//   1. the hybrid inverse: uniform bin 0 is hybrid band 0, bins 1..4 the
//      sums of hybrid pairs (1, 2) .. (7, 8), bins 5..128 hybrid bands
//      9..132 (non-hybrid banks: the bins as they are);
//   2. the low-delay odd-bin sign (-1)^k;
//   3. irDFT of each frame (129 bins -> 256 samples, 1/256 scaled);
//   4. synthesis window, overlap-add over 10 hops, merge of the 9-hop
//      tail -> y[r, :] (H x 128) and the new tail (9 x 128); for H < 9
//      part of the old tail carries into the new one.
//
// What bounds it on the H100: at the ambi_dec order 3 -> 22.x slice (rows
// = 64 streams x 22 loudspeakers = 1408, H = 64, K = 266) it reads 96 MB
// of spectra and 6.5 MB of tails and writes 53 MB, while the irDFTs as
// FFTs and the overlap-add cost ~0.7 GFLOP: HBM, 155 MB at 3.35 TB/s =
// 0.046 ms, bounds it.  (The first design multiplied the spectra by
// [P.A; P.B] as a 12.3 GFLOP SGEMM, so fp32 FMA bound it, and wrote 92 MB
// of frames that a second launch read back for the overlap-add.)
//
// What the design does about it:
//   * one 8-warp block per row walks the row's hops in order, 8 frames a
//     step (one a warp); 128 threads, one per sample, then add the step's
//     frames in order into 10 accumulators in registers (output hops f ..
//     f+9 of the next frame f, each frame's halves times the synthesis
//     window's hops): frame f completes hop f, which leaves as a whole
//     512-byte hop, and after the row's last frame the 9 hops still
//     accumulating are the new tail.  No frame buffer in device memory, no
//     second launch, no frame transformed twice (tiles of output hops
//     would recompute 9 context frames each), and a frame stays in shared
//     memory for one step only; 1408 rows fill the card's 132 SMs, four
//     blocks each;
//   * a step's packed spectra (8 rows of 1064 B: only 8-byte aligned every
//     second row) arrive by 8-byte cp.async into shared memory, the next
//     step's while this one is transformed;
//   * each warp forms its frame's 129 uniform bins in irdft256's layout
//     (bin l + 32 r in lane l, register r; the Nyquist real part on lane
//     0), summing the hybrid pairs and applying the odd-bin sign as it
//     goes, and runs irdft256 (afstft_common.cuh: no A/B reads);
//   * all arithmetic is fp32 FMA, no TF32; the sums differ from the plain
//     version (dense [P.A; P.B] product, then the overlap-add) only in
//     their order.

#include <cuda_runtime.h>

#include "afstft_common.cuh"

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int NF = WARPS;              // frames per step, one a warp
constexpr int K_MAX = 2 * (NB + 4);    // packed hybrid row

static_assert(THREADS >= HOP, "a thread per output sample");

// shared memory carve-up, in floats (each part a multiple of 4)
constexpr int SM_SPEC = NF * K_MAX;              // one spectra buffer
constexpr int SM_FRAMES = NF * FRAME;
constexpr int SM_TW = 2 * FFT_TW;
constexpr int SM_FLOATS = 2 * SM_SPEC + SM_FRAMES + SM_TW;
static_assert(SM_SPEC % 4 == 0 && SM_FRAMES % 4 == 0,
              "16-byte aligned parts");
static_assert(SM_FLOATS * 4 <= 48 * 1024, "no opt-in shared memory needed");

template <bool HYBRID>
__global__ void __launch_bounds__(THREADS, 4)
synthesis_back(const float* __restrict__ spec,      // (rows, H, K)
               const float* __restrict__ ola_tail,  // (rows, NT, HOP)
               const float* __restrict__ w_syn,     // (10*HOP)
               const float2* __restrict__ tw_g,     // (FFT_TW)
               float* __restrict__ y,               // (rows, H, HOP)
               float* __restrict__ new_tail,        // (rows, NT, HOP)
               int H, int low_delay) {
  constexpr int NBH = HYBRID ? NB + 4 : NB;  // bands per packed half
  constexpr int K = 2 * NBH;
  constexpr int SHIFT = NBH - NB;            // hybrid band of uniform bin
                                             // k >= 5 is k + SHIFT
  extern __shared__ float4 smem4[];
  float* spec_s = reinterpret_cast<float*>(smem4);            // 2 buffers
  float* fr_s = spec_s + 2 * SM_SPEC;                         // NF frames
  float2* tw = reinterpret_cast<float2*>(fr_s + SM_FRAMES);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t row = blockIdx.x;
  const float* sp = spec + row * H * K;
  const bool ola = tid < HOP;         // threads of the overlap-add: sample i
  const int i = tid % HOP;

  for (int j = tid; j < FFT_TW; j += THREADS) tw[j] = tw_g[j];
  // w[k]: window hop k at sample i; acc[k]: output hop f + k at sample i
  // from the frames before f, f the next frame to add
  float w[TOTAL_HOPS], acc[TOTAL_HOPS];
#pragma unroll
  for (int k = 0; k < TOTAL_HOPS; ++k) {
    w[k] = w_syn[k * HOP + i];
    acc[k] = 0.f;
  }

  // step s: frames s*NF .. min(s*NF + NF, H) - 1, one contiguous span
  auto load = [&](int s, int buf) {
    const int n = min(NF, H - s * NF) * K / 2;
    const float* src = sp + (size_t)s * NF * K;
    float* dst = spec_s + buf * SM_SPEC;
    for (int e = tid; e < n; e += THREADS) cp_async8(dst + 2 * e, src + 2 * e);
  };
  const int n_steps = (H + NF - 1) / NF;
  load(0, 0);
  cp_async_commit();

  for (int s = 0; s < n_steps; ++s) {
    // 1. start the next step's spectra, wait for this step's; the barrier
    //    also ends the previous step's reads of the frames rewritten
    if (s + 1 < n_steps) load(s + 1, (s + 1) & 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const int f0 = s * NF;

    // 2. frame f0 + warp: uniform bins in the lanes, irDFT, to fr_s[warp]
    const int f = f0 + warp;
    if (f < H) {  // warp-uniform
      const float* fr = spec_s + (s & 1) * SM_SPEC + warp * K;
      float2 v[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int k = lane + 32 * r;
        const int b = (HYBRID && k >= 5) ? k + SHIFT : k;
        v[r] = make_float2(fr[b], fr[NBH + b]);
      }
      if (HYBRID && lane >= 1 && lane <= 4)  // the sums of hybrid pairs
        v[0] = make_float2(fr[2 * lane - 1] + fr[2 * lane],
                           fr[NBH + 2 * lane - 1] + fr[NBH + 2 * lane]);
      const float nyq = fr[HOP + SHIFT];
      if (low_delay && (lane & 1)) {  // (-1)^k on the odd bins
#pragma unroll
        for (int r = 0; r < 4; ++r) v[r] = make_float2(-v[r].x, -v[r].y);
      }
      irdft256(v, nyq, tw, lane);
      float* fo = fr_s + warp * FRAME;
#pragma unroll
      for (int r = 0; r < 4; ++r)
        *reinterpret_cast<float2*>(fo + 2 * fft_in_index(lane, r)) = v[r];
    }
    __syncthreads();

    // 3. the step's frames in order into the accumulators: frame f adds
    //    its half k % 2 times window hop k to output hop f + k, which
    //    completes hop f; it leaves with the old tail added for f < 9, and
    //    after the row's last frame the 9 hops still accumulating are the
    //    new tail
    if (ola) {
      const int nf = min(NF, H - f0);
#pragma unroll
      for (int j = 0; j < NF; ++j) {
        if (j >= nf) break;
        const float a = fr_s[j * FRAME + i], b = fr_s[j * FRAME + HOP + i];
#pragma unroll
        for (int k = 0; k < TOTAL_HOPS; ++k)
          acc[k] = fmaf(k & 1 ? b : a, w[k], acc[k]);
        const int p = f0 + j;
        y[(row * H + p) * HOP + i] =
            p < NT ? acc[0] + ola_tail[(row * NT + p) * HOP + i] : acc[0];
#pragma unroll
        for (int k = 0; k + 1 < TOTAL_HOPS; ++k) acc[k] = acc[k + 1];
        acc[TOTAL_HOPS - 1] = 0.f;
      }
    }
  }
  if (ola) {
#pragma unroll
    for (int k = 0; k < NT; ++k) {
      const int p = H + k;
      new_tail[(row * NT + k) * HOP + i] =
          p < NT ? acc[k] + ola_tail[(row * NT + p) * HOP + i] : acc[k];
    }
  }
  cp_async_wait<0>();
}

template <bool HYBRID>
cudaError_t launch(const float* spec, const float* ola_tail,
                   const float* w_syn, const float* tw, float* y,
                   float* new_tail, int rows, int H, int low_delay,
                   cudaStream_t st) {
  synthesis_back<HYBRID><<<rows, THREADS, SM_FLOATS * sizeof(float), st>>>(
      spec, ola_tail, w_syn, reinterpret_cast<const float2*>(tw), y,
      new_tail, H, low_delay);
  return cudaGetLastError();
}

}  // namespace

// C interface, loaded with ctypes.  Launches on `stream` and returns the
// CUDA error code (0 = success); allocates nothing.  hybrid != 0: rows of
// K = 266 (a hybrid bank), else 258; low_delay != 0: the odd-bin sign
// before the irDFT (the caller passes the low-delay window).  tw: the FFT
// twiddle table W256^k, (256, 2) float32.
extern "C" int saf_synthesis_back_ri(const float* spec, const float* ola_tail,
                                     const float* w_syn, const float* tw,
                                     float* y, float* new_tail, int rows,
                                     int H, int hybrid, int low_delay,
                                     void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rows < 1 || H < 1) return (int)cudaErrorInvalidConfiguration;
  return (int)(hybrid ? launch<true>(spec, ola_tail, w_syn, tw, y, new_tail,
                                     rows, H, low_delay, st)
                      : launch<false>(spec, ola_tail, w_syn, tw, y,
                                      new_tail, rows, H, low_delay, st));
}
