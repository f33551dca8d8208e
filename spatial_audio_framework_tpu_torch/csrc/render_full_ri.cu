// One-kernel TF-matrix renderer for Hopper (sm_90a): afSTFT analysis,
// hybrid-band decode and afSTFT synthesis of a block of hops.
//
// Replaces: the TPU kernel `_render_full_kernel`
//   (spatial_audio_framework_tpu/ops/pallas_afstft.py:674, launched by
//   `render_full_ri` through pl.pallas_call at :778).  It computes the same
//   function; the plain PyTorch version is `render_full_ri_reference` in
//   spatial_audio_framework_tpu_torch/ops/afstft_kernels.py.
//
// What it computes, per stream s (hop = 128, 129 uniform bands):
//   1. fold the H+6 frames of [in_tail | x] (15 + H hops) with the 10-hop
//      analysis window into 256-point frames (two parity accumulators);
//   2. rDFT of each frame as products with the C/S matrices (256 x 129);
//   3. hybrid banks: direct taps d = s[h+3] and hybrid context
//      g = c1(s[h+6]-s[h]) + c2(s[h+4]-s[h+2]) on bands 0..15 only;
//      non-hybrid banks: d = s[h+6] and no context (a template parameter);
//   4. per ear, summed over cin: A.d + B.(j g), j g = (-g_im, g_re), with
//      shared taps (cin, cout, 4, 129) or per-stream taps (S, cin, cout, 4,
//      129), a pointer offset per stream;
//   5. irDFT against A/B (129 x 256);
//   6. synthesis window, overlap-add over 10 hops, merge of the 9-hop tail.
// A low-delay bank changes only the constants: the wrapper passes its
// analysis and synthesis windows, and A/B with the odd-bin sign folded in
// (as `_render_full_ri` does, pallas_afstft.py:756-761).
//
// What bounds it on the H100: at the flagship shape (S = 64 streams,
// cin = 16, cout = 2, H = 64) the rDFT alone is 64*16*70 frames x 256x258
// x 2 = 9.5 GFLOP per chunk, against ~41 MB of input and tails, i.e.
// ~230 FLOP per byte of device memory traffic: fp32 compute bounds it
// (67 TFLOP/s of fp32 FMA without tensor cores), not the 3.35 TB/s HBM.
//
// What the design does about it:
//   * the spectra never leave the SM: a block owns (stream, tile of 32
//     output hops), loops over the cin channels, and keeps the fold, the
//     38-frame spectrum and the per-ear decode accumulators in shared
//     memory and registers; only the irDFT frames (S, cout, H, 256) go to
//     a scratch buffer that is mostly L2-resident;
//   * the rDFT is a register-tiled product: each thread owns one band and
//     19 frames, so every C/S value it loads (through L1/L2; the two
//     matrices are 264 KB, above the 227 KB a block may hold in shared
//     memory) feeds 19 x 2 FMAs, and the frame samples come from shared
//     memory as 16-byte broadcasts;
//   * all arithmetic is fp32 FMA, no TF32, for every precision mode
//     (ops/precision.py); the sums differ from the plain version only in
//     their order.
// A second, light launch does step 6, one thread per output sample
// (`overlap_add`).  It, the hop load, the fold, the rDFT loop, the decode
// and the irDFT are shared with the other kernels through
// afstft_common.cuh.
// Making the rDFT a tensor-core product (3xTF32 or a split-bf16 scheme as
// on the TPU) is later work.

#include <cuda_runtime.h>

#include "afstft_common.cuh"

namespace {

constexpr int TAIL_HOPS = 15;         // carried input hops (9 + 6)
constexpr int TILE = 32;              // output hops per block
constexpr int NF = TILE + 6;          // frames per block (6-hop context)
constexpr int NHOPS_IN = NF + NT;     // input hops the frames span
constexpr int GROUPS = 2;             // frame groups per band
constexpr int FPG = NF / GROUPS;      // rDFT frames per thread
constexpr int HPG = TILE / GROUPS;    // decoded hops per thread
constexpr int EC = 2;                 // ears per pass over the channels
constexpr int THREADS = 288;          // >= GROUPS * NB, whole warps

static_assert(NF % GROUPS == 0 && TILE % GROUPS == 0, "even split");
static_assert(THREADS >= GROUPS * NB && THREADS >= FRAME, "threads");
static_assert(THREADS >= EC * TILE, "threads");

// shared memory carve-up, in floats (each part a multiple of 4)
constexpr int SM_HOPS = NHOPS_IN * HOP;
constexpr int SM_WIN = TOTAL_HOPS * HOP;
constexpr int SM_FOLD = NF * FRAME;
constexpr int SM_SPEC = NF * NB * 2;
constexpr int SM_OUT = EC * TILE * NB_PAD * 2;
constexpr int SM_FLOATS = SM_HOPS + SM_WIN + SM_FOLD + SM_SPEC + SM_OUT;
static_assert(SM_HOPS % 4 == 0 && SM_WIN % 4 == 0 && SM_FOLD % 4 == 0 &&
              SM_SPEC % 4 == 0, "16-byte aligned parts");
static_assert(SM_FLOATS * 4 <= 232448, "fits a block's shared memory");

// Launch (a): analysis, decode and irDFT of one (stream, hop tile).
// HYBRID: d at hop offset 3 with the hybrid context, else d at offset 6.
template <bool HYBRID>
__global__ void __launch_bounds__(THREADS)
analysis_decode_irdft(const float* __restrict__ in_tail,  // (S, cin, 15*HOP)
                      const float* __restrict__ x,        // (S, cin, H*HOP)
                      const float* __restrict__ taps,     // (cin, cout, 4, NB)
                                                          // per stream
                      long long taps_stride,              // 0: shared taps
                      const float* __restrict__ w_ana,    // (10*HOP)
                      const float* __restrict__ Cm,       // (FRAME, NB)
                      const float* __restrict__ Sm,       // (FRAME, NB)
                      const float* __restrict__ Am,       // (NB_PAD, FRAME)
                      const float* __restrict__ Bm,       // (NB_PAD, FRAME)
                      float* __restrict__ frames,         // (S, cout, H, FRAME)
                      int cin, int cout, int H, int n_tiles) {
  extern __shared__ float4 smem4[];
  float* hop_s = reinterpret_cast<float*>(smem4);
  float* win_s = hop_s + SM_HOPS;
  float* fold_s = win_s + SM_WIN;
  float2* spec_s = reinterpret_cast<float2*>(fold_s + SM_FOLD);
  float* out_s = fold_s + SM_FOLD + SM_SPEC;

  const int tid = threadIdx.x;
  const int s = blockIdx.x / n_tiles;
  const int h0 = (blockIdx.x % n_tiles) * TILE;
  const int k = tid % NB;             // band of this thread
  const int grp = tid / NB;           // frame/hop group; >= GROUPS: idle
  const bool band_thread = grp < GROUPS;
  const bool hyb = HYBRID && k < G_BANDS;
  constexpr int D_OFF = HYBRID ? 3 : 6;
  const float* tps = taps + s * taps_stride;

  for (int i = tid; i < SM_WIN; i += THREADS) win_s[i] = w_ana[i];

  for (int e0 = 0; e0 < cout; e0 += EC) {
    const int ne = min(EC, cout - e0);
    float acc_re[EC][HPG], acc_im[EC][HPG];
#pragma unroll
    for (int e = 0; e < EC; ++e)
#pragma unroll
      for (int hh = 0; hh < HPG; ++hh) acc_re[e][hh] = acc_im[e][hh] = 0.f;

    for (int c = 0; c < cin; ++c) {
      // 1. input hops h0 .. h0+NHOPS_IN-1 of [in_tail | x]; zeros past the end
      load_hops(hop_s, in_tail + ((size_t)s * cin + c) * (TAIL_HOPS * HOP),
                TAIL_HOPS, x + ((size_t)s * cin + c) * ((size_t)H * HOP), H,
                h0, NHOPS_IN, tid, THREADS);
      __syncthreads();

      // 2. window fold: parity p accumulates window hops p, p+2, ..., p+8
      fold_frames(fold_s, hop_s, win_s, NF, tid);
      __syncthreads();

      // 3. rDFT: this thread's band k for frames grp*FPG .. grp*FPG+FPG-1
      if (band_thread) {
        float sr[FPG], si[FPG];
        rdft_band<FPG>(fold_s + grp * FPG * FRAME, Cm, Sm, k, sr, si);
#pragma unroll
        for (int jj = 0; jj < FPG; ++jj)
          spec_s[(grp * FPG + jj) * NB + k] = make_float2(sr[jj], si[jj]);
      }
      __syncthreads();

      // 4. decode this channel into hops grp*HPG .. grp*HPG+HPG-1, band k
      if (band_thread) {
        const BandTaps<EC> t = load_taps<EC>(
            tps + ((size_t)c * cout + e0) * 4 * NB + k, ne, hyb);
#pragma unroll
        for (int hh = 0; hh < HPG; ++hh) {
          const int h = grp * HPG + hh;
          const float2 d = spec_s[(h + D_OFF) * NB + k];
          float2 w = make_float2(0.f, 0.f);
          if (hyb) {
            const float2 g = hybrid_context(
                spec_s[h * NB + k], spec_s[(h + 2) * NB + k],
                spec_s[(h + 4) * NB + k], spec_s[(h + 6) * NB + k]);
            w = make_float2(-g.y, g.x);
          }
          decode_hop<EC, HPG>(t, d, w, acc_re, acc_im, hh);
        }
      }
    }

    // 5. decoded spectra to shared memory as (re, im) pairs, band NB zeroed
    if (band_thread)
      store_decoded<EC, HPG, TILE>(out_s, acc_re, acc_im, grp * HPG, k);
    zero_pad_band<EC, TILE>(out_s, tid);
    __syncthreads();

    // 6. irDFT: thread n computes sample n of every (ear, hop) frame
    irdft_tile<EC, TILE>(out_s, Am, Bm,
                         frames + ((size_t)s * cout + e0) * H * FRAME, H, h0,
                         ne, tid);
    __syncthreads();  // out_s is rewritten by the next ear pass
  }
}

template <bool HYBRID>
cudaError_t launch(const float* in_tail, const float* x, const float* taps,
                   long long taps_stride, const float* w_ana,
                   const float* Cm, const float* Sm, const float* Am,
                   const float* Bm, float* frames, int n_streams, int cin,
                   int cout, int H, cudaStream_t st) {
  const int n_tiles = (H + TILE - 1) / TILE;
  const int smem = SM_FLOATS * (int)sizeof(float);
  const cudaError_t err = cudaFuncSetAttribute(
      analysis_decode_irdft<HYBRID>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  analysis_decode_irdft<HYBRID><<<n_streams * n_tiles, THREADS, smem, st>>>(
      in_tail, x, taps, taps_stride, w_ana, Cm, Sm, Am, Bm, frames, cin, cout,
      H, n_tiles);
  return cudaGetLastError();
}

}  // namespace

// C interface, loaded with ctypes.  Launches both kernels on `stream` and
// returns the first CUDA error code (0 = success); allocates nothing.
// hybrid != 0: a hybrid bank; per_stream != 0: taps (S, cin, cout, 4, NB).
// For a low-delay bank the caller passes its windows and the signed A/B.
extern "C" int saf_render_full_ri(const float* in_tail, const float* x,
                                  const float* ola_tail, const float* taps,
                                  const float* w_ana, const float* w_syn,
                                  const float* Cm, const float* Sm,
                                  const float* Am, const float* Bm,
                                  float* frames, float* y, float* new_tail,
                                  int n_streams, int cin, int cout, int H,
                                  int hybrid, int per_stream, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long taps_stride =
      per_stream ? (long long)cin * cout * 4 * NB : 0;
  const cudaError_t err =
      hybrid ? launch<true>(in_tail, x, taps, taps_stride, w_ana, Cm, Sm, Am,
                            Bm, frames, n_streams, cin, cout, H, st)
             : launch<false>(in_tail, x, taps, taps_stride, w_ana, Cm, Sm,
                             Am, Bm, frames, n_streams, cin, cout, H, st);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_overlap_add(frames, w_syn, ola_tail, y, new_tail,
                                 (long long)n_streams * cout, H, st);
}

extern "C" const char* saf_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
