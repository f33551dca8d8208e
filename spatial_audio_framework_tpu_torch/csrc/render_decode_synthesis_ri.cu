// Decode + afSTFT synthesis back end of the two-kernel TF-matrix renderer
// for Hopper (sm_90a): per-band decode with A/B taps summed over the input
// channels, irDFT, synthesis window, overlap-add and tail merge of a block
// of hops, for many streams at once.
//
// Replaces: the TPU kernels `_render_kernel` and `_render_dg_kernel`
//   (spatial_audio_framework_tpu/ops/pallas_afstft.py:414 and :561,
//   launched by `render_decode_synthesis_ri` through pl.pallas_call at :486
//   and by `render_decode_synthesis_dg_ri` at :629).  One kernel template,
//   the input form a template parameter, serves both entry points; the
//   plain PyTorch versions are `render_decode_synthesis_ri_reference` and
//   `render_decode_synthesis_dg_ri_reference` in
//   spatial_audio_framework_tpu_torch/ops/afstft_kernels.py.
//
// What it computes, per stream s and output hop h (hop = 128, 129 uniform
// bands), from one of three input forms:
//   * (d, g) pair (analysis_front_dg_ri.cu): d (S, cin, H, 129) and g
//     (S, cin, H, 16) as given;
//   * spectra of H + 6 hops (analysis_front_ri.cu), hybrid bank: d = s[h+3]
//     and g = c1 (s[h+6] - s[h]) + c2 (s[h+4] - s[h+2]);
//   * the same spectra, non-hybrid bank: d = s[h+6] and no g;
// then
//   1. per ear, summed over cin: A.d + B.(j g), the B taps on bands 0..15
//      only (decode_taps makes them zero above band 4); shared taps
//      (cin, cout, 4, 129) or per-stream taps (S, cin, cout, 4, 129), a
//      pointer offset per stream;
//   2. irDFT against A/B (129 x 256; for a low-delay bank the wrapper
//      passes them with the odd-bin sign folded in);
//   3. synthesis window, overlap-add over 10 hops, merge of the 9-hop tail
//      (`overlap_add`, a second light launch, as in render_full_ri.cu).
//
// What bounds it on the H100: at the ambi_bin order-7 slice (S = 64
// streams, cin = 64, cout = 2, H = 64) step 1 reads the (d, g) pair, 64 x
// 64 x 64 x (129 + 16) x 8 B = 304 MB per call, for 0.27 GFLOP of decode;
// the irDFT is 1.1 GFLOP.  Reading d and g from device memory bounds it:
// 0.09 ms at 3.35 TB/s.
//
// What the design does about it:
//   * one block per (stream, tile of 16 output hops), 256 blocks at the
//     order-7 shape, each thread owning one band and 8 hops: for every
//     channel a warp reads whole 129-float rows of d, coalesced over the
//     bands, with 8 x 2 independent loads per thread in flight;
//   * registers are capped for two blocks per SM (__launch_bounds__ 2:
//     96 registers, a few bytes spilled): on the H100 that took the (d, g)
//     form from 0.66 to 0.36 ms at the order-7 shape, where 168 registers
//     had left one block per SM and the loads too few to hide latency;
//   * the decode accumulates over cin in registers, per ear, with the same
//     device code as render_full_ri.cu (afstft_common.cuh), and only the
//     decoded tile (33 KB) goes to shared memory;
//   * the irDFT is the one of render_full_ri.cu: thread n computes sample n
//     of every (ear, hop) frame, every A/B value loaded feeds 32 FMAs;
//   * all arithmetic is fp32 FMA, no TF32, for every precision mode; the
//     sums differ from the plain version only in their order.
// Splitting cin across warps (more bytes in flight per block) and tensor-
// core irDFTs are later work.

#include <cuda_runtime.h>

#include "afstft_common.cuh"

namespace {

constexpr int TILE = 16;              // output hops per block
constexpr int GROUPS = 2;             // hop groups per band
constexpr int HPG = TILE / GROUPS;    // decoded hops per thread
constexpr int EC = 2;                 // ears per pass over the channels
constexpr int THREADS = 288;          // >= GROUPS * NB, whole warps

static_assert(TILE % GROUPS == 0, "even split");
static_assert(THREADS >= GROUPS * NB && THREADS >= FRAME, "threads");
static_assert(THREADS >= EC * TILE, "threads");

// the input forms
constexpr int FORM_DG = 0;            // (d, g) pair, H hops
constexpr int FORM_HYBRID = 1;        // spectra of H + 6 hops, hybrid bank
constexpr int FORM_PLAIN = 2;         // spectra of H + 6 hops, non-hybrid

// Launch (a): decode and irDFT of one (stream, hop tile).
template <int FORM>
__global__ void __launch_bounds__(THREADS, 2)
decode_irdft(const float* __restrict__ re,    // d or spectra, real part
             const float* __restrict__ im,    // d or spectra, imaginary part
             const float* __restrict__ g_re,  // FORM_DG: (S, cin, H, 16)
             const float* __restrict__ g_im,
             const float* __restrict__ taps,  // (cin, cout, 4, NB) per stream
             long long taps_stride,           // 0 for shared taps
             const float* __restrict__ Am,    // (NB_PAD, FRAME)
             const float* __restrict__ Bm,    // (NB_PAD, FRAME)
             float* __restrict__ frames,      // (S, cout, H, FRAME)
             int cin, int cout, int H, int n_tiles) {
  __shared__ __align__(16) float dec_s[EC * TILE * NB_PAD * 2];

  const int tid = threadIdx.x;
  const int s = blockIdx.x / n_tiles;
  const int h0 = (blockIdx.x % n_tiles) * TILE;
  const int k = tid % NB;             // band of this thread
  const int grp = tid / NB;           // hop group; >= GROUPS: idle
  const bool band_thread = grp < GROUPS;
  const bool hyb = FORM != FORM_PLAIN && k < G_BANDS;
  const int n_in = FORM == FORM_DG ? H : H + 6;    // hops per channel row
  const int d_off = FORM == FORM_DG ? 0 : (FORM == FORM_HYBRID ? 3 : 6);
  const float* tps = taps + s * taps_stride;

  for (int e0 = 0; e0 < cout; e0 += EC) {
    const int ne = min(EC, cout - e0);
    float acc_re[EC][HPG], acc_im[EC][HPG];
#pragma unroll
    for (int e = 0; e < EC; ++e)
#pragma unroll
      for (int hh = 0; hh < HPG; ++hh) acc_re[e][hh] = acc_im[e][hh] = 0.f;

    // 1. decode, summed over the channels: band k, hops grp*HPG + hh
    if (band_thread) {
      for (int c = 0; c < cin; ++c) {
        const BandTaps<EC> t = load_taps<EC>(
            tps + ((size_t)c * cout + e0) * 4 * NB + k, ne, hyb);
        const size_t row = (size_t)s * cin + c;
        const float* r = re + row * n_in * NB + k;
        const float* i = im + row * n_in * NB + k;
#pragma unroll
        for (int hh = 0; hh < HPG; ++hh) {
          const int h = h0 + grp * HPG + hh;
          if (h < H) {
            const float2 d = make_float2(__ldg(r + (h + d_off) * NB),
                                         __ldg(i + (h + d_off) * NB));
            float2 w = make_float2(0.f, 0.f);
            if (hyb) {
              float2 g;
              if (FORM == FORM_DG) {
                const size_t o = (row * H + h) * G_BANDS + k;
                g = make_float2(__ldg(g_re + o), __ldg(g_im + o));
              } else {
                g = hybrid_context(
                    make_float2(__ldg(r + h * NB), __ldg(i + h * NB)),
                    make_float2(__ldg(r + (h + 2) * NB),
                                __ldg(i + (h + 2) * NB)),
                    make_float2(__ldg(r + (h + 4) * NB),
                                __ldg(i + (h + 4) * NB)),
                    make_float2(__ldg(r + (h + 6) * NB),
                                __ldg(i + (h + 6) * NB)));
              }
              w = make_float2(-g.y, g.x);
            }
            decode_hop<EC, HPG>(t, d, w, acc_re, acc_im, hh);
          }
        }
      }
      store_decoded<EC, HPG, TILE>(dec_s, acc_re, acc_im, grp * HPG, k);
    }
    zero_pad_band<EC, TILE>(dec_s, tid);
    __syncthreads();

    // 2. irDFT: thread n computes sample n of every (ear, hop) frame
    irdft_tile<EC, TILE>(dec_s, Am, Bm,
                         frames + ((size_t)s * cout + e0) * H * FRAME, H, h0,
                         ne, tid);
    __syncthreads();  // dec_s is rewritten by the next ear pass
  }
}

template <int FORM>
cudaError_t launch(const float* re, const float* im, const float* g_re,
                   const float* g_im, const float* taps, int per_stream,
                   const float* Am, const float* Bm, const float* w_syn,
                   const float* ola_tail, float* frames, float* y,
                   float* new_tail, int n_streams, int cin, int cout, int H,
                   cudaStream_t st) {
  const int n_tiles = (H + TILE - 1) / TILE;
  const long long taps_stride =
      per_stream ? (long long)cin * cout * 4 * NB : 0;
  decode_irdft<FORM><<<n_streams * n_tiles, THREADS, 0, st>>>(
      re, im, g_re, g_im, taps, taps_stride, Am, Bm, frames, cin, cout, H,
      n_tiles);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_overlap_add(frames, w_syn, ola_tail, y, new_tail,
                            (long long)n_streams * cout, H, st);
}

}  // namespace

// C interface, loaded with ctypes.  Each launches both kernels on `stream`
// and returns the first CUDA error code (0 = success); allocates nothing.

// From the spectra of H + 6 hops (S, cin, H+6, NB); hybrid != 0: d at hop
// offset 3 with the hybrid context, else d at offset 6 and no context.
extern "C" int saf_render_decode_synthesis_ri(
    const float* sre, const float* sim, const float* taps, const float* Am,
    const float* Bm, const float* w_syn, const float* ola_tail, float* frames,
    float* y, float* new_tail, int n_streams, int cin, int cout, int H,
    int hybrid, int per_stream, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hybrid)
    return (int)launch<FORM_HYBRID>(sre, sim, nullptr, nullptr, taps,
                                    per_stream, Am, Bm, w_syn, ola_tail,
                                    frames, y, new_tail, n_streams, cin, cout,
                                    H, st);
  return (int)launch<FORM_PLAIN>(sre, sim, nullptr, nullptr, taps, per_stream,
                                 Am, Bm, w_syn, ola_tail, frames, y, new_tail,
                                 n_streams, cin, cout, H, st);
}

// From the (d, g) pair: d (S, cin, H, NB), g (S, cin, H, G_BANDS).
extern "C" int saf_render_decode_synthesis_dg_ri(
    const float* dre, const float* dim, const float* gre, const float* gim,
    const float* taps, const float* Am, const float* Bm, const float* w_syn,
    const float* ola_tail, float* frames, float* y, float* new_tail,
    int n_streams, int cin, int cout, int H, int per_stream, void* stream) {
  return (int)launch<FORM_DG>(dre, dim, gre, gim, taps, per_stream, Am, Bm,
                              w_syn, ola_tail, frames, y, new_tail, n_streams,
                              cin, cout, H, static_cast<cudaStream_t>(stream));
}
