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
//   2. the odd-bin sign of a low-delay bank, then the irDFT (129 bins ->
//      256 samples);
//   3. synthesis window, overlap-add over 10 hops, merge of the 9-hop tail
//      (`overlap_add`, a second light launch, as in render_full_ri.cu).
//
// What bounds it on the H100: bytes.  At the ambi_bin order-7 slice (S = 64
// streams, cin = 64, cout = 2, H = 64) step 1 reads the (d, g) pair, 64 x
// 64 x 64 x (129 + 16) x 8 B = 304 MB per call, for 0.5 GFLOP of decode and
// 0.04 GFLOP of irDFTs as FFTs: 0.09 ms at 3.35 TB/s.  What it must do is
// keep loads in flight on every SM from a block's first cycle to its last,
// and read the inputs from device memory once whatever the number of ears.
//
// What the design does about it:
//   * the hops of a tile are one contiguous span per (stream, channel) and
//     array (16 x 129 floats of d.re, the same of d.im, 16 x 16 of each g,
//     and the channel's taps for every ear of the pass); each span goes by
//     cp.async into a ring of shared-memory stages, so the next channel
//     arrives while this one is decoded and no thread waits on a load it
//     started itself.  Two stages and four 8-warp blocks an SM were fastest
//     (64 registers a thread); three or four stages with two blocks an SM
//     and six with one were slower: while a block sums, transforms and
//     stores it loads nothing, and only other blocks on the SM cover that.
//     A span starts at (row H + h0) 129 floats, 16-byte aligned only where
//     row H + h0 is a multiple of 4: load_span_async keeps the span's place
//     within its 16-byte word in shared memory, so all but its first and
//     last few floats go as 16-byte copies at any H, row and pointer;
//   * cin is split over a thread-block cluster per (stream, tile of 16
//     hops): rank q decodes channels q, q + cs, ..., and the ranks' decoded
//     tiles are summed through distributed shared memory in rank order 0,
//     1, ..., so the result does not depend on scheduling.  A cluster
//     rather than warps of one block: it multiplies the blocks, and so the
//     rings, that a few tiles put on the card.  The cluster is the largest
//     power of two (up to 8 and cin) that keeps the whole grid resident at
//     once: 2 at the order-7 shape (512 blocks for 528 places), where 1, 4
//     and 8 were 7 to 10 % slower, 8 for a single stream;
//   * a thread owns one band and 8 hops (4 above two ears) and keeps the
//     accumulators of every ear of the pass in registers, one chain of FMAs
//     each: up to 8 ears are decoded from one load of a channel's stage
//     (above 4, in two passes over the stage, not over device memory); only
//     calls with more than 8 ears read their inputs again, once per 8 ears.
//     Only the warps that hold bands 0..15 spend instructions on the B taps;
//   * the spectra forms read their context from the stage: the hybrid form
//     stages 16 + 6 hops, the non-hybrid form 16 (d = s[h+6] alone);
//   * each rank then transforms its share of the (ear, hop) frames with
//     irdft256 (afstft_common.cuh: one warp a frame, bins l + 32 r in lane
//     l register r, the low-delay sign applied to the summed bins): no A/B
//     reads, 5 k FLOP a frame;
//   * tiles stay independent: frames go to an (S, cout, H, 256) buffer (5 %
//     more bytes, mostly L2-resident) and `overlap_add` runs second.  A
//     cluster that walked a stream's tiles in order and carried the
//     overlap-add in registers was 30 to 60 % slower: it leaves S x cs
//     blocks, each with three cluster barriers a tile;
//   * per-stream taps ride the same ring, so each of a stream's hop tiles
//     reads that stream's taps once: ceil(H / 16) reads per call, all but
//     the first from L2 when the set fits it;
//   * all arithmetic is fp32 FMA, no TF32, for every precision mode; the
//     sums differ from the plain version only in their order.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "afstft_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int TILE = 16;              // output hops per cluster
constexpr int MAX_EARS = 8;           // ears per pass over device memory

// the input forms
constexpr int FORM_DG = 0;            // (d, g) pair, H hops
constexpr int FORM_HYBRID = 1;        // spectra of H + 6 hops, hybrid bank
constexpr int FORM_PLAIN = 2;         // spectra of H + 6 hops, non-hybrid

constexpr int MAX_CLUSTER = 8;        // the portable limit

// Block shape and shared-memory carve-up (floats) of one instantiation: EC
// ears a pass.
template <int FORM, int EC>
struct Cfg {
  static constexpr int HPG = EC <= 2 ? 8 : 4;     // hops per band thread
  static constexpr int MB = EC <= 2 ? 4 : 1;      // blocks an SM
  static constexpr int GROUPS = TILE / HPG;       // hop groups per band
  static constexpr int THREADS = GROUPS * HOP;    // a thread per (band < 128,
  static constexpr int WARPS = THREADS / 32;      // group)
  static constexpr int EB = EC < 4 ? EC : 4;      // ears whose taps a thread
                                                  // holds at once
  static constexpr int NSTAGE = EC <= 2 ? 2 : 3;  // ring stages
  static constexpr int HOPS_IN = FORM == FORM_HYBRID ? TILE + 6 : TILE;
  static constexpr int SM_D = span_room(HOPS_IN * NB);
  static constexpr int SM_G = FORM == FORM_DG ? span_room(TILE * G_BANDS) : 0;
  static constexpr int SM_TAPS = span_room(EC * 4 * NB);
  static constexpr int SM_STAGE = 2 * SM_D + 2 * SM_G + SM_TAPS;
  // the decoded tile reuses the ring once the channel loop is over
  static constexpr int SM_OUT = EC * TILE * NB_PAD * 2;
  static constexpr int SM_MAIN =
      NSTAGE * SM_STAGE > SM_OUT ? NSTAGE * SM_STAGE : SM_OUT;
  static constexpr int SM_FLOATS = SM_MAIN + 2 * FFT_TW;
  static_assert(EC * TILE <= THREADS, "a thread per Nyquist accumulator");
  static_assert(SM_FLOATS * 4 <= 232448, "fits an SM");
};

// One channel's stage decoded into a thread's accumulators: band k, hops
// hop0 .. hop0+HPG-1 (those below nh), ears < ne, EB ears at a time.  CTX:
// the thread's warp holds bands 0..15, which carry the hybrid context
// (`hyb`: this thread's band does); other warps skip the B taps altogether.
// Each accumulator is one chain of FMAs in channel order.
template <int FORM, int EC, int HPG, int EB, bool CTX>
__device__ __forceinline__ void decode_stage(
    const float* dre, const float* dim, const float* gre, const float* gim,
    const float* tp, int k, int hop0, int nh, int ne, bool hyb,
    float (&acc_re)[EC][HPG], float (&acc_im)[EC][HPG]) {
  constexpr int D_OFF = FORM == FORM_HYBRID ? 3 : 0;  // d's hop in the stage
#pragma unroll
  for (int eb = 0; eb < EC; eb += EB) {
    if (eb >= ne) break;
    BandTaps<EB> tb;
#pragma unroll
    for (int e = 0; e < EB; ++e) {
      const bool on = eb + e < ne;
      const float* te = tp + (eb + e) * 4 * NB + k;
      tb.are[e] = on ? te[0] : 0.f;
      tb.aim[e] = on ? te[NB] : 0.f;
      tb.bre[e] = (CTX && on && hyb) ? te[2 * NB] : 0.f;
      tb.bim[e] = (CTX && on && hyb) ? te[3 * NB] : 0.f;
    }
#pragma unroll
    for (int hh = 0; hh < HPG; ++hh) {
      const int h = hop0 + hh;
      if (h >= nh) break;
      const float2 d = make_float2(dre[(h + D_OFF) * NB + k],
                                   dim[(h + D_OFF) * NB + k]);
      float2 wv = make_float2(0.f, 0.f);  // j g
      if (CTX && hyb) {
        float2 g;
        if (FORM == FORM_DG)
          g = make_float2(gre[h * G_BANDS + k], gim[h * G_BANDS + k]);
        else
          g = hybrid_context(
              make_float2(dre[h * NB + k], dim[h * NB + k]),
              make_float2(dre[(h + 2) * NB + k], dim[(h + 2) * NB + k]),
              make_float2(dre[(h + 4) * NB + k], dim[(h + 4) * NB + k]),
              make_float2(dre[(h + 6) * NB + k], dim[(h + 6) * NB + k]));
        wv = make_float2(-g.y, g.x);
      }
#pragma unroll
      for (int e = 0; e < EB; ++e) {
        float r = acc_re[eb + e][hh], i = acc_im[eb + e][hh];
        r = fmaf(tb.are[e], d.x, r);
        r = fmaf(-tb.aim[e], d.y, r);
        i = fmaf(tb.are[e], d.y, i);
        i = fmaf(tb.aim[e], d.x, i);
        if (CTX) {
          r = fmaf(tb.bre[e], wv.x, r);
          r = fmaf(-tb.bim[e], wv.y, r);
          i = fmaf(tb.bre[e], wv.y, i);
          i = fmaf(tb.bim[e], wv.x, i);
        }
        acc_re[eb + e][hh] = r;
        acc_im[eb + e][hh] = i;
      }
    }
  }
}

// First launch: decode and irDFT of one (stream, hop tile) by a cluster.
template <int FORM, int EC>
__global__ void __launch_bounds__(Cfg<FORM, EC>::THREADS, Cfg<FORM, EC>::MB)
decode_irdft(const float* __restrict__ re,    // d or spectra, real part
             const float* __restrict__ im,    // d or spectra, imaginary part
             const float* __restrict__ g_re,  // FORM_DG: (S, cin, H, 16)
             const float* __restrict__ g_im,
             const float* __restrict__ taps,  // (cin, cout, 4, NB) per stream
             long long taps_stride,           // 0 for shared taps
             const float2* __restrict__ tw_g, // (FFT_TW)
             float* __restrict__ frames,      // (S, cout, H, FRAME)
             int cin, int cout, int H, int n_tiles, int low_delay) {
  using C = Cfg<FORM, EC>;
  constexpr int HPG = C::HPG, EB = C::EB, NSTAGE = C::NSTAGE;
  extern __shared__ float4 smem4[];
  float* ring = reinterpret_cast<float*>(smem4);
  float* out_s = ring;                               // after the channels
  float2* tw = reinterpret_cast<float2*>(ring + C::SM_MAIN);

  cg::cluster_group cluster = cg::this_cluster();
  const int cs = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tile = blockIdx.x / cs;
  const int s = tile / n_tiles;
  const int h0 = (tile % n_tiles) * TILE;
  const int nh = min(TILE, H - h0);
  // the hops of a channel row the stage holds: [in0, in0 + n_ld)
  const int in0 = h0 + (FORM == FORM_PLAIN ? 6 : 0);
  const int n_ld = nh + (FORM == FORM_HYBRID ? 6 : 0);
  const int n_in = FORM == FORM_DG ? H : H + 6;    // hops per channel row
  const int k = tid % HOP;            // band of this thread
  const int grp = tid / HOP;          // its hop group
  const bool hyb = FORM != FORM_PLAIN && k < G_BANDS;
  // the warps that hold bands 0..15 decode the hybrid context too
  const bool ctx_warp = FORM != FORM_PLAIN && k < 32;
  const float* tps = taps + s * taps_stride;
  const int n_ch = (cin - rank + cs - 1) / cs;     // this rank's channels

  for (int i = tid; i < FFT_TW; i += C::THREADS) tw[i] = tw_g[i];

  for (int e0 = 0; e0 < cout; e0 += EC) {
    const int ne = min(EC, cout - e0);
    // the spans of channel c in device memory
    auto src_d = [&](const float* base, int c) {
      return base + (((size_t)s * cin + c) * n_in + in0) * NB;
    };
    auto src_g = [&](const float* base, int c) {
      return base + (((size_t)s * cin + c) * H + h0) * G_BANDS;
    };
    auto src_taps = [&](int c) {
      return tps + ((size_t)c * cout + e0) * 4 * NB;
    };
    auto load = [&](int c, int stage) {
      float* st = ring + stage * C::SM_STAGE;
      load_span_async(st, src_d(re, c), n_ld * NB, tid, C::THREADS);
      load_span_async(st + C::SM_D, src_d(im, c), n_ld * NB, tid, C::THREADS);
      if (FORM == FORM_DG) {
        load_span_async(st + 2 * C::SM_D, src_g(g_re, c), nh * G_BANDS, tid,
                        C::THREADS);
        load_span_async(st + 2 * C::SM_D + C::SM_G, src_g(g_im, c),
                        nh * G_BANDS, tid, C::THREADS);
      }
      load_span_async(st + 2 * C::SM_D + 2 * C::SM_G, src_taps(c),
                      ne * 4 * NB, tid, C::THREADS);
    };

    float acc_re[EC][HPG], acc_im[EC][HPG];
#pragma unroll
    for (int e = 0; e < EC; ++e)
#pragma unroll
      for (int hh = 0; hh < HPG; ++hh) acc_re[e][hh] = acc_im[e][hh] = 0.f;
    float2 nyq_acc = make_float2(0.f, 0.f);  // tid < EC * TILE: band 128

    // 1. decode, summed over this rank's channels rank, rank + cs, ...:
    //    NSTAGE - 1 channels in flight ahead of the one decoded
    for (int p = 0; p < NSTAGE - 1; ++p) {
      if (p < n_ch) load(rank + p * cs, p);
      cp_async_commit();
    }
    for (int it = 0; it < n_ch; ++it) {
      cp_async_wait<NSTAGE - 2>();
      __syncthreads();  // channel it has landed; stage it - 1 is free
      if (it + NSTAGE - 1 < n_ch)
        load(rank + (it + NSTAGE - 1) * cs, (it + NSTAGE - 1) % NSTAGE);
      cp_async_commit();

      const int c = rank + it * cs;
      const float* st = ring + (it % NSTAGE) * C::SM_STAGE;
      const float* dre = st + span_offset(src_d(re, c));
      const float* dim = st + C::SM_D + span_offset(src_d(im, c));
      const float* gre = st + 2 * C::SM_D;
      const float* gim = gre + C::SM_G;
      if (FORM == FORM_DG) {
        gre += span_offset(src_g(g_re, c));
        gim += span_offset(src_g(g_im, c));
      }
      const float* tp =
          st + 2 * C::SM_D + 2 * C::SM_G + span_offset(src_taps(c));

      if (ctx_warp)
        decode_stage<FORM, EC, HPG, EB, true>(dre, dim, gre, gim, tp, k,
                                              grp * HPG, nh, ne, hyb, acc_re,
                                              acc_im);
      else
        decode_stage<FORM, EC, HPG, EB, false>(dre, dim, gre, gim, tp, k,
                                               grp * HPG, nh, ne, false,
                                               acc_re, acc_im);
      //    and the Nyquist band, one (ear, hop) a thread (A taps only)
      if (tid < EC * TILE) {
        const int e = tid / TILE, h = tid % TILE;
        if (e < ne && h < nh) {
          constexpr int D_OFF = FORM == FORM_HYBRID ? 3 : 0;
          const float are = tp[(e * 4 + 0) * NB + HOP];
          const float aim = tp[(e * 4 + 1) * NB + HOP];
          const float2 d = make_float2(dre[(h + D_OFF) * NB + HOP],
                                       dim[(h + D_OFF) * NB + HOP]);
          nyq_acc.x = fmaf(-aim, d.y, fmaf(are, d.x, nyq_acc.x));
          nyq_acc.y = fmaf(aim, d.x, fmaf(are, d.y, nyq_acc.y));
        }
      }
    }
    cp_async_wait<0>();
    __syncthreads();  // the ring is read; out_s reuses it

    // 2. this rank's decoded tile to shared memory as (re, im) pairs
    store_decoded<EC, HPG, TILE>(out_s, acc_re, acc_im, grp * HPG, k);
    if (tid < EC * TILE) {
      out_s[(tid * NB_PAD + HOP) * 2 + 0] = nyq_acc.x;
      out_s[(tid * NB_PAD + HOP) * 2 + 1] = nyq_acc.y;
    }
    cluster.sync();

    // 3. irDFT of this rank's (ear, hop) frames, their spectra summed over
    //    the cluster's ranks in rank order
    for (int f = rank + cs * warp; f < EC * TILE; f += cs * C::WARPS) {
      const int e = f / TILE, hh = f % TILE;
      if (e >= ne || hh >= nh) continue;  // warp-uniform
      float2 v[4] = {};
      float nyq = 0.f;
      for (int q = 0; q < cs; ++q) {
        const float* o = cluster.map_shared_rank(out_s, q) + f * NB_PAD * 2;
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float2 u =
              *reinterpret_cast<const float2*>(o + 2 * (lane + 32 * r));
          v[r] = make_float2(v[r].x + u.x, v[r].y + u.y);
        }
        nyq += o[2 * HOP];
      }
      if (low_delay && (lane & 1)) {  // (-1)^k on the odd bins
#pragma unroll
        for (int r = 0; r < 4; ++r) v[r] = make_float2(-v[r].x, -v[r].y);
      }
      irdft256(v, nyq, tw, lane);
      float* fo = frames + (((size_t)s * cout + e0 + e) * H + h0 + hh) * FRAME;
#pragma unroll
      for (int r = 0; r < 4; ++r)
        *reinterpret_cast<float2*>(fo + 2 * fft_in_index(lane, r)) = v[r];
    }
    cluster.sync();  // every rank has read out_s before it is rewritten
  }
}

template <int FORM, int EC>
cudaError_t launch_decode(const float* re, const float* im, const float* g_re,
                          const float* g_im, const float* taps,
                          long long taps_stride, const float* tw,
                          float* frames, int n_streams, int cin, int cout,
                          int H, int low_delay, cudaStream_t st) {
  using C = Cfg<FORM, EC>;
  const int n_tiles = (H + TILE - 1) / TILE;
  int dev = 0, n_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  // the largest cluster that keeps the grid resident at once
  const long long places = (long long)n_sm * C::MB;
  int cs = 1;
  while (2 * cs <= MAX_CLUSTER && 2 * cs <= cin &&
         2LL * cs * n_streams * n_tiles <= places)
    cs *= 2;
  const int smem = C::SM_FLOATS * (int)sizeof(float);
  err = cudaFuncSetAttribute(decode_irdft<FORM, EC>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(n_streams * n_tiles * cs));
  cfg.blockDim = dim3(C::THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, decode_irdft<FORM, EC>, re, im, g_re,
                            g_im, taps, taps_stride,
                            reinterpret_cast<const float2*>(tw), frames, cin,
                            cout, H, n_tiles, low_delay);
}

// Both launches: the decode + irDFT with the fewest ears a pass that hold
// the call's (2, 4 or 8), then the overlap-add.
template <int FORM>
cudaError_t launch(const float* re, const float* im, const float* g_re,
                   const float* g_im, const float* taps, int per_stream,
                   const float* tw, const float* w_syn, const float* ola_tail,
                   float* frames, float* y, float* new_tail, int n_streams,
                   int cin, int cout, int H, int low_delay, cudaStream_t st) {
  if (n_streams < 1 || cin < 1 || cout < 1 || H < 1)
    return cudaErrorInvalidValue;
  const long long taps_stride =
      per_stream ? (long long)cin * cout * 4 * NB : 0;
#define SAF_DECODE(EC)                                                    \
  launch_decode<FORM, EC>(re, im, g_re, g_im, taps, taps_stride, tw, frames, \
                          n_streams, cin, cout, H, low_delay, st)
  const cudaError_t err = cout <= 2   ? SAF_DECODE(2)
                          : cout <= 4 ? SAF_DECODE(4)
                                      : SAF_DECODE(MAX_EARS);
#undef SAF_DECODE
  if (err != cudaSuccess) return err;
  return launch_overlap_add(frames, w_syn, ola_tail, y, new_tail,
                            (long long)n_streams * cout, H, st);
}

}  // namespace

// C interface, loaded with ctypes.  Each launches both kernels on `stream`
// and returns the first CUDA error code (0 = success; a refused cluster
// launch returns its code); allocates nothing.  per_stream != 0: taps (S,
// cin, cout, 4, NB); low_delay != 0: the odd-bin sign before the irDFT (the
// caller passes the low-delay synthesis window).  tw: the FFT twiddle table
// W256^k, (256, 2) float32.

// From the spectra of H + 6 hops (S, cin, H+6, NB); hybrid != 0: d at hop
// offset 3 with the hybrid context, else d at offset 6 and no context.
extern "C" int saf_render_decode_synthesis_ri(
    const float* sre, const float* sim, const float* taps, const float* tw,
    const float* w_syn, const float* ola_tail, float* frames, float* y,
    float* new_tail, int n_streams, int cin, int cout, int H, int hybrid,
    int per_stream, int low_delay, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hybrid)
    return (int)launch<FORM_HYBRID>(sre, sim, nullptr, nullptr, taps,
                                    per_stream, tw, w_syn, ola_tail, frames,
                                    y, new_tail, n_streams, cin, cout, H,
                                    low_delay, st);
  return (int)launch<FORM_PLAIN>(sre, sim, nullptr, nullptr, taps, per_stream,
                                 tw, w_syn, ola_tail, frames, y, new_tail,
                                 n_streams, cin, cout, H, low_delay, st);
}

// From the (d, g) pair: d (S, cin, H, NB), g (S, cin, H, G_BANDS).
extern "C" int saf_render_decode_synthesis_dg_ri(
    const float* dre, const float* dim, const float* gre, const float* gim,
    const float* taps, const float* tw, const float* w_syn,
    const float* ola_tail, float* frames, float* y, float* new_tail,
    int n_streams, int cin, int cout, int H, int per_stream, int low_delay,
    void* stream) {
  return (int)launch<FORM_DG>(dre, dim, gre, gim, taps, per_stream, tw, w_syn,
                              ola_tail, frames, y, new_tail, n_streams, cin,
                              cout, H, low_delay,
                              static_cast<cudaStream_t>(stream));
}
