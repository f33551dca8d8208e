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
//   2. rDFT of each frame (256 points -> 129 bins);
//   3. hybrid banks: direct taps d = s[h+3] and hybrid context
//      g = c1(s[h+6]-s[h]) + c2(s[h+4]-s[h+2]) on bands 0..15 only;
//      non-hybrid banks: d = s[h+6] and no context (a template parameter);
//   4. per ear, summed over cin: A.d + B.(j g), j g = (-g_im, g_re), with
//      shared taps (cin, cout, 4, 129) or per-stream taps (S, cin, cout, 4,
//      129), a pointer offset per stream;
//   5. irDFT (129 bins -> 256 samples), with the odd-bin sign of a
//      low-delay bank (as `_render_full_ri` folds it into A/B,
//      pallas_afstft.py:756-761);
//   6. synthesis window, overlap-add over 10 hops, merge of the 9-hop tail.
// A low-delay bank also changes the windows, which the wrapper passes.
//
// What bounds it on the H100: HBM would bound it at 0.014 ms at the
// flagship shape (S = 64 streams, cin = 16, cout = 2, H = 64: 41.5 MB read,
// 4.8 MB written; 0.22 ms at 1024 streams), but the SM's shared-memory and
// shuffle pipe sets its time.  A frame folded and transformed alone takes
// ~53 8-byte shared loads a lane (20 hop pairs, 20 window pairs, 13
// twiddles), 5 stores and 32 shuffles: ~150 cycles of that pipe against
// ~60 of FP32 work.  Timed in parts on the card (throwaway variants, both
// launches, 1024 streams, H = 64): the hop loads with overlap_add 0.41 ms,
// the frame stage 0.81 ms more, the decode and irDFTs 0.32 ms more, 1.58 ms
// in all; at H = 8 0.14 + 0.45 + 0.15 = 0.73 ms, when a 32-hop tile spent
// 63 % of its frames and 75 % of its decode on hops past the block.  (The
// dense C/S and A/B products of the first design cost 9.5 GFLOP a chunk.)
//
// What the design does about it:
//   * the tile follows H, which the C entry reads: 32 output hops (two
//     8-warp blocks an SM, 128 registers, 96 KB of shared memory each), or
//     8 for blocks of at most 8 hops, the runtime's frame (three blocks an
//     SM, 80 registers, 46 KB).  A tile folds only the
//     nf = min(TILE, H - h0) + 6 frames its hops need, loads their nf + 9
//     input hops and decodes its min(TILE, H - h0) output hops;
//   * a thread-block cluster of cs = min(4, cin) blocks per (stream, tile)
//     splits the cin channels (block rank q takes channels q, q + cs, ...);
//   * per channel, warp w folds and transforms a run of the frames of
//     parity w & 1 in registers, in chains of CHAIN frames j, j + 2
//     (fold_chain, rdft256_chain, afstft_common.cuh: no C/S reads): a
//     chain reads each of its hop rows, window pairs and FFT stage twiddles
//     once for both frames, ~31 shared loads a frame where one frame alone
//     takes 53 (chains of three spill at 128 registers).  The spectra go to
//     shared memory while the next channel's hops arrive by cp.async, a hop
//     a warp; a thread per (band, hop group) then decodes them into per-ear
//     accumulators in registers (the Nyquist band's in shared memory);
//   * the blocks of a cluster sum their decoded spectra through
//     distributed shared memory in rank order 0, 1, ..., so the result does
//     not depend on scheduling, and split the irDFTs of the (ear, hop)
//     frames between them (irdft256: no A/B reads); only those frames
//     (S, cout, H, 256) go to a scratch buffer that is mostly L2-resident;
//   * all arithmetic is fp32 FMA, no TF32, for every precision mode
//     (ops/precision.py); the sums differ from the plain version only in
//     their order.
// A second, light launch does step 6, one thread per output sample
// (`overlap_add`).  It, the hop load, the fold, the FFTs and the decode are
// shared with the other kernels through afstft_common.cuh.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "afstft_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int TAIL_HOPS = 15;         // carried input hops (9 + 6)
constexpr int HS = HOP + 4;           // hop stride in shared memory
constexpr int GROUPS = 2;             // hop groups per band
constexpr int EC = 2;                 // ears per pass over the channels
constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int MAX_CLUSTER = 4;
constexpr int CHAIN = 2;              // frames a warp folds and transforms
                                      // at once (fold_chain, rdft256_chain)
constexpr int LONG_TILE = 32;         // output hops per cluster, and for
constexpr int SHORT_TILE = 8;         // blocks of at most 8 hops

static_assert(THREADS == GROUPS * HOP, "a thread per (band < 128, group)");

// A tile of TILE output hops: its frames, and the shared memory carve-up
// in floats (each part a multiple of 4).  The decoded spectra of the block
// (EC x TILE rows of NB_PAD bins) reuse the hop buffers and the spectrum
// once the channel loop is over; the decode of the Nyquist band (128)
// accumulates in shared memory.  Long tiles: 16 warps an SM, 4 per
// scheduler, so 128 registers a thread; short tiles hold a quarter of the
// decode's accumulators and run 24 warps an SM (80 registers).
template <int TILE>
struct Tile {
  static constexpr int NF = TILE + 6;            // frames (6-hop context)
  static constexpr int NHOPS_IN = NF + NT;       // input hops they span
  static constexpr int HPG = TILE / GROUPS;      // decoded hops a thread
  static constexpr int BLOCKS = TILE == LONG_TILE ? 2 : 3;  // an SM
  static constexpr int SM_HOPS = NHOPS_IN * HS;  // one hop buffer
  static constexpr int SM_SPEC = NF * NB * 2;
  static constexpr int SM_WIN = TOTAL_HOPS * HS;
  static constexpr int SM_TW = 2 * FFT_TW;
  static constexpr int SM_NYQ = EC * TILE * 2;
  static constexpr int SM_OUT = EC * TILE * NB_PAD * 2;
  static constexpr int SM_FLOATS =
      2 * SM_HOPS + SM_SPEC + SM_WIN + SM_TW + SM_NYQ;
  static_assert(TILE % GROUPS == 0, "even split");
  static_assert(THREADS >= EC * TILE, "a thread per Nyquist accumulator");
  static_assert(SM_HOPS % 4 == 0 && SM_SPEC % 4 == 0 && SM_WIN % 4 == 0 &&
                SM_TW % 4 == 0 && SM_NYQ % 4 == 0, "16-byte aligned parts");
  static_assert(SM_OUT <= 2 * SM_HOPS + SM_SPEC, "decoded spectra fit");
  static_assert(SM_FLOATS * 4 <= 232448 / BLOCKS, "the blocks fit an SM");
};

// Frames j, j + 2, ..., j + 2(n - 1) (n <= K) of one channel: fold_chain,
// rdft256_chain, and each frame's 129 bins to its spectrum row.
template <int K>
__device__ __forceinline__ void frame_chain(int n, int j, const float* hops,
                                            const float* win_s,
                                            const float2* tw, float2* spec_s,
                                            int lane) {
  if (n == K) {
    float2 v[K][4];
    fold_chain<K>(v, hops, HS, j, lane, [&](int m, int r) {
      return window_pair(win_s, HS, lane, m, r);
    });
    rdft256_chain<K>(v, tw, lane, [&](int c, const float2(&x)[4], float nyq) {
      float2* row = spec_s + (j + 2 * c) * NB;
#pragma unroll
      for (int r = 0; r < 4; ++r) row[lane + 32 * r] = x[r];
      if (lane == 0) row[HOP] = make_float2(nyq, 0.f);
    });
  } else if constexpr (K > 1) {
    frame_chain<K - 1>(n, j, hops, win_s, tw, spec_s, lane);
  }
}

// Launch (a): analysis, decode and irDFT of one (stream, tile of TILE hops)
// by a cluster.  HYBRID: d at hop offset 3 with the hybrid context, else d
// at offset 6.
template <bool HYBRID, int TILE>
__global__ void __launch_bounds__(THREADS, Tile<TILE>::BLOCKS)
analysis_decode_irdft(const float* __restrict__ in_tail,  // (S, cin, 15*HOP)
                      const float* __restrict__ x,        // (S, cin, H*HOP)
                      const float* __restrict__ taps,     // (cin, cout, 4, NB)
                                                          // per stream
                      long long taps_stride,              // 0: shared taps
                      const float* __restrict__ w_ana,    // (10*HOP)
                      const float2* __restrict__ tw_g,    // (FFT_TW)
                      float* __restrict__ frames,         // (S, cout, H, FRAME)
                      int cin, int cout, int H, int n_tiles, int low_delay) {
  using P = Tile<TILE>;
  extern __shared__ float4 smem4[];
  float* hop_s = reinterpret_cast<float*>(smem4);      // 2 buffers
  float2* spec_s = reinterpret_cast<float2*>(hop_s + 2 * P::SM_HOPS);
  float* win_s = hop_s + 2 * P::SM_HOPS + P::SM_SPEC;
  float2* tw = reinterpret_cast<float2*>(win_s + P::SM_WIN);
  float2* nyq_s = tw + FFT_TW;                         // (EC, TILE)
  float* out_s = hop_s;                                // after the channels

  cg::cluster_group cluster = cg::this_cluster();
  const int cs = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tile = blockIdx.x / cs;
  const int s = tile / n_tiles;
  const int h0 = (tile % n_tiles) * TILE;
  const int nf = min(P::NF, H - h0 + 6);  // the frames this tile needs
  const int nh = min(TILE, H - h0);       // and its output hops
  const int k = tid % HOP;            // band of this thread
  const int grp = tid / HOP;          // its hop group
  const bool hyb = HYBRID && k < G_BANDS;
  constexpr int D_OFF = HYBRID ? 3 : 6;
  const float* tps = taps + s * taps_stride;

  for (int i = tid; i < TOTAL_HOPS * HOP; i += THREADS)
    win_s[(i / HOP) * HS + i % HOP] = w_ana[i];
  for (int i = tid; i < FFT_TW; i += THREADS) tw[i] = tw_g[i];

  // the nf + 9 input hops of channel c into hop buffer buf: a hop a warp,
  // 16 bytes a lane, so no thread holds its copies' offsets across the
  // kernel (they cost registers the frame stage needs)
  auto load = [&](int c, int buf) {
    const size_t row = (size_t)s * cin + c;
    for (int q = warp; q < nf + NT; q += WARPS)
      load_hops_async(hop_s + buf * P::SM_HOPS + q * HS, HS,
                      in_tail + row * (TAIL_HOPS * HOP), TAIL_HOPS,
                      x + row * ((size_t)H * HOP), H, h0 + q, 1, lane, 32);
  };

  for (int e0 = 0; e0 < cout; e0 += EC) {
    const int ne = min(EC, cout - e0);
    float acc_re[EC][P::HPG], acc_im[EC][P::HPG];
#pragma unroll
    for (int e = 0; e < EC; ++e)
#pragma unroll
      for (int hh = 0; hh < P::HPG; ++hh) acc_re[e][hh] = acc_im[e][hh] = 0.f;
    if (tid < EC * TILE) nyq_s[tid] = make_float2(0.f, 0.f);

    // this block's channels rank, rank + cs, ... (cs <= cin: at least one)
    load(rank, 0);
    cp_async_commit();
    int it = 0;
    for (int c = rank; c < cin; c += cs, ++it) {
      // 1. start the next channel's hops, wait for this channel's
      if (c + cs < cin) load(c + cs, (it + 1) & 1);
      cp_async_commit();
      cp_async_wait<1>();
      __syncthreads();
      const float* hops = hop_s + (it & 1) * P::SM_HOPS;

      // 2. the nf frames: warp w takes a run of the frames of parity w & 1,
      //    the runs as equal as they come, in chains of CHAIN frames
      {
        const int par = warp & 1, runs = WARPS / 2, u = warp >> 1;
        const int n = (nf + 1 - par) / 2;  // frames of this parity
        const int q1 = (u + 1) * n / runs;
        for (int q = u * n / runs; q < q1; q += CHAIN)
          frame_chain<CHAIN>(min(CHAIN, q1 - q), 2 * q + par, hops, win_s,
                             tw, spec_s, lane);
      }
      __syncthreads();

      // 3. decode this channel into hops grp*HPG .. grp*HPG+HPG-1 (those
      //    below nh), band k
      const float* tc = tps + ((size_t)c * cout + e0) * 4 * NB;
      const BandTaps<EC> t = load_taps<EC>(tc + k, ne, hyb);
#pragma unroll
      for (int hh = 0; hh < P::HPG; ++hh) {
        const int h = grp * P::HPG + hh;
        if (h >= nh) break;
        const float2 d = spec_s[(h + D_OFF) * NB + k];
        float2 w = make_float2(0.f, 0.f);
        if (hyb) {
          const float2 g = hybrid_context(
              spec_s[h * NB + k], spec_s[(h + 2) * NB + k],
              spec_s[(h + 4) * NB + k], spec_s[(h + 6) * NB + k]);
          w = make_float2(-g.y, g.x);
        }
        decode_hop<EC, P::HPG>(t, d, w, acc_re, acc_im, hh);
      }
      //    and the Nyquist band, one (ear, hop) a thread (A taps only)
      if (tid < EC * TILE && tid % TILE < nh) {
        const int e = tid / TILE, h = tid % TILE;
        const BandTaps<1> tn = load_taps<1>(tc + 4 * e * NB + HOP,
                                            e < ne ? 1 : 0, false);
        const float2 d = spec_s[(h + D_OFF) * NB + HOP];
        float2 a = nyq_s[tid];
        a.x += tn.are[0] * d.x - tn.aim[0] * d.y;
        a.y += tn.are[0] * d.y + tn.aim[0] * d.x;
        nyq_s[tid] = a;
      }
    }
    cp_async_wait<0>();
    __syncthreads();  // the spectrum is read; out_s reuses it

    // 4. this block's decoded spectra to shared memory as (re, im) pairs
    store_decoded<EC, P::HPG, TILE>(out_s, acc_re, acc_im, grp * P::HPG, k);
    if (tid < EC * TILE) {
      out_s[(tid * NB_PAD + HOP) * 2 + 0] = nyq_s[tid].x;
      out_s[(tid * NB_PAD + HOP) * 2 + 1] = nyq_s[tid].y;
    }
    cluster.sync();

    // 5. irDFT of this rank's (ear, hop) frames, their spectra summed over
    //    the cluster's blocks in rank order
    for (int f = rank + cs * warp; f < EC * TILE; f += cs * WARPS) {
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

template <bool HYBRID, int TILE>
cudaError_t launch_tile(const float* in_tail, const float* x,
                        const float* taps, long long taps_stride,
                        const float* w_ana, const float* tw, float* frames,
                        int n_streams, int cin, int cout, int H,
                        int low_delay, cudaStream_t st) {
  const int n_tiles = (H + TILE - 1) / TILE;
  const int cs = cin < MAX_CLUSTER ? cin : MAX_CLUSTER;
  const int smem = Tile<TILE>::SM_FLOATS * (int)sizeof(float);
  const cudaError_t err = cudaFuncSetAttribute(
      analysis_decode_irdft<HYBRID, TILE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(n_streams * n_tiles * cs));
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, analysis_decode_irdft<HYBRID, TILE>,
                            in_tail, x, taps, taps_stride, w_ana,
                            reinterpret_cast<const float2*>(tw), frames, cin,
                            cout, H, n_tiles, low_delay);
}

// The tile follows H: short tiles for blocks of at most SHORT_TILE hops
// (the runtime's frame of 1024 samples is 8 hops), long tiles otherwise.
template <bool HYBRID>
cudaError_t launch(const float* in_tail, const float* x, const float* taps,
                   long long taps_stride, const float* w_ana, const float* tw,
                   float* frames, int n_streams, int cin, int cout, int H,
                   int low_delay, cudaStream_t st) {
  return H <= SHORT_TILE
             ? launch_tile<HYBRID, SHORT_TILE>(in_tail, x, taps, taps_stride,
                                               w_ana, tw, frames, n_streams,
                                               cin, cout, H, low_delay, st)
             : launch_tile<HYBRID, LONG_TILE>(in_tail, x, taps, taps_stride,
                                              w_ana, tw, frames, n_streams,
                                              cin, cout, H, low_delay, st);
}

}  // namespace

// C interface, loaded with ctypes.  Launches both kernels on `stream` and
// returns the first CUDA error code (0 = success; a refused cluster launch
// returns its code); allocates nothing.  hybrid != 0: a hybrid bank;
// per_stream != 0: taps (S, cin, cout, 4, NB); low_delay != 0: the odd-bin
// sign before the irDFT (the caller passes the low-delay windows).  tw: the
// FFT twiddle table W256^k, (256, 2) float32.
extern "C" int saf_render_full_ri(const float* in_tail, const float* x,
                                  const float* ola_tail, const float* taps,
                                  const float* w_ana, const float* w_syn,
                                  const float* tw, float* frames, float* y,
                                  float* new_tail, int n_streams, int cin,
                                  int cout, int H, int hybrid, int per_stream,
                                  int low_delay, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long taps_stride =
      per_stream ? (long long)cin * cout * 4 * NB : 0;
  const cudaError_t err =
      hybrid ? launch<true>(in_tail, x, taps, taps_stride, w_ana, tw, frames,
                            n_streams, cin, cout, H, low_delay, st)
             : launch<false>(in_tail, x, taps, taps_stride, w_ana, tw, frames,
                             n_streams, cin, cout, H, low_delay, st);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_overlap_add(frames, w_syn, ola_tail, y, new_tail,
                                 (long long)n_streams * cout, H, st);
}

extern "C" const char* saf_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
