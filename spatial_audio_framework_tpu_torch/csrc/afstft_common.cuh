// Device code shared by the port's afSTFT kernels (hop 128, 129 uniform
// bands, 10-hop prototype): the input-hop load, the analysis window fold,
// one band's rDFT over a run of frames, the hybrid-FIR context, the
// per-band decode with A/B taps, the irDFT of a decoded tile, and the
// synthesis window / overlap-add / tail-merge launch.
//
// Included by every kernel source in csrc/.  Everything here has internal
// linkage, so each translation unit keeps its own copy.
#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int HOP = 128;
constexpr int NB = HOP + 1;           // uniform bands
constexpr int FRAME = 2 * HOP;        // folded frame length
constexpr int TOTAL_HOPS = 10;        // prototype length in hops
constexpr int NT = TOTAL_HOPS - 1;    // overlap-add tail hops
constexpr int NB_PAD = NB + 1;        // A/B rows and decoded rows, even count
constexpr int G_BANDS = 16;           // bands carrying the hybrid context
// half-band ("hybrid") filter coefficients, afSTFT_internal.h:73-76
constexpr float COEFF1 = 0.031273141818515176604f;
constexpr float COEFF2 = 0.28127313041521179171f;

// Hops q0 .. q0+n-1 of the row [tail | x] (t_hops + x_hops hops) into
// dst, zeros past the end.  float4 loads: both rows are whole hops long,
// so every hop starts 16-byte aligned when the row bases are.
__device__ __forceinline__ void load_hops(float* dst, const float* tail,
                                          int t_hops, const float* x,
                                          int x_hops, int q0, int n, int tid,
                                          int nthreads) {
  for (int i = tid; i < n * HOP / 4; i += nthreads) {
    const int q = q0 + (4 * i) / HOP;
    const int off = (4 * i) % HOP;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q < t_hops)
      v = *reinterpret_cast<const float4*>(tail + (size_t)q * HOP + off);
    else if (q < t_hops + x_hops)
      v = *reinterpret_cast<const float4*>(x + (size_t)(q - t_hops) * HOP +
                                           off);
    reinterpret_cast<float4*>(dst)[i] = v;
  }
}

// Window fold of nf frames from nf + 9 hops: thread tid < FRAME computes
// sample tid of every frame; parity p = tid / HOP accumulates window hops
// p, p+2, ..., p+8.  win: the 10-hop analysis window (shared or global).
__device__ __forceinline__ void fold_frames(float* fold, const float* hops,
                                            const float* win, int nf,
                                            int tid) {
  if (tid < FRAME) {
    const int p = tid / HOP, i = tid % HOP;
    float w[TOTAL_HOPS / 2];
#pragma unroll
    for (int m = 0; m < TOTAL_HOPS / 2; ++m)
      w[m] = win[(2 * m + p) * HOP + i];
    for (int j = 0; j < nf; ++j) {
      float a = 0.f;
#pragma unroll
      for (int m = 0; m < TOTAL_HOPS / 2; ++m)
        a += hops[(j + 2 * m + p) * HOP + i] * w[m];
      fold[j * FRAME + tid] = a;
    }
  }
}

// rDFT of band k for FPG consecutive folded frames starting at frow (in
// shared memory, FRAME floats each): sr/si = frame . C[:, k] / S[:, k].
// Every C/S value loaded feeds FPG x 2 FMAs; the frame samples are read as
// 16-byte broadcasts.
template <int FPG>
__device__ __forceinline__ void rdft_band(const float* frow,
                                          const float* __restrict__ Cm,
                                          const float* __restrict__ Sm, int k,
                                          float (&sr)[FPG], float (&si)[FPG]) {
#pragma unroll
  for (int jj = 0; jj < FPG; ++jj) sr[jj] = si[jj] = 0.f;
#pragma unroll 2
  for (int t = 0; t < FRAME; t += 4) {
    const float c0 = __ldg(Cm + (t + 0) * NB + k);
    const float c1 = __ldg(Cm + (t + 1) * NB + k);
    const float c2 = __ldg(Cm + (t + 2) * NB + k);
    const float c3 = __ldg(Cm + (t + 3) * NB + k);
    const float s0 = __ldg(Sm + (t + 0) * NB + k);
    const float s1 = __ldg(Sm + (t + 1) * NB + k);
    const float s2 = __ldg(Sm + (t + 2) * NB + k);
    const float s3 = __ldg(Sm + (t + 3) * NB + k);
#pragma unroll
    for (int jj = 0; jj < FPG; ++jj) {
      const float4 f = *reinterpret_cast<const float4*>(frow + jj * FRAME + t);
      sr[jj] = fmaf(f.w, c3, fmaf(f.z, c2, fmaf(f.y, c1,
               fmaf(f.x, c0, sr[jj]))));
      si[jj] = fmaf(f.w, s3, fmaf(f.z, s2, fmaf(f.y, s1,
               fmaf(f.x, s0, si[jj]))));
    }
  }
}

// Hybrid-FIR context of one band from its spectra at hops h, h+2, h+4 and
// h+6: g = c1 (s[h+6] - s[h]) + c2 (s[h+4] - s[h+2]), as (re, im).
__device__ __forceinline__ float2 hybrid_context(float2 f0, float2 f2,
                                                 float2 f4, float2 f6) {
  return make_float2(COEFF1 * (f6.x - f0.x) + COEFF2 * (f4.x - f2.x),
                     COEFF1 * (f6.y - f0.y) + COEFF2 * (f4.y - f2.y));
}

// The decode taps of one band and one input channel for EC ears.
template <int EC>
struct BandTaps {
  float are[EC], aim[EC], bre[EC], bim[EC];
};

// Taps of ears e0 .. e0+EC-1 from tp = &taps[c, e0, 0, k] of a (cin, cout,
// 4, NB) tensor; ears >= ne read as zero, and so do the B taps unless hyb
// (the band carries the hybrid context).
template <int EC>
__device__ __forceinline__ BandTaps<EC> load_taps(const float* __restrict__ tp,
                                                  int ne, bool hyb) {
  BandTaps<EC> t;
#pragma unroll
  for (int e = 0; e < EC; ++e) {
    const bool on = e < ne;
    t.are[e] = on ? __ldg(tp + (4 * e + 0) * NB) : 0.f;
    t.aim[e] = on ? __ldg(tp + (4 * e + 1) * NB) : 0.f;
    t.bre[e] = (on && hyb) ? __ldg(tp + (4 * e + 2) * NB) : 0.f;
    t.bim[e] = (on && hyb) ? __ldg(tp + (4 * e + 3) * NB) : 0.f;
  }
  return t;
}

// One hop of one channel's decode into the per-ear accumulators (hop hh of
// the thread's run): acc += A.d + B.w, with w = j g = (-g_im, g_re).
template <int EC, int HPG>
__device__ __forceinline__ void decode_hop(const BandTaps<EC>& t, float2 d,
                                           float2 w, float (&acc_re)[EC][HPG],
                                           float (&acc_im)[EC][HPG], int hh) {
#pragma unroll
  for (int e = 0; e < EC; ++e) {
    acc_re[e][hh] += (t.are[e] * d.x - t.aim[e] * d.y)
                     + (t.bre[e] * w.x - t.bim[e] * w.y);
    acc_im[e][hh] += (t.are[e] * d.y + t.aim[e] * d.x)
                     + (t.bre[e] * w.y + t.bim[e] * w.x);
  }
}

// The decoded spectra of band k, hops hop0 .. hop0+HPG-1 of each ear, to
// dec_s as (re, im) pairs, NB_PAD bands per row; row e * TILE + hop.
template <int EC, int HPG, int TILE>
__device__ __forceinline__ void store_decoded(float* dec_s,
                                              const float (&acc_re)[EC][HPG],
                                              const float (&acc_im)[EC][HPG],
                                              int hop0, int k) {
#pragma unroll
  for (int e = 0; e < EC; ++e)
#pragma unroll
    for (int hh = 0; hh < HPG; ++hh) {
      const int row = e * TILE + hop0 + hh;
      dec_s[(row * NB_PAD + k) * 2 + 0] = acc_re[e][hh];
      dec_s[(row * NB_PAD + k) * 2 + 1] = acc_im[e][hh];
    }
}

// Zero the pad band NB of each of dec_s's EC * TILE rows (threads
// tid < EC * TILE), so the irDFT can read bands in pairs.
template <int EC, int TILE>
__device__ __forceinline__ void zero_pad_band(float* dec_s, int tid) {
  if (tid < EC * TILE) {
    dec_s[(tid * NB_PAD + NB) * 2 + 0] = 0.f;
    dec_s[(tid * NB_PAD + NB) * 2 + 1] = 0.f;
  }
}

// irDFT of the EC x TILE decoded rows of dec_s against A/B (NB_PAD x FRAME,
// row-major, the pad row zero): thread n < FRAME computes sample n of every
// (ear, hop) frame and stores those of ears < ne and hops h0 + h < H to
// fr = &frames[s, e0, 0, 0] of an (S, cout, H, FRAME) buffer.
template <int EC, int TILE>
__device__ __forceinline__ void irdft_tile(const float* dec_s,
                                           const float* __restrict__ Am,
                                           const float* __restrict__ Bm,
                                           float* __restrict__ fr_out, int H,
                                           int h0, int ne, int tid) {
  if (tid >= FRAME) return;
  const int n = tid;
  float fr[EC][TILE];
#pragma unroll
  for (int e = 0; e < EC; ++e)
#pragma unroll
    for (int h = 0; h < TILE; ++h) fr[e][h] = 0.f;
  for (int kk = 0; kk < NB_PAD; kk += 2) {
    const float a0 = __ldg(Am + kk * FRAME + n);
    const float a1 = __ldg(Am + (kk + 1) * FRAME + n);
    const float b0 = __ldg(Bm + kk * FRAME + n);
    const float b1 = __ldg(Bm + (kk + 1) * FRAME + n);
#pragma unroll
    for (int e = 0; e < EC; ++e)
#pragma unroll
      for (int h = 0; h < TILE; ++h) {
        const float4 v = *reinterpret_cast<const float4*>(
            dec_s + ((e * TILE + h) * NB_PAD + kk) * 2);
        fr[e][h] = fmaf(v.w, b1, fmaf(v.z, a1, fmaf(v.y, b0,
                   fmaf(v.x, a0, fr[e][h]))));
      }
  }
#pragma unroll
  for (int e = 0; e < EC; ++e)
#pragma unroll
    for (int h = 0; h < TILE; ++h)
      if (e < ne && h0 + h < H)
        fr_out[((size_t)e * H + h0 + h) * FRAME + n] = fr[e][h];
}

// Synthesis window, overlap-add over 10 hops and the tail merge; one
// thread per sample of the H + 9 output hops (y, then the new tail) of
// each of the `rows` frame rows.
__global__ void overlap_add(const float* __restrict__ frames,   // (rows, H, FRAME)
                            const float* __restrict__ w_syn,    // (10*HOP)
                            const float* __restrict__ ola_tail, // (rows, NT, HOP)
                            float* __restrict__ y,              // (rows, H*HOP)
                            float* __restrict__ new_tail,       // (rows, NT, HOP)
                            int H, long long total) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int i = (int)(idx % HOP);
  const long long r = idx / HOP;
  const int p = (int)(r % (H + NT));
  const long long se = r / (H + NT);  // frame row
  const float* fr = frames + se * (long long)H * FRAME;
  float acc = 0.f;
#pragma unroll
  for (int k = 0; k < TOTAL_HOPS; ++k) {
    const int h = p - k;
    if (h >= 0 && h < H)
      acc += fr[(long long)h * FRAME + (k & 1) * HOP + i] * w_syn[k * HOP + i];
  }
  if (p < NT) acc += ola_tail[(se * NT + p) * HOP + i];
  if (p < H)
    y[(se * H + p) * HOP + i] = acc;
  else
    new_tail[(se * NT + (p - H)) * HOP + i] = acc;
}

// Launches overlap_add over `rows` frame rows of H hops on `st`.
inline cudaError_t launch_overlap_add(const float* frames, const float* w_syn,
                                      const float* ola_tail, float* y,
                                      float* new_tail, long long rows, int H,
                                      cudaStream_t st) {
  const long long total = rows * (H + NT) * HOP;
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  overlap_add<<<(unsigned)blocks, threads, 0, st>>>(frames, w_syn, ola_tail,
                                                    y, new_tail, H, total);
  return cudaGetLastError();
}

}  // namespace
