// Device code shared by the port's afSTFT kernels (hop 128, 129 uniform
// bands, 10-hop prototype): the cp.async hop and span loads, the FFT-based
// rDFT and irDFT of a frame with the analysis window fold, the hybrid-FIR
// context, the per-band decode with A/B taps, and the synthesis window /
// overlap-add / tail-merge launch.
//
// The 256-point real DFT and its inverse are rdft256 / irdft256: one warp
// per frame, a 128-point complex FFT in registers plus the real/complex
// split, ~5 k FLOP per frame, twiddles from a 2 KB table.  Every kernel
// source uses them; none reads a dense DFT matrix.
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
constexpr int NB_PAD = NB + 1;        // bins of a decoded row in shared memory
constexpr int G_BANDS = 16;           // bands carrying the hybrid context
// half-band ("hybrid") filter coefficients, afSTFT_internal.h:73-76
constexpr float COEFF1 = 0.031273141818515176604f;
constexpr float COEFF2 = 0.28127313041521179171f;

// ---------------------------------------------------------------------------
// Asynchronous loads (cp.async)
// ---------------------------------------------------------------------------

// 16 bytes, L2 only; src_bytes < 16 zero-fills the rest.
__device__ __forceinline__ void cp_async16(void* dst_shared, const void* src,
                                           int src_bytes) {
  const unsigned dst =
      static_cast<unsigned>(__cvta_generic_to_shared(dst_shared));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes));
}

// 8 bytes; src and dst 8-byte aligned (cached in L1 too: .cg takes 16 only).
__device__ __forceinline__ void cp_async8(void* dst_shared, const void* src) {
  const unsigned dst =
      static_cast<unsigned>(__cvta_generic_to_shared(dst_shared));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(dst),
               "l"(src));
}

// 4 bytes.
__device__ __forceinline__ void cp_async4(void* dst_shared, const void* src) {
  const unsigned dst =
      static_cast<unsigned>(__cvta_generic_to_shared(dst_shared));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Starts the copy of hops q0 .. q0+n-1 of the row [tail | x] (t_hops +
// x_hops hops) into dst, hop q0+qq at dst + qq * hs (hs >= HOP, a multiple
// of 4); hops past the end are zero-filled.  Completes at the caller's
// next cp_async_commit / cp_async_wait.
__device__ __forceinline__ void load_hops_async(float* dst, int hs,
                                                const float* tail, int t_hops,
                                                const float* x, int x_hops,
                                                int q0, int n, int tid,
                                                int nthreads) {
  for (int i = tid; i < n * (HOP / 4); i += nthreads) {
    const int qq = i / (HOP / 4), off = 4 * (i % (HOP / 4));
    const int q = q0 + qq;
    const float* src = tail;  // any valid address for a zero fill
    int bytes = 0;
    if (q < t_hops) {
      src = tail + (size_t)q * HOP + off;
      bytes = 16;
    } else if (q < t_hops + x_hops) {
      src = x + (size_t)(q - t_hops) * HOP + off;
      bytes = 16;
    }
    cp_async16(dst + qq * hs + off, src, bytes);
  }
}

// A span of floats in device memory starts anywhere in a 16-byte word:
// span_offset is the floats it lies past the word's start (0..3).
__device__ __forceinline__ int span_offset(const float* src) {
  return (int)((reinterpret_cast<unsigned long long>(src) >> 2) & 3);
}

// Floats of shared memory for a span of n floats at any span_offset, in
// whole 16-byte words.
constexpr int span_room(int n) { return (n + 6) / 4 * 4; }

// Starts the copy of the n floats at src to dst + span_offset(src) (dst
// 16-byte aligned, span_room(n) floats): the copy keeps the span's place
// within its 16-byte word, so all but its first and last (up to 3) floats
// go as 16-byte copies.  Completes at the caller's next cp_async_commit /
// cp_async_wait.
__device__ __forceinline__ void load_span_async(float* dst, const float* src,
                                                int n, int tid,
                                                int nthreads) {
  const int off = span_offset(src);
  const int head = min(n, (4 - off) & 3);
  const int body = (n - head) / 4;
  const int done = head + 4 * body;
  dst += off;
  if (tid < head) cp_async4(dst + tid, src + tid);
  for (int i = tid; i < body; i += nthreads)
    cp_async16(dst + head + 4 * i, src + head + 4 * i, 16);
  if (tid < n - done) cp_async4(dst + done + tid, src + done + tid);
}

// ---------------------------------------------------------------------------
// FFT-based rDFT / irDFT of one 256-sample frame by one warp
// ---------------------------------------------------------------------------
//
// The frame f[0..255] is packed as z[n] = f[2n] + i f[2n+1], n = 0..127,
// transformed by a 128-point complex FFT Z, and split into the 129 real-
// input bins:  X[k] = (Z[k] + Z*[128-k]) / 2 - i W256^k (Z[k] - Z*[128-k]) / 2
// (Z[128] = Z[0]).  The inverse runs the same steps backwards: the inverse
// split, the adjoint FFT schedule with conjugate twiddles, and the unpack,
// scaled by 1/256, equal to X.re @ A + X.im @ B (the imaginary parts of
// X[0] and X[128] ignored).
//
// Layout: lane l holds four complex points v[0..3].
//   FFT input (and inverse output): v[r] = z[fft_in_index(l, r)];
//   FFT output (and inverse input): v[r] = Z[l + 32 r].
// Schedule (forward; each radix-4 stage multiplies v[1..3] by twiddles
// W128^(e q) = tw[2 e q] and then takes a 4-point DFT over the registers):
//   A  radix 2 across lane bit 0 (one __shfl_xor_sync per register);
//   B  radix 4, e = 16 (l & 1);
//      swap register bits (0, 1) with lane bits (1, 2);
//   C  radix 4, e = 4 (l & 7);
//      swap register bits (0, 1) with lane bits (3, 4);
//   D  radix 4, e = l.
// No shared memory between stages.  The split reads Z[128 - k] from lane
// (32 - l) & 31, register 3 - r (lane 0: its own register (4 - r) & 3).
// tw: W256^k = (cos, -sin)(2 pi k / 256), k = 0..255 (ops/fft.py
// _fft256_twiddles, float64 on the host, passed as float32).  All fp32 FMA,
// no TF32, no fast-math intrinsics.  tests/test_torch_fft256.py runs a
// numpy mirror of this schedule against numpy.fft and the dense operators.

constexpr unsigned FULL_MASK = 0xffffffffu;
constexpr int FFT_TW = 256;           // twiddle table entries (float2)

__device__ __forceinline__ int fft_in_index(int lane, int r) {
  return 64 * (lane & 1) + 16 * r + 4 * ((lane >> 1) & 3) + (lane >> 3);
}

__device__ __forceinline__ float2 cmul(float2 a, float2 w) {
  return make_float2(a.x * w.x - a.y * w.y, a.x * w.y + a.y * w.x);
}

__device__ __forceinline__ float2 cmul_conj(float2 a, float2 w) {  // a w*
  return make_float2(a.x * w.x + a.y * w.y, a.y * w.x - a.x * w.y);
}

__device__ __forceinline__ float2 shfl2(float2 v, int src) {
  return make_float2(__shfl_sync(FULL_MASK, v.x, src),
                     __shfl_sync(FULL_MASK, v.y, src));
}

__device__ __forceinline__ float2 shfl2_xor(float2 v, int mask) {
  return make_float2(__shfl_xor_sync(FULL_MASK, v.x, mask),
                     __shfl_xor_sync(FULL_MASK, v.y, mask));
}

// Radix-2 butterfly across lane bit 0: the lane with bit 0 clear keeps
// a + b, its partner a - b (self-adjoint, so the inverse runs it as is).
__device__ __forceinline__ void fft_radix2_lanes(float2 (&v)[4], int lane) {
  const bool hi = lane & 1;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const float2 o = shfl2_xor(v[r], 1);
    v[r] = hi ? make_float2(o.x - v[r].x, o.y - v[r].y)
              : make_float2(v[r].x + o.x, v[r].y + o.y);
  }
}

// 4-point DFT over the registers (INV: the unnormalised inverse).
template <bool INV>
__device__ __forceinline__ void fft_dft4(float2 (&v)[4]) {
  const float2 a = make_float2(v[0].x + v[2].x, v[0].y + v[2].y);
  const float2 b = make_float2(v[0].x - v[2].x, v[0].y - v[2].y);
  const float2 c = make_float2(v[1].x + v[3].x, v[1].y + v[3].y);
  const float2 d = make_float2(v[1].x - v[3].x, v[1].y - v[3].y);
  const float2 bpjd = make_float2(b.x - d.y, b.y + d.x);  // b + i d
  const float2 bmjd = make_float2(b.x + d.y, b.y - d.x);  // b - i d
  v[0] = make_float2(a.x + c.x, a.y + c.y);
  v[2] = make_float2(a.x - c.x, a.y - c.y);
  v[1] = INV ? bpjd : bmjd;
  v[3] = INV ? bmjd : bpjd;
}

// v[q] *= W256^(step q), q = 1..3 (conjugated for the inverse).
template <bool INV>
__device__ __forceinline__ void fft_twiddle(float2 (&v)[4],
                                            const float2* tw, int step) {
#pragma unroll
  for (int q = 1; q < 4; ++q)
    v[q] = INV ? cmul_conj(v[q], tw[step * q]) : cmul(v[q], tw[step * q]);
}

// Swap register bit J with lane bit B: per pair of registers, one exchange
// with the lane across bit B; the lane with bit B set sends its register
// with bit J clear, its partner the one with bit J set.
template <int J, int B>
__device__ __forceinline__ void fft_swap_bit(float2 (&v)[4], int lane) {
  const bool beta = (lane >> B) & 1;
#pragma unroll
  for (int r0 = 0; r0 < 4; ++r0) {
    if (r0 & (1 << J)) continue;
    const int r1 = r0 | (1 << J);
    const float2 recv = shfl2_xor(beta ? v[r0] : v[r1], 1 << B);
    if (beta)
      v[r0] = recv;
    else
      v[r1] = recv;
  }
}

__device__ __forceinline__ void fft128_fwd(float2 (&v)[4], const float2* tw,
                                           int lane) {
  fft_radix2_lanes(v, lane);
  fft_twiddle<false>(v, tw, 32 * (lane & 1));
  fft_dft4<false>(v);
  fft_swap_bit<0, 1>(v, lane);
  fft_swap_bit<1, 2>(v, lane);
  fft_twiddle<false>(v, tw, 8 * (lane & 7));
  fft_dft4<false>(v);
  fft_swap_bit<0, 3>(v, lane);
  fft_swap_bit<1, 4>(v, lane);
  fft_twiddle<false>(v, tw, 2 * lane);
  fft_dft4<false>(v);
}

// The adjoint of fft128_fwd: the unnormalised inverse FFT.
__device__ __forceinline__ void fft128_inv(float2 (&v)[4], const float2* tw,
                                           int lane) {
  fft_dft4<true>(v);
  fft_twiddle<true>(v, tw, 2 * lane);
  fft_swap_bit<0, 3>(v, lane);
  fft_swap_bit<1, 4>(v, lane);
  fft_dft4<true>(v);
  fft_twiddle<true>(v, tw, 8 * (lane & 7));
  fft_swap_bit<0, 1>(v, lane);
  fft_swap_bit<1, 2>(v, lane);
  fft_dft4<true>(v);
  fft_twiddle<true>(v, tw, 32 * (lane & 1));
  fft_radix2_lanes(v, lane);
}

// Z[128 - k] for the lane's k = l + 32 r, r = 0..3.
__device__ __forceinline__ void fft_partners(const float2 (&v)[4],
                                             float2 (&p)[4], int lane) {
  const int src = (32 - lane) & 31;
#pragma unroll
  for (int r = 0; r < 4; ++r) p[r] = shfl2(v[3 - r], src);
  if (lane == 0) {
    p[0] = v[0];
    p[1] = v[3];
    p[2] = v[2];
    p[3] = v[1];
  }
}

// Forward: v holds z in the FFT input layout; on return v[r] = X[l + 32 r]
// and the result is X[128] (real; valid on lane 0).
__device__ __forceinline__ float rdft256(float2 (&v)[4], const float2* tw,
                                         int lane) {
  fft128_fwd(v, tw, lane);
  float2 p[4];
  fft_partners(v, p, lane);
  const float nyq = v[0].x - v[0].y;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const float2 w = tw[lane + 32 * r];
    const float er = 0.5f * (v[r].x + p[r].x), ei = 0.5f * (v[r].y - p[r].y);
    const float dr = v[r].x - p[r].x, di = v[r].y + p[r].y;
    v[r] = make_float2(er + 0.5f * (w.x * di + w.y * dr),
                       ei - 0.5f * (w.x * dr - w.y * di));
  }
  return nyq;
}

// Inverse: v[r] = X[l + 32 r], nyq = Re X[128] (read on lane 0); on
// return v[r] = (f[2n], f[2n+1]), n = fft_in_index(l, r), scaled by 1/256.
__device__ __forceinline__ void irdft256(float2 (&v)[4], float nyq,
                                         const float2* tw, int lane) {
  if (lane == 0) v[0].y = 0.f;
  float2 p[4];
  fft_partners(v, p, lane);
  if (lane == 0) p[0] = make_float2(nyq, 0.f);
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const float2 w = tw[lane + 32 * r];
    const float er = v[r].x + p[r].x, ei = v[r].y - p[r].y;
    const float dr = v[r].x - p[r].x, di = v[r].y + p[r].y;
    v[r] = make_float2(er - (w.x * di - w.y * dr), ei + (w.x * dr + w.y * di));
  }
  fft128_inv(v, tw, lane);
  constexpr float SCALE = 1.f / FRAME;
#pragma unroll
  for (int r = 0; r < 4; ++r) v[r] = make_float2(v[r].x * SCALE, v[r].y * SCALE);
}

// The fold of the lane's points of frame j into the FFT input layout:
// v[r] = (f[2n], f[2n+1]) with n = fft_in_index(l, r), parity p = l & 1,
// i = 2n mod 128, f[p*128 + i] = sum over m = 0..4 of hop (j + 2m + p)
// sample i times window hop (2m + p) sample i, summed in the order of m.
// hops: hop q at hops + q * hs; win(m, r): the window pair (float2) of
// window hop 2m + p at sample i of register r.
template <class Win>
__device__ __forceinline__ void fold_lane(float2 (&v)[4], const float* hops,
                                          int hs, int j, int lane, Win win) {
  const int p = lane & 1;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = 2 * (fft_in_index(lane, r) & (HOP / 2 - 1));
    float a = 0.f, b = 0.f;
#pragma unroll
    for (int m = 0; m < TOTAL_HOPS / 2; ++m) {
      const float2 h =
          *reinterpret_cast<const float2*>(hops + (j + 2 * m + p) * hs + i);
      const float2 w = win(m, r);
      a += h.x * w.x;
      b += h.y * w.y;
    }
    v[r] = make_float2(a, b);
  }
}

// The window pair of register r, window hop 2m + p, for this lane; window
// hop w at win + w * ws.
__device__ __forceinline__ float2 window_pair(const float* win, int ws,
                                              int lane, int m, int r) {
  const int i = 2 * (fft_in_index(lane, r) & (HOP / 2 - 1));
  return *reinterpret_cast<const float2*>(win + (2 * m + (lane & 1)) * ws +
                                          i);
}

// The fold of a chain of K frames of one parity, j, j + 2, ..., j + 2(K-1):
// v[c] is fold_lane's v of frame j + 2c.  Each hop row j + 2t + p
// (t = 0 .. K + 3) is read once and serves every frame c of the chain with
// m = t - c in 0..4, and win(m, r) is called once a chain, where K frames
// folded one by one read 5K hop rows and call win 5K times a register.
// The window pairs slide through K registers: at step t, w[c] is window
// hop m = t - c of frame c.  Each frame sums its products in the order of
// m, so v is fold_lane's bit for bit.
template <int K, class Win>
__device__ __forceinline__ void fold_chain(float2 (&v)[K][4],
                                           const float* hops, int hs, int j,
                                           int lane, Win win) {
  constexpr int M = TOTAL_HOPS / 2;
  const int p = lane & 1;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = 2 * (fft_in_index(lane, r) & (HOP / 2 - 1));
    float2 w[K];
    float a[K], b[K];
#pragma unroll
    for (int c = 0; c < K; ++c) a[c] = b[c] = 0.f;
#pragma unroll
    for (int t = 0; t < K + M - 1; ++t) {
#pragma unroll
      for (int c = K - 1; c > 0; --c) w[c] = w[c - 1];
      if (t < M) w[0] = win(t, r);
      const float2 h =
          *reinterpret_cast<const float2*>(hops + (j + 2 * t + p) * hs + i);
#pragma unroll
      for (int c = 0; c < K; ++c) {
        if (t - c < 0 || t - c >= M) continue;
        a[c] += h.x * w[c].x;
        b[c] += h.y * w[c].y;
      }
    }
#pragma unroll
    for (int c = 0; c < K; ++c) v[c][r] = make_float2(a[c], b[c]);
  }
}

// rdft256 of the K frames of a chain: each twiddle of the FFT's stages is
// read once and serves every frame (the split's four are read a frame:
// held across the chain they cost more registers than their reads save);
// the shuffles and the arithmetic are rdft256's, frame by frame.
// out(c, v[c], nyq) takes frame c's bins as rdft256 leaves them (bit for
// bit) as soon as its split is done, before the next frame's.
template <int K, class Out>
__device__ __forceinline__ void rdft256_chain(float2 (&v)[K][4],
                                              const float2* tw, int lane,
                                              Out out) {
  auto twiddle = [&](int step) {  // fft_twiddle<false> on every frame
    float2 w[3];
#pragma unroll
    for (int q = 1; q < 4; ++q) w[q - 1] = tw[step * q];
#pragma unroll
    for (int c = 0; c < K; ++c)
#pragma unroll
      for (int q = 1; q < 4; ++q) v[c][q] = cmul(v[c][q], w[q - 1]);
  };
#pragma unroll
  for (int c = 0; c < K; ++c) fft_radix2_lanes(v[c], lane);
  twiddle(32 * (lane & 1));
#pragma unroll
  for (int c = 0; c < K; ++c) {
    fft_dft4<false>(v[c]);
    fft_swap_bit<0, 1>(v[c], lane);
    fft_swap_bit<1, 2>(v[c], lane);
  }
  twiddle(8 * (lane & 7));
#pragma unroll
  for (int c = 0; c < K; ++c) {
    fft_dft4<false>(v[c]);
    fft_swap_bit<0, 3>(v[c], lane);
    fft_swap_bit<1, 4>(v[c], lane);
  }
  twiddle(2 * lane);
#pragma unroll
  for (int c = 0; c < K; ++c) fft_dft4<false>(v[c]);
#pragma unroll
  for (int c = 0; c < K; ++c) {
    float2 w[4], p[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) w[r] = tw[lane + 32 * r];
    fft_partners(v[c], p, lane);
    const float nyq = v[c][0].x - v[c][0].y;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float er = 0.5f * (v[c][r].x + p[r].x);
      const float ei = 0.5f * (v[c][r].y - p[r].y);
      const float dr = v[c][r].x - p[r].x, di = v[c][r].y + p[r].y;
      v[c][r] = make_float2(er + 0.5f * (w[r].x * di + w[r].y * dr),
                            ei - 0.5f * (w[r].x * dr - w[r].y * di));
    }
    out(c, v[c], nyq);
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
