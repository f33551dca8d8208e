// The binauraliser's per-block mixing matrices for Hopper (sm_90a): head
// rotation, HRTF-table interpolation and the collapse to uniform-band
// decode taps, from a block's source directions straight to the taps the
// render kernels read.
//
// Replaces: no TPU kernel.  On the TPU this is XLA's work around the render
// kernel (`rotate_dirs`, `interp_hrtfs_ri` in
// spatial_audio_framework_tpu/models/binauraliser.py and `decode_taps` in
// its ops/pallas_afstft.py); the plain PyTorch version, that same chain, is
// `hrtf_taps_ri_reference` in
// spatial_audio_framework_tpu_torch/ops/afstft_kernels.py.
//
// What it computes, per (stream s, source n) of a block:
//   1. optionally the head rotation: R = yaw_pitch_roll2_rzyx(ypr[s])
//      multiplied out, the source's unit vector u times R as a row vector,
//      atan2 back to degrees;
//   2. the VBAP table row: C's (int)(x + 0.5f) of the floor-mod azimuth and
//      of the elevation, then `models/_common.table_row`'s rules (a NaN row
//      is row 0, a negative row counts from the table's end, a row outside
//      the table gives NaN weights; every index is clamped into its table,
//      so no direction can make the card assert);
//   3. per ear and hybrid band, the three-weight sum over the row's HRTF
//      directions: the complex HRTFs (INTERP_TRI) or the magnitudes, with
//      the interpolated ITD's phase below 1.5 kHz (INTERP_TRI_PS);
//   4. the collapse of the 133 hybrid bands to [A_re, A_im, B_re, B_im]
//      over the 129 uniform bands (`decode_taps`), written as taps
//      (S, nSrc, 2, 4, 129): the per-stream taps of
//      `render_decode_synthesis_dg_ri` and `render_full_ri`.
// Every step is fp32 in the plain version's op order, with the products
// and sums kept apart (no contraction into FMAs) and precise sinf / cosf /
// atan2f / fmodf, since a direction's table row depends on them.
//
// What bounds it on the H100: at 1024 streams x 64 sources it must write
// 65,536 x 4,128 B = 270 MB of taps (0.08 ms at 3.35 TB/s) and reads 0.5 MB
// of directions and the 1.8 MB direction-major HRTF table, which stays in
// L2.  The torch chain it replaces wrote and reread three intermediates as
// large as the taps in ~70 launches.
//
// What the design does about it:
//   * the table is read direction-major (`hrtf_ri_by_dir`, (nDirs, 2, 133)
//     (re, im) pairs, and `hrtf_mag_by_dir`, (nDirs, 2, 133), made once with
//     the weights), so a source's three directions are three contiguous
//     rows an ear, read from L2 as one 8-byte load a lane a direction;
//   * a block takes 4 consecutive (stream, source) pairs: 4 threads first
//     compute each pair's rotation, row, three indices, three weights (and
//     ITD) into shared memory, then every thread takes (pair, ear, band)
//     items, so a pair's lookup is done once and shared by its 258 lanes;
//     small blocks, 8 an SM, let one block's lookup overlap the others'
//     stores;
//   * the items write the pairs' taps into shared memory, and the block
//     copies them out as one contiguous, 16-byte aligned run of 16.5 KB in
//     16-byte stores: a tap row of 129 floats starts off a 16-byte
//     boundary, and stored straight from the items the same bytes took 2.4x
//     as long (0.326 against 0.136 ms on an H100, 1024 x 64 sources).

#include <cuda_runtime.h>

#include <cfloat>
#include <climits>
#include <cmath>

namespace {

constexpr int NB_HYB = 133;              // hybrid bands at hop 128
constexpr int NU = 129;                  // uniform bands
constexpr int EARS = 2;
constexpr int ITEMS = EARS * NU;         // (ear, band) items a pair
constexpr int PAIR_FLOATS = EARS * 4 * NU;
constexpr int PAIRS = 4;                 // (stream, source) pairs a block
constexpr int THREADS = 256;

// the plain version's Python constants as its float32 arithmetic sees them
constexpr float DEG2RAD = 0.017453292519943295f;   // math.pi / 180
constexpr float RAD2DEG = 57.29577951308232f;      // 180 / math.pi
constexpr float PI_F = 3.141592653589793f;
constexpr float TWO_PI_F = 6.283185307179586f;

struct Lookup {
  int idx[3];
  float w[3];
  float itd;
};

// torch.remainder(a, b) for float32: fmod, moved into b's sign
__device__ __forceinline__ float remainder(float a, float b) {
  float m = fmodf(a, b);
  if (m != 0.0f && ((b < 0.0f) != (m < 0.0f))) m = __fadd_rn(m, b);
  return m;
}

// (p0 + p1) + p2 of the three products, the plain version's sum(-1)
__device__ __forceinline__ float sum3(float w0, float a0, float w1, float a1,
                                      float w2, float a2) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a0, w0), __fmul_rn(a1, w1)),
                   __fmul_rn(a2, w2));
}

// steps 1-2 (and the ITD of step 3) for one pair
__device__ Lookup lookup(const float* __restrict__ dirs,
                         const float* __restrict__ ypr,
                         const float* __restrict__ table_w,
                         const long long* __restrict__ table_idx,
                         const float* __restrict__ itds, int pair, int n_src,
                         int n_dirs, int n_table, int n_azi, float azi_res,
                         float elev_res, bool phase_synth) {
  float az = dirs[2 * pair], el = dirs[2 * pair + 1];
  if (ypr != nullptr) {
    // geometry.yaw_pitch_roll2_rzyx_torch, unit_sph2cart_torch, the row
    // vector times R, unit_cart2sph_torch
    const float* a = ypr + 3 * (pair / n_src);
    const float cy = cosf(a[0]), cp = cosf(a[1]), cr = cosf(a[2]);
    const float sy = sinf(a[0]), sp = sinf(a[1]), sr = sinf(a[2]);
    const float R[3][3] = {
        {__fmul_rn(cp, cy), __fmul_rn(cp, sy), -sp},
        {__fsub_rn(__fmul_rn(__fmul_rn(sr, sp), cy), __fmul_rn(cr, sy)),
         __fadd_rn(__fmul_rn(__fmul_rn(sr, sp), sy), __fmul_rn(cr, cy)),
         __fmul_rn(sr, cp)},
        {__fadd_rn(__fmul_rn(__fmul_rn(cr, sp), cy), __fmul_rn(sr, sy)),
         __fsub_rn(__fmul_rn(__fmul_rn(cr, sp), sy), __fmul_rn(sr, cy)),
         __fmul_rn(cr, cp)}};
    const float azr = __fmul_rn(az, DEG2RAD), elr = __fmul_rn(el, DEG2RAD);
    const float ce = cosf(elr);
    const float u[3] = {__fmul_rn(ce, cosf(azr)), __fmul_rn(ce, sinf(azr)),
                        sinf(elr)};
    float v[3];
#pragma unroll
    for (int i = 0; i < 3; ++i)
      v[i] = __fadd_rn(__fadd_rn(__fmul_rn(u[0], R[0][i]),
                                 __fmul_rn(u[1], R[1][i])),
                       __fmul_rn(u[2], R[2][i]));
    az = __fmul_rn(atan2f(v[1], v[0]), RAD2DEG);
    el = __fmul_rn(
        atan2f(v[2], __fsqrt_rn(__fadd_rn(__fmul_rn(v[0], v[0]),
                                          __fmul_rn(v[1], v[1])))),
        RAD2DEG);
  }
  // binauraliser.interp_hrtfs_ri: round half up of the table coordinates
  const float azi_idx = floorf(__fadd_rn(
      __fdiv_rn(remainder(__fadd_rn(az, 180.0f), 360.0f), azi_res), 0.5f));
  const float elev_idx =
      floorf(__fadd_rn(__fdiv_rn(__fadd_rn(el, 90.0f), elev_res), 0.5f));
  float r = __fadd_rn(__fmul_rn(elev_idx, (float)n_azi), azi_idx);
  // _common.table_row: nan_to_num, clamp, truncate, wrap, flag, clamp
  if (isnan(r)) r = 0.0f;
  else if (isinf(r)) r = r > 0.0f ? FLT_MAX : -FLT_MAX;
  r = fminf(fmaxf(r, (float)(-n_table - 1)), (float)n_table);
  long long row = (long long)r;
  if (row < 0) row += n_table;
  const bool outside = row < 0 || row >= n_table;
  row = row < 0 ? 0 : (row >= n_table ? n_table - 1 : row);
  Lookup L;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const long long i = table_idx[3 * row + k];
    L.idx[k] = (int)(i < 0 ? 0 : (i >= n_dirs ? n_dirs - 1 : i));
    L.w[k] = outside ? __int_as_float(0x7fc00000) : table_w[3 * row + k];
  }
  L.itd = phase_synth ? sum3(L.w[0], itds[L.idx[0]], L.w[1], itds[L.idx[1]],
                             L.w[2], itds[L.idx[2]])
                      : 0.0f;
  return L;
}

// the interpolated (re, im) HRTF of one ear at hybrid band b; ri: (nDirs,
// 2, 133) (re, im) pairs, mag: (nDirs, 2, 133)
template <bool PS>
__device__ __forceinline__ float2 hrtf(const float2* __restrict__ ri,
                                       const float* __restrict__ mag,
                                       const float* __restrict__ freqs,
                                       const Lookup& L, int ear, int b) {
  const int e = ear * NB_HYB + b;
  const int o0 = L.idx[0] * EARS * NB_HYB + e;
  const int o1 = L.idx[1] * EARS * NB_HYB + e;
  const int o2 = L.idx[2] * EARS * NB_HYB + e;
  if (!PS) {
    const float2 a0 = __ldg(ri + o0), a1 = __ldg(ri + o1), a2 = __ldg(ri + o2);
    return make_float2(sum3(L.w[0], a0.x, L.w[1], a1.x, L.w[2], a2.x),
                       sum3(L.w[0], a0.y, L.w[1], a1.y, L.w[2], a2.y));
  }
  // INTERP_TRI_PS: magnitude times the phase of half the interpolated IPD
  // below 1.5 kHz, +IPD/2 on the left ear and -IPD/2 on the right
  const float m = sum3(L.w[0], __ldg(mag + o0), L.w[1], __ldg(mag + o1),
                       L.w[2], __ldg(mag + o2));
  const float f = __ldg(freqs + b);
  float ipd = __fadd_rn(__fmul_rn(__fmul_rn(TWO_PI_F, f), L.itd), PI_F);
  ipd = __fdiv_rn(__fsub_rn(remainder(ipd, TWO_PI_F), PI_F), 2.0f);
  if (!(f < 1.5e3f)) ipd = 0.0f;
  const float ph = ear == 0 ? ipd : -ipd;
  return make_float2(__fmul_rn(m, cosf(ph)), __fmul_rn(m, sinf(ph)));
}

template <bool PS>
__global__ void __launch_bounds__(THREADS)
    hrtf_taps(const float* __restrict__ dirs, const float* __restrict__ ypr,
              const float2* __restrict__ ri, const float* __restrict__ mag,
              const float* __restrict__ table_w,
              const long long* __restrict__ table_idx,
              const float* __restrict__ itds,
              const float* __restrict__ freqs, float* __restrict__ taps,
              int n_pairs, int n_src, int n_dirs, int n_table, int n_azi,
              float azi_res, float elev_res) {
  __shared__ Lookup look[PAIRS];
  __shared__ __align__(16) float out_s[PAIRS * PAIR_FLOATS];
  const int p0 = blockIdx.x * PAIRS;
  const int np = min(PAIRS, n_pairs - p0);
  if (threadIdx.x < np)
    look[threadIdx.x] = lookup(dirs, ypr, table_w, table_idx, itds,
                               p0 + threadIdx.x, n_src, n_dirs, n_table,
                               n_azi, azi_res, elev_res, PS);
  __syncthreads();
  for (int i = threadIdx.x; i < np * ITEMS; i += THREADS) {
    const int q = i / ITEMS, r = i % ITEMS;
    const int ear = r / NU, u = r % NU;
    const Lookup& L = look[q];
    float2 A, B;
    if (u >= 1 && u <= 4) {
      // a split band: the mean and the signed half-difference of its two
      // hybrid halves, s = [-1, 1, -1, 1]
      const float2 lo = hrtf<PS>(ri, mag, freqs, L, ear, 2 * u - 1);
      const float2 hi = hrtf<PS>(ri, mag, freqs, L, ear, 2 * u);
      const float s = (u & 1) ? -1.0f : 1.0f;
      A = make_float2(__fmul_rn(0.5f, __fadd_rn(lo.x, hi.x)),
                      __fmul_rn(0.5f, __fadd_rn(lo.y, hi.y)));
      B = make_float2(__fmul_rn(s, __fsub_rn(lo.x, hi.x)),
                      __fmul_rn(s, __fsub_rn(lo.y, hi.y)));
    } else {
      A = hrtf<PS>(ri, mag, freqs, L, ear, u == 0 ? 0 : u + 4);
      B = make_float2(0.0f, 0.0f);
    }
    float* o = out_s + q * PAIR_FLOATS + ear * 4 * NU + u;
    o[0] = A.x;
    o[NU] = A.y;
    o[2 * NU] = B.x;
    o[3 * NU] = B.y;
  }
  __syncthreads();
  // the block's pairs are one run of taps, 16-byte aligned (4,128 B a pair)
  float4* out = reinterpret_cast<float4*>(taps + (size_t)p0 * PAIR_FLOATS);
  const float4* in = reinterpret_cast<const float4*>(out_s);
  for (int i = threadIdx.x; i < np * (PAIR_FLOATS / 4); i += THREADS)
    out[i] = in[i];
}

}  // namespace

// C interface, loaded with ctypes.  Launches on `stream` and returns the
// CUDA error code (0 = success); allocates nothing.  dirs (S, nSrc, 2)
// degrees; ypr (S, 3) radians, or null for no rotation; ri (nDirs, 2, 133,
// 2) and mag (nDirs, 2, 133) the direction-major HRTFs; table_w /
// table_idx (n_table, 3); itds (nDirs,); freqs (133,); taps (S, nSrc, 2, 4,
// 129), 16-byte aligned.
extern "C" int saf_hrtf_taps_ri(const float* dirs, const float* ypr,
                                const float* ri, const float* mag,
                                const float* table_w,
                                const long long* table_idx, const float* itds,
                                const float* freqs, float* taps,
                                int n_streams, int n_src, int n_dirs,
                                int n_table, int n_azi, float azi_res,
                                float elev_res, int phase_synth,
                                void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long n_pairs = (long long)n_streams * n_src;
  if (n_pairs < 1 || n_pairs > INT_MAX - PAIRS || n_dirs < 1 || n_table < 1)
    return (int)cudaErrorInvalidValue;
  const int blocks = (int)((n_pairs + PAIRS - 1) / PAIRS);
  const float2* ri2 = reinterpret_cast<const float2*>(ri);
  if (phase_synth)
    hrtf_taps<true><<<blocks, THREADS, 0, st>>>(
        dirs, ypr, ri2, mag, table_w, table_idx, itds, freqs, taps,
        (int)n_pairs, n_src, n_dirs, n_table, n_azi, azi_res, elev_res);
  else
    hrtf_taps<false><<<blocks, THREADS, 0, st>>>(
        dirs, ypr, ri2, mag, table_w, table_idx, itds, freqs, taps,
        (int)n_pairs, n_src, n_dirs, n_table, n_azi, azi_res, elev_res);
  return (int)cudaGetLastError();
}
