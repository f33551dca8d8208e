// Device code shared by the port's afSTFT kernels (hop 128, 129 uniform
// bands, 10-hop prototype): the input-hop load, the analysis window fold,
// one band's rDFT over a run of frames, and the synthesis window /
// overlap-add / tail-merge launch.
//
// Included by render_full_ri.cu, analysis_front_ri.cu and
// synthesis_back_ri.cu.  Everything here has internal linkage, so each
// translation unit keeps its own copy.
#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int HOP = 128;
constexpr int NB = HOP + 1;           // uniform bands
constexpr int FRAME = 2 * HOP;        // folded frame length
constexpr int TOTAL_HOPS = 10;        // prototype length in hops
constexpr int NT = TOTAL_HOPS - 1;    // overlap-add tail hops

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
