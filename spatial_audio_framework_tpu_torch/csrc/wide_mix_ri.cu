// The wide TF-matrix render's glue for Hopper (sm_90a): the hybrid
// filterbank's forward stage and the per-band mixing matrix, from the
// analysis front's spectra straight into the packed rows the synthesis
// back end reads.
//
// Replaces: no TPU kernel.  On the TPU this is XLA's work between the two
// filterbank kernels of `render_tf_matrix_ri` past 128 channel pairs
// (`_hybrid_forward_ri_packed` and the per-band `jnp.einsum` in
// spatial_audio_framework_tpu/ops/afstft_ri.py); the plain PyTorch version,
// that same composition, is `wide_mix_ri_reference` in
// spatial_audio_framework_tpu_torch/ops/afstft_kernels.py.
//
// What it computes, for stream s, output channel e, hop h < H and band b
// (NBH = 133 hybrid bands, 129 for a non-hybrid bank):
//   1. the band's input from the front's uniform-bin spectra
//      s_c[h'][k] (re, im), (S*cin, H+6, 129) each: hybrid band 0 is
//      s[h+3][0] and bands 9..132 are s[h+3][b-4]; bands 1..8 are the two
//      halves of uniform bins k = 1..4, 0.5 s[h+3][k] +- sigma_k j (C1
//      (s[h+6] - s[h]) + C2 (s[h+4] - s[h+2]))[k] with sigma = [-1, 1, -1,
//      1] (`_hybrid_segments_ri`); a non-hybrid bank's band b is
//      s[h+6][b];
//   2. y[s, e, h, b] = sum_c M[b][e][c] x_c[b], M real or complex, shared
//      (NBH, cout, cin) or per stream (S, NBH, cout, cin);
//   3. written as the packed row [re | im] of (S*cout, H, 2*NBH): the rows
//      `synthesis_back_ri` reads.
// All arithmetic is fp32 FMA, no TF32; the sums over c run in channel
// order, where the plain version's matrix product may take another.
//
// What bounds it on the H100: at the benchmark's wide cell (1024 streams,
// 16 -> 22, H = 64) it must read the front's spectra once, 1,183.6 MB, and
// write the packed mix once, 1,534.1 MB: 0.811 ms at 3.35 TB/s.  The mix
// is ~6 G fp32 FMAs.
//
// Two kernels, one per form of the matrix, each adapting to the shapes
// (the entry picks by the matrix's form, cin and H, never by a model):
//   * wide_mix_real, a shared real matrix of at most 16 inputs and 96
//     outputs and H % 4 == 0 (every Ambisonic decoder of order <= 3 to a
//     loudspeaker layout, the benchmark's cell): a thread holds its band's
//     matrix entries for 4 outputs in registers, so the mix reads no
//     matrix from shared memory; a block of 13 warps takes 12 outputs of a
//     run of units (stream, 4 hops), stages each unit whole (every input's
//     4 rows, both parts, one contiguous span each) a unit ahead, and
//     writes each output's 4 rows, contiguous, with 16-byte stores from
//     shared memory.  The split bands 1..8 have a warp of their own,
//     reading inputs made once a unit, so no mixing warp branches.  The
//     blocks of a unit form a cluster: each copies its share of the spans
//     to all of them with one multicast bulk copy (TMA) a span, so every
//     span leaves L2 once (1.41 -> 1.33 ms at the cell, where two blocks
//     share a unit); a lone block copies in 16-byte cp.async chunks, which
//     beat its bulk copies (0.73 against 0.80 ms, 11 outputs).
//   * wide_mix, any matrix (complex, per stream, any cin): a block of 12
//     warps holds the matrix of a group of bands for all outputs and
//     inputs in shared memory and stages only those bands' bins of each
//     unit (stream, hop class, tile of 16 hops) in 16-byte chunks, 1..3
//     units ahead (a producer warp's bulk copies of the 50-300-byte
//     segments took 1.4-2.8x longer).  A lane is a position of a row: a
//     warp takes a 32-float window of the rows shifted by the row's offset
//     within its sector, so every store writes whole 32-byte sectors
//     (stores that straddle sectors ran at ~0.8 TB/s on an H100, whole
//     sectors at ~3 TB/s), for the four rows h, h+4, h+8, h+12 (one offset
//     when H % 4 == 0; other H are right, with part-sector stores), each
//     matrix entry read from shared memory serving four FMAs.
// Both plan their grid from the shapes and the card (SM count, clusters it
// holds at once), so that every SM gets a block whatever the batch.
// Measured on an H100 (80 GB HBM3, 700 W): 1.33 ms at the cell, 61 % of its
// byte bound; the non-hybrid bank's 1.19 ms says the split bands' context
// costs ~0.15 ms of it.

#include <cuda_runtime.h>

#include <cstdint>

#include "afstft_common.cuh"

namespace {

// -- shared by both kernels --------------------------------------------------

constexpr int SMEM_MAX = 227 * 1024;

// a band's uniform bin, and for the split hybrid bands 1..8 the sign of
// the hybrid FIR's term (0 for a band that is a uniform bin as it is)
struct Source {
  int k;
  float sigma;
};

template <bool HYBRID>
__host__ __device__ __forceinline__ Source band_source(int b) {
  if (!HYBRID) return {b, 0.f};
  if (b == 0) return {0, 0.f};
  if (b >= 9) return {b - 4, 0.f};
  const int k = (b + 1) >> 1;
  const float s = (k & 1) ? -1.f : 1.f;       // [-1, 1, -1, 1] over k
  return {k, (b & 1) ? s : -s};               // odd b: the low half
}

// the 16-byte chunks of floats [a, a + n) of a 16-byte aligned array: the
// first chunk's float and the bytes
struct Span {
  size_t a0;
  uint32_t bytes;
};
__device__ __forceinline__ Span span16(size_t a, int n) {
  const size_t a0 = a & ~size_t(3);
  return {a0, static_cast<uint32_t>((((a + n + 3) >> 2) - (a >> 2)) * 16)};
}

__host__ __device__ constexpr int round4(int n) { return (n + 3) / 4 * 4; }


// -- mbarriers, multicast bulk copies, the cluster ---------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(count));
}

__device__ __forceinline__ void mbar_arrive_expect(uint64_t* bar,
                                                   uint32_t bytes) {
  asm volatile(
      "{\n.reg .b64 st;\n"
      "mbarrier.arrive.expect_tx.shared::cta.b64 st, [%0], %1;\n}" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

// arrives on the barrier at bar's place in the shared memory of the
// cluster's block `rank`
__device__ __forceinline__ void mbar_arrive_remote(uint64_t* bar, int rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(remote)
               : "r"(smem_addr(bar)), "r"(rank));
  asm volatile(
      "mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];" ::"r"(
          remote)
      : "memory");
}

__device__ __forceinline__ bool mbar_test(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}"
      : "=r"(done)
      : "r"(smem_addr(bar)), "r"(parity)
      : "memory");
  return done != 0;
}

// waits for the phase of the given parity to complete; traps after ~10 s
// rather than hang the card if a count is ever wrong
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  if (mbar_test(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_test(bar, parity))
    if (clock64() - t0 > (1ll << 35)) __trap();
}

// bytes (a multiple of 16) from global memory to the same place in the
// shared memory of every block of the cluster in `mask`, each completing
// on its barrier at bar's place
__device__ __forceinline__ void bulk_copy_multicast(void* dst, const void* src,
                                                    uint32_t bytes,
                                                    uint64_t* bar,
                                                    uint16_t mask) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1], %2, [%3], %4;" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar)), "h"(mask)
      : "memory");
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;" ::
          : "memory");
}

// -- wide_mix: any matrix ----------------------------------------------------

constexpr int P = 4;                  // rows a lane: h, h+4, h+8, h+12
constexpr int HT = 4 * P;             // hops a tile: 4 classes of P rows
constexpr int NCW = 12;               // warps
constexpr int THREADS = 32 * NCW;
constexpr int EC_MAX = 12;            // outputs a lane
constexpr int CTX = 2 * 10 * 8;       // context floats a channel: part,
                                      // hops hb + 0, 2, .., 18, and the
                                      // 16-byte chunks holding bins 1..4
constexpr int SPLIT = P * 2 * 8;      // the split bands' inputs a channel:
                                      // [p][part][band 1..8]
constexpr int MAX_STAGES = 4;

template <int EC>
__device__ __forceinline__ void load_row(float (&w)[EC], const float* p) {
  if constexpr (EC % 4 == 0) {
#pragma unroll
    for (int i = 0; i < EC / 4; ++i) {
      const float4 v = reinterpret_cast<const float4*>(p)[i];
      w[4 * i] = v.x;
      w[4 * i + 1] = v.y;
      w[4 * i + 2] = v.z;
      w[4 * i + 3] = v.w;
    }
  } else if constexpr (EC == 2) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    w[0] = v.x;
    w[1] = v.y;
  } else {
    w[0] = p[0];
  }
}

// Shapes of one launch: outputs a lane (EC) and e-groups, bands a block's
// group (bg) and the groups, floats a staged row segment (segp), stages,
// and units of work a block (upb) over nby rows of blocks.
struct Plan {
  int ec, n_eg, bg, ng, segp, ns, upb, nby;
  size_t smem;
};

// floats of a stage: the row segments [c][p][part][segp], then for a
// hybrid bank the split bands' context [c][part][hop][8] and inputs
__host__ __device__ inline int stage_floats(int cin, int segp, bool hybrid) {
  return cin * P * 2 * segp + (hybrid ? cin * (CTX + SPLIT) : 0);
}
__host__ __device__ inline int matrix_floats(int cin, int ect, int bg) {
  return round4(cin * ect * bg);
}

bool make_plan(int S, int cin, int cout, int H, bool complex_m, bool hybrid,
               int sms, Plan& pl) {
  const int nbh = hybrid ? NB + 4 : NB;
  const int mf = complex_m ? 2 : 1;
  pl.n_eg = (cout + EC_MAX - 1) / EC_MAX;
  const int need = (cout + pl.n_eg - 1) / pl.n_eg;
  pl.ec = need <= 1 ? 1 : need <= 2 ? 2 : need <= 4 ? 4 : need <= 8 ? 8 : 12;
  const int ect = pl.n_eg * pl.ec;
  bool found = false;
  for (int ng = 1; ng <= nbh && !found; ++ng) {
    const int bg = (nbh + ng - 1) / ng;
    if (ng > 1 && bg == (nbh + ng - 2) / (ng - 1)) continue;   // same groups
    const int segp = round4(bg + 3);
    const size_t stage = stage_floats(cin, segp, hybrid);
    const size_t mat = (size_t)mf * matrix_floats(cin, ect, bg);
    for (int ns = MAX_STAGES; ns >= 2; --ns) {
      const size_t smem = (mat + ns * stage) * 4;
      if (smem <= SMEM_MAX) {
        pl.bg = bg;
        pl.ng = (nbh + bg - 1) / bg;
        pl.segp = segp;
        pl.ns = ns;
        pl.smem = smem;
        found = true;
        break;
      }
    }
  }
  if (!found) return false;
  // units: (stream, hop class, tile of HT hops); every SM a block
  const long long units = (long long)S * 4 * ((H + HT - 1) / HT);
  const int rows = sms / pl.ng > 1 ? sms / pl.ng : 1;
  const long long upb = (units + rows - 1) / rows;
  if (upb > (1ll << 30)) return false;
  pl.upb = (int)upb;
  pl.nby = (int)((units + upb - 1) / upb);
  return true;
}

template <bool COMPLEX, bool PER_STREAM, bool HYBRID, int EC>
__global__ void __launch_bounds__(THREADS, 1)
wide_mix(const float* __restrict__ sre,   // (S*cin, H+6, NB)
         const float* __restrict__ sim,
         const float* __restrict__ mre,   // ([S,] NBH, cout, cin)
         const float* __restrict__ mim,
         float* __restrict__ out,         // (S*cout, H, 2*NBH)
         int S, int cin, int cout, int H, int n_eg, int bg, int segp, int ns,
         int upb) {
  constexpr int NBH = HYBRID ? NB + 4 : NB;
  constexpr int RL = 2 * NBH;           // an output row: [re | im]
  constexpr int OFF = HYBRID ? 3 : 6;   // hop of a band's direct input
  constexpr int NP = COMPLEX ? 2 : 1;   // input parts a lane reads
  extern __shared__ float4 smem4[];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int He = H + 6;
  const int b_lo = blockIdx.x * bg, b_hi = min(NBH, b_lo + bg);
  const int klo = band_source<HYBRID>(b_lo).k;
  const int nbin = band_source<HYBRID>(b_hi - 1).k - klo + 1;
  const bool has_ctx = HYBRID && b_lo <= 8 && b_hi > 1;
  const int ect = n_eg * EC;
  const int mat = matrix_floats(cin, ect, bg);
  const int stage_f = stage_floats(cin, segp, HYBRID);
  const int seg_f = cin * P * 2 * segp;   // the stage's row segments
  float* ms = reinterpret_cast<float*>(smem4);   // [part][c][eg][bl][e]
  float* stages = ms + (COMPLEX ? 2 : 1) * mat;

  const int ups = 4 * ((H + HT - 1) / HT);   // units a stream
  const long long n_units = (long long)S * ups;
  const long long u0 = (long long)blockIdx.y * upb;
  const long long u1 = min(n_units, u0 + upb);
  // unit u: stream s, first hop hb (class hb & 3, rows hb + 4p); a unit
  // with hb >= H (H < 4) is empty
  auto unit = [&](long long u, int& s, int& hb) {
    s = (int)(u / ups);
    const int r = (int)(u - (long long)s * ups);
    hb = (r >> 2) * HT + (r & 3);
  };

  // the matrix of the group's bands for stream sb (any stream when
  // shared), read in its own order (c fastest)
  auto stage_matrix = [&](int sb) {
    const size_t base = PER_STREAM ? (size_t)sb * NBH * cout * cin : 0;
    const int n = (b_hi - b_lo) * cout * cin;
    for (int i = tid; i < n; i += THREADS) {
      const int c = i % cin, q = i / cin, e = q % cout, bl = q / cout;
      const size_t si = base + ((size_t)(b_lo + bl) * cout + e) * cin + c;
      const int d = ((c * n_eg + e / EC) * bg + bl) * EC + e % EC;
      ms[d] = mre[si];
      if (COMPLEX) ms[mat + d] = mim[si];
    }
  };

  // the copies of unit u into stage st: its row segments (bins klo ..
  // klo+nbin-1 of hops hb+4p+OFF, both parts, every channel) in 16-byte
  // chunks, [c][p][part][segp], and for a group with split bands their
  // context (bins 1..4 of hops hb, hb+2, .., hb+18), [c][part][hop][8]
  auto load = [&](long long u, int st) {
    int s, hb;
    unit(u, s, hb);
    if (hb >= H) return;
    float* dst = stages + st * stage_f;
    const size_t row0 = (size_t)s * cin * He + hb;   // (s, c = 0, hb)
    const int ch = segp >> 2;
    for (int idx = tid; idx < cin * P * 2 * ch; idx += THREADS) {
      const int i = idx / ch, j = idx - i * ch;
      const int c = i / (2 * P), p = (i >> 1) % P, part = i & 1;
      if (hb + 4 * p < H) {
        const Span sp =
            span16((row0 + (size_t)c * He + 4 * p + OFF) * NB + klo, nbin);
        if (j * 16 < (int)sp.bytes)
          cp_async16(dst + i * segp + 4 * j,
                     (part ? sim : sre) + sp.a0 + 4 * j, 16);
      }
    }
    if (has_ctx)
      for (int idx = tid; idx < cin * 40; idx += THREADS) {
        const int i = idx >> 1, half = idx & 1;
        const int c = i / 20, part = (i % 20) / 10, hi = i % 10;
        if (hb + 2 * hi < He) {
          const Span sp =
              span16((row0 + (size_t)c * He + 2 * hi) * NB + 1, 4);
          if (half * 16 < (int)sp.bytes)
            cp_async16(dst + seg_f + i * 8 + 4 * half,
                       (part ? sim : sre) + sp.a0 + 4 * half, 16);
        }
      }
  };

  if (!PER_STREAM) stage_matrix(0);
  for (int k = 0; k < ns - 1; ++k) {
    if (u0 + k < u1) load(u0 + k, k);
    cp_async_commit();
  }
  int t = 0, m_stream = -1;
  for (long long u = u0; u < u1; ++u, ++t) {
    if (u + ns - 1 < u1) load(u + ns - 1, (t + ns - 1) % ns);
    cp_async_commit();
    switch (ns) {                       // this unit's copies have landed
      case 2: cp_async_wait<1>(); break;
      case 3: cp_async_wait<2>(); break;
      default: cp_async_wait<3>();
    }
    int s, hb;
    unit(u, s, hb);
    if (PER_STREAM && s != m_stream) {
      stage_matrix(s);
      m_stream = s;
    }
    __syncthreads();
    const float* x0 = stages + (t % ns) * stage_f;
    if (hb < H) {
      const int hc = hb & 3;
      const int r4 = (int)(((size_t)s * cin * He + hb) & 3);   // (s, 0, hb)
      float* split = const_cast<float*>(x0) + seg_f + cin * CTX;
      if (has_ctx) {
        // the split bands' inputs, once a unit, [c][p][part][band 1..8]:
        // 0.5 d +- j (C1 (s[h+6] - s[h]) + C2 (s[h+4] - s[h+2]))
        for (int i = tid; i < cin * SPLIT; i += THREADS) {
          const int c = i / SPLIT, p = (i / 16) % P, part = (i >> 3) & 1;
          const Source src = band_source<HYBRID>((i & 7) + 1);
          const int rc = (r4 + c * (He & 3)) & 3;
          float v = 0.f;
          if (src.k >= klo && src.k < klo + nbin) {
            v = x0[c * (P * 2 * segp) + (2 * p + part) * segp +
                   ((rc + OFF + klo) & 3) + src.k - klo];
            const float* cx = x0 + seg_f + c * CTX + src.k - 1;
            auto f = [&](int pp, int hi) {
              return cx[(pp * 10 + hi) * 8 + ((rc + hi * 2 + 1) & 3)];
            };
            auto inner = [&](int pp) {
              return COEFF1 * (f(pp, 2 * p + 3) - f(pp, 2 * p)) +
                     COEFF2 * (f(pp, 2 * p + 2) - f(pp, 2 * p + 1));
            };
            v = part ? 0.5f * v + src.sigma * inner(0)
                     : 0.5f * v - src.sigma * inner(1);
          }
          split[i] = v;
        }
        __syncthreads();
      }
      // a window's first position lies on a sector boundary of its rows:
      // row r (r = hc mod 4 when H % 4 == 0) begins at float RL r = 2 hc
      // mod 8; a unit's items are its windows of the group's positions,
      // each in the e-groups of EC outputs
      const int lo0 = b_lo, hi0 = b_hi, lo1 = NBH + b_lo, hi1 = NBH + b_hi;
      const int w0 = lo0 - ((lo0 + 2 * hc) & 7);
      const int w1 = lo1 - ((lo1 + 2 * hc) & 7);
      const int nw0 = (hi0 - w0 + 31) >> 5, nw1 = (hi1 - w1 + 31) >> 5;
      const int items = (nw0 + nw1) * n_eg;
      for (int it = warp; it < items; it += NCW) {
        const int eg = it % n_eg, wi = it / n_eg;
        const int pt = wi >= nw0;
        const int q = (pt ? w1 + 32 * (wi - nw0) : w0 + 32 * wi) + lane;
        if (q < (pt ? lo1 : lo0) || q >= (pt ? hi1 : hi0)) continue;
        const int b = q - pt * NBH, bl = b - b_lo;
        // a lane reads its inputs from the row segments, or a split band's
        // from the unit's split inputs
        const bool sp = HYBRID && b >= 1 && b <= 8;
        const float* xb =
            sp ? split + b - 1 : x0 + band_source<HYBRID>(b).k - klo;
        const int sc = sp ? SPLIT : P * 2 * segp, spp = sp ? 8 : segp;
        const int shm = sp ? 0 : 3;
        float acc[EC][P];
#pragma unroll
        for (int e = 0; e < EC; ++e)
#pragma unroll
          for (int p = 0; p < P; ++p) acc[e][p] = 0.f;
        int rc = r4;                    // row (s, c, hb) mod 4
        for (int c = 0; c < cin; ++c, rc = (rc + He) & 3) {
          // segment (c, p, part) starts 16-byte aligned at float A & ~3
          // of the spectra, A = row (c, hb + 4p + OFF) * NB + klo; A mod 4
          // is the same for every p
          const float* xs = xb + c * sc + ((rc + OFF + klo) & shm);
          float x[P][NP];
#pragma unroll
          for (int p = 0; p < P; ++p)
#pragma unroll
            for (int part = 0; part < NP; ++part)
              x[p][part] = xs[(2 * p + (COMPLEX ? part : pt)) * spp];
          const int mo = ((c * n_eg + eg) * bg + bl) * EC;
          float w[EC];
          load_row<EC>(w, ms + mo);
          if (COMPLEX) {
            // re: Mre x_re - Mim x_im; im: Mre x_im + Mim x_re
            float wi_[EC];
            load_row<EC>(wi_, ms + mat + mo);
#pragma unroll
            for (int e = 0; e < EC; ++e) {
              const float wo = pt ? wi_[e] : -wi_[e];
#pragma unroll
              for (int p = 0; p < P; ++p) {
                const float xs_ = pt ? x[p][NP - 1] : x[p][0];
                const float xo = pt ? x[p][0] : x[p][NP - 1];
                acc[e][p] = fmaf(w[e], xs_, acc[e][p]);
                acc[e][p] = fmaf(wo, xo, acc[e][p]);
              }
            }
          } else {
#pragma unroll
            for (int e = 0; e < EC; ++e)
#pragma unroll
              for (int p = 0; p < P; ++p)
                acc[e][p] = fmaf(w[e], x[p][0], acc[e][p]);
          }
        }
        const int nec = min(EC, cout - eg * EC);
        float* o = out + ((size_t)(s * cout + eg * EC) * H + hb) * RL + q;
#pragma unroll
        for (int e = 0; e < EC; ++e) {
          if (e < nec) {
#pragma unroll
            for (int p = 0; p < P; ++p)
              if (hb + 4 * p < H) o[((size_t)e * H + 4 * p) * RL] = acc[e][p];
          }
        }
      }
    }
    // every thread is done with the stage (and the matrix) before it is
    // refilled
    __syncthreads();
  }
}

// -- wide_mix_real: a shared real matrix of at most 16 inputs --------------

namespace zr {
constexpr int HR = 4;               // hops a unit: rows hb .. hb + 3
constexpr int CIN = 16;             // inputs a thread's registers hold
constexpr int EG = 4;               // outputs a thread
constexpr int NEG = 3;              // output groups a block
constexpr int EB = EG * NEG;        // outputs a block
constexpr int NS = 2;               // input stages
constexpr int MW = 13;              // warps: 12 for the bands that are a
                                    // uniform bin as it is, the last for
                                    // the split bands 1..8
constexpr int ZT = 32 * MW;
constexpr int RAWP = round4(HR * NB + 3);   // floats of a staged (c, part)
constexpr int CTXH = HR + 6;        // context hops hb .. hb + HR + 5
static_assert(32 * 12 >= (NB - 4) * NEG && 32 >= 8 * NEG, "bands fit");
static_assert(ZT >= NB * NEG, "a non-hybrid bank's bands fit");

template <bool HYBRID>
struct Geo {
  static constexpr int NBH = HYBRID ? NB + 4 : NB;
  static constexpr int RL = 2 * NBH;
  static constexpr int RAW = NS * CIN * 2 * RAWP;
  static constexpr int CTX = HYBRID ? NS * CIN * 2 * CTXH * 8 : 0;
  static constexpr int SPL = HYBRID ? CIN * 2 * HR * 8 : 0;   // split
  static constexpr int OUT = EB * HR * RL;
  static constexpr size_t SMEM =
      (size_t)(RAW + CTX + SPL + OUT) * 4 + 2 * NS * sizeof(uint64_t);
  static_assert(SMEM <= SMEM_MAX, "fits shared memory");
};
}  // namespace zr

template <bool HYBRID, bool MC>
__global__ void __launch_bounds__(zr::ZT, 1)
wide_mix_real(const float* __restrict__ sre, const float* __restrict__ sim,
              const float* __restrict__ mre, float* __restrict__ out, int S,
              int cin, int cout, int H, int upb) {
  using namespace zr;
  using G = Geo<HYBRID>;
  constexpr int NBH = G::NBH, RL = G::RL;
  constexpr int OFF = HYBRID ? 3 : 6;
  extern __shared__ float4 smem4[];
  float* raw = reinterpret_cast<float*>(smem4);    // [NS][c][part][RAWP]
  float* ctx = raw + G::RAW;                       // [NS][c][part][hop][8]
  float* split = ctx + G::CTX;                     // [c][part][h][8]
  float* ob = split + G::SPL;                      // [e][h][RL]
  uint64_t* full = reinterpret_cast<uint64_t*>(ob + G::OUT);
  uint64_t* empty = full + NS;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int He = H + 6, upsr = H / HR, hm = He & 3;
  const int e0 = blockIdx.x * EB, ne = min(EB, cout - e0);
  const int nx = gridDim.x, rank = blockIdx.x;     // the cluster: a row
  const long long n_units = (long long)S * upsr;
  const long long u0 = (long long)blockIdx.y * upb;
  const long long u1 = min(n_units, u0 + upb);
  // a thread's band and output group: warps 0..11 the bands that are a
  // uniform bin as it is, the last warp the split bands
  int b = 0, g = NEG;
  if (HYBRID && warp < 12) {
    const int j = tid % (NB - 4);
    b = j ? j + 8 : 0;
    g = tid < (NB - 4) * NEG ? tid / (NB - 4) : NEG;
  } else if (HYBRID) {
    b = lane % 8 + 1;
    g = lane < 8 * NEG ? lane / 8 : NEG;
  } else {
    b = tid % NB;
    g = tid < NB * NEG ? tid / NB : NEG;
  }
  const bool active = g < NEG;

  float w[EG][CIN];
#pragma unroll
  for (int e = 0; e < EG; ++e) {
    const int ge = e0 + g * EG + e;
#pragma unroll
    for (int c = 0; c < CIN; ++c)
      w[e][c] = active && ge < cout && c < cin
                    ? mre[((size_t)b * cout + ge) * cin + c]
                    : 0.f;
  }
  // the inputs past cin stay zero (their matrix entries are zero too)
  for (int i = tid; i < (CIN - cin) * 2 * RAWP; i += ZT)
    for (int k = 0; k < NS; ++k) raw[(k * CIN + cin) * 2 * RAWP + i] = 0.f;
  for (int i = cin * 2 * HR * 8 + tid; i < G::SPL; i += ZT) split[i] = 0.f;

  // the copies of unit u (stream s, hops hb .. hb + HR - 1) into stage st:
  // each input's HR rows, both parts, one span each; for a hybrid bank the
  // context, bins 1..4 of hops hb .. hb + HR + 5
  auto load = [&](long long u, int st) {
    const int s = (int)(u / upsr), hb = (int)(u - (long long)s * upsr) * HR;
    const size_t r0 = (size_t)s * cin * He + hb;   // row (s, c = 0, hb)
    if (MC) {
      // the rows: every block of the cluster copies its share to all
      if (warp == 0) {
        uint32_t bytes = 0;
        for (int r = lane; r < 2 * cin; r += 32)
          bytes += span16((r0 + (size_t)(r >> 1) * He + OFF) * NB, HR * NB)
                       .bytes;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          bytes += __shfl_xor_sync(0xffffffffu, bytes, o);
        if (lane == 0) mbar_arrive_expect(&full[st], bytes);
        __syncwarp();
        for (int r = rank + nx * lane; r < 2 * cin; r += nx * 32) {
          const int c = r >> 1, part = r & 1;
          const Span sp = span16((r0 + (size_t)c * He + OFF) * NB, HR * NB);
          bulk_copy_multicast(raw + ((st * CIN + c) * 2 + part) * RAWP,
                              (part ? sim : sre) + sp.a0, sp.bytes, &full[st],
                              (uint16_t)((1u << nx) - 1));
        }
      }
    } else
    for (int i = tid; i < 2 * cin * (RAWP / 4); i += ZT) {
      const int r = i / (RAWP / 4), j = i - r * (RAWP / 4);
      const int c = r >> 1, part = r & 1;
      const Span sp = span16((r0 + (size_t)c * He + OFF) * NB, HR * NB);
      if (j * 16 < (int)sp.bytes)
        cp_async16(raw + ((st * CIN + c) * 2 + part) * RAWP + 4 * j,
                   (part ? sim : sre) + sp.a0 + 4 * j, 16);
    }
    if (HYBRID)
      for (int i = tid; i < 2 * cin * CTXH * 2; i += ZT) {
        const int half = i & 1, q = i >> 1, hi = q % CTXH, r = q / CTXH;
        const int c = r >> 1, part = r & 1;
        const Span sp = span16((r0 + (size_t)c * He + hi) * NB + 1, 4);
        if (half * 16 < (int)sp.bytes)
          cp_async16(ctx + (((st * CIN + c) * 2 + part) * CTXH + hi) * 8 +
                         4 * half,
                     (part ? sim : sre) + sp.a0 + 4 * half, 16);
      }
    if (MC)
      asm volatile(
          "cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(
              smem_addr(&full[st]))
          : "memory");
  };

  // the split bands' inputs of unit u in stage st, [c][part][h][band 1..8]:
  // 0.5 d +- j (C1 (s[h+6] - s[h]) + C2 (s[h+4] - s[h+2]))
  auto split_inputs = [&](long long u, int st) {
    const int s = (int)(u / upsr), hb = (int)(u - (long long)s * upsr) * HR;
    const int rc0 = (int)(((size_t)s * cin * He + hb) & 3);
    for (int i = tid; i < cin * 2 * HR * 8; i += ZT) {
      const int c = i / (2 * HR * 8), part = (i / (HR * 8)) & 1;
      const int h = (i >> 3) % HR;
      const Source src = band_source<HYBRID>((i & 7) + 1);
      const int rc = (rc0 + c * hm) & 3;      // row (s, c, hb) mod 4
      const float d = raw[((st * CIN + c) * 2 + part) * RAWP +
                          ((rc + OFF) & 3) + h * NB + src.k];
      auto f = [&](int pp, int hi) {
        return ctx[(((st * CIN + c) * 2 + pp) * CTXH + hi) * 8 +
                   ((rc + hi + 1) & 3) + src.k - 1];
      };
      auto inner = [&](int pp) {
        return COEFF1 * (f(pp, h + 6) - f(pp, h)) +
               COEFF2 * (f(pp, h + 4) - f(pp, h + 2));
      };
      split[i] = part ? 0.5f * d + src.sigma * inner(0)
                      : 0.5f * d - src.sigma * inner(1);
    }
  };

  if (MC) {
    if (tid == 0) {
      for (int i = 0; i < NS; ++i) {
        mbar_init(&full[i], 1 + ZT);
        mbar_init(&empty[i], nx);
      }
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    cluster_sync();
  }
  for (int k = 0; k < NS - 1; ++k) {
    if (u0 + k < u1) load(u0 + k, k);
    cp_async_commit();
  }
  if (MC) {
    if (u0 < u1) mbar_wait(&full[0], 0);
  } else
  cp_async_wait<NS - 2>();
  __syncthreads();
  if (HYBRID && u0 < u1) split_inputs(u0, 0);
  __syncthreads();
  int t = 0;
  for (long long u = u0; u < u1; ++u, ++t) {
    // here the unit's rows and split inputs are in shared memory, and the
    // last unit's output has left it
    if (u + NS - 1 < u1) {
      const int v = t + NS - 1, sv = v % NS;
      // every block of the cluster is done with the stage's last unit
      if (MC && v >= NS) mbar_wait(&empty[sv], (v / NS - 1) & 1);
      load(u + NS - 1, sv);
    }
    cp_async_commit();
    const int st = t % NS;
    const int s = (int)(u / upsr), hb = (int)(u - (long long)s * upsr) * HR;
    const int rc0 = (int)(((size_t)s * cin * He + hb) & 3);

    // the mix: every thread its band's EG outputs at HR hops, both parts,
    // from the staged rows (the split bands' warp from their inputs)
    if (active) {
      float acc[EG][HR * 2];
#pragma unroll
      for (int e = 0; e < EG; ++e)
#pragma unroll
        for (int k = 0; k < HR * 2; ++k) acc[e][k] = 0.f;
      auto mix = [&](auto x_of) {
#pragma unroll
        for (int c = 0; c < CIN; ++c) {
          float x[HR * 2];
#pragma unroll
          for (int k = 0; k < HR * 2; ++k) x[k] = x_of(c, k & 1, k >> 1);
#pragma unroll
          for (int e = 0; e < EG; ++e)
#pragma unroll
            for (int k = 0; k < HR * 2; ++k)
              acc[e][k] = fmaf(w[e][c], x[k], acc[e][k]);
        }
      };
      if (HYBRID && warp == 12) {
        const float* xb = split + b - 1;
        mix([&](int c, int part, int h) {
          return xb[((c * 2 + part) * HR + h) * 8];
        });
      } else {
        const float* xb =
            raw + st * CIN * 2 * RAWP + band_source<HYBRID>(b).k;
        mix([&](int c, int part, int h) {
          // (c, part)'s span starts 16-byte aligned at float A & ~3 of the
          // spectra, A = row (s, c, hb + OFF) * NB
          return xb[(c * 2 + part) * RAWP + ((rc0 + c * hm + OFF) & 3) +
                    h * NB];
        });
      }
#pragma unroll
      for (int e = 0; e < EG; ++e)
#pragma unroll
        for (int k = 0; k < HR * 2; ++k)
          ob[((g * EG + e) * HR + (k >> 1)) * RL + (k & 1) * NBH + b] =
              acc[e][k];
    }
    if (MC) {
      if (u + 1 < u1) mbar_wait(&full[(t + 1) % NS], ((t + 1) / NS) & 1);
    } else
    cp_async_wait<NS - 2>();            // the next unit's rows
    __syncthreads();
    if (MC && tid < nx) mbar_arrive_remote(&empty[st], tid);
    // output e's rows (s, e, hb .. hb + HR - 1) are contiguous and start
    // 16-byte aligned for hb and H even: 16-byte stores; then the next
    // unit's split inputs
    {
      constexpr int C4 = HR * RL / 4;
      float* dst = out + ((size_t)(s * cout + e0) * H + hb) * RL;
      for (int i = tid; i < ne * C4; i += ZT) {
        const int e = i / C4, j = i - e * C4;
        reinterpret_cast<float4*>(dst + (size_t)e * H * RL)[j] =
            reinterpret_cast<const float4*>(ob + e * HR * RL)[j];
      }
    }
    if (HYBRID && u + 1 < u1) split_inputs(u + 1, (t + 1) % NS);
    __syncthreads();
  }
  // no block leaves while another may still write to its shared memory
  if (MC) cluster_sync();
}

template <bool HYBRID>
cudaError_t launch_real(const float* sre, const float* sim, const float* mre,
                        float* out, int S, int cin, int cout, int H, int sms,
                        cudaStream_t st) {
  using G = zr::Geo<HYBRID>;
  // blocks over (12 outputs, a run of units); every SM a block; the blocks
  // of a unit in one cluster, which copies each row once for all of them
  const int nx = (cout + zr::EB - 1) / zr::EB;
  const long long units = (long long)S * (H / zr::HR);
  auto kernel = nx > 1 ? wide_mix_real<HYBRID, true>
                       : wide_mix_real<HYBRID, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)G::SMEM);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(zr::ZT);
  cfg.dynamicSmemBytes = G::SMEM;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = nx;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int rows = sms / nx > 1 ? sms / nx : 1;
  if (nx > 1) {
    // as many rows as clusters the card holds at once
    int fit = 0;
    cfg.gridDim = dim3(nx, rows);
    err = cudaOccupancyMaxActiveClusters(&fit, kernel, &cfg);
    if (err != cudaSuccess) return err;
    if (fit < 1) return cudaErrorInvalidConfiguration;
    rows = fit < rows ? fit : rows;
  }
  const long long upb = (units + rows - 1) / rows;
  if (upb > (1ll << 30)) return cudaErrorInvalidValue;
  cfg.gridDim = dim3(nx, (int)((units + upb - 1) / upb));
  return cudaLaunchKernelEx(&cfg, kernel, sre, sim, mre, out, S, cin, cout, H,
                            (int)upb);
}

template <bool COMPLEX, bool PER_STREAM, bool HYBRID, int EC>
cudaError_t launch(const float* sre, const float* sim, const float* mre,
                   const float* mim, float* out, int S, int cin, int cout,
                   int H, const Plan& pl, cudaStream_t st) {
  auto kernel = wide_mix<COMPLEX, PER_STREAM, HYBRID, EC>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)pl.smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(pl.ng, pl.nby), THREADS, pl.smem, st>>>(
      sre, sim, mre, mim, out, S, cin, cout, H, pl.n_eg, pl.bg, pl.segp,
      pl.ns, pl.upb);
  return cudaGetLastError();
}

template <bool COMPLEX, bool PER_STREAM, bool HYBRID>
cudaError_t launch_ec(const float* sre, const float* sim, const float* mre,
                      const float* mim, float* out, int S, int cin, int cout,
                      int H, const Plan& pl, cudaStream_t st) {
  switch (pl.ec) {
    case 1:
      return launch<COMPLEX, PER_STREAM, HYBRID, 1>(sre, sim, mre, mim, out,
                                                    S, cin, cout, H, pl, st);
    case 2:
      return launch<COMPLEX, PER_STREAM, HYBRID, 2>(sre, sim, mre, mim, out,
                                                    S, cin, cout, H, pl, st);
    case 4:
      return launch<COMPLEX, PER_STREAM, HYBRID, 4>(sre, sim, mre, mim, out,
                                                    S, cin, cout, H, pl, st);
    case 8:
      return launch<COMPLEX, PER_STREAM, HYBRID, 8>(sre, sim, mre, mim, out,
                                                    S, cin, cout, H, pl, st);
    default:
      return launch<COMPLEX, PER_STREAM, HYBRID, 12>(sre, sim, mre, mim, out,
                                                     S, cin, cout, H, pl, st);
  }
}

template <bool COMPLEX, bool PER_STREAM>
cudaError_t launch_hyb(int hybrid, const float* sre, const float* sim,
                       const float* mre, const float* mim, float* out, int S,
                       int cin, int cout, int H, const Plan& pl,
                       cudaStream_t st) {
  return hybrid ? launch_ec<COMPLEX, PER_STREAM, true>(
                      sre, sim, mre, mim, out, S, cin, cout, H, pl, st)
                : launch_ec<COMPLEX, PER_STREAM, false>(
                      sre, sim, mre, mim, out, S, cin, cout, H, pl, st);
}

}  // namespace

// C interface, loaded with ctypes.  Launches on `stream` and returns the
// CUDA error code (0 = success); allocates nothing.  sre / sim (S*cin,
// H+6, 129) the front's spectra, 16-byte aligned; mre ([S,] NBH, cout,
// cin) with per_stream != 0 one matrix a stream, mim the same or null for
// a real matrix; out (S*cout, H, 2*NBH), NBH = 133 with hybrid != 0, else
// 129, 16-byte aligned.  cudaErrorInvalidValue where no plan fits shared
// memory (a complex matrix of more than ~140 inputs).
extern "C" int saf_wide_mix_ri(const float* sre, const float* sim,
                               const float* mre, const float* mim, float* out,
                               int S, int cin, int cout, int H, int hybrid,
                               int per_stream, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (S < 1 || cin < 1 || cout < 1 || H < 1)
    return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const bool complex_m = mim != nullptr;
  if (!complex_m && !per_stream && cin <= zr::CIN && H % zr::HR == 0 &&
      cout <= 8 * zr::EB)
    return (int)(hybrid ? launch_real<true>(sre, sim, mre, out, S, cin, cout,
                                            H, sms, st)
                        : launch_real<false>(sre, sim, mre, out, S, cin, cout,
                                             H, sms, st));
  Plan pl;
  if (!make_plan(S, cin, cout, H, complex_m, hybrid != 0, sms, pl))
    return (int)cudaErrorInvalidValue;
  if (complex_m)
    return (int)(per_stream
                     ? launch_hyb<true, true>(hybrid, sre, sim, mre, mim, out,
                                              S, cin, cout, H, pl, st)
                     : launch_hyb<true, false>(hybrid, sre, sim, mre, mim,
                                               out, S, cin, cout, H, pl, st));
  return (int)(per_stream
                   ? launch_hyb<false, true>(hybrid, sre, sim, mre, mim, out,
                                             S, cin, cout, H, pl, st)
                   : launch_hyb<false, false>(hybrid, sre, sim, mre, mim, out,
                                              S, cin, cout, H, pl, st));
}
