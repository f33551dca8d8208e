"""A numpy mirror of the CUDA kernels' FFT-based 256-point rDFT / irDFT
(``rdft256`` / ``irdft256`` in
``spatial_audio_framework_tpu_torch/csrc/afstft_common.cuh``), step for step:
one warp per frame, lane l holding four complex points v[0..3], the same
stages, register/lane bit swaps, shuffles, twiddle indices and split
formulas, and the host twiddle table (``ops/fft._fft256_twiddles``).

The mirror runs forward against ``numpy.fft.rfft`` and inverse against the
dense ``X.re @ A + X.im @ B`` of ``ops/fft._rdft_mats`` (the plain versions'
operators), on random frames and on impulses at every index, and the
kernels' fold + rDFT against the plain analysis front.  An index or
twiddle mistake in the schedule fails here rather than on the card.
Tolerance 1e-5 relative to the largest magnitude: float32 FFT rounding
is ~1e-6 of it.
"""
import numpy as np
import pytest
import torch

from spatial_audio_framework_tpu_torch.ops import afstft_kernels as tak
from spatial_audio_framework_tpu_torch.ops.fft import (_fft256_twiddles,
                                                       _rdft_mats)

TOL = 1e-5
LANE = np.arange(32)
TW = _fft256_twiddles()


def tw(idx):
    """W256^idx from the table, per lane (complex64)."""
    t = TW[idx]
    return (t[..., 0] + 1j * t[..., 1]).astype(np.complex64)


def fft_in_index(lane, r):
    """n of the point lane l holds in register r at the forward FFT's input
    (and the inverse FFT's output): z[n] = f[2n] + i f[2n+1]."""
    return 64 * (lane & 1) + 16 * r + 4 * ((lane >> 1) & 3) + (lane >> 3)


def shfl(v, src):
    """__shfl_sync: lane l receives v of lane src[l]."""
    return v[src]


def per_lane(a, like):
    """A per-lane array shaped to broadcast against ``like``, whose leading
    axes are a's and whose trailing axes (a batch of frames) are not."""
    return a.reshape(a.shape + (1,) * (like.ndim - a.ndim))


def radix2_lanes(V):
    """Radix-2 butterfly across lane bit 0: the lane with bit 0 clear keeps
    a + b, its partner a − b."""
    hi = per_lane((LANE & 1).astype(bool), V[:, 0])
    for r in range(4):
        o = shfl(V[:, r], LANE ^ 1)
        V[:, r] = np.where(hi, o - V[:, r], V[:, r] + o)


def dft4(V, inverse):
    a, b = V[:, 0] + V[:, 2], V[:, 0] - V[:, 2]
    c, d = V[:, 1] + V[:, 3], V[:, 1] - V[:, 3]
    jd = 1j * d
    V[:, 0], V[:, 2] = a + c, a - c
    V[:, 1], V[:, 3] = (b + jd, b - jd) if inverse else (b - jd, b + jd)


def twiddle(V, step, inverse):
    """v[q] *= W256^(step·q), q = 1..3 (conjugated for the inverse)."""
    for q in (1, 2, 3):
        w = per_lane(tw(step * q), V[:, q])
        V[:, q] = V[:, q] * (np.conj(w) if inverse else w)


def swap_bit(V, j, b):
    """Swap register bit j with lane bit b by one __shfl_xor_sync per pair
    of registers: the lane with lane bit b set sends its register with
    bit j clear and takes its partner's with bit j set, and vice versa."""
    beta = per_lane(((LANE >> b) & 1).astype(bool), V[:, 0])
    for r0 in range(4):
        if r0 >> j & 1:
            continue
        r1 = r0 | (1 << j)
        recv = shfl(np.where(beta, V[:, r0], V[:, r1]), LANE ^ (1 << b))
        V[:, r0] = np.where(beta, recv, V[:, r0])
        V[:, r1] = np.where(beta, V[:, r1], recv)


def fft128(V, inverse=False):
    """The 128-point complex FFT, unnormalised: forward from the input
    layout (fft_in_index) to Z[l + 32 r]; inverse (the adjoint schedule,
    conjugate twiddles) back."""
    stages = [(lambda: radix2_lanes(V)),
              (32 * (LANE & 1)), (lambda: (swap_bit(V, 0, 1), swap_bit(V, 1, 2))),
              (8 * (LANE & 7)), (lambda: (swap_bit(V, 0, 3), swap_bit(V, 1, 4))),
              (2 * LANE)]
    for st in (stages[::-1] if inverse else stages):
        if callable(st):
            st()
        elif inverse:
            dft4(V, True)
            twiddle(V, st, True)
        else:
            twiddle(V, st, False)
            dft4(V, False)


def partner(V, r):
    """Z[128 − k] for k = l + 32 r: lane (32 − l) & 31, register 3 − r;
    lane 0 reads its own register (4 − r) & 3."""
    p = shfl(V[:, 3 - r], (32 - LANE) & 31)
    p[0] = V[0, (4 - r) & 3]
    return p


LANE_BIN = LANE[:, None] + 32 * np.arange(4)[None, :]   # k = l + 32 r


def rdft_lanes(V):
    """rdft256 of one frame from the FFT's input layout V (32, 4) (changed
    in place) → (X[l + 32 r] at [l, r], X[128])."""
    fft128(V)
    P = np.stack([partner(V, r) for r in range(4)], axis=1)
    W = tw(LANE_BIN)
    E = 0.5 * (V + np.conj(P))
    D = V - np.conj(P)
    return E - 0.5j * W * D, np.float32(V[0, 0].real - V[0, 0].imag)


def rdft256(f):
    """256 real samples (frames, 256) → (X[0..127] as (frames, 32, 4) with
    X[l + 32 r] at [l, r], X[128])."""
    out, nyq = [], []
    for fr in f.astype(np.float32):
        z = (fr[0::2] + 1j * fr[1::2]).astype(np.complex64)
        X, n = rdft_lanes(z[fft_in_index(LANE[:, None], np.arange(4)[None, :])])
        out.append(X)
        nyq.append(n)
    return np.stack(out), np.asarray(nyq, np.float32)


def irdft_lanes(V, nyq):
    """irdft256 of one frame from its bins in the lanes, V (32, 4) with
    X[l + 32 r] at [l, r] and nyq = Re X[128] → 256 real samples, the
    imaginary parts of bins 0 and 128 ignored, 1/256 scaled.  A batch of
    frames: V (32, 4, n), nyq (n,) → (256, n)."""
    V = V.astype(np.complex64).copy()
    V[0, 0] = V[0, 0].real
    P = np.stack([partner(V, r) for r in range(4)], axis=1)
    P[0, 0] = nyq
    W = per_lane(tw(LANE_BIN), V)
    V = (V + np.conj(P)) + 1j * np.conj(W) * (V - np.conj(P))
    fft128(V, inverse=True)
    z = np.empty((128,) + V.shape[2:], np.complex64)
    z[fft_in_index(LANE[:, None], np.arange(4)[None, :])] = V / 256
    f = np.empty((256,) + V.shape[2:], np.float32)
    f[0::2], f[1::2] = z.real, z.imag
    return f


def irdft256(X):
    """(frames, 129) complex → (frames, 256) real, the imaginary parts of
    bins 0 and 128 ignored, 1/256 scaled."""
    return np.stack([irdft_lanes(x[LANE_BIN], x[128].real)
                     for x in X.astype(np.complex64)])


def _bins(V, nyq):
    """(frames, 32, 4) + (frames,) → (frames, 129) in bin order."""
    X = V.transpose(0, 2, 1).reshape(len(V), 128)
    return np.concatenate([X, nyq[:, None].astype(np.complex64)], axis=1)


def _frames(case):
    if case.startswith("impulses"):
        lo = 32 * int(case[-1])
        return np.eye(256, dtype=np.float32)[lo:lo + 32]
    return np.random.default_rng(int(case[-1])).uniform(
        -1, 1, (8, 256)).astype(np.float32)


CASES = [f"random{s}" for s in range(4)] + [f"impulses{b}" for b in range(8)]


def test_twiddle_table():
    """Float64 on the host, rounded once to float32; the kernels get it as
    a contiguous (256, 2) tensor."""
    ang = 2 * np.pi * np.arange(256) / 256
    assert TW.dtype == np.float32 and TW.shape == (256, 2)
    assert np.abs(TW[:, 0] - np.cos(ang)).max() <= 6e-8
    assert np.abs(TW[:, 1] + np.sin(ang)).max() <= 6e-8
    t = tak._fft_twiddles(torch.device("cpu"))
    assert t.is_contiguous() and t.dtype == torch.float32
    np.testing.assert_array_equal(t.numpy(), TW)


@pytest.mark.parametrize("case", CASES)
def test_forward_schedule_vs_numpy_rfft(case):
    f = _frames(case)
    V, nyq = rdft256(f)
    ref = np.fft.rfft(f.astype(np.float64), axis=-1)
    err = np.abs(_bins(V, nyq) - ref).max()
    assert err <= TOL * max(1.0, np.abs(ref).max()), err
    # X[0] and X[128] come out real
    assert np.all(V[:, 0, 0].imag == 0)


@pytest.mark.parametrize("case", CASES)
def test_inverse_schedule_vs_dense_irdft(case):
    """Spectra of the case's frames plus random imaginary parts on bins 0
    and 128, which the dense operator ignores too."""
    X = np.fft.rfft(_frames(case).astype(np.float64), axis=-1)
    X[:, [0, 128]] += 1j * np.random.default_rng(9).uniform(-3, 3, (len(X), 2))
    _, _, A, B = _rdft_mats(256)
    ref = X.real @ A.astype(np.float64) + X.imag @ B.astype(np.float64)
    err = np.abs(irdft256(X) - ref).max()
    assert err <= TOL * max(1.0, np.abs(ref).max()), err


@pytest.mark.parametrize("bin_", [0, 1, 31, 32, 64, 97, 127, 128])
def test_inverse_schedule_single_bins(bin_):
    """A unit spectrum at one bin, real and imaginary."""
    _, _, A, B = _rdft_mats(256)
    for val in (1.0, 1j):
        X = np.zeros((1, 129), np.complex128)
        X[0, bin_] = val
        ref = X.real @ A + X.imag @ B
        assert np.abs(irdft256(X) - ref).max() <= TOL


def fold_lane_frames(row, w_ana, n_frames):
    """The kernels' per-lane fold (``fold_lane``): lane l, register r folds
    samples 2n, 2n+1 (n = fft_in_index(l, r), parity p = l & 1, i = 2n mod
    128) of frame j from hops j + 2m + p with window hops 2m + p, m = 0..4,
    in fold_frames' order → the forward FFT's input, (frames, 32, 4)."""
    hops, win = row.reshape(-1, 128), w_ana.reshape(10, 128)
    lane, r = LANE[:, None], np.arange(4)[None, :]
    p, i = lane & 1, 2 * (fft_in_index(lane, r) % 64)
    out = []
    for j in range(n_frames):
        a = np.zeros((32, 4), np.float32)
        b = np.zeros((32, 4), np.float32)
        for m in range(5):
            q, wq = j + 2 * m + p, 2 * m + p
            a = a + hops[q, i] * win[wq, i]
            b = b + hops[q, i + 1] * win[wq, i + 1]
        out.append(a + 1j * b)
    return np.stack(out).astype(np.complex64)


@pytest.mark.parametrize("low_delay", [False, True])
def test_fold_and_rdft_vs_plain_front(low_delay):
    """Fold + FFT + split on a row of 9 + 5 hops vs
    analysis_front_ri_reference (the dense fold and C/S product)."""
    rng = np.random.default_rng(3)
    tail = rng.uniform(-0.5, 0.5, (1, 9 * 128)).astype(np.float32)
    x = rng.uniform(-0.5, 0.5, (1, 5 * 128)).astype(np.float32)
    re, im = tak.analysis_front_ri_reference(
        torch.from_numpy(tail), torch.from_numpy(x), low_delay=low_delay)
    ref = re[0].numpy() + 1j * im[0].numpy()
    w_ana = tak.device_consts(128, low_delay, torch.device("cpu"))["w_ana"]
    Z = fold_lane_frames(np.concatenate([tail, x], 1)[0], w_ana.numpy(),
                         ref.shape[0])
    out, nyq = [], []
    for V in Z:
        fft128(V)
        P = np.stack([partner(V, r) for r in range(4)], axis=1)
        W = tw(LANE[:, None] + 32 * np.arange(4)[None, :])
        out.append(0.5 * (V + np.conj(P)) - 0.5j * W * (V - np.conj(P)))
        nyq.append(V[0, 0].real - V[0, 0].imag)
    got = _bins(np.stack(out), np.asarray(nyq))
    assert np.abs(got - ref).max() <= TOL * np.abs(ref).max()


# ---------------------------------------------------------------------------
# The two kernels built on this FFT, mirrored around it: analysis_front_ri
# (csrc/analysis_front_ri.cu) and synthesis_back_ri (csrc/synthesis_back_ri.cu)
# ---------------------------------------------------------------------------

NF_MAX = 40   # analysis_front_ri.cu: frames per tile, at most
WARPS = 8     # synthesis_back_ri.cu: frames per step, one a warp


def front_tiles(n_out):
    """The launcher's tiles: n_tiles tiles of nf <= NF_MAX frames, as equal
    as they come, none empty."""
    n0 = -(-n_out // NF_MAX)
    nf = -(-n_out // n0)
    return nf, -(-n_out // nf)


def front_kernel_mirror(tail, x, w_ana):
    """analysis_front_ri's kernel: per (row, tile) the fold + rDFT of each
    of the tile's frames from the tile's nf + 9 hops (fold_lane, rdft256),
    its bins written from the lanes to row f0 + j."""
    rows, t_hops, H = x.shape[0], tail.shape[1] // 128, x.shape[1] // 128
    n_out = t_hops + H - 9
    nf, n_tiles = front_tiles(n_out)
    out = np.full((rows, n_out, 129), np.nan, np.complex64)
    written = np.zeros((rows, n_out), int)
    for row in range(rows):
        hops = np.concatenate([tail[row], x[row]]).reshape(-1, 128)
        for t in range(n_tiles):
            f0 = t * nf
            n = min(nf, n_out - f0)
            Z = fold_lane_frames(hops[f0:f0 + n + 9].ravel(), w_ana, n)
            for j in range(n):
                X, nyq = rdft_lanes(Z[j])
                out[row, f0 + j, LANE_BIN] = X
                out[row, f0 + j, 128] = nyq
                written[row, f0 + j] += 1
    assert (written == 1).all()      # every frame once, no tile overlaps
    return out.real, out.imag


@pytest.mark.parametrize("t_hops,H,low_delay", [
    (15, 1, False), (15, 4, True), (9, 9, False), (15, 64, False),
    (9, 64, True), (15, 130, False)])
def test_front_kernel_layout_vs_plain_front(t_hops, H, low_delay):
    """Tiles (70 frames: two of 35; 136: four of 34) and each frame's hops
    and output row, on 3 rows vs analysis_front_ri_reference."""
    rng = np.random.default_rng(t_hops + H)
    tail = rng.uniform(-0.5, 0.5, (3, t_hops * 128)).astype(np.float32)
    x = rng.uniform(-0.5, 0.5, (3, H * 128)).astype(np.float32)
    ref = tak.analysis_front_ri_reference(
        torch.from_numpy(tail), torch.from_numpy(x), low_delay=low_delay)
    w_ana = tak.device_consts(128, low_delay, torch.device("cpu"))["w_ana"]
    got = front_kernel_mirror(tail, x, w_ana.numpy())
    scale = max(np.abs(r.numpy()).max() for r in ref)
    for g, r in zip(got, ref):
        assert g.shape == tuple(r.shape)
        assert np.abs(g - r.numpy()).max() <= TOL * scale


def test_front_tiles_cover_every_frame():
    for n_out in range(1, 2000):
        nf, n_tiles = front_tiles(n_out)
        assert nf <= NF_MAX and 0 < n_out - (n_tiles - 1) * nf <= nf


def back_lanes(fr, hybrid, low_delay):
    """synthesis_back_ri's bins of one packed row [re | im] in irdft256's
    layout: uniform bin k = l + 32 r in lane l, register r is hybrid band k
    (k = 0), the sum of bands 2k-1 and 2k (k = 1..4) or band k + 4 (k >= 5);
    non-hybrid: band k; the odd bins negated for low delay → (V, nyq)."""
    nbh = fr.size // 2
    shift = nbh - 129
    b = np.where((LANE_BIN >= 5) & hybrid, LANE_BIN + shift, LANE_BIN)
    V = (fr[b] + 1j * fr[nbh + b]).astype(np.complex64)
    if hybrid:
        lane = np.arange(1, 5)
        V[lane, 0] = ((fr[2 * lane - 1] + fr[2 * lane])
                      + 1j * (fr[nbh + 2 * lane - 1] + fr[nbh + 2 * lane]))
    if low_delay:
        V[1::2] = -V[1::2]
    return V, np.float32(fr[128 + shift])


def back_kernel_mirror(spec, tail, w_syn, hybrid, low_delay):
    """synthesis_back_ri's kernel: per row, steps of WARPS irDFT frames; a
    thread per sample adds each frame in order into 10 accumulators (output
    hops f .. f+9 of the next frame f): frame f completes hop f, which
    leaves with the old tail added for f < 9; after the last frame the 9
    hops still accumulating, with the old tail where p < 9, are the new
    tail."""
    rows, H, _ = spec.shape
    ws = w_syn.reshape(10, 128)
    y = np.full((rows, H, 128), np.nan, np.float32)
    new_tail = np.full((rows, 9, 128), np.nan, np.float32)
    for row in range(rows):
        acc = np.zeros((10, 128), np.float32)
        for f0 in range(0, H, WARPS):
            frames = [irdft_lanes(*back_lanes(spec[row, f], hybrid,
                                              low_delay))
                      for f in range(f0, min(f0 + WARPS, H))]
            for j, fr in enumerate(frames):
                p = f0 + j
                for k in range(10):
                    acc[k] = acc[k] + fr[(k & 1) * 128:(k & 1) * 128 + 128] * ws[k]
                y[row, p] = acc[0] + tail[row, p] if p < 9 else acc[0]
                acc = np.concatenate([acc[1:], np.zeros((1, 128), np.float32)])
        for k in range(9):
            p = H + k
            new_tail[row, k] = acc[k] + tail[row, p] if p < 9 else acc[k]
    return y, new_tail


@pytest.mark.parametrize("H", [1, 4, 9, 64])
@pytest.mark.parametrize("hybrid,low_delay", [(True, False), (False, True),
                                              (True, True)])
def test_back_kernel_layout_vs_plain_back(H, hybrid, low_delay):
    """The packed-row → lane mapping (hybrid pair sums, odd-bin sign,
    Nyquist bin), the accumulators' 9-hop carry across steps and into the
    new tail (H < 9: the old tail's later hops too), on 2 rows with spectra
    of scale 10, vs synthesis_back_ri_reference."""
    rng = np.random.default_rng(H + 2 * hybrid + low_delay)
    K = 2 * (133 if hybrid else 129)
    spec = rng.uniform(-10, 10, (2, H, K)).astype(np.float32)
    tail = rng.uniform(-1, 1, (2, 9, 128)).astype(np.float32)
    ry, rt = tak.synthesis_back_ri_reference(
        torch.from_numpy(spec), torch.from_numpy(tail), low_delay=low_delay,
        hybrid=hybrid)
    w_syn = tak.device_consts(128, low_delay, torch.device("cpu"))["w_syn"]
    gy, gt = back_kernel_mirror(spec, tail, w_syn.numpy(), hybrid, low_delay)
    scale = max(1.0, np.abs(ry.numpy()).max())
    assert np.abs(gy - ry.numpy()).max() <= TOL * scale
    assert np.abs(gt - rt.numpy()).max() <= TOL * scale


# ---------------------------------------------------------------------------
# The decode + synthesis render (csrc/render_decode_synthesis_ri.cu),
# mirrored around the irDFT: the split of cin over a cluster's ranks, the
# stage each channel's tile is decoded from, the rank-order sum, the lane
# layout, and the overlap-add
# ---------------------------------------------------------------------------

R_TILE = 16        # output hops per cluster
R_MAX_CLUSTER = 8  # ranks per cluster, at most
R_MAX_EARS = 8     # ears per pass over the inputs


def render_cluster_size(S, n_tiles, cin, cout, n_sm):
    """The launcher's cluster: the largest power of two, up to
    R_MAX_CLUSTER and cin, that keeps the grid of S * n_tiles clusters
    resident at once on n_sm SMs (four blocks an SM up to two ears, one
    above)."""
    places = n_sm * (4 if cout <= 2 else 1)
    cs = 1
    while (2 * cs <= R_MAX_CLUSTER and 2 * cs <= cin
           and 2 * cs * S * n_tiles <= places):
        cs *= 2
    return cs


def render_stage(form, spec, s, c, h0, nh):
    """What one ring stage holds of channel c for the tile at h0 and what
    the decode reads from it → (d, w = j g), each (nh, 129).  (d, g) pair:
    nh hops of d and of g; hybrid spectra: nh + 6 hops, d at stage hop
    hh + 3 and g from stage hops hh, hh + 2, hh + 4, hh + 6 on bands 0..15;
    non-hybrid spectra: the nh hops from h0 + 6, no g."""
    g = np.zeros((nh, 129), np.complex64)
    if form == "dg":
        dre, dim_, gre, gim = spec
        d = dre[s, c, h0:h0 + nh] + 1j * dim_[s, c, h0:h0 + nh]
        g[:, :16] = gre[s, c, h0:h0 + nh] + 1j * gim[s, c, h0:h0 + nh]
    elif form == "hybrid":
        st = (spec[0][s, c, h0:h0 + nh + 6]
              + 1j * spec[1][s, c, h0:h0 + nh + 6]).astype(np.complex64)
        assert len(st) == nh + 6 <= R_TILE + 6
        d = st[3:3 + nh]
        lo = st[:, :16]
        g[:, :16] = (np.float32(tak._COEFF1) * (lo[6:6 + nh] - lo[0:nh])
                     + np.float32(tak._COEFF2) * (lo[4:4 + nh] - lo[2:2 + nh]))
    else:
        d = (spec[0][s, c, h0 + 6:h0 + 6 + nh]
             + 1j * spec[1][s, c, h0 + 6:h0 + 6 + nh])
    return d.astype(np.complex64), (1j * g).astype(np.complex64)


def render_kernel_mirror(form, spec, taps, tail, w_syn, low_delay,
                         per_stream, n_sm):
    """render_decode_synthesis_ri.cu: per (stream, tile of R_TILE hops) a
    cluster of render_cluster_size ranks; rank q decodes channels q, q + cs,
    ... of every ear of the pass in channel order, the ranks' tiles are
    summed in rank order, each (ear, hop) row goes to irdft256's lanes (bin
    l + 32 r at [l, r], the odd lanes negated for low delay, Re X[128]
    apart) and its frame to the (S, cout, H, 256) buffer; then the
    overlap-add launch: output hop p sums frame p - k's half k % 2 times
    window hop k, plus the old tail for p < 9."""
    S, cin = spec[0].shape[:2]
    H = spec[0].shape[2] - (0 if form == "dg" else 6)
    cout = taps.shape[-3]
    cs = render_cluster_size(S, -(-H // R_TILE), cin, cout, n_sm)
    frames = np.full((S, cout, H, 256), np.nan, np.float32)
    for s in range(S):
        tp = taps[s] if per_stream else taps          # (cin, cout, 4, 129)
        for e0 in range(0, cout, R_MAX_EARS):
            ears = slice(e0, min(e0 + R_MAX_EARS, cout))
            for h0 in range(0, H, R_TILE):
                nh = min(R_TILE, H - h0)
                tile = np.zeros((ears.stop - e0, nh, 129), np.complex64)
                for rank in range(cs):
                    dec = np.zeros_like(tile)
                    for c in range(rank, cin, cs):
                        d, w = render_stage(form, spec, s, c, h0, nh)
                        A = (tp[c, ears, 0] + 1j * tp[c, ears, 1])[:, None]
                        B = (tp[c, ears, 2] + 1j * tp[c, ears, 3])[:, None]
                        dec = dec + (A.astype(np.complex64) * d
                                     + B.astype(np.complex64) * w)
                    tile = tile + dec
                # the tile's (ear, hop) rows as a batch of frames
                rows = tile.reshape(-1, 129)
                V = np.moveaxis(rows[:, LANE_BIN], 0, -1).copy()
                if low_delay:
                    V[1::2] = -V[1::2]
                assert np.isnan(frames[s, ears, h0:h0 + nh]).all()
                frames[s, ears, h0:h0 + nh] = irdft_lanes(
                    V, rows[:, 128].real).T.reshape(-1, nh, 256)
    assert not np.isnan(frames).any()     # every frame once
    ws = w_syn.reshape(10, 128)
    out = np.zeros((S, cout, H + 9, 128), np.float32)
    for p in range(H + 9):
        for k in range(10):
            if 0 <= p - k < H:
                half = frames[:, :, p - k, (k & 1) * 128:(k & 1) * 128 + 128]
                out[:, :, p] = out[:, :, p] + half * ws[k]
        if p < 9:
            out[:, :, p] = out[:, :, p] + tail[:, :, p]
    return out[:, :, :H].reshape(S, cout, H * 128), out[:, :, H:]


def test_render_cluster_sizes():
    """On 132 SMs: 2 at the main paths' shape (512 blocks for 528 places),
    8 for a single stream, 1 past 264 tiles, never more ranks than
    channels."""
    assert render_cluster_size(64, 4, 64, 2, 132) == 2
    assert render_cluster_size(1, 1, 64, 2, 132) == 8
    assert render_cluster_size(1, 4, 5, 2, 132) == 4
    assert render_cluster_size(40, 9, 5, 2, 132) == 1
    assert render_cluster_size(8, 4, 17, 7, 132) == 4
    assert render_cluster_size(1, 1, 1, 2, 132) == 1


# n_sm: the card's 132 SMs, and counts that force clusters of 1 and 2
@pytest.mark.parametrize("low_delay,per_stream,n_sm", [
    (False, False, 132), (True, False, 1), (False, True, 2),
    (True, True, 132)])
@pytest.mark.parametrize("form", ["dg", "hybrid", "plain"])
@pytest.mark.parametrize("cout", [2, 3, 7])
@pytest.mark.parametrize("cin", [5, 17, 64])
@pytest.mark.parametrize("H", [1, 4, 9, 17, 64])
def test_render_kernel_layout_vs_plain_render(H, cin, cout, form, low_delay,
                                              per_stream, n_sm):
    """One stream (two with per-stream taps) of spectra of scale 4 and
    taps scaled as a wide render's, vs the plain versions."""
    S = 2 if per_stream else 1
    rng = np.random.default_rng(H + cin + cout)
    u = lambda *shape: rng.uniform(-4, 4, shape).astype(np.float32)  # noqa: E731
    if form == "dg":
        spec = (u(S, cin, H, 129), u(S, cin, H, 129), u(S, cin, H, 16),
                u(S, cin, H, 16))
    else:
        spec = (u(S, cin, H + 6, 129), u(S, cin, H + 6, 129))
    hybrid = form != "plain"
    M = torch.from_numpy(
        min(1.0, (16 / cin) ** 0.5) * rng.uniform(
            -1, 1, (2,) + ((S,) if per_stream else ())
            + (133 if hybrid else 129, cout, cin)).astype(np.float32))
    taps = tak.decode_taps(M[0], M[1], hybrid=hybrid).contiguous()
    tail = rng.uniform(-1, 1, (S, cout, 9, 128)).astype(np.float32)
    t = [torch.from_numpy(a) for a in spec]
    kw = dict(low_delay=low_delay, per_stream=per_stream)
    if form == "dg":
        ry, rt = tak.render_decode_synthesis_dg_ri_reference(
            *t, torch.from_numpy(tail), taps, **kw)
    else:
        ry, rt = tak.render_decode_synthesis_ri_reference(
            *t, torch.from_numpy(tail), taps, hybrid=hybrid, **kw)
    w_syn = tak.device_consts(128, low_delay, torch.device("cpu"))["w_syn"]
    gy, gt = render_kernel_mirror(form, spec, taps.numpy(), tail,
                                  w_syn.numpy(), low_delay, per_stream, n_sm)
    scale = max(1.0, np.abs(ry.numpy()).max())
    assert gy.shape == tuple(ry.shape) and gt.shape == tuple(rt.shape)
    assert np.abs(gy - ry.numpy()).max() <= TOL * scale
    assert np.abs(gt - rt.numpy()).max() <= TOL * scale


# ---------------------------------------------------------------------------
# The one-pass render's frame stage (csrc/render_full_ri.cu, fold_chain in
# afstft_common.cuh): the tile follows H, a tile folds only the frames its
# hops need, each warp walks a run of frames of one parity in chains
# ---------------------------------------------------------------------------

F_SHORT_TILE, F_LONG_TILE = 8, 32   # output hops a tile (short: H <= 8)
F_WARPS, F_CHAIN = 8, 2             # warps a block; frames a chain
F_HOPS = [1, 7, 8, 32, 33, 64, 65]


def full_tiles(H):
    """The C entry's tiles for a block of H hops → [(h0, nf)], nf the
    frames the tile needs: its output hops + 6."""
    tile = F_SHORT_TILE if H <= F_SHORT_TILE else F_LONG_TILE
    return [(h0, min(tile, H - h0) + 6) for h0 in range(0, H, tile)]


def full_chains(nf):
    """The frame stage's walk → per warp, its chains of frames: warp w
    takes the u-th (u = w >> 1) of four runs of the frames of parity w & 1,
    the runs as equal as they come, in chains of up to F_CHAIN frames."""
    runs = F_WARPS // 2
    walk = []
    for w in range(F_WARPS):
        par, u = w & 1, w >> 1
        n = (nf + 1 - par) // 2
        q0, q1 = u * n // runs, (u + 1) * n // runs
        walk.append([[2 * q + par for q in range(q, min(q + F_CHAIN, q1))]
                     for q in range(q0, q1, F_CHAIN)])
    return walk


def fold_chain_products(j, k, p):
    """fold_chain's products for a chain of k frames from frame j, at lane
    parity p, in the order they are summed → {frame: [(hop row, window
    hop)]}; each hop row j + 2t + p is read once (t = 0 .. k + 3)."""
    out = {j + 2 * c: [] for c in range(k)}
    for t in range(k + 4):
        for c in range(k):
            if 0 <= t - c < 5:
                out[j + 2 * c].append((j + 2 * t + p, 2 * (t - c) + p))
    return out


def fold_chain_lanes(hops, win, j, k):
    """fold_chain's arithmetic on a row's hops (float32, as fold_lane_frames)
    → the k frames' FFT inputs, (k, 32, 4)."""
    lane, r = LANE[:, None], np.arange(4)[None, :]
    p, i = lane & 1, 2 * (fft_in_index(lane, r) % 64)
    a = np.zeros((k, 32, 4), np.float32)
    b = np.zeros((k, 32, 4), np.float32)
    for t in range(k + 4):
        q = j + 2 * t + p
        h_even, h_odd = hops[q, i], hops[q, i + 1]
        for c in range(k):
            m = t - c
            if 0 <= m < 5:
                a[c] = a[c] + h_even * win[2 * m + p, i]
                b[c] = b[c] + h_odd * win[2 * m + p, i + 1]
    return (a + 1j * b).astype(np.complex64)


@pytest.mark.parametrize("H", F_HOPS)
def test_full_frame_walk_folds_each_needed_frame_once(H):
    """Every frame 0 .. nf - 1 of each tile folded exactly once, none past
    nf (the padded frames), each chain of one parity, no hop row past the
    nf + 9 the tile loads, and the warps' shares within one frame of each
    other's per parity."""
    for h0, nf in full_tiles(H):
        assert nf == min(H - h0, F_LONG_TILE) + 6
        walk = full_chains(nf)
        folded = [j for chains in walk for ch in chains for j in ch]
        assert sorted(folded) == list(range(nf))
        for w, chains in enumerate(walk):
            for ch in chains:
                assert 1 <= len(ch) <= F_CHAIN
                assert all(j % 2 == w % 2 for j in ch)
                assert ch == list(range(ch[0], ch[0] + 2 * len(ch), 2))
                rows = [q for p in (0, 1) for prods in
                        fold_chain_products(ch[0], len(ch), p).values()
                        for q, _ in prods]
                assert max(rows) < nf + 9
        for par in (0, 1):
            sizes = [sum(map(len, walk[w])) for w in range(par, F_WARPS, 2)]
            assert max(sizes) - min(sizes) <= 1


@pytest.mark.parametrize("H", F_HOPS)
def test_full_frame_chain_products_are_fold_lanes(H):
    """Each frame's (hop row, window hop) products in a chain are
    fold_lane's, in fold_lane's order (m = 0 .. 4)."""
    for _, nf in full_tiles(H):
        for chains in full_chains(nf):
            for ch in chains:
                for p in (0, 1):
                    got = fold_chain_products(ch[0], len(ch), p)
                    for j in ch:
                        assert got[j] == [(j + 2 * m + p, 2 * m + p)
                                          for m in range(5)]


@pytest.mark.parametrize("low_delay", [False, True])
def test_full_frame_chains_equal_fold_lane_bit_for_bit(low_delay):
    """fold_chain's arithmetic on a row of 15 + 64 hops, over the walk of
    both long tiles, equals fold_lane's frame by frame, bit for bit (the
    same products summed in the same order)."""
    rng = np.random.default_rng(9)
    row = rng.uniform(-1, 1, (15 + 64) * 128).astype(np.float32)
    w_ana = tak.device_consts(128, low_delay,
                              torch.device("cpu"))["w_ana"].numpy()
    hops, win = row.reshape(-1, 128), w_ana.reshape(10, 128)
    ref = fold_lane_frames(row, w_ana, 64 + 6)
    seen = 0
    for h0, nf in full_tiles(64):
        for chains in full_chains(nf):
            for ch in chains:
                got = fold_chain_lanes(hops[h0:h0 + nf + 9], win, ch[0],
                                       len(ch))
                for c, j in enumerate(ch):
                    assert np.array_equal(got[c], ref[h0 + j])
                    seen += 1
    assert seen == 2 * 38
