"""wide_mix_ri, the wide render's hybrid stage and per-band mix, on the
CPU: the plain version is the route's old torch glue bit for bit, the wide
route through it is the old route bit for bit, the entry is counted like
every kernel, and numpy mirrors of the two CUDA kernels' walks
(``csrc/wide_mix_ri.cu``: ``wide_mix``'s band groups, units, staged
segments, split inputs, windows and e-groups; ``wide_mix_real``'s output
blocks, units, staged spans, split inputs and thread map) write every
output once with the plain version's value.  The kernels themselves are
held to the plain version on the card (tests/test_torch_cuda.py)."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from spatial_audio_framework_tpu_torch.ops import afstft_kernels as ak
from spatial_audio_framework_tpu_torch.ops import afstft_ri as ri
from spatial_audio_framework_tpu_torch.ops.afstft import (_COEFF1, _COEFF2,
                                                          AfSTFT)
from spatial_audio_framework_tpu_torch.utils import profiling

FORMS = {"real_shared": (False, False), "complex_shared": (True, False),
         "real_per_stream": (False, True),
         "complex_per_stream": (True, True)}


def _t(rng, shape, amp=1.0):
    return torch.from_numpy((amp * rng.uniform(-1, 1, shape))
                            .astype(np.float32))


def _matrix(rng, S, n_bands, cout, cin, form):
    complex_m, per_stream = FORMS[form]
    shape = ((S,) if per_stream else ()) + (n_bands, cout, cin)
    return _t(rng, shape), _t(rng, shape) if complex_m else None


def _old_glue(bank, st, x, Mre, Mim):
    """The wide route's glue before the kernel: the packed spectra of the
    batched analysis, the einsum, its dense copy."""
    spec_p, st = ri.analysis_ri_batched(bank, st, x, packed=True,
                                        use_kernel=True)
    return ri._mix_bands(Mre, Mim, spec_p).contiguous().flatten(-2), st


@pytest.mark.parametrize("hybrid", [True, False])
@pytest.mark.parametrize("form", list(FORMS))
def test_plain_version_is_the_old_glue_bit_for_bit(form, hybrid):
    bank = AfSTFT(hybrid=hybrid)
    rng = np.random.default_rng(len(form) + hybrid)
    S, cin, cout, H = 3, 12, 13, 5
    st = ri.AfSTFTStateBatched(_t(rng, (S, cin, 15 * 128)),
                               _t(rng, (S, cout, 9 * 128)))
    x = _t(rng, (S, cin, H * 128))
    Mre, Mim = _matrix(rng, S, bank.n_bands, cout, cin, form)
    old, _ = _old_glue(bank, st, x, Mre, Mim)
    sre, sim, _ = ri._front_rows(bank, st, x)
    new = ak.wide_mix_ri(sre, sim, Mre, Mim, hybrid=hybrid)
    assert new.shape == (S * cout, H, 2 * bank.n_bands)
    assert torch.equal(new, old.reshape(S * cout, H, -1))


@pytest.mark.parametrize("hybrid", [True, False])
@pytest.mark.parametrize("form", list(FORMS))
def test_wide_route_is_the_old_route_bit_for_bit(form, hybrid):
    """render_tf_matrix_ri(fused=True) past 128 channel pairs on the CPU:
    the output and both tails of the old route (front, glue, back)."""
    bank = AfSTFT(hybrid=hybrid)
    rng = np.random.default_rng(7 * len(form) + hybrid)
    S, cin, cout, H = 2, 16, 9, 4
    st = ri.AfSTFTStateBatched(_t(rng, (S, cin, 15 * 128)),
                               _t(rng, (S, cout, 9 * 128)))
    Mre, Mim = _matrix(rng, S, bank.n_bands, cout, cin, form)
    st_new = st_old = st
    for _ in range(2):
        x = _t(rng, (S, cin, H * 128))
        y_new, st_new = ri.render_tf_matrix_ri(bank, st_new, x, Mre, Mim)
        spec, st_old = _old_glue(bank, st_old, x, Mre, Mim)
        y_old, st_old = ri.synthesis_ri_batched(bank, st_old, spec,
                                                packed=True, use_kernel=True)
        assert torch.equal(y_new, y_old)
        assert torch.equal(st_new.in_tail, st_old.in_tail)
        assert torch.equal(st_new.ola_tail, st_old.ola_tail)


def test_entry_is_listed_spanned_and_not_counted_on_the_cpu():
    assert "wide_mix_ri" in ak.KERNELS
    rng = np.random.default_rng(2)
    sre, sim = _t(rng, (6, 7, 129)), _t(rng, (6, 7, 129))
    Mre, Mim = _matrix(rng, 2, 133, 5, 3, "complex_shared")
    profiling.reset_counters()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = ak.wide_mix_ri(sre, sim, Mre, Mim)
    assert torch.equal(out, ak.wide_mix_ri_reference(sre, sim, Mre, Mim))
    names = [e.name for e in prof.events()]
    # the plain version's own steps run unspanned inside the entry's span
    assert names.count("kernels.wide_mix_ri") == 1
    assert "ops.hybrid_forward" not in names and "ops.mix_bands" not in names
    assert profiling.counters()["kernels.wide_mix_ri.launches"] == 0


# -- numpy mirrors of csrc/wide_mix_ri.cu's two kernels ----------------------

P, HT, CTX, SPLIT = 4, 16, 160, 64


def _band_source(b, hybrid):
    """band_source: (uniform bin, sigma of the hybrid FIR)."""
    if not hybrid:
        return b, 0.0
    if b == 0:
        return 0, 0.0
    if b >= 9:
        return b - 4, 0.0
    k = (b + 1) >> 1
    s = -1.0 if k & 1 else 1.0
    return k, s if b & 1 else -s


def _span16(a, n):
    """span16: the 16-byte chunks of floats [a, a + n) → (first float,
    floats)."""
    return a & ~3, 4 * (((a + n + 3) >> 2) - (a >> 2))


def _split_value(x0, ctx, rc, klo, shift_of, p, part, b, seg_of):
    """A split band's input: 0.5 d ± j (C1 (s[h+6] - s[h]) + C2 (s[h+4] -
    s[h+2])), d the band's bin in its segment, the context read by the
    kernels' indices (ctx(pp, hi) → float)."""
    k, sigma = _band_source(b, True)
    d = x0[seg_of(part) + shift_of + k - klo]

    def inner(pp):
        return (_COEFF1 * (ctx(pp, 2 * p + 3, k) - ctx(pp, 2 * p, k))
                + _COEFF2 * (ctx(pp, 2 * p + 2, k) - ctx(pp, 2 * p + 1, k)))
    return (0.5 * d + sigma * inner(0) if part
            else 0.5 * d - sigma * inner(1))


def _mirror(sre, sim, Mre, Mim, hybrid, ec, n_eg, bg, upb):
    """The general kernel's walk for a given plan, in float64: blocks over
    (group of bg bands, run of upb units); a unit (stream, hop class, tile
    of 16 hops) is staged as the block copies it, whole 16-byte chunks of
    the flattened spectra (past their end: NaN) into row segments
    [c][p][part][segp] and the split bands' context [c][part][hop][8],
    from which the split bands' inputs [c][p][part][band] are made; the
    matrix as the block stages it, [part][c][eg][band][e] (NaN where it
    writes nothing); the items (windows of the group's positions on sector
    boundaries, e-groups) read them back by the kernel's indices and write
    their positions.  Returns the packed rows and how often each output
    float was written."""
    flat = [np.concatenate([t.double().numpy().ravel(), np.full(8, np.nan)])
            for t in (sre, sim)]
    M = [Mre.double().numpy()] + ([] if Mim is None
                                  else [Mim.double().numpy()])
    per_stream, complex_m = M[0].ndim == 4, Mim is not None
    nbh, cout, cin = M[0].shape[-3:]
    S, He = sre.shape[0] // cin, sre.shape[1]
    H, off, rl, nb = He - 6, 3 if hybrid else 6, 2 * nbh, 129
    segp = (bg + 3 + 3) // 4 * 4
    seg_f = cin * P * 2 * segp
    out = np.zeros((S * cout, H, rl))
    writes = np.zeros(out.shape, np.int64)
    ups = 4 * -(-H // HT)
    n_units = S * ups
    for g in range(-(-nbh // bg)):
        b_lo, b_hi = g * bg, min(nbh, g * bg + bg)
        klo = _band_source(b_lo, hybrid)[0]
        nbin = _band_source(b_hi - 1, hybrid)[0] - klo + 1
        has_ctx = hybrid and b_lo <= 8 and b_hi > 1
        for u0 in range(0, n_units, upb):
            m_stream = None
            for u in range(u0, min(n_units, u0 + upb)):
                s, r = divmod(u, ups)
                hb = (r >> 2) * HT + (r & 3)
                if hb >= H:
                    continue
                if m_stream != (s if per_stream else 0):   # the matrix
                    m_stream = s if per_stream else 0
                    ms = np.full((len(M), cin, n_eg, bg, ec), np.nan)
                    for pi, Mp in enumerate(M):
                        Ms = Mp[s] if per_stream else Mp
                        for bl in range(b_hi - b_lo):
                            for e in range(cout):
                                ms[pi, :, e // ec, bl, e % ec] = \
                                    Ms[b_lo + bl, e]
                # the copies
                x0 = np.full(seg_f + (cin * (CTX + SPLIT) if hybrid else 0),
                             np.nan)
                row0 = s * cin * He + hb
                for i in range(cin * P * 2):
                    c, p, part = i // (2 * P), (i >> 1) % P, i & 1
                    if hb + 4 * p < H:
                        a0, n = _span16((row0 + c * He + 4 * p + off) * nb
                                        + klo, nbin)
                        assert n <= segp
                        x0[i * segp:i * segp + n] = flat[part][a0:a0 + n]
                for i in range(cin * 20 if has_ctx else 0):
                    c, part, hi = i // 20, (i % 20) // 10, i % 10
                    if hb + 2 * hi < He:
                        a0, n = _span16((row0 + c * He + 2 * hi) * nb + 1, 4)
                        assert n <= 8
                        x0[seg_f + i * 8:seg_f + i * 8 + n] = \
                            flat[part][a0:a0 + n]
                r4 = (s * cin * He + hb) & 3
                split = seg_f + cin * CTX
                for i in range(cin * SPLIT if has_ctx else 0):
                    c, p, part = i // SPLIT, (i // 16) % P, (i >> 3) & 1
                    b = (i & 7) + 1
                    rc = (r4 + c * (He & 3)) & 3
                    if not klo <= _band_source(b, True)[0] < klo + nbin:
                        x0[split + i] = 0.0
                        continue

                    def ctx(pp, hi, k, c=c, rc=rc):
                        return x0[seg_f + c * CTX + (pp * 10 + hi) * 8
                                  + ((rc + 2 * hi + 1) & 3) + k - 1]
                    x0[split + i] = _split_value(
                        x0, ctx, rc, klo, (rc + off + klo) & 3, p, part, b,
                        lambda pt, c=c, p=p: c * (P * 2 * segp)
                        + (2 * p + pt) * segp)
                # the items
                hc = hb & 3
                lo = (b_lo, nbh + b_lo)
                hi_ = (b_hi, nbh + b_hi)
                w = [q - ((q + 2 * hc) & 7) for q in lo]
                nw = [(h - s0 + 31) >> 5 for h, s0 in zip(hi_, w)]
                for it in range((nw[0] + nw[1]) * n_eg):
                    eg, wi = it % n_eg, it // n_eg
                    pt = int(wi >= nw[0])
                    q0 = w[pt] + 32 * (wi - pt * nw[0])
                    assert (q0 + 2 * hc) % 8 == 0
                    for lane in range(32):
                        q = q0 + lane
                        if not lo[pt] <= q < hi_[pt]:
                            continue
                        b = q - pt * nbh
                        bl = b - b_lo
                        sp = hybrid and 1 <= b <= 8
                        xb = (split + b - 1 if sp
                              else _band_source(b, hybrid)[0] - klo)
                        sc, spp = (SPLIT, 8) if sp else (P * 2 * segp, segp)
                        acc = np.zeros((ec, P))
                        for c in range(cin):
                            rc = (r4 + c * He) & 3
                            xs = xb + c * sc + (0 if sp
                                                else (rc + off + klo) & 3)
                            x = np.array([[x0[xs + (2 * p + part) * spp]
                                           for part in range(2)]
                                          for p in range(P)])
                            wr = ms[0, c, eg, bl]
                            if complex_m:
                                y = np.outer(wr + 1j * ms[1, c, eg, bl],
                                             x[:, 0] + 1j * x[:, 1])
                                acc += y.imag if pt else y.real
                            else:
                                acc += np.outer(wr, x[:, pt])
                        for e in range(min(ec, cout - eg * ec)):
                            for p in range(P):
                                h = hb + 4 * p
                                if h < H:
                                    row = s * cout + eg * ec + e
                                    out[row, h, q] = acc[e, p]
                                    writes[row, h, q] += 1
    return out, writes


@pytest.mark.parametrize("S,cin,cout,H,form,hybrid,ec,n_eg,bg,upb", [
    (3, 3, 5, 5, "real_shared", True, 8, 1, 67, 3),      # odd H, two groups
    (2, 2, 13, 11, "complex_shared", True, 8, 2, 45, 5),  # e-groups 8, 5
    (3, 5, 3, 1, "complex_per_stream", True, 4, 1, 5, 2),  # split bands
    #                            across groups; H = 1: empty units
    (2, 3, 2, 9, "real_per_stream", False, 2, 1, 129, 3),  # 129 bands
    (1, 6, 4, 20, "complex_shared", False, 4, 1, 33, 7),   # three tiles
    (2, 11, 1, 3, "real_per_stream", True, 1, 1, 133, 5),  # one group
    (2, 2, 25, 4, "real_shared", True, 12, 3, 67, 1),     # 12, 12, 1
    (3, 4, 2, 17, "complex_per_stream", True, 2, 1, 20, 9),  # streams
    #                            change inside a block's run
])
def test_mirror_of_the_kernel_writes_each_output_once(S, cin, cout, H, form,
                                                      hybrid, ec, n_eg, bg,
                                                      upb):
    rng = np.random.default_rng(S + cin + cout + H)
    nb = 133 if hybrid else 129
    sre, sim = _t(rng, (S * cin, H + 6, 129)), _t(rng, (S * cin, H + 6, 129))
    Mre, Mim = _matrix(rng, S, nb, cout, cin, form)
    got, writes = _mirror(sre, sim, Mre, Mim, hybrid, ec, n_eg, bg, upb)
    assert (writes == 1).all()
    ref = ak.wide_mix_ri_reference(sre, sim, Mre, Mim, hybrid=hybrid)
    np.testing.assert_allclose(got, ref.double().numpy(), rtol=0, atol=1e-5)


# wide_mix_real: HR hops a unit, CIN inputs in registers, EG outputs a
# thread, NEG groups a block, 13 warps
HR, CIN, EG, NEG, ZT = 4, 16, 4, 3, 416
RAWP, CTXH = (HR * 129 + 3 + 3) // 4 * 4, HR + 6


def _mirror_real(sre, sim, Mre, hybrid, upb):
    """wide_mix_real's walk for a shared real matrix, in float64: blocks
    over (12 outputs, run of upb units of HR hops); a unit is staged as
    the blocks copy it (multicast within a cluster or 16-byte chunks, to
    the same places), each input's HR rows and both parts one span of
    whole 16-byte chunks (past the spectra's end: NaN) [c][part][RAWP],
    the context of bins 1..4 [c][part][hop][8], and from them the split
    bands' inputs [c][part][h][band]; inputs past cin are zero; a thread's
    band and output group by the kernel's map (warps 0..11 the bands that
    are a bin as it is, warp 12 the split bands) and its matrix entries
    (zero past cout and cin); the mix reads the stage by the kernel's
    indices into the output rows [e][h][RL], which leave as each output's
    HR contiguous rows.  Returns the packed rows and how often each output
    float was written."""
    flat = [np.concatenate([t.double().numpy().ravel(), np.full(8, np.nan)])
            for t in (sre, sim)]
    M = Mre.double().numpy()
    nbh, cout, cin = M.shape
    S, He = sre.shape[0] // cin, sre.shape[1]
    H, off, rl, nb = He - 6, 3 if hybrid else 6, 2 * nbh, 129
    assert H % HR == 0 and cin <= CIN
    upsr = H // HR
    out = np.zeros((S * cout, H, rl))
    writes = np.zeros(out.shape, np.int64)
    tid = np.arange(ZT)
    if hybrid:
        j = tid % (nb - 4)
        b = np.where(tid < 384, np.where(j > 0, j + 8, 0), tid % 32 % 8 + 1)
        g = np.where(tid < 384, np.where(tid < (nb - 4) * NEG,
                                         tid // (nb - 4), NEG),
                     np.where(tid % 32 < 8 * NEG, tid % 32 // 8, NEG))
    else:
        b, g = tid % nb, np.where(tid < nb * NEG, tid // nb, NEG)
    act = g < NEG
    assert sorted(zip(b[act], g[act])) == sorted(
        (bb, gg) for gg in range(NEG) for bb in range(nbh))
    for e0 in range(0, cout, EG * NEG):
        w = np.zeros((ZT, EG, CIN))
        for t in np.flatnonzero(act):
            for e in range(EG):
                ge = e0 + g[t] * EG + e
                if ge < cout:
                    w[t, e, :cin] = M[b[t], ge]
        for u0 in range(0, S * upsr, upb):
            for u in range(u0, min(S * upsr, u0 + upb)):
                s, hb = u // upsr, u % upsr * HR
                raw = np.full((CIN, 2, RAWP), np.nan)
                raw[cin:] = 0.0
                ctx = np.full((CIN, 2, CTXH, 8), np.nan)
                r0 = s * cin * He + hb
                for c in range(cin):
                    for part in range(2):
                        a0, n = _span16((r0 + c * He + off) * nb, HR * nb)
                        assert n <= RAWP
                        raw[c, part, :n] = flat[part][a0:a0 + n]
                        for hi in range(CTXH if hybrid else 0):
                            a0, n = _span16((r0 + c * He + hi) * nb + 1, 4)
                            ctx[c, part, hi, :n] = flat[part][a0:a0 + n]
                rc0 = r0 & 3
                split = np.zeros((CIN, 2, HR, 8))
                for c in range(cin if hybrid else 0):
                    rc = (rc0 + c * (He & 3)) & 3
                    for part in range(2):
                        for h in range(HR):
                            for bb in range(1, 9):
                                k, sigma = _band_source(bb, True)
                                d = raw[c, part, ((rc + off) & 3) + h * nb + k]

                                def f(pp, hi, c=c, rc=rc, k=k):
                                    return ctx[c, pp, hi,
                                               ((rc + hi + 1) & 3) + k - 1]

                                def inner(pp, h=h, f=f):
                                    return (_COEFF1 * (f(pp, h + 6) - f(pp, h))
                                            + _COEFF2 * (f(pp, h + 4)
                                                         - f(pp, h + 2)))
                                split[c, part, h, bb - 1] = (
                                    0.5 * d + sigma * inner(0) if part
                                    else 0.5 * d - sigma * inner(1))
                ob = np.full((EG * NEG, HR, rl), np.nan)
                for t in np.flatnonzero(act):
                    x = np.zeros((CIN, HR, 2))
                    for c in range(CIN):
                        for h in range(HR):
                            for part in range(2):
                                if hybrid and t >= 384:
                                    x[c, h, part] = split[c, part, h,
                                                          b[t] - 1]
                                else:
                                    x[c, h, part] = raw[
                                        c, part,
                                        ((rc0 + c * (He & 3) + off) & 3)
                                        + h * nb
                                        + _band_source(b[t], hybrid)[0]]
                    acc = np.einsum("ec,chp->ehp", w[t], x)
                    for e in range(EG):
                        for h in range(HR):
                            for part in range(2):
                                ob[g[t] * EG + e, h,
                                   part * nbh + b[t]] = acc[e, h, part]
                for e in range(min(EG * NEG, cout - e0)):
                    row = s * cout + e0 + e
                    out[row, hb:hb + HR] = ob[e]
                    writes[row, hb:hb + HR] += 1
    return out, writes


@pytest.mark.parametrize("S,cin,cout,H,hybrid,upb", [
    (2, 16, 13, 4, True, 1),        # two blocks of outputs, 12 and 1
    (1, 9, 5, 8, True, 2),          # inputs past cin, one block
    (3, 3, 2, 4, False, 2),         # 129 bands; a run across streams
    (2, 5, 25, 8, True, 3),         # three blocks of outputs: 12, 12, 1
    (1, 4, 12, 4, False, 1),        # exactly one block of outputs
])
def test_mirror_of_the_real_kernel_writes_each_output_once(S, cin, cout, H,
                                                           hybrid, upb):
    rng = np.random.default_rng(S + cin + cout + H + hybrid)
    nb = 133 if hybrid else 129
    sre, sim = _t(rng, (S * cin, H + 6, 129)), _t(rng, (S * cin, H + 6, 129))
    Mre = _t(rng, (nb, cout, cin))
    got, writes = _mirror_real(sre, sim, Mre, hybrid, upb)
    assert (writes == 1).all()
    ref = ak.wide_mix_ri_reference(sre, sim, Mre, None, hybrid=hybrid)
    np.testing.assert_allclose(got, ref.double().numpy(), rtol=0, atol=1e-5)
