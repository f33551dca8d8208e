"""The PyTorch port vs goldens rendered by the compiled C reference
(tests/goldens/c_goldens.npz; see tests/test_c_goldens.py).  Budget
<=1e-4 absolute, <=1e-5 for the Voronoi weights."""
import os

import numpy as np
import pytest
import torch

from spatial_audio_framework_tpu_torch.models import ambi_drc, decorrelator
from spatial_audio_framework_tpu_torch.models import dirass, powermap, sldoa
from spatial_audio_framework_tpu_torch.models import (ambi_bin, ambi_dec,
                                                      ambi_enc, beamformer,
                                                      binauraliser,
                                                      binauraliser_nf, panner,
                                                      roombinauraliser,
                                                      rotator)
from spatial_audio_framework_tpu_torch.modules import hoa, hrir, sh, sh_est
from spatial_audio_framework_tpu_torch.modules import vbap
from spatial_audio_framework_tpu_torch.ops import afstft_ri
from spatial_audio_framework_tpu_torch.ops.afstft import AfSTFT
from spatial_audio_framework_tpu_torch.utils import dvf, filters, presets
from spatial_audio_framework_tpu_torch.utils import geometry as geo

pytestmark = pytest.mark.goldens

GOLDENS = os.path.join(os.path.dirname(__file__), "goldens", "c_goldens.npz")
TOL = 1e-4


@pytest.fixture(scope="module")
def g():
    return np.load(GOLDENS)


def test_voronoi_weights(g):
    _, dirs_deg, _ = hrir.default_hrirs()
    w = geo.get_voronoi_weights(dirs_deg)
    assert np.abs(w - g["dec_voronoi_w"]).max() <= 1e-5


def test_magls_decoder_order3(g):
    hrirs, dirs_deg, fs = hrir.default_hrirs()
    itds = hrir.estimate_itds(hrirs, fs)
    fb = hrir.hrirs_to_hrtfs_afstft(hrirs, 128)
    w = geo.get_voronoi_weights(dirs_deg)
    cf = AfSTFT(hop=128, hybrid=True).centre_freqs(48000.0)
    fb_eq = hrir.diffuse_field_equalise_hrtfs(fb, itds, cf, w)
    dec = hoa.get_binaural_ambi_decoder_mtx(
        fb_eq, dirs_deg, "magls", 3, freq_vector=cf, itds=itds, weights=w,
        enable_max_re_weighting=True)
    assert np.abs(dec - g["dec_magls_o3"]).max() <= TOL


@pytest.mark.parametrize("route", ["default", "one_pass"])
def test_ambi_bin_order4_end_to_end(g, route):
    """Order 4, MagLS, N3D, yaw = π folded into the weights (as the
    reference's process_ri does), one stream through the batched path in
    512-sample blocks: matches the compiled C example's output.  The
    default dispatch takes the two-kernel (d, g) route (cin = 25 > 16);
    "one_pass" forces the one-pass render_full_ri route."""
    cfg = ambi_bin.AmbiBinConfig(order=4, method="magls", norm="n3d")
    Mre, Mim = ambi_bin.design_ri(cfg, device="cpu")
    R = geo.yaw_pitch_roll2_rzyx(np.pi, 0.0, 0.0).astype(np.float32)
    M_rot = torch.from_numpy(
        np.asarray(sh.get_sh_rot_mtx_real(R, 4), np.float32))
    w = (torch.einsum("bes,st->bet", Mre, M_rot),
         torch.einsum("bes,st->bet", Mim, M_rot))
    x = torch.from_numpy(np.ascontiguousarray(
        g["ambi_bin_enc_y"][:, None] * g["ambi_bin_in_mono"][None, :],
        np.float32))[None]
    st = ambi_bin.init_state_batched(cfg, 1, device="cpu")
    outs = []
    for f in range(x.shape[-1] // 512):
        xb = x[..., f * 512:(f + 1) * 512]
        if route == "default":
            y, st = ambi_bin.process_ri_batched(cfg, w, st, xb)
        else:
            y, st = afstft_ri._render_one_pass(cfg.afstft, st, xb, *w)
        outs.append(y[0].numpy())
    err = np.abs(np.concatenate(outs, -1) - g["ambi_bin_out"]).max()
    assert err <= TOL, err


@pytest.mark.parametrize("case", ["binaur", "brot"])
def test_binauraliser_end_to_end(g, case):
    """The binauraliser example, 2 sources at (30°, 0°) and (−45°, 10°),
    default HRIRs, triplet interpolation, diffuse-field EQ; "brot" with the
    head rotated by yaw 40°, pitch −15°, roll 10° (the C's row convention,
    binauraliser.c:238-241).  One stream through process_ri_batched in
    128-sample blocks: the one-pass route with per-stream taps.  Matches
    the compiled C example's output."""
    rot = case == "brot"
    cfg = binauraliser.BinauraliserConfig(n_sources=2, enable_rotation=rot)
    w = binauraliser.design_ri(cfg, device="cpu")
    dirs = torch.tensor([[[30.0, 0.0], [-45.0, 10.0]]])
    ypr = (torch.from_numpy(np.deg2rad([[40.0, -15.0, 10.0]]).astype(
        np.float32)) if rot else None)
    x = torch.from_numpy(np.asarray(g[f"{case}_in"], np.float32))[None]
    fsz = int(g["binaur_frame_size"][0])
    st = binauraliser.init_state_batched(cfg, 1, device="cpu")
    outs = []
    for f in range(x.shape[-1] // fsz):
        y, st = binauraliser.process_ri_batched(
            cfg, w, st, x[..., f * fsz:(f + 1) * fsz], dirs, None, ypr)
        outs.append(y[0].numpy())
    err = np.abs(np.concatenate(outs, -1) - g[f"{case}_out"]).max()
    assert err <= TOL, err


_AMBI_DEC_CASES = {
    # dual-band AllRAD, max-rE above 800 Hz only, energy-preserving EQ
    "dec_e2e": dict(dec_method=("allrad", "allrad"), re_weight=(False, True)),
    # SAD below / EPAD above the transition, amplitude-preserving EQ
    "ada": dict(dec_method=("sad", "epad"), re_weight=(False, False),
                diff_eq_mode=(ambi_dec.AMPLITUDE_PRESERVING,
                              ambi_dec.AMPLITUDE_PRESERVING)),
    # MMD with max-rE in both bands and a per-band decoding order
    "adm": dict(dec_method=("mmd", "mmd"), re_weight=(True, True)),
}


@pytest.mark.parametrize("case", list(_AMBI_DEC_CASES))
def test_ambi_dec_end_to_end(g, case):
    """Order 3 → the golden 9-loudspeaker layout (cout·cin = 144 > 128, so
    the kernel route is analysis → einsum → synthesis), one stream through
    process_ri_batched in 128-sample blocks (H = 1): matches the compiled C
    example's output."""
    key = "dec_e2e_ls_dirs" if case == "dec_e2e" else "ad16_ls_dirs"
    ls = np.asarray(g[key], np.float64)
    opb = (np.asarray(g["adm_order_per_band"], int) if case == "adm"
           else None)
    cfg = ambi_dec.AmbiDecConfig(master_order=3, norm="n3d",
                                 transition_freq=800.0,
                                 **_AMBI_DEC_CASES[case])
    w = ambi_dec.design_ri(cfg, ls, opb, device="cpu")
    x = torch.from_numpy(np.asarray(g[f"{case}_in"], np.float32))[None]
    st = ambi_dec.init_state_batched(cfg, 1, 9, device="cpu")
    outs = []
    for f in range(x.shape[-1] // 128):
        y, st = ambi_dec.process_ri_batched(
            cfg, w, st, x[..., f * 128:(f + 1) * 128])
        outs.append(y[0].numpy())
    err = np.abs(np.concatenate(outs, -1) - g[f"{case}_out"]).max()
    assert err <= TOL, err


def _blocks(process, st, x, fsz):
    """x (1, n_in, T) through ``process(st, block) -> (y, st)`` in blocks of
    ``fsz`` samples → the first stream's output (n_out, T) as numpy."""
    outs = []
    for f in range(x.shape[-1] // fsz):
        y, st = process(st, x[..., f * fsz:(f + 1) * fsz])
        outs.append(y[0].numpy())
    return np.concatenate(outs, -1)


@pytest.mark.parametrize("case", ["pan", "pyr", "p2d"])
def test_panner_end_to_end(g, case):
    """The panner example, 2 sources, DTT 0.5, the 1° gain table, 32 blocks
    of 128 samples, one stream through process_ri_batched (the one-pass
    route with per-stream taps): "pan" on the golden 9-loudspeaker layout,
    "pyr" the same under a yaw/pitch/roll rotation (rows × Rzyx,
    panner.c:212-223), "p2d" a planar 5.0 ring on the 2-D pairwise table
    (source 1 sits at 20° elevation, which the 2-D lookup ignores)."""
    key = "p2d" if case == "p2d" else "pan"
    ls = np.asarray(g[f"{key}_ls_dirs"], np.float64)
    cfg = panner.PannerConfig(n_sources=2, n_loudspeakers=len(ls))
    w = panner.design(cfg, ls, device="cpu")
    assert w.gtable.shape[0] == (361 if case == "p2d" else 361 * 181)
    dirs = torch.from_numpy(np.asarray(g[f"{key}_src_dirs"], np.float32))[None]
    ypr = (torch.from_numpy(np.radians(np.asarray(
        g["pyr_ypr_deg"], np.float32)))[None] if case == "pyr" else None)
    x = torch.from_numpy(np.asarray(g[f"{case}_in"], np.float32))[None]
    out = _blocks(lambda st, xb: panner.process_ri_batched(cfg, w, st, xb,
                                                           dirs, ypr),
                  panner.init_state_batched(cfg, 1, len(ls), device="cpu"),
                  x[..., :32 * 128], 128)
    err = np.abs(out - g[f"{case}_out"]).max()
    assert err <= TOL, err


def test_ambi_enc_end_to_end(g):
    """The ambi_enc example: order 3, N3D, 3 sources, post scaling, 32
    frames of 64 samples; the state starts from the sources' directions."""
    cfg = ambi_enc.AmbiEncConfig(order=3, norm="n3d", n_sources=3,
                                 enable_post_scaling=True, frame_size=64)
    conv = ambi_enc.design(cfg, device="cpu")
    dirs = torch.from_numpy(np.asarray(g["enc_dirs"], np.float32))
    st = ambi_enc.init_state(cfg, np.asarray(g["enc_dirs"], np.float64),
                             device="cpu")
    x = torch.from_numpy(np.asarray(g["enc_in"], np.float32))
    outs = []
    for f in range(32):
        y, st = ambi_enc.process(cfg, conv, st, x[:, f * 64:(f + 1) * 64],
                                 dirs)
        outs.append(y.numpy())
    err = np.abs(np.concatenate(outs, -1) - g["enc_out"]).max()
    assert err <= TOL, err


@pytest.mark.parametrize("case", ["bnf", "bnfr"])
def test_binauraliser_nf_end_to_end(g, case):
    """The near-field binauraliser, 2 sources, 48 blocks of 128 samples,
    one stream through process_ri_batched: the DVF chain with the C's
    (mag + j·phase) scale and the HRTF interpolation table; "bnfr" with the
    head rotated by yaw 40°, pitch −15°, roll 10° (distances unrotated)."""
    rot = case == "bnfr"
    cfg = binauraliser_nf.BinauraliserNFConfig(n_sources=2,
                                               enable_rotation=rot)
    w = binauraliser_nf.design_ri(cfg, device="cpu")
    if rot:
        dirs = torch.tensor([[[35.0, 12.0], [-60.0, -8.0]]])
        dists = torch.tensor([[0.35, 0.8]])
        ypr = torch.from_numpy(np.deg2rad([[40.0, -15.0, 10.0]]).astype(
            np.float32))
    else:
        dirs = torch.from_numpy(np.asarray(g["bnf_src_dirs"],
                                           np.float32))[None]
        dists = torch.from_numpy(np.asarray(g["bnf_dists"], np.float32))[None]
        ypr = None
    x = torch.from_numpy(np.asarray(g[f"{case}_in"], np.float32))[None]
    out = _blocks(lambda st, xb: binauraliser_nf.process_ri_batched(
                      cfg, w, st, xb, dirs, dists, None, ypr),
                  binauraliser_nf.init_state_batched(cfg, 1, device="cpu"),
                  x[..., :48 * 128], 128)
    err = np.abs(out - g[f"{case}_out"]).max()
    assert err <= TOL, err


@pytest.mark.parametrize("case", ["rb", "rbr"])
def test_roombinauraliser_end_to_end(g, case):
    """The fork's BRIR renderer on its default-HRIR fallback, FABIAN-CTF
    diffuse-field EQ, 2 sources, 48 blocks of 128 samples, one stream
    through process_ri_batched: "rb" with rotation off (lookup at (0, 0)),
    "rbr" with the reference frame [1, 0, 0] rotated by yaw 40°, pitch
    −15°, roll 10° (roombinauraliser.c:239-244)."""
    rot = case == "rbr"
    cfg = roombinauraliser.RoomBinauraliserConfig(
        n_sources=2, enable_rotation=rot, enable_hrir_diff_eq=True,
        diff_eq_mode=roombinauraliser.DIFF_EQ_FABIAN_CTF,
        interp_mode=roombinauraliser.INTERP_TRI)
    cfg, w = roombinauraliser.design_ri(cfg, device="cpu")
    ypr = (torch.from_numpy(np.deg2rad([[40.0, -15.0, 10.0]]).astype(
        np.float32)) if rot else None)
    x = torch.from_numpy(np.asarray(g[f"{case}_in"], np.float32))[None]
    out = _blocks(lambda st, xb: roombinauraliser.process_ri_batched(
                      cfg, w, st, xb, None, ypr),
                  roombinauraliser.init_state_batched(cfg, 1, device="cpu"),
                  x[..., :48 * 128], 128)
    err = np.abs(out - g[f"{case}_out"]).max()
    assert err <= TOL, err


def test_dvf_params_and_coeffs(g):
    """interpDVFShelfParams and calcDVFCoeffs on the golden grid of lateral
    angles and distances, in float64 (the torch functions keep their
    inputs' dtype)."""
    A, R = np.meshgrid(np.array([0.0, 30.0, 90.0, 150.0]),
                       np.array([1.2, 2.0, 4.0]), indexing="ij")
    A, R = torch.from_numpy(A), torch.from_numpy(R)
    params = torch.stack(dvf.interp_dvf_shelf_params(A, R), dim=-1).numpy()
    assert np.abs(params - g["dvf_params"]).max() <= 1e-2   # fc is O(1e4) Hz
    b, a = dvf.calc_dvf_coeffs(A, R, 48000.0)
    ref_ba = np.asarray(g["dvf_ba"])
    # C's calcDVFCoeffs writes b[0], b[1], a[1] only (a[0] implicitly 1; the
    # golden slot carries the generator's 0 sentinel): compare those 3
    assert np.abs(b.numpy() - ref_ba[..., :2]).max() <= TOL
    assert np.abs(a.numpy()[..., 1] - ref_ba[..., 3]).max() <= TOL
    assert bool((a[..., 0] == 1.0).all())


@pytest.mark.parametrize("tag,in_fs,out_fs,pad", [
    ("48k_44k", 48000, 44100, False),     # interpolated table, downsample
    ("44k_48k", 44100, 48000, False),     # interpolated table, upsample
    ("48k_96k_pad", 48000, 96000, True),  # direct table + pow2 tail
    ("96k_48k", 96000, 48000, False),     # direct table, downsample
    ("48k_16k", 48000, 16000, False),     # heavy-down oversample>>=1 branch
])
def test_resample_hrirs(g, tag, in_fs, out_fs, pad):
    """resampleHRIRs (saf_hrir.c:365-465): speex QUALITY_MAX + skip_zeros +
    zero-fed tail, through the port's utils/speex.py."""
    ref = g[f"rsmp_{tag}_out"]
    out, out_len = hrir.resample_hrirs(g["rsmp_in"], in_fs, out_fs,
                                       pad_to_next_pow2=pad)
    assert out.shape == ref.shape and out_len == ref.shape[-1]
    assert np.abs(out - ref).max() <= TOL


def test_ambi_bin_spr_end_to_end(g):
    """ambi_bin with the SPR decoder, order 3, N3D, 64 blocks of 128
    samples, one stream through process_ri_batched."""
    cfg = ambi_bin.AmbiBinConfig(order=3, method="spr", norm="n3d")
    w = ambi_bin.design_ri(cfg, device="cpu")
    x = torch.from_numpy(np.asarray(g["ab2_in"], np.float32))[None]
    out = _blocks(lambda st, xb: ambi_bin.process_ri_batched(cfg, w, st, xb),
                  ambi_bin.init_state_batched(cfg, 1, device="cpu"),
                  x[..., :64 * 128], 128)
    err = np.abs(out - g["abspr_out"]).max()
    assert err <= TOL, err


# -- the single-stream entry points (one listener, 128-sample frames) ---------

def _frames(process, st, x, fsz, n):
    """x (n_in, T) through ``process(st, frame) -> (y, st)``, n frames of
    ``fsz`` samples → (n_out, n·fsz) numpy."""
    outs = []
    for f in range(n):
        y, st = process(st, x[:, f * fsz:(f + 1) * fsz])
        outs.append(y.numpy())
    return np.concatenate(outs, -1)


@pytest.mark.parametrize("entry,fsz", [("process", 128), ("process_ri", 512),
                                       ("process_ri", 128)])
def test_ambi_bin_head_tracked_end_to_end(g, entry, fsz):
    """Order 4, MagLS, N3D, the head turned by yaw = π through ``ypr`` (the
    SH rotation built per block, not folded by the test): the compiled C
    example's output, from the complex and the (re, im) entry points."""
    cfg = ambi_bin.AmbiBinConfig(order=4, method="magls", norm="n3d",
                                 enable_rotation=True)
    y_enc = sh.get_rsh(4, np.array([[-90.0, 0.0]], np.float32))[:, 0]
    assert np.abs(y_enc - g["ambi_bin_enc_y"]).max() <= TOL
    x = torch.from_numpy(np.ascontiguousarray(
        y_enc[:, None] * g["ambi_bin_in_mono"][None, :], np.float32))
    ypr = torch.tensor([np.pi, 0.0, 0.0], dtype=torch.float32)
    if entry == "process":
        w, st = ambi_bin.design(cfg, device="cpu"), ambi_bin.init_state(
            cfg, device="cpu")
    else:
        w, st = ambi_bin.design_ri(cfg, device="cpu"), ambi_bin.init_state_ri(
            cfg, device="cpu")
    proc = getattr(ambi_bin, entry)
    out = _frames(lambda s, xb: proc(cfg, w, s, xb, ypr), st, x, fsz,
                  x.shape[-1] // fsz)
    err = np.abs(out - g["ambi_bin_out"]).max()
    assert err <= TOL, err


@pytest.mark.parametrize("entry", ["process", "process_ri"])
def test_ambi_bin_fuma_rotation_end_to_end(g, entry):
    """FuMa input and a general head rotation: the C converts the signal
    FuMa → ACN first and then applies M_dec·M_rot (ambi_bin.c:420-455); the
    order-1 channel permutation does not commute with the rotation, so this
    fails if the conversion sits on the wrong side."""
    cfg = ambi_bin.AmbiBinConfig(order=1, method="magls", norm="fuma",
                                 ch_ordering="fuma", enable_rotation=True)
    x = torch.from_numpy(np.asarray(g["abf_in"], np.float32))
    ypr = torch.from_numpy(np.radians([20.0, -10.0, 5.0]).astype(np.float32))
    if entry == "process":
        w, st = ambi_bin.design(cfg, device="cpu"), ambi_bin.init_state(
            cfg, device="cpu")
    else:
        w, st = ambi_bin.design_ri(cfg, device="cpu"), ambi_bin.init_state_ri(
            cfg, device="cpu")
    proc = getattr(ambi_bin, entry)
    out = _frames(lambda s, xb: proc(cfg, w, s, xb, ypr), st, x, 128, 32)
    err = np.abs(out - g["abf_out"]).max()
    assert err <= TOL, err


@pytest.mark.parametrize("method,key", [("lsdiffeq", "ablsd_out"),
                                        ("spr", "abspr_out")])
def test_ambi_bin_lsdiffeq_spr_single_stream(g, method, key):
    """The LS + diffuse-field-EQ and SPR decoders, order 3, rotation off,
    64 frames through the complex ``process``."""
    cfg = ambi_bin.AmbiBinConfig(order=3, method=method, norm="n3d")
    w = ambi_bin.design(cfg, device="cpu")
    x = torch.from_numpy(np.asarray(g["ab2_in"], np.float32))
    out = _frames(lambda s, xb: ambi_bin.process(cfg, w, s, xb, None),
                  ambi_bin.init_state(cfg, device="cpu"), x, 128, 64)
    err = np.abs(out - g[key]).max()
    assert err <= TOL, (method, err)


def test_rotator_end_to_end(g):
    cfg = rotator.RotatorConfig(order=3, norm="n3d", frame_size=64)
    w = rotator.design(cfg, device="cpu")
    ypr = torch.from_numpy(np.radians([30.0, -20.0, 10.0]).astype(np.float32))
    x = torch.from_numpy(np.asarray(g["rot_in"], np.float32))
    out = _frames(lambda s, xb: rotator.process(cfg, w, s, xb, ypr),
                  rotator.init_state(cfg, device="cpu"), x, 64, 32)
    assert np.abs(out - g["rot_out"]).max() <= TOL


@pytest.mark.parametrize("btype,xkey,key", [
    (beamformer.BEAM_MAX_EV, "bf_in", "bf_out"),
    (beamformer.BEAM_CARDIOID, "bf2_in", "bfc_out"),
    (beamformer.BEAM_HYPERCARDIOID, "bf2_in", "bfh_out")])
def test_beamformer_end_to_end(g, btype, xkey, key):
    cfg = beamformer.BeamformerConfig(order=3, n_beams=2, beam_type=btype,
                                      norm="n3d")
    W = beamformer.design(cfg, np.asarray(g["bf_dirs"], np.float64),
                          device="cpu")
    x = torch.from_numpy(np.asarray(g[xkey], np.float32))
    out = _frames(lambda s, xb: beamformer.process(cfg, W, s, xb),
                  beamformer.init_state(cfg, device="cpu"), x, 128, 32)
    assert np.abs(out - g[key]).max() <= TOL


@pytest.mark.parametrize("case", ["binaur", "brot", "btp"])
def test_binauraliser_single_stream(g, case):
    """The complex ``process`` against the goldens the batched path meets
    ("binaur", "brot"), and "btp": INTERP_TRI_PS (magnitude + ITD
    interpolation with phase synthesis, binauraliser_internal.c:90), 2
    sources, 48 frames."""
    rot = case == "brot"
    mode = (binauraliser.INTERP_TRI_PS if case == "btp"
            else binauraliser.INTERP_TRI)
    cfg = binauraliser.BinauraliserConfig(n_sources=2, enable_rotation=rot,
                                          interp_mode=mode)
    w = binauraliser.design(cfg, device="cpu")
    dirs = torch.tensor([[20.0, -30.0], [-70.0, 35.0]] if case == "btp"
                        else [[30.0, 0.0], [-45.0, 10.0]])
    ypr = (torch.from_numpy(np.deg2rad([40.0, -15.0, 10.0]).astype(
        np.float32)) if rot else None)
    x = torch.from_numpy(np.asarray(g[f"{case}_in"], np.float32))
    out = _frames(lambda s, xb: binauraliser.process(cfg, w, s, xb, dirs,
                                                     None, ypr),
                  binauraliser.init_state(cfg, device="cpu"), x, 128,
                  x.shape[-1] // 128)
    err = np.abs(out - g[f"{case}_out"]).max()
    assert err <= TOL, err


@pytest.mark.parametrize("case", ["bnf", "bnfr"])
def test_binauraliser_nf_single_stream(g, case):
    rot = case == "bnfr"
    cfg = binauraliser_nf.BinauraliserNFConfig(n_sources=2,
                                               enable_rotation=rot)
    w = binauraliser_nf.design(cfg, device="cpu")
    if rot:
        dirs = torch.tensor([[35.0, 12.0], [-60.0, -8.0]])
        dists = torch.tensor([0.35, 0.8])
        ypr = torch.from_numpy(np.deg2rad([40.0, -15.0, 10.0]).astype(
            np.float32))
    else:
        dirs = torch.from_numpy(np.asarray(g["bnf_src_dirs"], np.float32))
        dists = torch.from_numpy(np.asarray(g["bnf_dists"], np.float32))
        ypr = None
    x = torch.from_numpy(np.asarray(g[f"{case}_in"], np.float32))
    out = _frames(lambda s, xb: binauraliser_nf.process(
                      cfg, w, s, xb, dirs, dists, None, ypr),
                  binauraliser_nf.init_state(cfg, device="cpu"), x, 128, 48)
    err = np.abs(out - g[f"{case}_out"]).max()
    assert err <= TOL, err


@pytest.mark.parametrize("case", ["rb", "rbr"])
def test_roombinauraliser_single_stream(g, case):
    rot = case == "rbr"
    cfg = roombinauraliser.RoomBinauraliserConfig(
        n_sources=2, enable_rotation=rot, enable_hrir_diff_eq=True,
        diff_eq_mode=roombinauraliser.DIFF_EQ_FABIAN_CTF,
        interp_mode=roombinauraliser.INTERP_TRI)
    cfg, w = roombinauraliser.design(cfg, device="cpu")
    ypr = (torch.from_numpy(np.deg2rad([40.0, -15.0, 10.0]).astype(
        np.float32)) if rot else None)
    x = torch.from_numpy(np.asarray(g[f"{case}_in"], np.float32))
    out = _frames(lambda s, xb: roombinauraliser.process(cfg, w, s, xb, None,
                                                         ypr),
                  roombinauraliser.init_state(cfg, device="cpu"), x, 128, 48)
    err = np.abs(out - g[f"{case}_out"]).max()
    assert err <= TOL, err


@pytest.mark.parametrize("case", ["pan", "pyr", "p2d"])
def test_panner_single_stream(g, case):
    key = "p2d" if case == "p2d" else "pan"
    ls = np.asarray(g[f"{key}_ls_dirs"], np.float64)
    cfg = panner.PannerConfig(n_sources=2, n_loudspeakers=len(ls))
    w = panner.design(cfg, ls, device="cpu")
    dirs = torch.from_numpy(np.asarray(g[f"{key}_src_dirs"], np.float32))
    ypr = (torch.from_numpy(np.radians(np.asarray(
        g["pyr_ypr_deg"], np.float32))) if case == "pyr" else None)
    x = torch.from_numpy(np.asarray(g[f"{case}_in"], np.float32))
    out = _frames(lambda s, xb: panner.process(cfg, w, s, xb, dirs, ypr),
                  panner.init_state(cfg, device="cpu"), x, 128, 32)
    err = np.abs(out - g[f"{case}_out"]).max()
    assert err <= TOL, err


@pytest.mark.parametrize("entry", ["process", "process_ri_batched"])
def test_ambi_dec_binaural_preview(g, entry):
    """binauraliseLS (ambi_dec.c:543-563): TRI_PS HRTFs at the 9
    loudspeakers folded onto the dual-band AllRAD decode, scaled by
    1/sqrt(nLS); the batched path folds H_bin·M on the host (2e-4 there, as
    ``tests/test_c_goldens.py``)."""
    ls = np.asarray(g["ad16_ls_dirs"], np.float64)
    cfg = ambi_dec.AmbiDecConfig(master_order=3, norm="n3d",
                                 dec_method=("allrad", "allrad"),
                                 re_weight=(False, True),
                                 transition_freq=800.0, binauralise_ls=True)
    x = torch.from_numpy(np.asarray(g["adb_in"], np.float32))
    if entry == "process":
        w = ambi_dec.design(cfg, ls, device="cpu")
        hin = np.asarray(g["adb_hinterp"])           # (nLS, nBands, 2)
        H = w.H_bin.numpy() * 3.0                    # undo 1/sqrt(9)
        assert np.abs(H.transpose(2, 0, 1) - hin).max() <= TOL
        out = _frames(lambda s, xb: ambi_dec.process(cfg, w, s, xb),
                      ambi_dec.init_state(cfg, 9, device="cpu"), x, 128, 32)
        assert np.abs(out - g["adb_out"]).max() <= TOL
    else:
        w = ambi_dec.design_ri(cfg, ls, device="cpu")
        y, _ = ambi_dec.process_ri_batched(
            cfg, w, ambi_dec.init_state_batched(cfg, 1, 9, device="cpu"),
            x[None])
        assert np.abs(y[0].numpy() - g["adb_out"]).max() <= 2e-4


# -- the analysers and the decorrelator: the JAX tests' recipes and
# -- tolerances (tests/test_c_goldens.py), through the port on the CPU ------

def test_sph_pwd_music_esprit(g):
    """sphPWD / sphMUSIC maps and peaks on the t-design-21 grid, and the
    ESPRIT directions from the signal subspace (MUSIC compared as 1/p, the
    quantity computed)."""
    grid = presets.tdesign(21)
    Cx = np.asarray(g["doa_Cx"])
    peaks, p = sh_est.sph_pwd(Cx, grid, 2)
    ref = np.asarray(g["doa_pwd_map"])
    assert np.abs(p - ref).max() <= TOL * max(1.0, ref.max())
    assert set(map(int, peaks)) == set(map(int, g["doa_pwd_peaks"]))
    peaks, p = sh_est.sph_music(Cx, grid, 2)
    ref = np.asarray(g["doa_music_map"])
    assert np.abs(1.0 / p - 1.0 / ref).max() \
        <= TOL * max(1.0, (1.0 / ref).max())
    assert set(map(int, peaks)) == set(map(int, g["doa_music_peaks"]))
    _, V = np.linalg.eigh(Cx.astype(np.complex64))
    dirs = np.sort(sh_est.sph_esprit(V[:, ::-1][:, :2]), axis=0)
    assert np.abs(dirs - np.sort(np.asarray(g["doa_esprit_dirs_rad"]),
                                 axis=0)).max() <= 1e-3


def test_sector_coeffs(g):
    A = sh.compute_vel_coeffs_mtx(2)
    assert np.abs(A - g["sec_A_xyz_o2"]).max() <= TOL
    dirs = np.asarray(g["sec_dirs_deg"])
    for ep, key, i in ((True, "sec_coeffs_ep_o2", 0),
                       (False, "sec_coeffs_ap_o2", 1)):
        sec, norm = sh.compute_sector_coeffs(2, sh.SECTOR_PATTERN_PWD, dirs,
                                             ep)
        assert abs(norm - g["sec_norms"][i]) <= TOL
        assert np.abs(sec.reshape(24, 16) - g[key]).max() <= TOL


def test_faf_iir_filterbank(g):
    """The host bank, at the C's own recursion noise (2.5e-3)."""
    bank = filters.FafIIRFilterbank(3, [250.0, 500.0, 1000.0, 2000.0, 4000.0],
                                    48000.0)
    assert np.abs(bank.apply(np.asarray(g["faf_in"])) - g["faf_out_o3"]
                  ).max() <= 2.5e-3


@pytest.mark.parametrize("case", ["dcr", "dkr"])
def test_decorrelator_end_to_end(g, case):
    """Sample-exact lattice decorrelation, the delays from the C's rand()
    stream (at 5016 for ``dcr``, 0 for ``dkr``); ``dkr`` with the transient
    ducker, level compensation and a 0.8 wet/dry mix."""
    if case == "dcr":
        cfg = decorrelator.DecorrelatorConfig(n_channels=4)
        w = decorrelator.design(cfg, c_rand_offset=5016, device="cpu")
    else:
        cfg = decorrelator.DecorrelatorConfig(
            n_channels=4, decor_amount=0.8, enable_transient_ducker=True,
            compensate_level=True)
        w = decorrelator.design(cfg, c_rand_offset=0, device="cpu")
    x = torch.from_numpy(np.asarray(g[f"{case}_in"], np.float32))
    out = _frames(lambda s, xb: decorrelator.process(cfg, w, s, xb),
                  decorrelator.init_state(cfg, w, device="cpu"), x, 128, 64)
    assert np.abs(out - g[f"{case}_out"]).max() <= TOL
    if case == "dcr":   # the stream-batched path, one block of 64 hops
        y, _ = decorrelator.process_ri_batched(
            cfg, w, decorrelator.init_state_batched(cfg, w, 1, device="cpu"),
            x[None])
        assert np.abs(y[0].numpy() - g["dcr_out"]).max() <= TOL


def test_decorrelator_default_delays_statistics(g):
    """The numpy-rng delays still behave like the C: per-channel energy
    within 2x of it, outputs decorrelated from the input."""
    cfg = decorrelator.DecorrelatorConfig(n_channels=4)
    w = decorrelator.design(cfg, device="cpu")
    x = np.asarray(g["dcr_in"], np.float32)
    out = _frames(lambda s, xb: decorrelator.process(cfg, w, s, xb),
                  decorrelator.init_state(cfg, w, device="cpu"),
                  torch.from_numpy(x), 128, 64)
    ref = np.asarray(g["dcr_out"])
    ratio = (out[:, 2048:] ** 2).mean(-1) / (ref[:, 2048:] ** 2).mean(-1)
    assert np.all(ratio > 0.5) and np.all(ratio < 2.0)
    for ch in range(4):
        a = out[ch, 2048:] - out[ch, 2048:].mean()
        b = x[ch, 2048:] - x[ch, 2048:].mean()
        assert abs(np.corrcoef(a, b)[0, 1]) < 0.35


@pytest.mark.parametrize("entry", ["process", "process_ri_batched"])
def test_ambi_drc_end_to_end(g, entry):
    """64 frames of amplitude-modulated noise through the compressor
    (order 1, -30 dB, 8:1, 5 dB knee, 20/200 ms, +6/+3 dB); the batched
    packed path in one 64-hop block."""
    cfg = ambi_drc.AmbiDrcConfig(order=1, theshold_db=-30.0, ratio=8.0,
                                 knee_db=5.0, attack_ms=20.0,
                                 release_ms=200.0, in_gain_db=6.0,
                                 out_gain_db=3.0)
    x = torch.from_numpy(np.asarray(g["drc_in"], np.float32))
    if entry == "process":
        out = _frames(lambda s, xb: ambi_drc.process(cfg, s, xb),
                      ambi_drc.init_state(cfg, device="cpu"), x, 128, 64)
    else:
        y, _ = ambi_drc.process_ri_batched(
            cfg, ambi_drc.init_state_batched(cfg, 1, device="cpu"), x[None])
        out = y[0].numpy()
    assert np.abs(out - g["drc_out"]).max() <= TOL


def _dense_itab(g, key, n_grid):
    """A dense (nDisp, nGrid) VBAP interpolation table from the C handle's
    sparse top-3 dump."""
    iti = np.asarray(g[f"{key}_iti"])
    itw = np.asarray(g[f"{key}_itw"], np.float32)
    T = np.zeros((iti.shape[0], n_grid), np.float32)
    np.add.at(T, (np.arange(iti.shape[0])[:, None], iti), itw)
    return T


def _pm_run(g, mode, tag, table):
    cfg = powermap.PowermapConfig(master_order=3, mode=mode, n_sources=2,
                                  norm="n3d", cov_avg_coeff=0.5,
                                  pmap_avg_coeff=0.666,
                                  analysis_order_per_band=(1,) * 133)
    w = powermap.design(cfg, device="cpu")
    w = w._replace(interp_table=torch.from_numpy(table(w)),
                   interp_dirs_deg=np.asarray(g["pm_grid_dirs"], np.float64))
    st = powermap.init_state(cfg, w, device="cpu")
    x = np.asarray(g[f"{tag}_in"], np.float32)
    maps = []
    for blk in range(8):
        p, st = powermap.analysis(cfg, w, st, torch.from_numpy(x[blk]))
        maps.append(p.numpy())
    return maps


def test_powermap_music_end_to_end(g):
    """The part-7 MUSIC recipe: the C's map froze after block 1 at the
    create-time per-band order 1, so block 1 is exact and the rest stay
    close (stationary scene)."""
    c_grid = np.asarray(g["pm_grid_dirs"], np.float64)
    maps = _pm_run(g, powermap.PM_MUSIC, "pm", lambda w: (
        vbap.vbap_gain_table_to_interp_table(
            vbap.generate_vbap_gain_table_3d_srcs(c_grid, w.grid_dirs_deg))
        .astype(np.float32)))
    assert np.abs(maps[0] - g["pm_pmap"]).max() <= 1e-4
    assert np.abs(maps[-1] - g["pm_pmap"]).max() <= 2e-2


@pytest.mark.parametrize("tag,mode", [("pmp", "pwd"), ("pmv", "mvdr"),
                                      ("pml", "music_log"),
                                      ("pmc", "cropac_lcmv"),
                                      ("pmn", "minnorm")])
def test_powermap_modes_end_to_end(g, tag, mode):
    """The remaining modes with the C handle's own display table; MinNorm
    statistically, as the JAX test (its linear map amplifies ULP-level SCM
    differences at the planted sources without bound)."""
    maps = _pm_run(g, mode, tag, lambda w: _dense_itab(
        g, f"{tag}_pmap", w.interp_table.shape[1]))
    ours, ref = maps[-1], np.asarray(g[f"{tag}_pmap"])
    if mode == "minnorm":
        assert np.corrcoef(np.log(ours + 1e-5), np.log(ref + 1e-5))[0, 1] \
            >= 0.8
        ug = np.asarray(geo.unit_sph2cart(
            np.asarray(g["pm_grid_dirs"], np.float64), degrees=True))
        srcs = np.asarray(geo.unit_sph2cart(
            np.array([[45.0, 20.0], [-120.0, -15.0]]), degrees=True))
        for m in (ours, ref):
            cosang = (ug[np.argsort(m)[-5:]] @ srcs.T).max(-1)
            assert np.degrees(np.arccos(np.clip(cosang, -1, 1))).max() <= 35
    else:
        tol = {"cropac_lcmv": 5e-3}.get(mode, 2e-3)
        assert np.abs(ours - ref).max() <= tol


def test_sldoa_end_to_end(g):
    """8 blocks: per-sector averaged DoAs, colour and alpha display."""
    cfg = sldoa.SldoaConfig(master_order=3, norm="n3d", min_freq=500.0,
                            max_freq=10000.0, avg_ms=0.5)
    w = sldoa.design(cfg, device="cpu")
    st = sldoa.init_state(cfg, device="cpu")
    x = np.asarray(g["sl_in"], np.float32)
    for blk in range(8):
        out, st = sldoa.analysis(cfg, w, st, torch.from_numpy(x[blk]))
    freqs = cfg.afstft.centre_freqs(cfg.fs)
    sel = (freqs >= 500.0) & (freqs <= 10000.0)
    sel[0] = False
    for name, mine, tol in (("sl_azi", out.azi_deg, 0.05),
                            ("sl_elev", out.elev_deg, 0.05),
                            ("sl_colour", out.colour_scale, 1e-6),
                            ("sl_alpha", out.alpha_scale, 1e-4)):
        ref = np.asarray(g[name]).reshape(133, 49)[:, :9]
        assert np.abs(mine.numpy()[sel][:, :9] - ref[sel]).max() <= tol, name


@pytest.mark.parametrize("tag,mode", [("dir", "upscale"), ("dirn", "nearest"),
                                      ("diro", "off"), ("diru", "upscale")])
def test_dirass_end_to_end(g, tag, mode):
    """Order 2, t-design 18, UPSCALE to order 6 / NEAREST / OFF, 6 blocks.
    ``dir`` (part 8, the map frozen at block 1 in the C, the display table
    rebuilt from the C grid) at 5e-2 and correlation 0.995; the re-armed
    ``dirn`` / ``diro`` / ``diru`` with the handle's own tables at 1e-3
    (off) and 1e-2."""
    cfg = dirass.DirassConfig(input_order=2, upscale_order=6, mode=mode,
                              beam_type="maxre", grid_tdesign=18,
                              min_freq_hz=100.0, max_freq_hz=8000.0,
                              pmap_avg_coeff=0.25, norm="n3d")
    w = dirass.design(cfg, device="cpu")
    c_grid = np.asarray(g["dir_grid_dirs"], np.float64)
    if tag == "dir":
        table = vbap.vbap_gain_table_to_interp_table(
            vbap.generate_vbap_gain_table_3d_srcs(c_grid, w.grid_dirs_deg))
    else:
        table = _dense_itab(g, f"{tag}_pmap", w.interp_table.shape[1])
    w = w._replace(
        interp_table=torch.from_numpy(np.asarray(table, np.float32)),
        interp_dirs_deg=c_grid,
        interp_u=torch.from_numpy(np.asarray(
            geo.unit_sph2cart(c_grid, degrees=True), np.float32)))
    st = dirass.init_state(cfg, w, device="cpu")
    x = np.asarray(g[f"{tag}_in"], np.float32)
    for blk in range(6):
        pmap, st = dirass.analysis(cfg, w, st, torch.from_numpy(x[blk]))
    pmap, ref = pmap.numpy(), np.asarray(g[f"{tag}_pmap"])
    if tag == "dir":
        assert np.abs(pmap - ref).max() <= 5e-2
        assert np.corrcoef(pmap, ref)[0, 1] >= 0.995
    else:
        assert np.abs(pmap - ref).max() <= (1e-3 if mode == "off" else 1e-2)


# -- the fixtures of earlier slices held through the port: SH, afSTFT, VBAP,
# -- decoders, beams, ambi_enc gains, the quickhull, utility surfaces ------

def test_get_sh_real_order7(g):
    Y = sh.get_sh_real(7, g["sh_dirs_rad"])
    assert np.abs(Y - g["sh_Y_o7"]).max() <= TOL


def test_get_rsh_order4(g):
    assert np.abs(sh.get_rsh(4, g["sh_dirs_deg"]) - g["sh_RSH_o4"]
                  ).max() <= TOL


def test_afstft_forward_backward(g):
    """Blockwise forward spectra and the round trip of the complex afSTFT
    (hybrid, hop 128) match the C."""
    bank = AfSTFT(hop=128, hybrid=True, low_delay=False)
    assert np.abs(bank.centre_freqs(48000.0)
                  - g["afstft_centre_freqs"]).max() == 0.0
    x = torch.from_numpy(np.asarray(g["afstft_in"], np.float32))
    st = bank.init_state(4, 4, device="cpu")
    specs, outs = [], []
    for f in range(8):
        S, st = bank.analysis(st, x[:, f * 512:(f + 1) * 512])
        specs.append(S.numpy())
        y, st = bank.synthesis(st, S)
        outs.append(y.numpy())
    spec_err = np.abs(np.stack(specs) - g["afstft_spec"]).max()
    assert spec_err <= 2e-4 * np.abs(g["afstft_spec"]).max()
    assert np.abs(np.concatenate(outs, -1) - g["afstft_out"]).max() <= TOL


def test_vbap_gain_table_3d(g):
    ls = np.asarray(g["vbap_ls_dirs"], np.float64)
    gt = vbap.generate_vbap_gain_table_3d(ls, 15, 15)
    assert gt.shape == tuple(g["vbap_gtable_15deg"].shape)
    assert np.abs(gt - g["vbap_gtable_15deg"]).max() <= TOL
    gt = vbap.generate_vbap_gain_table_3d(ls, 15, 15, spread=30.0)
    assert np.abs(gt - g["vbap_gtable_15deg_spread30"]).max() <= TOL


@pytest.mark.parametrize("method", ["sad", "mmd", "epad", "allrad"])
@pytest.mark.parametrize("maxre", [0, 1])
def test_loudspeaker_decoder_mtx(g, method, maxre):
    dec = hoa.get_loudspeaker_decoder_mtx(
        np.asarray(g["lsdec_dirs"], np.float64), method, 3,
        enable_max_re_weighting=bool(maxre))
    assert np.abs(dec - g[f"lsdec_{method}_o3_maxre{maxre}"]).max() <= TOL


def test_beam_weights(g):
    for key, fn in [("bw_cardioid", sh.beam_weights_cardioid),
                    ("bw_hypercardioid", sh.beam_weights_hypercardioid),
                    ("bw_maxev", sh.beam_weights_max_ev)]:
        for n in range(1, 5):
            assert np.abs(fn(n) - g[key][n - 1][:n + 1]).max() <= TOL
    mine = sh.rotate_axis_coeffs_real(3, sh.beam_weights_hypercardioid(3),
                                      1.1, -0.6)
    assert np.abs(mine - g["bw_rot_cnm_o3"]).max() <= TOL


def test_ambi_enc_gains_solo(g):
    """Per-source gains changed mid-stream and solo / unsolo
    (ambi_enc.c:135-137): gains scale the input frame that feeds the next
    output frame."""
    cfg = ambi_enc.AmbiEncConfig(order=2, n_sources=3, norm="n3d",
                                 frame_size=64)
    conv = ambi_enc.design(cfg, device="cpu")
    dirs = torch.from_numpy(np.asarray(g["aeg_dirs"], np.float32))
    st = ambi_enc.init_state(cfg, np.asarray(g["aeg_dirs"], np.float64),
                             device="cpu")
    x = torch.from_numpy(np.asarray(g["aeg_in"], np.float32))
    gains = {0: [1.0, 1.0, 1.0], 8: [0.5, 2.0, 1.0], 16: [0.0, 0.0, 1.0],
             24: [1.0, 1.0, 1.0]}
    outs = []
    for f in range(32):
        gg = torch.tensor(gains[8 * (f // 8)])
        y, st = ambi_enc.process(cfg, conv, st, x[:, f * 64:(f + 1) * 64],
                                 dirs, src_gains=gg)
        outs.append(y.numpy())
    assert np.abs(np.concatenate(outs, -1) - g["aeg_out"]).max() <= TOL


def test_convhull3d_triangulation(g):
    """The quickhull's faces, face order and vertex order, three grids in
    one rand() stream (as the C process made them)."""
    from spatial_audio_framework_tpu_torch.utils.convhull3d import (
        convhull_3d_build, glibc_rand)

    stream = glibc_rand()
    for tag in ("hrir836", "grid60", "tdes48"):
        faces = convhull_3d_build(np.asarray(g[f"vbh_{tag}_verts"],
                                             np.float64), rand_stream=stream)
        np.testing.assert_array_equal(faces, np.asarray(g[f"vbh_{tag}_faces"]),
                                      err_msg=tag)


def test_get_sh_complex(g):
    Y = sh.get_sh_complex(4, np.asarray(g["mu_shc_dirs_rad"], np.float64))
    assert np.abs(Y - g["mu_shc_Y_o4"]).max() <= TOL


def test_rotate_axis_coeffs_complex(g):
    c = sh.rotate_axis_coeffs_complex(3, sh.beam_weights_cardioid(3), 0.8,
                                      -1.3)
    assert np.abs(c - g["mu_rot_cnm_cmplx_o3"]).max() <= TOL


def test_check_cond_number_sht_real(g):
    grid = presets.tdesign(9)
    dirs_rad = np.stack([np.radians(grid[:, 0]),
                         np.pi / 2 - np.radians(grid[:, 1])], -1)
    cond = sh.check_cond_number_sht_real(4, dirs_rad)
    assert np.abs(cond - g["mu_cond_o4"]).max() <= 1e-5 * cond.max()


def test_truncation_eq(g):
    w_n = hoa.get_max_re_weights(1)
    gain = hoa.truncation_eq(np.array([w_n[0], w_n[1]]), 1, 7,
                             np.asarray(g["mu_teq_kr"], np.float64), 12.0)
    assert np.abs(gain - g["mu_teq_gain"]).max() <= TOL * 10.0


def test_binaural_diffuse_coherence(g):
    hrirs, dirs, fs = hrir.default_hrirs()
    coh = hrir.binaural_diffuse_coherence(
        hrir.hrirs_to_hrtfs_afstft(hrirs, 128), hrir.estimate_itds(hrirs, fs),
        AfSTFT(hop=128, hybrid=True).centre_freqs(48000.0))
    assert np.abs(coh - g["mu_bin_coh"]).max() <= TOL


# -- convolution, room simulation, CDF4SAP, HADES and the spreader ----------

@pytest.mark.parametrize("partitioned", [False, True])
def test_matrix_conv(g, partitioned):
    from spatial_audio_framework_tpu_torch.ops.matrix_conv import MatrixConv

    mc = MatrixConv(hop=128, length_h=1024, n_in=2, n_out=3,
                    partitioned=partitioned)
    Hd = mc.design(np.asarray(g["mc_H"]), "cpu")
    st = mc.init_state(device="cpu")
    x = torch.from_numpy(np.asarray(g["mc_in"], np.float32))
    outs = []
    for b in range(8):
        y, st = mc.apply_block(Hd, st, x[:, b * 128:(b + 1) * 128])
        outs.append(y.numpy())
    ref = g["mc_out_part" if partitioned else "mc_out_nonpart"]
    assert np.abs(np.concatenate(outs, -1) - ref).max() <= TOL
    if partitioned:       # the (re, im) form, the whole input in one block
        y, _ = mc.apply_block_ri(mc.design_ri(np.asarray(g["mc_H"]), "cpu"),
                                 mc.init_state_ri(device="cpu"), x)
        assert np.abs(y.numpy() - ref).max() <= TOL


@pytest.mark.parametrize("partitioned", [False, True])
def test_multiconv(g, partitioned):
    from spatial_audio_framework_tpu_torch.ops.matrix_conv import MultiConv

    mc = MultiConv(hop=128, length_h=300, n_ch=3, partitioned=partitioned)
    y, _ = mc.apply_block(mc.design(np.asarray(g["mtc_H"]), "cpu"),
                          mc.init_state(device="cpu"),
                          torch.from_numpy(np.asarray(g["mtc_in"],
                                                      np.float32)))
    key = "mtc_out_part" if partitioned else "mtc_out_nonpart"
    assert np.abs(y.numpy() - g[key]).max() <= TOL


def test_tvconv(g):
    """saf_TVConv across position changes (the one-hop crossfade), both
    forms of the per-hop block path."""
    from spatial_audio_framework_tpu_torch.ops.matrix_conv import TVConv

    H = np.asarray(g["tvc_H"])
    x = torch.from_numpy(np.asarray(g["tvc_in"], np.float32))
    idx = torch.from_numpy(np.asarray(g["tvc_idx"], np.int32))
    tv = TVConv(hop=128, length_h=512, n_out=2, n_irs=3)
    y, _ = tv.apply_block(tv.design(H, "cpu"), tv.init_state(0, device="cpu"),
                          x, idx)
    assert np.abs(y.numpy() - g["tvc_out"]).max() <= TOL
    y, _ = tv.apply_block_ri(tv.design_ri(H, "cpu"),
                             tv.init_state_ri(0, device="cpu"), x, idx)
    assert np.abs(y.numpy() - g["tvc_out"]).max() <= TOL


def test_ims_shoebox_rir(g):
    from spatial_audio_framework_tpu_torch.modules import reverb

    base = np.array([0.30, 0.24, 0.12, 0.06])
    room = reverb.ShoeboxRoom(
        room_dims=[10.0, 7.0, 4.0],
        abs_wall=base[:, None] + 0.02 * np.arange(6)[None, :],
        lowest_octave_band=250.0, fs=48000.0)
    sid = room.add_source([6.2, 5.1, 1.2])
    rid = room.add_receiver_sh(1, [2.1, 3.3, 1.6])
    room.compute_echograms(max_order=3)
    rir = room.render_rirs(fractional_delays=False)[(rid, sid)]
    assert rir.shape == g["ims_rir_o3_sh1"].shape
    assert np.abs(rir - g["ims_rir_o3_sh1"]).max() <= TOL


@pytest.mark.parametrize("entry", ["process_ri", "process"])
def test_ambi_roomsim_end_to_end(g, entry):
    """64 frames through the ambi_roomsim example (order 2, 2 sources,
    reflection order 2, broadband default absorption)."""
    from spatial_audio_framework_tpu_torch.models import ambi_roomsim as RS

    cfg = RS.AmbiRoomSimConfig(sh_order=2, n_sources=2, n_receivers=1,
                               refl_order=2, room_dims=(10.0, 7.0, 4.0))
    src = np.array([[2.0, 3.0, 1.5], [4.0, 2.0, 1.7]])
    rec = np.array([[3.0, 2.5, 1.6]])
    if entry == "process_ri":
        w = RS.design_ri(cfg, src, rec, device="cpu")
        st, proc = RS.init_state_ri(cfg, w, device="cpu"), RS.process_ri
    else:
        w = RS.design(cfg, src, rec, device="cpu")
        st, proc = RS.init_state(cfg, w, device="cpu"), RS.process
    x = torch.from_numpy(np.asarray(g["ars_in"], np.float32))
    outs = []
    for f in range(64):
        y, st = proc(cfg, w, st, x[:, f * 128:(f + 1) * 128])
        outs.append(y.numpy())
    assert np.abs(np.concatenate(outs, -1) - g["ars_out"]).max() <= TOL


@pytest.mark.parametrize("energy", [0, 1])
@pytest.mark.parametrize("cplx", [False, True])
def test_cdf4sap(g, cplx, energy):
    """The generic path on float32 tensors (torch.linalg.svd), at the JAX
    test's 1e-3."""
    from spatial_audio_framework_tpu_torch.modules import cdf4sap

    s = "_c" if cplx else ""
    dt = np.complex64 if cplx else np.float32
    f = (cdf4sap.formulate_M_and_Cr_cmplx if cplx
         else cdf4sap.formulate_M_and_Cr)
    M, Cr = f(*(torch.from_numpy(np.asarray(g[f"cdf_{k}{s}"]).astype(dt))
                for k in ("Cx", "Cy", "Q")), use_energy=bool(energy),
              reg=0.01)
    suff = s + ("_energy" if energy else "")
    assert np.abs(M.numpy() - g["cdf_M" + suff]).max() <= 1e-3
    assert np.abs(Cr.numpy() - g["cdf_Cr" + suff]).max() <= 1e-3


def _hades_run(g, pfx, *, hybrid, low_delay, beam, interp, enable_cm,
               n_blocks, out_tol, hrirs=None, hrir_dirs=None, hfs=48000.0,
               redit=False):
    """The JAX tests' HADES recipe (tests/test_c_goldens.py) through the
    port's two-stage path: a 6-mic array on the 36-direction t-design
    grid, hop 64, blocks of 256; diffuseness and DoA per block, the
    binaural output at the end."""
    from spatial_audio_framework_tpu_torch.modules import hades as HD

    ana = HD.HadesAnalysis(
        fs=48000.0, hop=64, h_array=np.asarray(g[f"{pfx}_h_array"], np.float32),
        grid_dirs_deg=np.asarray(g["hds_grid_dirs_deg"], np.float64),
        blocksize=256, hybrid=hybrid, low_delay=low_delay, device="cpu")
    assert np.abs(ana.freq_vector - g[f"{pfx}_freq_vector"]).max() <= 1e-2
    if hrirs is None:
        hrirs, hrir_dirs, hfs = hrir.default_hrirs()
    syn = HD.HadesSynthesis(ana, hrirs=hrirs, hrir_dirs_deg=hrir_dirs,
                            hrir_fs=hfs, beam_option=beam,
                            ref_indices=(1, 5), enable_cm=enable_cm,
                            interp_option=interp)
    assert np.abs(syn.H_bin - g[f"{pfx}_H_bin"]).max() <= 2e-5
    assert np.abs(syn.diff_eq - g[f"{pfx}_diff_eq"]).max() <= 1e-5
    ed = HD.HadesRadialEditor(ana.grid_dirs_deg) if redit else None
    ramp = -70.0 + 0.45 * np.arange(360)          # crosses both dB clamps
    x = np.asarray(g[f"{pfx}_in"], np.float32)
    outs = []
    for blk in range(n_blocks):
        params, sigs = ana.apply(x[:, blk * 256:(blk + 1) * 256])
        assert np.abs(params.diffuseness
                      - g[f"{pfx}_diffuseness"][blk]).max() <= 1e-5, blk
        assert (params.doa_idx
                == np.asarray(g[f"{pfx}_doa_idx"][blk]).astype(int)).all(), blk
        if ed is not None:
            params = ed.apply(params, ramp)
        outs.append(syn.apply(params, sigs))
    if redit:
        assert np.abs(params.gains_dir - g[f"{pfx}_gains_dir"]).max() <= 1e-6
    ref = np.asarray(g[f"{pfx}_out" if pfx != "hds" else "hds_out_bin"])
    err = np.abs(np.concatenate(outs, -1) - ref.reshape(2, -1)).max()
    assert err <= out_tol, err
    return ana, syn


def test_hades_end_to_end(g):
    """BMVDR + covariance matching, nearest HRTFs, low-delay non-hybrid
    bank (``hds``), 16 blocks, at the JAX test's 5e-4 (the C's own chain
    moves by 5.3e-4 for a one-ulp input change)."""
    ana, syn = _hades_run(g, "hds", hybrid=False, low_delay=True,
                          beam="bmvdr", interp="nearest", enable_cm=True,
                          n_blocks=16, out_tol=5e-4)
    assert np.abs(ana.H_array - g["hds_H_array_fb"]).max() <= 1e-5
    assert np.abs(ana.DCM - g["hds_DCM"]).max() <= 1e-5
    assert abs(ana.cov_avg_coeff - float(np.ravel(g["hds_cov_avg"])[0])) <= 1e-6


@pytest.mark.parametrize("pfx", ["hdt", "hdr", "hdh"])
def test_hades_variants_end_to_end(g, pfx):
    """The three option branches: ``hdt`` beamformer none + triangular HRTF
    interpolation on the analysis grid (no solve or SVD chain: 1e-5),
    ``hdr`` filter-and-sum with the radial editor between the stages
    (6e-4), ``hdh`` the hybrid non-low-delay bank with BMVDR (3e-4)."""
    if pfx == "hdt":
        _hades_run(g, "hdt", hybrid=False, low_delay=True, beam="none",
                   interp="triangular", enable_cm=False, n_blocks=12,
                   out_tol=1e-5, hrirs=np.asarray(g["hdt_hrirs"], np.float32),
                   hrir_dirs=np.asarray(g["hds_grid_dirs_deg"], np.float64),
                   hfs=44100.0)
    elif pfx == "hdr":
        _hades_run(g, "hdr", hybrid=False, low_delay=True,
                   beam="filter_and_sum", interp="nearest", enable_cm=True,
                   n_blocks=12, out_tol=6e-4, redit=True)
    else:
        _hades_run(g, "hdh", hybrid=True, low_delay=False, beam="bmvdr",
                   interp="nearest", enable_cm=True, n_blocks=8,
                   out_tol=3e-4)


@pytest.mark.parametrize("mode,key,off,tol", [
    ("naive", "spr_out_naive", None, 2 * TOL),
    ("om", "spr_out_om", 9272, 1e-3), ("evd", "spr_out_evd", 16036, 1e-3)])
def test_spreader(g, mode, key, off, tol):
    """All three modes sample for sample: the decorrelation delays from the
    C's rand() stream (offsets 9272 / 16036), the C's un-reset high-band
    target accumulator, LAPACK cheev's eigenvector signs for EVD."""
    from spatial_audio_framework_tpu_torch.models import spreader as SPR

    cfg = SPR.SpreaderConfig(n_sources=1, mode=mode, cov_avg_coeff=0.5)
    w = SPR.design(cfg, c_rand_offset=off, device="cpu")
    st = SPR.init_state(cfg, w, device="cpu")
    dirs, spread = torch.tensor([[40.0, 10.0]]), torch.tensor([60.0])
    x = torch.from_numpy(np.asarray(g["spr_in"], np.float32))
    outs = []
    for f in range(8):
        y, st = SPR.process(cfg, w, st, x[None, f * 512:(f + 1) * 512], dirs,
                            spread)
        outs.append(y.numpy())
    ref = np.asarray(g[key]).reshape(2, -1)
    assert np.abs(np.concatenate(outs, -1) - ref).max() <= tol, mode


# -- the last modules of the port: pitch shifter, QMF, tracker, the HOA
#    convention converters (tests/test_c_goldens.py:237, 416, 431, 528-560,
#    1373, at their tolerances)

@pytest.mark.parametrize("tag,shift", [("pitch_out_1p5", 1.5),
                                       ("pitch_out_0p5", 0.5),
                                       ("pitch_out_2p0", 2.0)])
def test_smb_pitch_shifter(g, tag, shift):
    """1e-3: long atan2 / phase-accumulation chains in float32 (the JAX
    test's budget); 0.5 collapses analysis-bin pairs onto one synthesis bin
    (last-k-wins), 2.0 maps half the bins out of range (skipped)."""
    from spatial_audio_framework_tpu_torch.ops.pitch import SmbPitchShift

    ps = SmbPitchShift(fs=48000.0, n_ch=1, fft_size=4096, osamp=4)
    y, _ = ps.apply(ps.init_state("cpu"),
                    torch.from_numpy(np.asarray(g["pitch_in"], np.float32))[None],
                    torch.tensor(shift))
    assert np.abs(y.numpy()[0] - np.asarray(g[tag])).max() <= 1e-3


def test_qmf(g):
    """Blockwise hybrid-QMF analysis spectra (|spec| ~ O(10): 1e-3) and the
    round trip's output (1e-4) against the C qmf, hop 128, hybrid."""
    from spatial_audio_framework_tpu_torch.ops.qmf import QMF

    bank = QMF(hop=128, hybrid=True)
    x = torch.from_numpy(np.asarray(g["qmf_in"], np.float32))
    st = bank.init_state(4, 4, device="cpu")
    specs, outs = [], []
    for f in range(8):
        spec, st = bank.analysis(st, x[:, f * 512:(f + 1) * 512])
        specs.append(spec.numpy())
        y, st = bank.synthesis(st, spec)
        outs.append(y.numpy())
    spec = np.stack(specs)
    assert spec.shape == g["qmf_spec"].shape
    assert np.abs(spec - g["qmf_spec"]).max() <= 1e-3
    assert np.abs(np.concatenate(outs, -1) - g["qmf_out"]).max() <= TOL


def test_tracker_numerical_core(g):
    from spatial_audio_framework_tpu_torch.modules import tracker as T

    F = np.zeros((6, 6))
    F[:3, 3:] = np.eye(3)
    A, Q = T.lti_disc(F, np.diag([0, 0, 0, 0.7, 0.7, 0.7]), 0.125)
    assert np.abs(A - g["trk_ltidisc_A"]).max() <= TOL
    assert np.abs(Q - g["trk_ltidisc_Q"]).max() <= TOL
    Mp, Pp = T.kf_predict6(np.asarray(g["trk_kf_M0"], np.float64),
                           np.asarray(g["trk_kf_P0"], np.float64),
                           np.asarray(g["trk_ltidisc_A"], np.float64),
                           np.asarray(g["trk_ltidisc_Q"], np.float64))
    assert np.abs(Mp - g["trk_kf_Mpred"]).max() <= TOL
    assert np.abs(Pp - g["trk_kf_Ppred"]).max() <= TOL
    H = np.zeros((3, 6))
    H[:, :3] = np.eye(3)
    Mu, Pu, LH = T.kf_update6(Mp, Pp, np.array([0.25, 0.1, 0.45]), H,
                              0.04 * np.eye(3))
    assert np.abs(Mu - g["trk_kf_Mupd"]).max() <= TOL
    assert np.abs(Pu - g["trk_kf_Pupd"]).max() <= TOL
    assert abs(LH - float(g["trk_kf_LH"])) <= TOL
    for x, ref in zip(g["trk_gamma_x"], g["trk_gamma_cdf"]):
        assert abs(T.gamma_cdf(float(x), 2.0, 0.8) - ref) <= 1e-6


def test_tracker3d_end_to_end(g):
    """The clean single-target trajectory; step 4 (a short-lived second
    hypothesis of the C's own draws) is excluded, as in the JAX test."""
    from spatial_audio_framework_tpu_torch.modules import tracker as T

    cfg = T.Tracker3DConfig(
        n_particles=20, dt=0.05, max_n_active_targets=4,
        noise_likelihood=0.005, measure_noise_sd=0.15, noise_spec_den=0.001,
        allow_multi_death=True, init_birth=0.5, alpha_death=200.0,
        beta_death=1.0, force_kill_targets=False, force_kill_distance=0.2,
        are_unit_vectors=True, M0=np.zeros(6), P0=np.eye(6),
        cd=1.0 / (4 * np.pi), w_avg_coeff=0.5)
    trk = T.Tracker3D(cfg, seed=7)
    obs = np.asarray(g["trk_e2e_obs"], np.float64)
    ref_pos, ref_n = np.asarray(g["trk_e2e_pos"]), np.asarray(g["trk_e2e_n"])
    for i in range(obs.shape[0]):
        pos, _, _ = trk.step(obs[i][None])
        if i == 4:
            continue
        assert len(pos) == int(ref_n[i]), i
        assert np.abs(pos[0] - ref_pos[i]).max() <= 1e-5, i


@pytest.mark.parametrize("as_tensor", [False, True])
def test_fuma_conversions(g, as_tensor):
    """convertHOAChannelConvention both directions on an order-2 signal
    (channels >= 4 zeroed), exactly; convertHOANormConvention's maxN (FuMa)
    gains both directions; on numpy and on tensors."""
    sig = np.asarray(g["fuma_sig"], np.float32)
    x = torch.from_numpy(sig) if as_tensor else sig
    back = (lambda t: t.numpy()) if as_tensor else np.asarray
    to_acn = hoa.convert_hoa_channel_convention(
        x, 2, hoa.HOA_CH_ORDER_FUMA, hoa.HOA_CH_ORDER_ACN)
    assert np.abs(back(to_acn) - g["fuma_to_acn"]).max() == 0.0
    to_fuma = hoa.convert_hoa_channel_convention(
        x, 2, hoa.HOA_CH_ORDER_ACN, hoa.HOA_CH_ORDER_FUMA)
    assert np.abs(back(to_fuma) - g["acn_to_fuma"]).max() == 0.0
    ones = np.ones((4, 4), np.float32)
    o = torch.from_numpy(ones) if as_tensor else ones
    f2n = hoa.convert_hoa_norm_convention(o, 1, hoa.HOA_NORM_FUMA,
                                          hoa.HOA_NORM_N3D)
    assert np.abs(back(f2n) - g["fuma_norm_to_n3d"]).max() <= TOL
    n2f = hoa.convert_hoa_norm_convention(o, 1, hoa.HOA_NORM_N3D,
                                          hoa.HOA_NORM_FUMA)
    assert np.abs(back(n2f) - g["n3d_norm_to_fuma"]).max() <= TOL
