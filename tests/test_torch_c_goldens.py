"""The PyTorch port vs goldens rendered by the compiled C reference
(tests/goldens/c_goldens.npz; see tests/test_c_goldens.py).  Budget
<=1e-4 absolute, <=1e-5 for the Voronoi weights."""
import os

import numpy as np
import pytest
import torch

from spatial_audio_framework_tpu_torch.models import (ambi_bin, ambi_dec,
                                                      binauraliser)
from spatial_audio_framework_tpu_torch.modules import hoa, hrir, sh
from spatial_audio_framework_tpu_torch.ops import afstft_ri
from spatial_audio_framework_tpu_torch.ops.afstft import AfSTFT
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
