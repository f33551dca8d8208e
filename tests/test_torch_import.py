"""The PyTorch port imports, designs (from a SOFA file too) and renders with
jax unavailable, and stands alone: it reads no file of the JAX package or
of ``native/`` (its data files and its runtime's C++ source are its own
copies), and its packaging lists every subpackage and file it needs."""
import ast
import hashlib
import os
import re
import subprocess
import sys
import tomllib
from pathlib import Path

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = Path(ROOT) / "spatial_audio_framework_tpu_torch"

_SCRIPT = """
import sys
sys.modules["jax"] = None          # any 'import jax' now raises ImportError
import numpy as np
import torch
from spatial_audio_framework_tpu_torch.models import ambi_bin, ambi_dec
from spatial_audio_framework_tpu_torch.utils import presets

cfg = ambi_bin.AmbiBinConfig(order=1)
rng = np.random.default_rng(0)
w = ambi_bin.weights_from_numpy(
    rng.standard_normal((133, 2, 4)), rng.standard_normal((133, 2, 4)),
    "cpu")
st = ambi_bin.init_state_batched(cfg, 2, device="cpu")
x = torch.from_numpy(rng.uniform(-1, 1, (2, 4, 4 * 128)).astype(np.float32))
y, st = ambi_bin.process_ri_batched(cfg, w, st, x)
assert y.shape == (2, 2, 512) and bool(torch.isfinite(y).all())
assert st.in_tail.shape == (2, 4, 15 * 128) and st.ola_tail.shape == (2, 2, 9 * 128)

# wider than 16 inputs: the two-kernel route, on the (d, g) pair for a
# hybrid bank (order 4) and on the front's spectra for a non-hybrid one
from spatial_audio_framework_tpu_torch.ops import afstft_ri
from spatial_audio_framework_tpu_torch.ops.afstft import AfSTFT
cfg4 = ambi_bin.AmbiBinConfig(order=4)
w4 = ambi_bin.weights_from_numpy(
    rng.standard_normal((133, 2, 25)), rng.standard_normal((133, 2, 25)),
    "cpu")
st4 = ambi_bin.init_state_batched(cfg4, 2, device="cpu")
x = torch.from_numpy(rng.uniform(-1, 1, (2, 25, 4 * 128)).astype(np.float32))
y, st4 = ambi_bin.process_ri_batched(cfg4, w4, st4, x)
assert y.shape == (2, 2, 512) and bool(torch.isfinite(y).all())
bank = AfSTFT(hybrid=False)
M = torch.from_numpy(rng.standard_normal((129, 2, 25)).astype(np.float32))
y, _ = afstft_ri.render_tf_matrix_ri(
    bank, afstft_ri.init_state_batched(bank, 2, 25, 2, device="cpu"), x, M)
assert y.shape == (2, 2, 512) and bool(torch.isfinite(y).all())

# ambi_dec: host design (presets, convhull3d, vbap, AllRAD), then a render
# wide enough (order 2 -> 22.x: 9 x 22 > 128) for the analysis/synthesis path
dcfg = ambi_dec.AmbiDecConfig(master_order=2)
dw = ambi_dec.design_ri(dcfg, presets.loudspeaker_preset("22.x"),
                        device="cpu")
dst = ambi_dec.init_state_batched(dcfg, 2, 22, device="cpu")
x = torch.from_numpy(rng.uniform(-1, 1, (2, 9, 4 * 128)).astype(np.float32))
y, dst = ambi_dec.process_ri_batched(dcfg, dw, dst, x)
assert y.shape == (2, 22, 512) and bool(torch.isfinite(y).all())

# binauraliser: a design from a SOFA file (utils/hdf5, modules/sofa, the
# VBAP grid table), then head-tracked renders on both routes
import os, tempfile
from spatial_audio_framework_tpu_torch.models import binauraliser
from spatial_audio_framework_tpu_torch.modules import hrir, sofa
h, d, fs = hrir.default_hrirs()
with tempfile.TemporaryDirectory() as tmp:
    path = os.path.join(tmp, "subset.sofa")
    sofa.sofa_save(path, h[::4].astype(np.float64), float(fs),
                   np.concatenate([d[::4], np.ones((len(d[::4]), 1))], 1))
    bw = binauraliser.design_ri(binauraliser.BinauraliserConfig(),
                                sofa_filepath=path, device="cpu")
assert bw.itds.shape == (len(d[::4]),)
for n_src in (2, 17):
    bcfg = binauraliser.BinauraliserConfig(n_sources=n_src,
                                           enable_rotation=True)
    bst = binauraliser.init_state_batched(bcfg, 2, device="cpu")
    x = torch.from_numpy(rng.uniform(-1, 1, (2, n_src, 512)).astype(np.float32))
    dirs = torch.zeros((2, n_src, 2))
    y, bst = binauraliser.process_ri_batched(bcfg, bw, bst, x, dirs,
                                             ypr=torch.ones((2, 3)))
    assert y.shape == (2, 2, 512) and bool(torch.isfinite(y).all())
leaked = [m for m in sys.modules
          if m == "spatial_audio_framework_tpu"
          or m.startswith("spatial_audio_framework_tpu.")]
assert not leaked, leaked
print("ok")
"""


# the four TF-matrix renderers that stand on render_tf_matrix_ri or a plain
# matrix product, and the host modules under them
_SCRIPT_RENDERERS = """
import sys
sys.modules["jax"] = None          # any 'import jax' now raises ImportError
import numpy as np
import torch
from spatial_audio_framework_tpu_torch.models import (
    _common, ambi_bin, ambi_enc, binauraliser_nf, panner, roombinauraliser)
from spatial_audio_framework_tpu_torch.modules import brir, hoa, hrir, sh, vbap
from spatial_audio_framework_tpu_torch.utils import dvf, speex

rng = np.random.default_rng(0)
u = lambda *shape: torch.from_numpy(
    rng.uniform(-1, 1, shape).astype(np.float32))

# modules/vbap (2-D) and models/panner: a planar and a 3-D layout
ring = np.array([[30, 0], [-30, 0], [0, 0], [110, 0], [-110, 0]], float)
assert vbap.find_ls_pairs(ring).shape == (5, 2)
assert vbap.generate_vbap_gain_table_2d(ring, 10).shape == (37, 5)
assert vbap.get_p_values(0.5, np.linspace(0, 24e3, 133)).shape == (133,)
dome = np.concatenate([ring, [[45, 45], [-45, 45], [180, 45]]])
for ls in (ring, dome):
    pcfg = panner.PannerConfig(n_sources=3, n_loudspeakers=len(ls),
                               azi_res=10, elev_res=10)
    pw = panner.design(pcfg, ls, device="cpu")
    pst = panner.init_state_batched(pcfg, 2, len(ls), device="cpu")
    dirs = u(2, 3, 2) * torch.tensor([180.0, 90.0])
    y, pst = panner.process_ri_batched(pcfg, pw, pst, u(2, 3, 512), dirs,
                                       u(2, 3))
    assert y.shape == (2, len(ls), 512) and bool(torch.isfinite(y).all())

# modules/sh (torch) and models/ambi_enc
assert sh.get_sh_real_torch(3, u(7, 2)).shape == (16, 7)
assert sh.check_cond_number_sht_real(2, rng.uniform(0, 3, (30, 2))).shape == (3,)
ecfg = ambi_enc.AmbiEncConfig(order=3, n_sources=4, frame_size=64)
conv = ambi_enc.design(ecfg, device="cpu")
assert _common.output_conversion_mtx(3, "acn", "sn3d").shape == (16, 16)
est = ambi_enc.init_state(ecfg, rng.uniform(-90, 90, (4, 2)), device="cpu")
for _ in range(2):
    y, est = ambi_enc.process(ecfg, conv, est, u(4, 64), u(4, 2) * 90.0)
assert y.shape == (16, 64) and bool(torch.isfinite(y).all())

# utils/speex, hrir.resample_hrirs, modules/brir
h, d, fs = hrir.default_hrirs()
h, d = h[::16], d[::16]
h44, n44 = brir.resample_hrirs(h, fs, 44100)
assert h44.shape == (len(h), 2, n44) and n44 == 236
assert speex.SpeexResampler(48000, 44100, quality=10).resample(h[0], 236).shape == (2, 236)
assert hrir.hrirs_to_hrtfs(h, 256).shape == (129, 2, len(h))

# utils/dvf and models/binauraliser_nf, on a design from 44.1 kHz HRIRs
b, a = dvf.calc_dvf_coeffs(u(5, 2).abs() * 180.0, 1.0 + u(5, 1).abs(), 48e3)
assert b.shape == a.shape == (5, 2, 2)
for n_src in (2, 17):
    ncfg = binauraliser_nf.BinauraliserNFConfig(n_sources=n_src,
                                                enable_rotation=True)
    nw = binauraliser_nf.design_ri(ncfg, h44, d, 44100, device="cpu")
    nst = binauraliser_nf.init_state_batched(ncfg, 2, device="cpu")
    y, nst = binauraliser_nf.process_ri_batched(
        ncfg, nw, nst, u(2, n_src, 512), u(2, n_src, 2) * 90.0,
        u(2, n_src).abs() * 4.0, ypr=u(2, 3))
    assert y.shape == (2, 2, 512) and bool(torch.isfinite(y).all())

# models/roombinauraliser: one BRIR set per source, every EQ mode, both
# routes
for n_src, eq in ((2, "fabian_ctf"), (17, "brir_ctf"), (2, "own_filter")):
    rcfg = roombinauraliser.RoomBinauraliserConfig(
        n_sources=n_src, diff_eq_mode=eq, interp_mode="tri_ps")
    sets = np.stack([np.roll(h, s, 0) for s in range(n_src)])
    rcfg, rw = roombinauraliser.design_ri(rcfg, sets, d, fs,
                                          rng.standard_normal(32),
                                          device="cpu")
    assert rcfg.vbap_3d and rw.hrtf_re.shape == (n_src, 133, 2, len(h))
    rst = roombinauraliser.init_state_batched(rcfg, 2, device="cpu")
    y, rst = roombinauraliser.process_ri_batched(
        rcfg, rw, rst, u(2, n_src, 512), u(2, n_src), u(2, 3))
    assert y.shape == (2, 2, 512) and bool(torch.isfinite(y).all())

# modules/hoa: the SPR decoder and diffuse-covariance matching through
# ambi_bin's design
for kw in (dict(method="spr"), dict(enable_diff_cov_matching=True)):
    M = ambi_bin.design_ri(ambi_bin.AmbiBinConfig(order=1, **kw), h, d, fs,
                           device="cpu")
    assert M[0].shape == (133, 2, 4) and bool(torch.isfinite(M[0]).all())
leaked = [m for m in sys.modules
          if m == "spatial_audio_framework_tpu"
          or m.startswith("spatial_audio_framework_tpu.")]
assert not leaked, leaked
print("ok")
"""


# the single-stream entry points (one head-tracked listener), rotator,
# beamformer, array2sh with its host modules, ambi_dec's binaural preview
_SCRIPT_SINGLE_STREAM = """
import importlib.abc
import sys


class NoJax(importlib.abc.MetaPathFinder):
    # any 'import jax' raises; sys.modules stays clean (scipy's array-API
    # helpers look "jax" up there and trip over a None entry)
    def find_spec(self, name, path, target=None):
        if name == "jax" or name.startswith("jax."):
            raise ImportError("jax is not available in this check")


sys.meta_path.insert(0, NoJax())
import numpy as np
import torch
from spatial_audio_framework_tpu_torch.models import (
    ambi_bin, ambi_dec, array2sh, beamformer, binauraliser, binauraliser_nf,
    panner, roombinauraliser, rotator)
from spatial_audio_framework_tpu_torch.modules import array_proc, hrir, sh
from spatial_audio_framework_tpu_torch.ops import afstft_ri
from spatial_audio_framework_tpu_torch.ops.afstft import AfSTFT
from spatial_audio_framework_tpu_torch.utils import bessel, geometry, presets

rng = np.random.default_rng(0)
u = lambda *shape: torch.from_numpy(
    rng.uniform(-1, 1, shape).astype(np.float32))
ok = lambda y, shape: y.shape == shape and bool(torch.isfinite(y).all())

# the SH rotation on a tensor, both Euler orders
R = geometry.yaw_pitch_roll2_rzyx_torch(u(3), roll_pitch_yaw=True)
assert sh.get_sh_rot_mtx_real_torch(R, 7).shape == (64, 64)

# the single-stream filterbank
bank = AfSTFT()
st = afstft_ri.init_state_ri(bank, 3, 3, device="cpu")
spec, st = afstft_ri.analysis_ri(bank, st, u(3, 256))
y, st = afstft_ri.synthesis_ri(bank, st, spec)
assert ok(y, (3, 256))

# ambi_bin: a head-tracked listener, complex and (re, im)
h, d, fs = hrir.default_hrirs()
h, d = h[::16], d[::16]
cfg = ambi_bin.AmbiBinConfig(order=2, enable_rotation=True,
                             ch_ordering="fuma", norm="fuma")
w = ambi_bin.design(cfg, h, d, fs, device="cpu")
sc = ambi_bin.init_state(cfg, device="cpu")
sr = ambi_bin.init_state_ri(cfg, device="cpu")
for _ in range(3):
    x, ypr = u(9, 128), u(3)
    yc, sc = ambi_bin.process(cfg, w, sc, x, ypr)
    yr, sr = ambi_bin.process_ri(cfg, ambi_bin.weights_ri(w), sr, x, ypr)
    assert ok(yc, (2, 128)) and float((yc - yr).abs().max()) < 1e-4

# rotator and beamformer
rcfg = rotator.RotatorConfig(order=3, use_roll_pitch_yaw=True)
rw, rs = rotator.design(rcfg, device="cpu"), rotator.init_state(rcfg, device="cpu")
for _ in range(2):
    y, rs = rotator.process(rcfg, rw, rs, u(16, 128), u(3))
assert ok(y, (16, 128))
for bt in ("cardioid", "hypercardioid", "max_ev"):
    bcfg = beamformer.BeamformerConfig(order=3, n_beams=2, beam_type=bt)
    W = beamformer.design(bcfg, [[10.0, 20.0], [-90.0, 0.0]], device="cpu")
    bs = beamformer.init_state(bcfg, device="cpu")
    for _ in range(2):
        y, bs = beamformer.process(bcfg, W, bs, u(16, 128))
    assert ok(y, (2, 128))

# the renderers' complex entry points
for mode in ("tri", "tri_ps"):
    kw = dict(n_sources=3, interp_mode=mode, enable_rotation=True,
              azi_res=10, elev_res=15)
    c = binauraliser.BinauraliserConfig(**kw)
    bw = binauraliser.design(c, h, d, fs, device="cpu")
    y, _ = binauraliser.process(c, bw, binauraliser.init_state(c, device="cpu"),
                                u(3, 256), u(3, 2) * 90.0, u(3), u(3))
    assert ok(y, (2, 256))
    c = binauraliser_nf.BinauraliserNFConfig(**kw)
    y, _ = binauraliser_nf.process(
        c, bw, binauraliser_nf.init_state(c, device="cpu"), u(3, 256),
        u(3, 2) * 90.0, u(3).abs() * 4.0, u(3), u(3))
    assert ok(y, (2, 256))
    c = roombinauraliser.RoomBinauraliserConfig(n_sources=3, interp_mode=mode)
    c, qw = roombinauraliser.design(
        c, np.stack([np.roll(h, s, 0) for s in range(3)]), d, fs, device="cpu")
    y, _ = roombinauraliser.process(
        c, qw, roombinauraliser.init_state(c, device="cpu"), u(3, 256), u(3),
        u(3))
    assert ok(y, (2, 256))
ring = np.array([[30, 0], [-30, 0], [0, 0], [110, 0], [-110, 0]], float)
pc = panner.PannerConfig(n_sources=2, n_loudspeakers=5, azi_res=10)
pw = panner.design(pc, ring, device="cpu")
y, _ = panner.process(pc, pw, panner.init_state(pc, device="cpu"), u(2, 256),
                      u(2, 2) * 90.0, u(3))
assert ok(y, (5, 256))

# ambi_dec: the binaural preview, batched and complex
ls = presets.loudspeaker_preset("22.x")
dc = ambi_dec.AmbiDecConfig(master_order=1, binauralise_ls=True)
dw = ambi_dec.design_ri(dc, ls, None, h, d, fs, device="cpu")
y, _ = ambi_dec.process_ri_batched(
    dc, dw, ambi_dec.init_state_batched(dc, 2, 22, device="cpu"), u(2, 4, 512))
assert ok(y, (2, 2, 512))
cw = ambi_dec.design(dc, ls, None, h, d, fs, device="cpu")
y, _ = ambi_dec.process(dc, cw, ambi_dec.init_state(dc, 22, device="cpu"),
                        u(4, 256))
assert ok(y, (2, 256))

# utils/bessel, modules/array_proc, models/array2sh
assert bessel.bessel_jn_all(3, np.array([0.0, 1.0]))[0].shape == (2, 4)
assert array_proc.sph_modal_coeffs(3, np.array([0.5, 1.0]), "rigid").shape == (2, 4)
sens = np.degrees(presets.mic_preset("eigenmike32"))
for ft in ("soft_lim", "tikhonov", "z_style", "z_style_maxre"):
    ac = array2sh.Array2SHConfig(order=2, filter_type=ft)
    aw = array2sh.design_ri(ac, sens, device="cpu")
    y, _ = array2sh.process_ri_batched(
        ac, aw, array2sh.init_state_batched(ac, 2, 32, device="cpu"),
        u(2, 32, 512))
    assert ok(y, (2, 9, 512))
acw = array2sh.design(ac, sens, device="cpu")
y, _ = array2sh.process(ac, acw, array2sh.init_state(ac, 32, device="cpu"),
                        u(32, 256))
assert ok(y, (9, 256))
assert len(array2sh.evaluate_filters(ac, acw, sens)) == 2
leaked = [m for m in sys.modules
          if m == "spatial_audio_framework_tpu"
          or m.startswith("spatial_audio_framework_tpu.")]
assert not leaked, leaked
assert "jax" not in sys.modules
print("ok")
"""


# the analysers and the decorrelator with their modules (ops/iir, ops/herm_ri,
# utils/filters, utils/decor, modules/sh_est, the sector half of modules/sh)
_SCRIPT_ANALYSERS = _SCRIPT_SINGLE_STREAM.split("import numpy as np")[0] + """
import numpy as np
import torch
from spatial_audio_framework_tpu_torch.models import (
    ambi_drc, decorrelator, dirass, powermap, sldoa)
from spatial_audio_framework_tpu_torch.modules import sh, sh_est
from spatial_audio_framework_tpu_torch.ops import herm_ri, iir
from spatial_audio_framework_tpu_torch.utils import decor, filters, presets

rng = np.random.default_rng(0)
u = lambda *shape: torch.from_numpy(
    rng.uniform(-1, 1, shape).astype(np.float32))
ok = lambda y, shape: tuple(y.shape) == shape and bool(torch.isfinite(y).all())

b, a = filters.biquad_coeffs(filters.BIQUAD_FILTER_HPF, 100.0, 48000.0, 0.7071)
y, z = iir.iir_filter(b, a, u(2, 300), torch.zeros(2, 2))
assert ok(y, (2, 300))
fb = filters.FafIIRFilterbank(3, np.array([500.0, 2000.0]), 48000.0)
y, _ = fb.apply_device(u(2, 256), fb.init_device_state((2,), device="cpu"))
assert ok(y, (3, 2, 256))
assert decor.synthesise_noise_reverb(1, 8000.0, np.array([0.1, 0.1]),
                                     np.array([500.0, 1000.0])).ndim == 2
sec, _ = sh.compute_sector_coeffs(1, sh.SECTOR_PATTERN_MAXRE,
                                  presets.tdesign(4))
assert sec.shape[1:] == (4, 9)
C = u(4, 4)
C = (C @ C.T + 4 * torch.eye(4), torch.zeros(4, 4))
assert ok(sh_est.generate_music_map_ri(C, u(4, 10), 1), (10,))
assert ok(herm_ri.herm_solve(C, (u(4, 3), u(4, 3)))[0], (4, 3))

dc = decorrelator.DecorrelatorConfig(n_channels=2, enable_transient_ducker=True)
dw = decorrelator.design(dc, c_rand_offset=0, device="cpu")
y, _ = decorrelator.process_ri_batched(
    dc, dw, decorrelator.init_state_batched(dc, dw, 2, device="cpu"),
    u(2, 2, 512))
assert ok(y, (2, 2, 512))
y, _ = decorrelator.process(dc, dw, decorrelator.init_state(dc, dw, "cpu"),
                            u(2, 256))
assert ok(y, (2, 256))
rc = ambi_drc.AmbiDrcConfig(order=1, theshold_db=-10.0)
y, _ = ambi_drc.process_ri_batched(
    rc, ambi_drc.init_state_batched(rc, 2, device="cpu"), u(2, 4, 512))
assert ok(y, (2, 4, 512))
y, _ = ambi_drc.process(rc, ambi_drc.init_state(rc, device="cpu"), u(4, 256))
assert ok(y, (4, 256))
for mode in ("pwd", "mvdr", "cropac_lcmv", "music", "minnorm_log"):
    pc = powermap.PowermapConfig(master_order=1, mode=mode, norm="n3d",
                                 analysis_grid="tdesign", grid_tdesign=6,
                                 interp_res_deg=30)
    pw = powermap.design(pc, device="cpu")
    n_disp = pw.interp_table.shape[0]
    p, _ = powermap.analysis_chunks(
        pc, pw, powermap.init_state_batched(pc, pw, 2, device="cpu"),
        u(2, 2, 4, 256))
    assert ok(p, (2, 2, n_disp))
    p, _ = powermap.analysis(pc, pw, powermap.init_state(pc, pw, "cpu"),
                             u(4, 256))
    assert ok(p, (n_disp,))
sc = sldoa.SldoaConfig(master_order=2, fit_grid_level=4)
sw = sldoa.design(sc, device="cpu")
o, _ = sldoa.analysis_batched(sc, sw, sldoa.init_state_batched(sc, 2, "cpu"),
                              u(2, 9, 256))
assert ok(o.azi_deg, (2, 133, 4))
o, _ = sldoa.analysis(sc, sw, sldoa.init_state(sc, "cpu"), u(9, 256))
assert ok(o.energy, (133, 4, 2))
for mode in ("off", "upscale", "nearest"):
    rcfg = dirass.DirassConfig(input_order=2, upscale_order=4, mode=mode,
                               grid_tdesign=6, interp_res_deg=30)
    rw = dirass.design(rcfg, device="cpu")
    p, _ = dirass.analysis(rcfg, rw, dirass.init_state(rcfg, rw, "cpu"),
                           u(9, 512))
    assert ok(p, (rw.interp_table.shape[0],))
leaked = [m for m in sys.modules
          if m == "spatial_audio_framework_tpu"
          or m.startswith("spatial_audio_framework_tpu.")]
assert not leaked, leaked
assert "jax" not in sys.modules
print("ok")
"""



# convolution, room simulation, HADES and the spreader with their modules
# (utils/misc, utils/sort, ops/matrix_conv, the 2x2 half of ops/herm_ri,
# modules/reverb, modules/cdf4sap)
_SCRIPT_CONV_HADES = _SCRIPT_SINGLE_STREAM.split("import numpy as np")[0] + """
import numpy as np
import torch
from spatial_audio_framework_tpu_torch.models import (ambi_roomsim,
                                                      conv_examples, spreader)
from spatial_audio_framework_tpu_torch.modules import cdf4sap, hades, hrir
from spatial_audio_framework_tpu_torch.modules import reverb
from spatial_audio_framework_tpu_torch.ops import herm_ri, matrix_conv
from spatial_audio_framework_tpu_torch.utils import misc, sort

rng = np.random.default_rng(0)
u = lambda *shape: torch.from_numpy(
    rng.uniform(-1, 1, shape).astype(np.float32))
ok = lambda y, shape: tuple(y.shape) == shape and bool(torch.isfinite(y).all())

assert misc.lagrange_weights(2, np.array([0.25])).shape == (3, 1)
assert len(misc.sort_cmplx_pairs(np.array([1 + 1j, 2.0, 1 - 1j]))) == 3
assert sort.find_closest_grid_points(np.zeros((3, 2)), np.zeros((1, 2))).shape == (1,)

ex = conv_examples.TVConvExample(hop=64)
conv, H, pos = ex.design_ri(u(3, 2, 100).numpy(), u(3, 3).numpy(), "cpu")
st = ex.init_state_ri(conv, batch=(2,), device="cpu")
y, st = ex.process_ri(conv, H, st, u(2, 256), u(2, 3), pos)
assert ok(y, (2, 2, 256))
mc = matrix_conv.MatrixConv(hop=64, length_h=100, n_in=2, n_out=3,
                            partitioned=False)
y, _ = mc.apply_block(mc.design(u(3, 2, 100).numpy(), "cpu"),
                      mc.init_state(device="cpu"), u(2, 256))
assert ok(y, (3, 256))
rcfg = ambi_roomsim.AmbiRoomSimConfig(refl_order=1, room_dims=(5.0, 4.0, 3.0))
rw = ambi_roomsim.design_ri(rcfg, np.array([[1.0, 1.0, 1.0]]),
                            np.array([[3.0, 2.0, 1.5]]), device="cpu")
y, _ = ambi_roomsim.process_ri(rcfg, rw, ambi_roomsim.init_state_ri(
    rcfg, rw, device="cpu"), u(1, 256))
assert ok(y, (4, 256))
room = reverb.ShoeboxRoom(np.array([5.0, 4.0, 3.0]),
                          np.tile([[0.3] * 6], (2, 1)))
room.add_source([1.0, 1.0, 1.0])
room.add_receiver_sh(1, [3.0, 2.0, 1.5])
room.compute_echograms(max_order=1)
app = room.td_applicator(0, max_delay=1024)
y, _ = app.process(app.init_state("cpu"), u(1, 256), room.pack_taps(0, 16))
assert ok(y, (4, 256))

C = u(5, 2, 2)
C = (C @ C.transpose(-1, -2) + torch.eye(2), torch.zeros(5, 2, 2))
assert ok(herm_ri.cheev_2x2(C)[0], (5, 2))
assert ok(herm_ri.cgesv_ri(C, (u(5, 2), u(5, 2)))[0], (5, 2))
assert ok(cdf4sap.formulate_M_and_Cr_ri(C, C, C)[0][0], (5, 2, 2))

h, d, fs = hrir.default_hrirs()
ana = hades.HadesAnalysis(h_array=h[::32], grid_dirs_deg=d[::32],
                          blocksize=256, device="cpu")
pipe = hades.HadesPipeline(ana, hades.HadesSynthesis(
    ana, h[::32], d[::32], beam_option="bmvdr", interp_option="nearest"))
y, _ = pipe.process_chunk_batched(pipe.init_state_batched(2), u(2, 2, 2, 256))
assert ok(y, (2, 2, 2, 256))
scfg = spreader.SpreaderConfig(mode="om")
sw = spreader.design(scfg, h[::32], d[::32], fs, device="cpu")
y, _ = spreader.process_chunk(scfg, sw, spreader.init_state(
    scfg, sw, n_instances=2, device="cpu"), u(2, 2, 1, 256),
    torch.tensor([[40.0, 10.0]]), torch.tensor([60.0]))
assert ok(y, (2, 2, 2, 256))
leaked = [m for m in sys.modules
          if m == "spatial_audio_framework_tpu"
          or m.startswith("spatial_audio_framework_tpu.")]
assert not leaked, leaked
assert "jax" not in sys.modules
print("ok")
"""
# the last modules: the runtime over the batched render, render_signal, the
# device grid, STFT, veclib, QMF, the pitch shifter, the tracker, profiling
# and the SAF-named facade
_SCRIPT_RUNTIME_FACADE = _SCRIPT_SINGLE_STREAM.split("import numpy as np")[0] + """
import numpy as np
import torch
from spatial_audio_framework_tpu_torch import compat
from spatial_audio_framework_tpu_torch.models import ambi_bin, pitch_shifter
from spatial_audio_framework_tpu_torch.modules import tracker
from spatial_audio_framework_tpu_torch.ops import qmf, stft, veclib
from spatial_audio_framework_tpu_torch.parallel import mesh
from spatial_audio_framework_tpu_torch.parallel.streaming import render_signal
from spatial_audio_framework_tpu_torch.runtime import (StreamRunner,
                                                       native_available,
                                                       torch_frame_fn)
from spatial_audio_framework_tpu_torch.utils import profiling

rng = np.random.default_rng(0)
cfg = ambi_bin.AmbiBinConfig(order=1)
w = ambi_bin.weights_from_numpy(rng.standard_normal((133, 2, 4)),
                                rng.standard_normal((133, 2, 4)), "cpu")
box = [ambi_bin.init_state_batched(cfg, 2, device="cpu")]

def frame(f):
    y, box[0] = ambi_bin.process_ri_batched(cfg, w, box[0], f.reshape(2, 4, -1))
    return y.reshape(4, -1)

assert native_available()
runner = StreamRunner(torch_frame_fn(frame, 8, 128, device="cpu"), 8, 4, 128)
y = runner.process_block(rng.uniform(-1, 1, (8, 300)).astype(np.float32))
assert y.shape == (4, 300) and np.isfinite(y).all() and runner.clock.frames == 2
x = torch.from_numpy(rng.uniform(-1, 1, (2, 4, 512)).astype(np.float32))
proc = lambda st, b: ambi_bin.process_ri_batched(cfg, w, st, b)
with profiling.trace_annotation("render"):
    y, _ = render_signal(proc, ambi_bin.init_state_batched(cfg, 2, device="cpu"),
                         x, 256)
assert tuple(y.shape) == (2, 2, 512)
grid = mesh.make_mesh(devices=["cpu", "cpu"])
y2, _ = mesh.run_sharded(lambda w_, s, b: ambi_bin.process_ri_batched(cfg, w_, s, b),
                         w, ambi_bin.init_state_batched(cfg, 2, device="cpu"),
                         x, grid)
assert tuple(y2.shape) == (2, 2, 512)
st = stft.STFT(128, 64)
spec, _ = st.forward(st.init_state(device="cpu"), x[0, :1])
q = qmf.QMF()
qs, _ = q.analysis(q.init_state(1, 1, device="cpu"), x[0, :1])
pcfg = pitch_shifter.PitchShifterConfig(fft_size=512, osamp=4)
yp, _ = pitch_shifter.process(pcfg, pitch_shifter.init_state(pcfg, device="cpu"),
                              x[0, :1], torch.tensor(1.5))
assert bool(torch.isfinite(yp).all())
assert veclib.seig(torch.eye(3))[1].shape == (3,)
trk = tracker.Tracker3D(tracker.Tracker3DConfig(), seed=0)
trk.step(np.array([[1.0, 0.0, 0.0]]))
h = compat.afSTFT(1, 1, device="cpu")
assert compat.utility_sinv(np.eye(2)).dtype == np.float32
leaked = [m for m in sys.modules
          if m == "spatial_audio_framework_tpu"
          or m.startswith("spatial_audio_framework_tpu.")]
assert not leaked, leaked
assert "jax" not in sys.modules
print("ok")
"""


# every script runs under an audit hook that records each file opened,
# library loaded or command run from the JAX package's directory or
# native/ (the files the port once read by path), and fails at its end if
# there was one
_GUARD = """
import os, sys
_foreign = tuple(os.path.join(os.path.realpath(%r), d) + os.sep
                 for d in ("spatial_audio_framework_tpu", "native"))
_reads = []
def _audit(event, args):
    if event in ("open", "ctypes.dlopen"):
        paths = args[:1]
    elif event == "subprocess.Popen":
        paths = list(args[1] or ())
    else:
        return
    for p in paths:
        if isinstance(p, (str, bytes, os.PathLike)):
            p = os.path.realpath(os.fsdecode(p))
            if p.startswith(_foreign):
                _reads.append((event, p))
sys.addaudithook(_audit)
""" % ROOT
_GUARD_END = """
assert not _reads, _reads
print("ok")
"""


def _run(script):
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", _GUARD + script + _GUARD_END],
                          cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")


def test_port_runs_without_jax():
    _run(_SCRIPT)


def test_tf_matrix_renderers_run_without_jax():
    """panner, ambi_enc, binauraliser_nf and roombinauraliser with their
    host modules (2-D VBAP, the torch SH, DVF, speex resampling, brir, the
    SPR decoder, diffuse-covariance matching)."""
    _run(_SCRIPT_RENDERERS)


def test_single_stream_entry_points_run_without_jax():
    """The head-tracked ambi_bin entry points, the renderers' complex
    process, rotator, beamformer, array2sh (bessel, array_proc) and
    ambi_dec's binaural preview."""
    _run(_SCRIPT_SINGLE_STREAM)


def test_analysers_and_decorrelator_run_without_jax():
    """decorrelator, ambi_drc, powermap (five modes), sldoa and dirass
    (three modes) with ops/iir, ops/herm_ri, utils/filters, utils/decor,
    modules/sh_est and the sector half of modules/sh."""
    _run(_SCRIPT_ANALYSERS)


def test_convolution_room_hades_spreader_run_without_jax():
    """matrix_conv and the conv examples, reverb and ambi_roomsim, the 2x2
    half of herm_ri, cdf4sap, HADES (batched) and the spreader (instances)
    with utils/misc and utils/sort."""
    _run(_SCRIPT_CONV_HADES)


def test_runtime_parallel_and_facade_run_without_jax():
    """The runtime (native ring buffers, StreamRunner over the batched
    render), render_signal under a trace annotation, the device grid,
    STFT, QMF, veclib, the pitch shifter, the tracker and compat."""
    _run(_SCRIPT_RUNTIME_FACADE)


# ---------------------------------------------------------------------------
# the port stands alone: its own data files and C++ source, no path into the
# JAX package, packaging that ships what it reads
# ---------------------------------------------------------------------------

_JAX_DATA = Path(ROOT) / "spatial_audio_framework_tpu" / "data"
_DATA_FILES = ("afstft_proto.npz", "default_hrirs.npz", "fabian_ctf.npz",
               "lattice_coeffs.npz", "presets.npz", "qmf_proto.npz")


def _sha256(path: Path) -> str:
    return hashlib.sha256(path.read_bytes()).hexdigest()


def test_port_has_the_jax_packages_data_files():
    assert sorted(p.name for p in (PORT / "data").iterdir()) == sorted(
        p.name for p in _JAX_DATA.iterdir()) == list(_DATA_FILES)


@pytest.mark.parametrize("name", _DATA_FILES)
def test_data_file_is_a_copy_of_the_jax_packages(name):
    """The port's copy cannot drift from the JAX package's file."""
    assert _sha256(PORT / "data" / name) == _sha256(_JAX_DATA / name)


# a path component naming the JAX package's directory or native/
_FOREIGN = re.compile(r"(^|/)(spatial_audio_framework_tpu|native)(/|$)")
# calls that take a path
_PATH_CALLS = {"join", "Path", "PurePath", "open", "load", "read_text",
               "read_bytes", "CDLL", "run", "Popen", "glob"}


def _path_strings(tree):
    """The strings that go into paths in a module: operands of ``/`` and
    arguments of the calls above (a file:line label in a message or a
    record is not a path)."""
    def strings(node):
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            yield node.value
        elif isinstance(node, ast.JoinedStr):
            for v in node.values:
                yield from strings(v)
        elif isinstance(node, (ast.List, ast.Tuple)):
            for v in node.elts:
                yield from strings(v)

    for node in ast.walk(tree):
        if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Div):
            yield from strings(node.left)
            yield from strings(node.right)
        elif isinstance(node, ast.Call):
            f = node.func
            name = f.attr if isinstance(f, ast.Attribute) else getattr(
                f, "id", None)
            if name in _PATH_CALLS:
                for a in node.args + [k.value for k in node.keywords]:
                    yield from strings(a)


def test_no_module_of_the_port_builds_a_path_into_the_jax_package():
    """Neither a module of the port nor chip_smoke.py (which runs in a
    checkout of the port on the card) names the JAX package's directory
    or native/ in a path."""
    files = sorted(PORT.rglob("*.py")) + [Path(ROOT) / "chip_smoke.py"]
    found = [(str(f.relative_to(ROOT)), s) for f in files
             for s in _path_strings(ast.parse(f.read_text()))
             if _FOREIGN.search(s)]
    assert not found, found


def test_path_check_sees_a_path_into_the_jax_package():
    tree = ast.parse('ROOT / "spatial_audio_framework_tpu" / "data"\n'
                     'os.path.join(ROOT, "native", "saf_runtime.cpp")\n'
                     'np.load(f"{ROOT}/spatial_audio_framework_tpu/x.npz")\n'
                     'label = f"spatial_audio_framework_tpu/ops/a.py:{n}"')
    assert sorted(s for s in _path_strings(tree) if _FOREIGN.search(s)) == [
        "/spatial_audio_framework_tpu/x.npz", "native",
        "spatial_audio_framework_tpu"]


def test_packaging_lists_the_ports_subpackages_and_files():
    """Every subpackage of the port (a directory with an ``__init__.py``)
    is in pyproject.toml's packages, and every file of ``csrc/`` and
    ``data/`` matches its package-data."""
    with open(Path(ROOT) / "pyproject.toml", "rb") as f:
        cfg = tomllib.load(f)["tool"]["setuptools"]
    subpackages = {".".join(p.parent.relative_to(ROOT).parts)
                   for p in PORT.rglob("__init__.py")}
    assert "spatial_audio_framework_tpu_torch.runtime" in subpackages
    assert not subpackages - set(cfg["packages"])
    globs = cfg["package-data"]["spatial_audio_framework_tpu_torch"]
    files = [p.relative_to(PORT) for d in ("csrc", "data")
             for p in (PORT / d).iterdir()]
    assert {p.suffix for p in files} == {".cu", ".cuh", ".cpp", ".npz"}
    assert not [p for p in files if not any(p.match(g) for g in globs)]
