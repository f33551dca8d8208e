"""The PyTorch port imports, designs (from a SOFA file too) and renders with
jax unavailable."""
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

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


def test_port_runs_without_jax():
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", _SCRIPT], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")
