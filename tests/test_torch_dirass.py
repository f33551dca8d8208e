"""dirass in the PyTorch port vs the JAX reference (CPU), in all three
modes (off, upscale, nearest): the design (steered beams, sector and
velocity beams of the sector half of modules/sh, the display table) and
``analysis`` over several blocks with the JAX state handed across at a
block boundary (``state_from_numpy``).  dirass launches none of the six
afSTFT kernels.

Tolerance: the [0, 1]-normalised maps 2e-3 absolute.  Both packages
band-pass the input with a float32 log-depth scan of the 100 Hz
high-pass, whose poles sit near the unit circle: on white noise the JAX
package's scan is 5e-4 of the output's scale off float64 ``lfilter``, the
port's 1.6e-5 (its pole-matrix powers composed in float64 on the host;
tests/test_torch_iir_decor.py), and the normalised maps carry the JAX
error to 1.3e-3 (seen on the first block).  The JAX C goldens hold the
maps to the C at 1e-3 (off) and 1e-2 (upscale, nearest);
tests/test_torch_c_goldens.py holds the port to the same.  The band-pass
states 1e-3 of the input's scale, the averaged energies and intensities
2e-3 of their largest, for the same reason."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spatial_audio_framework_tpu.models import dirass as J
from spatial_audio_framework_tpu_torch.models import dirass as T

TOL = 2e-3


def _cfgs(**kw):
    base = dict(input_order=2, upscale_order=6, grid_tdesign=18, norm="n3d")
    base.update(kw)
    return J.DirassConfig(**base), T.DirassConfig(**base)


def test_design_equals_jax():
    for kw in (dict(), dict(input_order=1, upscale_order=4, beam_type="cardioid",
                            grid_tdesign=10),
               dict(input_order=3, beam_type="hypercardioid",
                    interp_res_deg=10)):
        jc, tc = _cfgs(**kw)
        wj, wt = J.design(jc), T.design(tc, device="cpu")
        for name in ("W_beam", "Cw", "Cxyz", "Uw", "interp_table", "conv_in",
                     "interp_u"):
            assert np.array_equal(np.asarray(getattr(wj, name)),
                                  getattr(wt, name).numpy()), name
        assert np.array_equal(wj.grid_dirs_deg, wt.grid_dirs_deg)
        assert np.array_equal(wj.interp_dirs_deg, wt.interp_dirs_deg)


@pytest.mark.parametrize("mode", [T.REASS_OFF, T.REASS_UPSCALE,
                                  T.REASS_NEAREST])
def test_analysis_vs_jax(mode):
    jc, tc = _cfgs(mode=mode)
    wj, wt = J.design(jc), T.design(tc, device="cpu")
    rng = np.random.default_rng(3)
    sj, st = J.init_state(jc, wj), T.init_state(tc, wt, device="cpu")
    for blk in range(4):
        x = rng.standard_normal((9, 2048)).astype(np.float32)
        x[0] *= 2.0                       # a dominant omni
        if blk == 2:
            st = T.state_from_numpy(*(np.asarray(a) for a in sj),
                                    device="cpu")
        pj, sj = J.analysis(jc, wj, sj, jnp.asarray(x))
        pt, st = T.analysis(tc, wt, st, torch.from_numpy(x))
        assert pt.shape == (wt.interp_table.shape[0],)
        assert float(np.abs(np.asarray(pj) - pt.numpy()).max()) <= TOL, blk
    # the band-pass states relative to the input's scale (the scans'
    # errors are of that scale), the averaged energies and intensities
    # relative to their own
    scale = float(np.abs(x).max())
    for name in ("hpf_z", "lpf_z"):
        a = np.asarray(getattr(sj, name))
        assert np.abs(a - getattr(st, name).numpy()).max() <= 1e-3 * scale
    for name in ("prev_energy", "prev_intensity"):
        a = np.asarray(getattr(sj, name))
        assert np.abs(a - getattr(st, name).numpy()).max() \
            <= TOL * max(np.abs(a).max(), 1e-9)
