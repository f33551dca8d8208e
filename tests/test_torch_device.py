"""The port's entry points run on the card unless the caller asks for the
CPU: every public ``device`` parameter defaults to None, which resolves to
``cuda:0`` through ``default_device()``, and without a card that raises
instead of falling back to the CPU."""
import functools
import importlib
import inspect
import pkgutil

import numpy as np
import pytest
import torch

import spatial_audio_framework_tpu_torch as port
from spatial_audio_framework_tpu_torch.models import (ambi_drc, decorrelator,
                                                      dirass, powermap, sldoa)
from spatial_audio_framework_tpu_torch.models import (ambi_bin, ambi_dec,
                                                      ambi_enc, array2sh,
                                                      beamformer, binauraliser,
                                                      binauraliser_nf, panner,
                                                      roombinauraliser,
                                                      rotator)
from spatial_audio_framework_tpu_torch.ops import afstft_ri, herm_ri, iir
from spatial_audio_framework_tpu_torch.ops.afstft import AfSTFT
from spatial_audio_framework_tpu_torch.utils import decor, filters


def _public_functions_with_device():
    """(qualified name, function) of every public function or method of
    the port that takes a ``device`` parameter, except the private helpers
    that always receive one from their caller."""
    found = []
    names = [port.__name__] + [m.name for m in pkgutil.walk_packages(
        port.__path__, port.__name__ + ".")]
    for mod in map(importlib.import_module, names):
        objs = [(n, o) for n, o in vars(mod).items()
                if getattr(o, "__module__", None) == mod.__name__]
        for n, o in list(objs):
            if inspect.isclass(o):
                objs += [(f"{n}.{m}", f) for m, f in vars(o).items()
                         if inspect.isfunction(f)]
        for n, o in objs:
            if (inspect.isfunction(o) and not n.split(".")[-1].startswith("_")
                    and "device" in inspect.signature(o).parameters):
                found.append((f"{mod.__name__}.{n}", o))
    return found


def test_every_public_device_parameter_defaults_to_the_card():
    fns = _public_functions_with_device()
    assert len(fns) >= 15
    for name, fn in fns:
        default = inspect.signature(fn).parameters["device"].default
        assert default is None, f"{name}: device defaults to {default!r}"


def test_default_device_is_cuda0(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert port.default_device() == torch.device("cuda", 0)


def test_default_device_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port.default_device()


_Z = np.zeros((133, 2, 4))
ENTRY_POINTS = {
    "f32_tensor": lambda: port.f32_tensor(np.zeros(3)),
    "ambi_bin.weights_from_numpy": lambda: ambi_bin.weights_from_numpy(_Z, _Z),
    "ambi_bin.init_state_batched": lambda: ambi_bin.init_state_batched(
        ambi_bin.AmbiBinConfig(order=1), 2),
    "ambi_dec.init_state_batched": lambda: ambi_dec.init_state_batched(
        ambi_dec.AmbiDecConfig(master_order=1), 2, 4),
    "binauraliser.init_state_batched": lambda: (
        binauraliser.init_state_batched(binauraliser.BinauraliserConfig(), 2)),
    "afstft_ri.init_state_batched": lambda: afstft_ri.init_state_batched(
        AfSTFT(), 2, 4, 2),
    "AfSTFT.init_state": lambda: AfSTFT().init_state(2, 2),
}

_LS = np.array([[30.0, 0.0], [-30.0, 0.0], [110.0, 0.0], [-110.0, 0.0]])
_PCFG = panner.PannerConfig(n_sources=2, n_loudspeakers=4, azi_res=10)
_ECFG = ambi_enc.AmbiEncConfig(order=1, n_sources=2)
_T = np.zeros((10, 3))
# each new entry point that takes a device, called with ``device`` passed
# through: (n streams, ...) sizes are tiny and designs coarse
NEW_ENTRY_POINTS = {
    "panner.design": lambda **kw: panner.design(_PCFG, _LS, **kw),
    "panner.weights_from_numpy": lambda **kw: panner.weights_from_numpy(
        np.zeros((37, 4)), np.zeros(133), **kw),
    "panner.init_state_batched": lambda **kw: panner.init_state_batched(
        _PCFG, 2, 4, **kw),
    "ambi_enc.design": lambda **kw: ambi_enc.design(_ECFG, **kw),
    "ambi_enc.init_state": lambda **kw: ambi_enc.init_state(_ECFG, **kw),
    "ambi_enc.state_from_numpy": lambda **kw: ambi_enc.state_from_numpy(
        np.zeros((4, 2)), np.zeros((2, 128)), **kw),
    "binauraliser_nf.init_state_batched": lambda **kw: (
        binauraliser_nf.init_state_batched(
            binauraliser_nf.BinauraliserNFConfig(), 2, **kw)),
    "binauraliser_nf.weights_from_numpy": lambda **kw: (
        binauraliser_nf.weights_from_numpy(_Z, _Z, _Z, np.zeros(4), _T, _T,
                                           np.zeros(133), **kw)),
    "roombinauraliser.init_state_batched": lambda **kw: (
        roombinauraliser.init_state_batched(
            roombinauraliser.RoomBinauraliserConfig(), 2, **kw)),
    "roombinauraliser.weights_from_numpy": lambda **kw: (
        roombinauraliser.weights_from_numpy(
            _Z[None], _Z[None], _Z[None], np.zeros((1, 4)), _T, _T,
            np.zeros(133), **kw)),
    # the single-stream entry points, rotator, beamformer, array2sh and
    # ambi_dec's complex path
    "afstft_ri.init_state_ri": lambda **kw: afstft_ri.init_state_ri(
        AfSTFT(), 4, 2, **kw),
    "afstft_ri.state_ri_from_numpy": lambda **kw: (
        afstft_ri.state_ri_from_numpy(*_STATE_RI, **kw)),
    "ambi_bin.init_state": lambda **kw: ambi_bin.init_state(
        ambi_bin.AmbiBinConfig(order=1), **kw),
    "ambi_bin.init_state_ri": lambda **kw: ambi_bin.init_state_ri(
        ambi_bin.AmbiBinConfig(order=1), **kw),
    "ambi_bin.weights_complex_from_numpy": lambda **kw: (
        ambi_bin.weights_complex_from_numpy(_Z, _Z, **kw)),
    "ambi_bin.state_complex_from_numpy": lambda **kw: (
        ambi_bin.state_complex_from_numpy(*_STATE_RI, **kw)),
    "binauraliser.init_state": lambda **kw: binauraliser.init_state(
        binauraliser.BinauraliserConfig(), **kw),
    "binauraliser.weights_complex_from_numpy": lambda **kw: (
        binauraliser.weights_complex_from_numpy(
            _Z, _Z, _Z, np.zeros(4), _T, _T, np.zeros(133), **kw)),
    "binauraliser_nf.init_state": lambda **kw: binauraliser_nf.init_state(
        binauraliser_nf.BinauraliserNFConfig(), **kw),
    "roombinauraliser.init_state": lambda **kw: roombinauraliser.init_state(
        roombinauraliser.RoomBinauraliserConfig(), **kw),
    "roombinauraliser.weights_complex_from_numpy": lambda **kw: (
        roombinauraliser.weights_complex_from_numpy(
            _Z[None], _Z[None], _Z[None], np.zeros((1, 4)), _T, _T,
            np.zeros(133), **kw)),
    "panner.init_state": lambda **kw: panner.init_state(_PCFG, **kw),
    "rotator.design": lambda **kw: rotator.design(
        rotator.RotatorConfig(order=2), **kw),
    "rotator.init_state": lambda **kw: rotator.init_state(
        rotator.RotatorConfig(order=2), **kw),
    "rotator.state_from_numpy": lambda **kw: rotator.state_from_numpy(
        np.eye(4), np.zeros((4, 128)), **kw),
    "beamformer.design": lambda **kw: beamformer.design(
        beamformer.BeamformerConfig(order=2, n_beams=2), _LS[:2], **kw),
    "beamformer.init_state": lambda **kw: beamformer.init_state(
        beamformer.BeamformerConfig(order=2, n_beams=2), **kw),
    "beamformer.state_from_numpy": lambda **kw: beamformer.state_from_numpy(
        np.zeros((2, 9)), np.zeros((9, 128)), **kw),
    "array2sh.design": lambda **kw: array2sh.design(_ACFG, _SENSORS, **kw),
    "array2sh.design_ri": lambda **kw: array2sh.design_ri(_ACFG, _SENSORS,
                                                          **kw),
    "array2sh.weights_from_numpy": lambda **kw: array2sh.weights_from_numpy(
        _Z, _Z, **kw),
    "array2sh.weights_complex_from_numpy": lambda **kw: (
        array2sh.weights_complex_from_numpy(_Z, _Z, **kw)),
    "array2sh.init_state": lambda **kw: array2sh.init_state(_ACFG, 6, **kw),
    "array2sh.init_state_batched": lambda **kw: array2sh.init_state_batched(
        _ACFG, 2, 6, **kw),
    "ambi_dec.init_state": lambda **kw: ambi_dec.init_state(
        ambi_dec.AmbiDecConfig(master_order=1), 4, **kw),
    "ambi_dec.weights_complex_from_numpy": lambda **kw: (
        ambi_dec.weights_complex_from_numpy(_Z, _Z, _Z, _Z, **kw)),
}
_STATE_RI = (np.zeros((4, 9 * 128)), np.zeros((4, 6, 129)),
             np.zeros((4, 6, 129)), np.zeros((2, 9 * 128)))

# the analysers, the decorrelator and their modules, on coarse grids
_DCFG = decorrelator.DecorrelatorConfig(n_channels=2)
_DDES = decorrelator.DecorrelatorConfig(n_channels=2).lattice.design(
    AfSTFT().centre_freqs(48000.0), rng=np.random.default_rng(0))
_RCFG = ambi_drc.AmbiDrcConfig(order=1)
_PMCFG = powermap.PowermapConfig(master_order=1, analysis_grid="tdesign",
                                 grid_tdesign=4, interp_res_deg=30)
_SLCFG = sldoa.SldoaConfig(master_order=2, fit_grid_level=2)
_DICFG = dirass.DirassConfig(input_order=1, upscale_order=2, grid_tdesign=4,
                             interp_res_deg=30)

# CPU designs made at first use, not while the module is imported
@functools.cache
def _w(model, cfg):
    return model.design(cfg, device="cpu")


_BANKB = (np.zeros((2, 4, 15 * 128)), np.zeros((2, 1, 9 * 128)))
_C4 = np.zeros((133, 4, 4))
def _sldoa_weights(w, **kw):
    return sldoa.weights_from_numpy(
        *(t.numpy() for t in w[:5]), w.sec_dirs_deg, w.orders_per_band,
        [(m.numpy(), c.numpy()) for m, c in w.order_groups], **kw)[:5]


def _dirass_weights(w, **kw):
    return dirass.weights_from_numpy(
        *(t.numpy() for t in w[:6]), w.grid_dirs_deg, w.interp_dirs_deg,
        w.interp_u.numpy(), **kw)[:6]


NEW_ENTRY_POINTS.update({
    "decorrelator.design": lambda **kw: decorrelator.design(
        _DCFG, c_rand_offset=0, **kw)["_device"],
    "decorrelator.design_from_numpy": lambda **kw: (
        decorrelator.design_from_numpy(dict(_DDES), **kw)["_device"]),
    "decorrelator.init_state": lambda **kw: decorrelator.init_state(
        _DCFG, _DDES, **kw),
    "decorrelator.init_state_batched": lambda **kw: (
        decorrelator.init_state_batched(_DCFG, _DDES, 2, **kw)),
    "decorrelator.state_from_numpy": lambda **kw: (
        decorrelator.state_from_numpy(
            _STATE_RI, ((np.zeros(3),) * 2, (np.zeros(3),) * 2, np.zeros(3),
                        np.zeros(3)), (np.zeros(3), np.zeros(3)), **kw)),
    "decorrelator.state_batched_from_numpy": lambda **kw: (
        decorrelator.state_batched_from_numpy(
            _BANKB, (np.zeros(3),) * 4, (np.zeros(3),) * 2, **kw)),
    "ambi_drc.init_state": lambda **kw: ambi_drc.init_state(_RCFG, **kw),
    "ambi_drc.init_state_batched": lambda **kw: ambi_drc.init_state_batched(
        _RCFG, 2, **kw),
    "ambi_drc.state_from_numpy": lambda **kw: ambi_drc.state_from_numpy(
        _STATE_RI, np.zeros(133), **kw),
    "ambi_drc.state_batched_from_numpy": lambda **kw: (
        ambi_drc.state_batched_from_numpy(*_BANKB, np.zeros((2, 133)), **kw)),
    "powermap.design": lambda **kw: powermap.design(_PMCFG, **kw),
    "powermap.weights_from_numpy": lambda **kw: powermap.weights_from_numpy(
        *(t.numpy() for t in _w(powermap, _PMCFG)[:4]),
        *_w(powermap, _PMCFG)[4:], **kw),
    "powermap.init_state": lambda **kw: powermap.init_state(
        _PMCFG, _w(powermap, _PMCFG), **kw),
    "powermap.init_state_batched": lambda **kw: powermap.init_state_batched(
        _PMCFG, _w(powermap, _PMCFG), 2, **kw),
    "powermap.state_from_numpy": lambda **kw: powermap.state_from_numpy(
        _BANKB, _C4, _C4, np.zeros(10), **kw),
    "sldoa.design": lambda **kw: sldoa.design(_SLCFG, **kw)[:5],
    "sldoa.weights_from_numpy": lambda **kw: _sldoa_weights(
        _w(sldoa, _SLCFG), **kw),
    "sldoa.init_state": lambda **kw: sldoa.init_state(_SLCFG, **kw)[1:],
    "sldoa.init_state_batched": lambda **kw: sldoa.init_state_batched(
        _SLCFG, 2, **kw),
    "sldoa.state_from_numpy": lambda **kw: sldoa.state_from_numpy(
        _BANKB, np.zeros((133, 4, 3)), np.zeros((133, 4)), **kw),
    "dirass.design": lambda **kw: dirass.design(_DICFG, **kw)[:6],
    "dirass.weights_from_numpy": lambda **kw: _dirass_weights(
        _w(dirass, _DICFG), **kw),
    "dirass.init_state": lambda **kw: dirass.init_state(
        _DICFG, _w(dirass, _DICFG), **kw),
    "dirass.state_from_numpy": lambda **kw: dirass.state_from_numpy(
        np.zeros((4, 2)), np.zeros((4, 2)), np.zeros(6), np.zeros((6, 3)),
        **kw),
    "iir.block_mats": lambda **kw: iir.block_mats(
        np.array([1.0, 0.5]), np.array([1.0, -0.5]), 4, **kw),
    "iir.onepole_ewma_mats": lambda **kw: iir.onepole_ewma_mats(0.5, 4, **kw),
    "decor.LatticeDecorrelator.init_state": lambda **kw: (
        _DCFG.lattice.init_state(_DDES, 133, **kw)),
    "decor.lattice_init_state_ri": lambda **kw: decor.lattice_init_state_ri(
        _DCFG.lattice, _DDES, 133, (2,), **kw),
    "decor.lattice_design_on_device": lambda **kw: (
        decor.lattice_design_on_device(dict(_DDES), **kw)),
    "decor.transient_ducker_init": lambda **kw: decor.transient_ducker_init(
        133, 2, **kw),
    "filters.FafIIRFilterbank.init_device_state": lambda **kw: (
        filters.FafIIRFilterbank(1, np.array([1000.0]), 48000.0)
        .init_device_state((2,), **kw)),
    "herm_ri.split": lambda **kw: herm_ri.split(np.ones(3) * 1j, **kw),
})

# convolution, room simulation, HADES and the spreader, at tiny sizes
from spatial_audio_framework_tpu_torch.models import (ambi_roomsim,  # noqa: E402
                                                      conv_examples, spreader)
from spatial_audio_framework_tpu_torch.modules import hades, reverb  # noqa: E402
from spatial_audio_framework_tpu_torch.ops import matrix_conv as mconv  # noqa: E402

_MC = mconv.MatrixConv(hop=64, length_h=100, n_in=2, n_out=3)
_MU = mconv.MultiConv(hop=64, length_h=100, n_ch=2)
_TV = mconv.TVConv(hop=64, length_h=100, n_out=2, n_irs=3)
_H3 = np.ones((3, 2, 100), np.float32)
_RSCFG = ambi_roomsim.AmbiRoomSimConfig(refl_order=0, room_dims=(4.0, 3.0,
                                                                 2.5))
_RSPOS = (np.array([[1.0, 1.0, 1.0]]), np.array([[2.0, 2.0, 1.2]]))
_SPCFG = spreader.SpreaderConfig(mode="naive")


@functools.cache
def _hades_pipe():
    from spatial_audio_framework_tpu_torch.modules import hrir

    h, d, fs = hrir.default_hrirs()
    ana = hades.HadesAnalysis(h_array=h[::64], grid_dirs_deg=d[::64],
                              device="cpu")
    return hades.HadesPipeline(ana, hades.HadesSynthesis(
        ana, h[::64], d[::64], interp_option="nearest"))


@functools.cache
def _spreader_w():
    from spatial_audio_framework_tpu_torch.modules import hrir

    h, d, fs = hrir.default_hrirs()
    return spreader.design(_SPCFG, h[::64], d[::64], fs, device="cpu")


NEW_ENTRY_POINTS.update({
    "matrix_conv.MatrixConv.design": lambda **kw: _MC.design(_H3, **kw),
    "matrix_conv.MatrixConv.design_ri": lambda **kw: _MC.design_ri(_H3, **kw),
    "matrix_conv.MatrixConv.init_state": lambda **kw: _MC.init_state(**kw),
    "matrix_conv.MatrixConv.init_state_ri": lambda **kw: (
        _MC.init_state_ri(**kw)),
    "matrix_conv.MultiConv.design": lambda **kw: _MU.design(_H3[0], **kw),
    "matrix_conv.MultiConv.design_ri": lambda **kw: _MU.design_ri(_H3[0],
                                                                  **kw),
    "matrix_conv.MultiConv.init_state": lambda **kw: _MU.init_state(**kw),
    "matrix_conv.MultiConv.init_state_ri": lambda **kw: (
        _MU.init_state_ri(**kw)),
    "matrix_conv.TVConv.design": lambda **kw: _TV.design(_H3, **kw),
    "matrix_conv.TVConv.design_ri": lambda **kw: _TV.design_ri(_H3, **kw),
    "matrix_conv.TVConv.init_state": lambda **kw: _TV.init_state(**kw),
    "matrix_conv.TVConv.init_state_ri": lambda **kw: _TV.init_state_ri(**kw),
    "matrix_conv.design_from_numpy": lambda **kw: mconv.design_from_numpy(
        (np.zeros(3), np.zeros(3)), **kw),
    "matrix_conv.state_from_numpy": lambda **kw: mconv.state_from_numpy(
        np.zeros((1, 2, 66), np.complex64), np.zeros((3, 64)), **kw),
    "matrix_conv.tv_state_from_numpy": lambda **kw: (
        mconv.tv_state_from_numpy(np.zeros((1, 130)), np.zeros((2, 64)),
                                  np.zeros((2, 64)), 0, 0, **kw)),
    "conv_examples.MatrixConvExample": lambda **kw: (
        conv_examples.MatrixConvExample(hop=64).design(_H3, **kw)[1],
        conv_examples.MatrixConvExample(hop=64).design_ri(_H3, **kw)[1],
        conv_examples.MatrixConvExample(hop=64).init_state(_MC, **kw),
        conv_examples.MatrixConvExample(hop=64).init_state_ri(_MC, **kw)),
    "conv_examples.MultiConvExample": lambda **kw: (
        conv_examples.MultiConvExample(hop=64).design(_H3[0], **kw)[1],
        conv_examples.MultiConvExample(hop=64).design_ri(_H3[0], **kw)[1],
        conv_examples.MultiConvExample(hop=64).init_state(_MU, **kw),
        conv_examples.MultiConvExample(hop=64).init_state_ri(_MU, **kw)),
    "conv_examples.TVConvExample": lambda **kw: (
        conv_examples.TVConvExample(hop=64).design(_H3, np.zeros((3, 3)),
                                                   **kw)[1:],
        conv_examples.TVConvExample(hop=64).design_ri(_H3, np.zeros((3, 3)),
                                                      **kw)[1:],
        conv_examples.TVConvExample(hop=64).init_state(_TV, **kw),
        conv_examples.TVConvExample(hop=64).init_state_ri(_TV, **kw)),
    "reverb.ImsTDApplicator.init_state": lambda **kw: reverb.ImsTDApplicator(
        48000.0, 2, 4, (500.0,), 64).init_state(**kw),
    "reverb.taps_from_numpy": lambda **kw: reverb.taps_from_numpy(
        reverb.EchogramTaps(np.zeros((2, 4), np.int32),
                            np.zeros((2, 1, 4, 4))), **kw),
    "reverb.td_state_from_numpy": lambda **kw: reverb.td_state_from_numpy(
        np.zeros((2, 1, 64)), **kw),
    "ambi_roomsim.design": lambda **kw: ambi_roomsim.design(
        _RSCFG, *_RSPOS, **kw).Hf,
    "ambi_roomsim.design_ri": lambda **kw: ambi_roomsim.design_ri(
        _RSCFG, *_RSPOS, **kw).Hf,
    "ambi_roomsim.weights_from_numpy": lambda **kw: (
        ambi_roomsim.weights_from_numpy(_RSCFG, np.zeros((2, 4, 1, 129),
                                                         np.complex64),
                                        **kw).Hf),
    "ambi_roomsim.init_state": lambda **kw: ambi_roomsim.init_state(
        _RSCFG, ambi_roomsim.weights_from_numpy(
            _RSCFG, np.zeros((2, 4, 1, 129), np.complex64), "cpu"), **kw),
    "ambi_roomsim.init_state_ri": lambda **kw: ambi_roomsim.init_state_ri(
        _RSCFG, ambi_roomsim.weights_from_numpy(
            _RSCFG, np.zeros((2, 4, 1, 129), np.complex64), "cpu"), **kw),
    "hades.HadesAnalysis": lambda **kw: hades.HadesAnalysis(
        hop=128, h_array=np.ones((4, 2, 64), np.float32),
        grid_dirs_deg=np.array([[0.0, 0], [90, 0], [180, 0], [-90, 0]]),
        **kw).Cx_avg,
    "hades.HadesPipeline.state_from_numpy": lambda **kw: (
        hades.HadesPipeline.state_from_numpy(
            _STATE_RI, (np.zeros(3),) * 2, (np.zeros(3),) * 2, _STATE_RI,
            **kw)),
    "hades.HadesPipeline.state_batched_from_numpy": lambda **kw: (
        hades.HadesPipeline.state_batched_from_numpy(
            np.zeros((2, 2, 15 * 128)), (np.zeros(3),) * 2,
            (np.zeros(3),) * 2, np.zeros((2, 2, 9 * 128)), **kw)),
    "spreader.design": lambda **kw: _tensors(spreader.design(
        _SPCFG, *(a[::64] for a in _hrirs()[:2]), _hrirs()[2], **kw))[:6],
    "spreader.weights_from_numpy": lambda **kw: spreader.weights_from_numpy(
        *(t.numpy() for t in _spreader_w()[:6]), dict(_spreader_w().lattice),
        **kw)[:6],
    "spreader.init_state": lambda **kw: spreader.init_state(
        _SPCFG, _spreader_w(), n_instances=2, **kw),
    "spreader.state_from_numpy": lambda **kw: spreader.state_from_numpy(
        _BANKB, ((np.zeros(3),) * 4,), *(np.zeros(3),) * 7, **kw),
})


# the real-time runtime, the device grid, STFT, QMF, the pitch shifter and
# the facade's handles
def _last_slice():
    from spatial_audio_framework_tpu_torch import compat
    from spatial_audio_framework_tpu_torch.models import pitch_shifter
    from spatial_audio_framework_tpu_torch.ops import pitch, qmf, stft
    from spatial_audio_framework_tpu_torch.parallel import mesh
    from spatial_audio_framework_tpu_torch.runtime import (probe_device,
                                                           torch_frame_fn)

    pcfg = pitch_shifter.PitchShifterConfig(fft_size=512, osamp=4)
    st = stft.STFT(winsize=128, hopsize=64)
    return {
        "runtime.torch_frame_fn": lambda **kw: torch_frame_fn(
            lambda f: f * 2.0, 2, 8, **kw)(np.ones((2, 8), np.float32)),
        "runtime.probe_device": lambda **kw: torch.tensor(
            probe_device(timeout_s=60.0, reps=1, **kw)),
        "parallel.mesh.run_sharded": lambda **kw: mesh.run_sharded(
            lambda w, s, x: (x * w, s), torch.ones(1), (), torch.ones(2, 1, 4),
            mesh.make_mesh(devices=[torch.device(kw["device"])]
                           if kw else None))[0],
        "stft.STFT.init_state": lambda **kw: st.init_state(**kw),
        "stft.STFT.state_from_numpy": lambda **kw: st.state_from_numpy(
            np.zeros((1, 64)), np.zeros((1, 192)), **kw),
        "qmf.QMF.init_state": lambda **kw: qmf.QMF().init_state(1, 1, **kw),
        "qmf.QMF.state_from_numpy": lambda **kw: qmf.QMF().state_from_numpy(
            [np.zeros((1, 2))] * 4, **kw),
        "pitch.SmbPitchShift.design": lambda **kw: tuple(
            pitch.SmbPitchShift(fft_size=512).design(**kw).values()),
        "pitch_shifter.init_state": lambda **kw: pitch_shifter.init_state(
            pcfg, **kw),
        "pitch_shifter.state_from_numpy": lambda **kw: (
            pitch_shifter.state_from_numpy(pcfg, [np.zeros(3)] * 5, **kw)),
        "pitch_shifter.design": lambda **kw: tuple(pitch_shifter.design(
            pcfg, **kw).values()),
        "compat.afSTFT": lambda **kw: compat.afSTFT(1, 1, **kw)._st,
        "compat.qmf": lambda **kw: compat.qmf(1, 1, **kw)._st,
        "compat.latticeDecorrelator": lambda **kw: compat.latticeDecorrelator(
            48000.0, 128, np.linspace(0, 24000, 133), 1, **kw)._st,
    }


NEW_ENTRY_POINTS.update(_last_slice())


def _hrirs():
    from spatial_audio_framework_tpu_torch.modules import hrir

    return hrir.default_hrirs()


def test_hades_pipeline_batched_state_raises_without_a_card(monkeypatch):
    """HadesPipeline's states live on the analysis's device: a pipeline
    made on the CPU makes CPU states, and without a card the default
    analysis raises."""
    pipe = _hades_pipe()
    for st in (pipe.init_state(), pipe.init_state_batched(2)):
        assert all(t.device.type == "cpu" for t in _tensors(st))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        hades.HadesAnalysis(h_array=np.ones((4, 2, 64), np.float32),
                            grid_dirs_deg=np.zeros((4, 2)))


_ACFG = array2sh.Array2SHConfig(order=1)
_SENSORS = np.array([[0.0, 0], [90, 0], [180, 0], [-90, 0], [0, 90],
                     [0, -90]])


def _tensors(out):
    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, dict):
        return _tensors(list(out.values()))
    return [t for o in out for t in _tensors(o)] if isinstance(
        out, (tuple, list)) else []


def test_single_stream_designs_raise_without_a_card(monkeypatch):
    """The complex designs that load HRIRs (ambi_bin, binauraliser,
    binauraliser_nf, roombinauraliser, ambi_dec with the binaural preview)
    on a small subset: CPU tensors when asked, an error without a card."""
    from spatial_audio_framework_tpu_torch.modules import hrir

    h, d, fs = hrir.default_hrirs()
    h, d = h[::40], d[::40]
    bcfg = binauraliser.BinauraliserConfig(azi_res=10, elev_res=15)
    dcfg = ambi_dec.AmbiDecConfig(master_order=1, binauralise_ls=True)
    ls = np.array([[45.0, 0], [-45, 0], [135, 0], [-135, 0], [0, 90],
                   [0, -90]])
    designs = {
        "ambi_bin": lambda **kw: ambi_bin.design(
            ambi_bin.AmbiBinConfig(order=1), h, d, fs, **kw),
        "binauraliser": lambda **kw: binauraliser.design(bcfg, h, d, fs, **kw),
        "binauraliser_nf": lambda **kw: binauraliser_nf.design(
            binauraliser_nf.BinauraliserNFConfig(azi_res=10, elev_res=15),
            h, d, fs, **kw),
        "roombinauraliser": lambda **kw: roombinauraliser.design(
            roombinauraliser.RoomBinauraliserConfig(), h[None], d, fs,
            **kw)[1],
        "ambi_dec": lambda **kw: ambi_dec.design(dcfg, ls, None, h, d, fs,
                                                 **kw),
        "ambi_dec_ri": lambda **kw: ambi_dec.design_ri(dcfg, ls, None, h, d,
                                                       fs, **kw),
    }
    for name, fn in designs.items():
        tensors = _tensors(fn(device="cpu"))
        assert tensors and all(t.device.type == "cpu" for t in tensors), name
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name, fn in designs.items():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn()


@pytest.mark.parametrize("entry", list(NEW_ENTRY_POINTS))
def test_new_entry_point_without_a_card_raises(monkeypatch, entry):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        NEW_ENTRY_POINTS[entry]()


@pytest.mark.parametrize("entry", list(NEW_ENTRY_POINTS))
def test_new_entry_point_runs_on_the_cpu_when_asked(entry):
    tensors = _tensors(NEW_ENTRY_POINTS[entry](device="cpu"))
    assert tensors and all(t.device.type == "cpu" for t in tensors)


def test_designs_that_load_data_raise_without_a_card(monkeypatch):
    """binauraliser_nf.design_ri and roombinauraliser.design_ri on a small
    HRIR subset: without a card and without ``device`` they raise, with
    device="cpu" they return CPU tensors."""
    from spatial_audio_framework_tpu_torch.modules import hrir

    h, d, fs = hrir.default_hrirs()
    h, d = h[::40], d[::40]
    ncfg = binauraliser_nf.BinauraliserNFConfig()
    rcfg = roombinauraliser.RoomBinauraliserConfig()
    w = binauraliser_nf.design_ri(ncfg, h, d, fs, device="cpu")
    _, rw = roombinauraliser.design_ri(rcfg, h[None], d, fs, device="cpu")
    assert all(t.device.type == "cpu" for t in tuple(w) + tuple(rw))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        binauraliser_nf.design_ri(ncfg, h, d, fs)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        roombinauraliser.design_ri(rcfg, h[None], d, fs)


@pytest.mark.parametrize("entry", list(ENTRY_POINTS))
def test_entry_point_without_a_card_raises(monkeypatch, entry):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ENTRY_POINTS[entry]()

