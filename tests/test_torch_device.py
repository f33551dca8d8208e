"""The port's entry points run on the card unless the caller asks for the
CPU: every public ``device`` parameter defaults to None, which resolves to
``cuda:0`` through ``default_device()``, and without a card that raises
instead of falling back to the CPU."""
import importlib
import inspect
import pkgutil

import numpy as np
import pytest
import torch

import spatial_audio_framework_tpu_torch as port
from spatial_audio_framework_tpu_torch.models import (ambi_bin, ambi_dec,
                                                      ambi_enc, binauraliser,
                                                      binauraliser_nf, panner,
                                                      roombinauraliser)
from spatial_audio_framework_tpu_torch.ops import afstft_ri
from spatial_audio_framework_tpu_torch.ops.afstft import AfSTFT


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
}


def _tensors(out):
    if isinstance(out, torch.Tensor):
        return [out]
    return [t for o in out for t in _tensors(o)] if isinstance(
        out, (tuple, list)) else []


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

