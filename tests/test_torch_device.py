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
                                                      binauraliser)
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


@pytest.mark.parametrize("entry", list(ENTRY_POINTS))
def test_entry_point_without_a_card_raises(monkeypatch, entry):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ENTRY_POINTS[entry]()

