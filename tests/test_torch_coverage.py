"""The port is complete: every module of ``spatial_audio_framework_tpu``
has a counterpart in ``spatial_audio_framework_tpu_torch``, and every
public name of a JAX module (functions, classes, constants, and the public
members of its classes) exists in the port's module, except the deliberate
differences mapped below."""
import importlib
import inspect
import pkgutil

import pytest

import spatial_audio_framework_tpu as jpkg
import spatial_audio_framework_tpu_torch as tpkg

# JAX module → the port's module, where the name differs: the Pallas
# kernels became hand-written CUDA under csrc/ with their wrappers (and
# plain versions) in ops/afstft_kernels.py
RENAMED = {"ops.pallas_afstft": "ops.afstft_kernels"}

# names that exist only for the TPU, which the port does not carry
# (ROADMAP.md, "Out of scope this round"): the Pallas block sizes of the
# VMEM tiling; the matmul-DFT backend switch and the
# complex-free (re, im) DFT helpers (XLA's FFT is missing on the TPU
# runtime); the MXU precision policy (bf16 passes, the process-wide hot
# mode)
NOT_PORTED = {
    "ops.pallas_afstft": {"BLK_B", "BLK_S"},
    "ops.fft": {"force_dft_impl", "rfft_op_ri", "irfft_op_ri"},
    "ops.precision": {"to_xla", "hot_mode", "set_hot_precision", "EXACT",
                      "HOT"},
}


def _jax_modules():
    return sorted(m.name[len(jpkg.__name__) + 1:] for m in
                  pkgutil.walk_packages(jpkg.__path__, jpkg.__name__ + "."))


# modules whose re-exported names are their API: the SAF-named facade
FACADES = {"compat"}


def _public(mod, facade=False):
    """Public names of ``mod``: the functions and classes it defines and its
    constants (objects without a ``__module__``); for a facade, every name
    it exports but modules."""
    return {n: o for n, o in vars(mod).items()
            if not n.startswith("_") and not inspect.ismodule(o)
            and (facade or getattr(o, "__module__", mod.__name__)
                 == mod.__name__)}


MODULES = _jax_modules()


def test_every_jax_module_is_walked():
    assert len(MODULES) >= 60
    for must in ("runtime.native", "runtime.stream", "runtime.watchdog",
                 "parallel.mesh", "parallel.streaming", "compat",
                 "ops.pitch", "ops.qmf", "modules.tracker"):
        assert must in MODULES


@pytest.mark.parametrize("name", MODULES)
def test_module_has_a_counterpart_with_its_public_names(name):
    jmod = importlib.import_module(f"{jpkg.__name__}.{name}")
    tmod = importlib.import_module(
        f"{tpkg.__name__}.{RENAMED.get(name, name)}")
    skip = NOT_PORTED.get(name, set())
    public = _public(jmod, name in FACADES)
    missing = sorted(n for n in public
                     if n not in skip and not hasattr(tmod, n))
    assert not missing, f"{name}: not in the port: {missing}"
    for cname, cls in public.items():
        if (inspect.isclass(cls) and cls.__module__ == jmod.__name__
                and cname not in skip):
            tcls = getattr(tmod, cname)
            gone = sorted(a for a in vars(cls)
                          if not a.startswith("_") and not hasattr(tcls, a))
            assert not gone, f"{name}.{cname}: members not in the port: {gone}"


def test_deliberate_differences_are_real():
    """Every name of the map exists in the JAX module and not in the
    port's, so the map cannot hide a name that was ported after all."""
    for name, names in NOT_PORTED.items():
        jmod = importlib.import_module(f"{jpkg.__name__}.{name}")
        tmod = importlib.import_module(
            f"{tpkg.__name__}.{RENAMED.get(name, name)}")
        for n in names:
            assert hasattr(jmod, n) and not hasattr(tmod, n), (name, n)


def test_the_six_kernels_have_wrappers():
    from spatial_audio_framework_tpu_torch.ops import afstft_kernels as ak

    for k in ("analysis_front_ri", "analysis_front_dg_ri",
              "render_decode_synthesis_ri", "render_decode_synthesis_dg_ri",
              "render_full_ri", "synthesis_back_ri"):
        assert k in ak.LAUNCHES
        assert callable(getattr(ak, f"{k}_reference"))
