"""SOFA and HDF5 in the PyTorch port vs the JAX package (CPU): files written
by either package read back by the other, the HRIR use-case checks, the
bad-file fallback to the default HRIR set, and a binauraliser designed from
a SOFA file.  Every file is written to pytest's temporary directory; the
repository holds no SOFA file."""
import numpy as np
import pytest
import torch

from spatial_audio_framework_tpu.models import binauraliser as jbin
from spatial_audio_framework_tpu.modules import sofa as jsofa
from spatial_audio_framework_tpu.utils import hdf5 as jh5
from spatial_audio_framework_tpu_torch.models import ambi_bin as tab
from spatial_audio_framework_tpu_torch.models import binauraliser as tbin
from spatial_audio_framework_tpu_torch.modules import hrir as thrir
from spatial_audio_framework_tpu_torch.modules import sofa as tsofa
from spatial_audio_framework_tpu_torch.utils import hdf5 as th5

DESIGN_TOL = 1e-6   # host numpy on both sides; relative to a table's peak


def _subset(step=8):
    """Every ``step``-th direction of the default set, with radius 1.2 m."""
    hrirs, dirs, fs = thrir.default_hrirs()
    pos = np.concatenate([dirs[::step], np.full((len(dirs[::step]), 1), 1.2)],
                         -1)
    return hrirs[::step], pos, fs


def _assert_same_container(a, b):
    for name in ("n_sources", "n_receivers", "data_length_ir",
                 "data_sampling_rate", "n_listeners", "n_emitters"):
        assert getattr(a, name) == getattr(b, name), name
    for name in ("data_ir", "source_position", "receiver_position",
                 "listener_position", "listener_up", "listener_view"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name),
                                      err_msg=name)
    assert a.var_attrs == b.var_attrs and a.global_attrs == b.global_attrs
    np.testing.assert_array_equal(a.source_dirs_deg(), b.source_dirs_deg())


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_sofa_round_trip_between_packages(tmp_path, writer):
    """A file saved by one package opens identically in both."""
    hrirs, pos, fs = _subset()
    path = str(tmp_path / f"{writer}.sofa")
    save = jsofa.sofa_save if writer == "jax" else tsofa.sofa_save
    save(path, hrirs.astype(np.float64), float(fs), pos,
         extra_global_attrs={"Title": "subset"})
    t = tsofa.sofa_open(path, usecase=tsofa.USECASE_HRIR)
    j = jsofa.sofa_open(path, usecase=jsofa.USECASE_HRIR)
    _assert_same_container(t, j)
    assert t.n_sources == hrirs.shape[0] and t.n_receivers == 2
    np.testing.assert_array_equal(t.data_ir, hrirs)
    np.testing.assert_allclose(t.source_dirs_deg(), pos[:, :2], atol=1e-5)
    assert t.global_attrs["SOFAConventions"] == "SimpleFreeFieldHRIR"
    assert t.global_attrs["Title"] == "subset"
    assert t.var_attrs["SourcePosition:Type"] == "spherical"


def test_sofa_cartesian_positions(tmp_path):
    """Cartesian source positions convert to (azi, elev) degrees."""
    xyz = np.array([[1.0, 0.0, 0.0], [0.0, 2.0, 0.0], [0.0, 0.0, -1.5],
                    [-1.0, -1.0, 1.0]])
    path = str(tmp_path / "cart.sofa")
    tsofa.sofa_save(path, np.zeros((4, 2, 8)), 48000.0, xyz,
                    position_type="cartesian")
    got = tsofa.sofa_open(path).source_dirs_deg()
    np.testing.assert_allclose(got, jsofa.sofa_open(path).source_dirs_deg())
    np.testing.assert_allclose(got[:3], [[0, 0], [90, 0], [0, -90]],
                               atol=1e-5)


def test_sofa_usecase_checks(tmp_path):
    """The HRIR use-case takes 2 receivers only, the BRIR use-case its
    conventions only, and a missing file raises SofaError, as in the JAX
    package (tests/test_sofa.py)."""
    bad = str(tmp_path / "three.sofa")
    tsofa.sofa_save(bad, np.zeros((4, 3, 16)), 48000.0, np.zeros((4, 3)))
    with pytest.raises(tsofa.SofaError) as e:
        tsofa.sofa_open(bad, usecase=tsofa.USECASE_HRIR)
    assert e.value.code == tsofa.SAF_SOFA_ERROR_DIMENSIONS_UNEXPECTED
    with pytest.raises(tsofa.SofaError) as e:
        tsofa.sofa_open(str(tmp_path / "missing.sofa"))
    assert e.value.code == tsofa.SAF_SOFA_ERROR_INVALID_FILE_OR_FILE_PATH
    brir = str(tmp_path / "brir.sofa")
    tsofa.sofa_save(brir, np.zeros((2, 2, 64)), 48000.0, np.zeros((2, 3)),
                    conventions="MultiSpeakerBRIR")
    c = tsofa.sofa_open(brir, usecase=tsofa.USECASE_BRIR)
    assert c.global_attrs["SOFAConventions"] == "MultiSpeakerBRIR"
    hrir_conv = str(tmp_path / "hrir.sofa")
    tsofa.sofa_save(hrir_conv, np.zeros((2, 2, 64)), 48000.0,
                    np.zeros((2, 3)))
    with pytest.raises(tsofa.SofaError) as e:
        tsofa.sofa_open(hrir_conv, usecase=tsofa.USECASE_BRIR)
    assert e.value.code == tsofa.SAF_SOFA_ERROR_INVALID_READER_OPTION


def _no_source_position(path):
    w = th5.HDF5Writer()
    w.add_root_attr("Conventions", "SOFA")
    w.add_root_attr("SOFAConventions", "SimpleFreeFieldHRIR")
    w.add_dataset("Data.IR", np.zeros((4, 2, 16)))
    w.add_dataset("Data.SamplingRate", np.asarray([48000.0]),
                  attrs={"Units": "hertz"})
    w.save(path)


@pytest.mark.parametrize("bad", ["missing", "not_hdf5", "three_receivers",
                                 "no_source_position"])
def test_load_hrirs_falls_back_to_the_default_set(tmp_path, bad):
    """A SOFA path that cannot be loaded as a 2-receiver HRIR set warns and
    returns the default set (ambi_bin.c:209-218), as the JAX package does
    (tests/test_error_handling.py, tests/test_sofa.py)."""
    from spatial_audio_framework_tpu.modules import hrir as jhrir

    path = str(tmp_path / f"{bad}.sofa")
    if bad == "not_hdf5":
        with open(path, "wb") as f:
            f.write(b"not an HDF5 file")
    elif bad == "three_receivers":
        tsofa.sofa_save(path, np.zeros((10, 3, 64)), 48000.0,
                        np.zeros((10, 3)))
    elif bad == "no_source_position":
        _no_source_position(path)
    with pytest.warns(UserWarning, match="Using default HRIR data"):
        h, d, fs, used_default = thrir.load_hrirs(path)
    assert used_default
    ref_h, ref_d, ref_fs = thrir.default_hrirs()
    np.testing.assert_array_equal(h, ref_h)
    np.testing.assert_array_equal(d, ref_d)
    assert fs == ref_fs
    with pytest.warns(UserWarning):
        jh, jd, jfs, jdef = jhrir.load_hrirs(path)
    assert jdef and jfs == fs
    np.testing.assert_array_equal(jh, h)


def test_load_hrirs_reads_a_good_file_and_honours_use_default(tmp_path):
    hrirs, pos, fs = _subset(4)
    path = str(tmp_path / "good.sofa")
    tsofa.sofa_save(path, hrirs.astype(np.float64), float(fs), pos)
    h, d, fs2, used_default = thrir.load_hrirs(path)
    assert not used_default and fs2 == fs
    np.testing.assert_array_equal(h, hrirs)
    np.testing.assert_allclose(d, pos[:, :2], atol=1e-5)
    *_, used_default = thrir.load_hrirs(path, use_default=True)
    assert used_default


def test_design_survives_a_bad_sofa_path(tmp_path):
    """ambi_bin's design with an unloadable sofa_filepath equals the
    default-set design exactly (tests/test_error_handling.py)."""
    cfg = tab.AmbiBinConfig(order=1, method="ls")
    with pytest.warns(UserWarning):
        w_bad = tab.design_ri(cfg, sofa_filepath=str(tmp_path / "no.sofa"),
                              device="cpu")
    w_def = tab.design_ri(cfg, device="cpu")
    for a, b in zip(w_bad, w_def):
        assert torch.equal(a, b)


def test_binauraliser_design_from_sofa_vs_jax(tmp_path):
    """A binauraliser designed from a SOFA file of a subset of the default
    set (so the file is really read): port vs JAX, both from the file."""
    hrirs, pos, fs = _subset(2)
    path = str(tmp_path / "half.sofa")
    tsofa.sofa_save(path, hrirs.astype(np.float64), float(fs), pos)
    got = tbin.design_ri(tbin.BinauraliserConfig(), sofa_filepath=path,
                         device="cpu")
    ref = jbin.design_ri(jbin.BinauraliserConfig(), sofa_filepath=path)
    assert got.itds.shape == (hrirs.shape[0],)
    for name, a, b in zip(got._fields, ref, got):
        a = np.asarray(a)
        if name == "table_idx":
            np.testing.assert_array_equal(b.numpy(), a)
            continue
        peak = max(1.0, float(np.abs(a).max()))
        assert np.abs(a - b.numpy()).max() <= DESIGN_TOL * peak, name


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_hdf5_round_trip_between_packages(tmp_path, writer):
    """Datasets (f64, f32, 1-D to 3-D) and string attributes written by one
    package's HDF5Writer read back equal by both readers."""
    data = {"D64": np.arange(24, dtype=np.float64).reshape(2, 3, 4) * 1.5,
            "D32": np.arange(6, dtype=np.float32).reshape(2, 3) + 0.25,
            "V": np.asarray([48000.0])}
    w = (jh5 if writer == "jax" else th5).HDF5Writer()
    w.add_root_attr("Conventions", "SOFA")
    for name, a in data.items():
        w.add_dataset(name, a, attrs={"Units": "m"})
    path = str(tmp_path / f"{writer}.h5")
    w.save(path)
    for reader in (th5.read_hdf5, jh5.read_hdf5):
        root = reader(path)
        assert root.attrs["Conventions"] == "SOFA"
        assert set(root.datasets) == set(data)
        for name, a in data.items():
            np.testing.assert_array_equal(root.datasets[name].data, a)
            assert root.datasets[name].attrs["Units"] == "m"
