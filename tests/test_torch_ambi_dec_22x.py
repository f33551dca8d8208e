"""ambi_dec at order 3 onto the 22.x layout, the benchmark's
``ambi_dec_o3_22x`` configuration, on the CPU: the port's batched entry on
both routes against the benchmark's plain reference
(``portbench/reference/ambi_dec.py``), the reference's own design against
the port's ``design_host``, the reference's data against the port's
tables, and the cell's run at a tiny size with its counter
``ops.spectra_bytes`` by hand.

The card runs the cell at its size: ``python3 portbench/run.py --workload
ambi_dec_o3_22x.batch1024 --seed <n> --seconds 10 --trace <0|1>``.
"""
from __future__ import annotations

import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import run  # noqa: E402
from portbench.reference import ambi_dec as ref_ambi_dec  # noqa: E402
from portbench.reference.render import Reference  # noqa: E402
from portbench.systems.ambi_dec import System  # noqa: E402
from portbench.tests.test_portbench_harness import tiny  # noqa: E402
from spatial_audio_framework_tpu_torch.models import ambi_dec  # noqa: E402
from spatial_audio_framework_tpu_torch.utils import (  # noqa: E402
    presets, profiling)

CPU = torch.device("cpu")
HOP, S, CIN, COUT, N_BANDS = 128, 2, 16, 22, 133
CELL = "ambi_dec_o3_22x.batch1024"


@pytest.mark.parametrize("hops", [4, 14, 15, 20])
@pytest.mark.parametrize("fused", [True, False])
def test_batched_entry_matches_the_reference(fused, hops):
    """Three blocks with state carried, through the wide route's kernel
    versions (``fused=True``) or the plain path, against the reference's
    render of the whole signal from silence, a seeded random real
    (133, 22, 16) decoder."""
    rng = np.random.default_rng(19)
    cfg = ambi_dec.AmbiDecConfig(master_order=3)
    M = rng.standard_normal((N_BANDS, COUT, CIN)).astype(np.float32)
    w = ambi_dec.weights_from_numpy(M, None, CPU)
    st = ambi_dec.init_state_batched(cfg, S, COUT, device=CPU)
    n = hops * HOP
    x = torch.from_numpy(
        rng.uniform(-1, 1, (S, CIN, 3 * n)).astype(np.float32))
    ys = []
    for b in range(3):
        y, st = ambi_dec.process_ri_batched(cfg, w, st, x[..., b * n:
                                                          (b + 1) * n],
                                            fused=fused)
        ys.append(y)
    y = torch.cat(ys, dim=-1)
    ref = ref_ambi_dec.render(Reference(CPU), x, torch.from_numpy(M), hops)
    assert tuple(y.shape) == tuple(ref.shape) == (S, COUT, 3 * n)
    err = float((y - ref).abs().max() / ref.abs().max())
    assert err < 1e-5, err


def test_reference_design_matches_the_ports():
    """The reference's dual-band AllRAD decoder, max-rE, energy
    normalisation, band switch at 800 Hz and SN3D input, against the
    port's ``design_host``, to 1e-6 of the largest entry.  The two bands
    differ only by their hulls, drawn from one ``rand()`` stream one after
    the other: they split the layout's coplanar quads differently."""
    cfg = ambi_dec.AmbiDecConfig(master_order=3)
    port = ambi_dec.design_host(cfg, presets.loudspeaker_preset("22.x"))
    ref = ref_ambi_dec.decoder(3, 48000.0, 800.0, "22.x")
    assert ref.shape == port.shape == (N_BANDS, COUT, CIN)
    scale = np.abs(port).max()
    assert np.abs(ref - port).max() <= 1e-6 * scale
    low = ref_ambi_dec.centre_freqs(48000.0) < 800.0
    assert low.sum() == 9 and low[:9].all()
    assert np.abs(ref[0] - ref[-1]).max() > 1e-2 * scale


def test_reference_data_are_the_ports_tables():
    np.testing.assert_array_equal(ref_ambi_dec.layout_dirs_deg("22.x"),
                                  presets.loudspeaker_preset("22.x"))
    for degree in (30, 100):
        np.testing.assert_array_equal(ref_ambi_dec.tdesign(degree),
                                      presets.tdesign(degree))


def test_cells_block_bytes_by_hand():
    """1024 streams x 8192 samples: 16 in, 22 out, both tails read and
    written, float32, and the real decoder read once."""
    signal = 4 * (1024 * 16 * 8192 + 1024 * 22 * 8192
                  + 2 * 1024 * 16 * 15 * 128 + 2 * 1024 * 22 * 9 * 128)
    decoder = 4 * N_BANDS * COUT * CIN
    assert signal + decoder == 1_734_531_968
    system = SimpleNamespace(cfg=ambi_dec.AmbiDecConfig(master_order=3),
                             streams=1024, cin=CIN, cout=COUT,
                             block_samples=8192)
    assert System.work_bytes(system) == 1_734_531_968


def test_tiny_cell_run_is_correct_and_counts_its_spectra():
    """The cell through ``run.run_cell`` at 4 streams x 512 samples,
    traced: correct, the TF32 control over the limit, and
    ``ops.spectra_bytes`` the spectra written between the two kernels a
    block: the front's (re, im) over H + 6 hops, the packed hybrid
    spectra, the mix's output and its dense copy."""
    config, mix = tiny(CELL)
    profiling.reset_counters()
    r = run.run_cell(config, mix, 2 ** 31 + 19, 0.2, True, CPU,
                     per_layer=[("ops.spectra_bytes", "MB")], control=True)
    limit = r["checks"]["max_rel_err"]["limit"]
    assert limit == 2e-5
    assert r["correct"] and r["checks"]["max_rel_err"]["value"] < limit
    assert r["control"]["max_rel_err"] > 3 * limit
    s, h = mix["streams"], mix["block_samples"] // HOP
    hand = 4 * (2 * s * CIN * (h + 6) * (HOP + 1) + s * CIN * h * 2 * N_BANDS
                + 2 * s * COUT * h * 2 * N_BANDS)
    assert hand == 1_681_920
    assert r["metrics"]["ops.spectra_bytes"]["value"] == pytest.approx(
        hand / 1e6, rel=1e-12)


def test_spectra_reader_gives_nothing_without_the_counter(monkeypatch):
    """A program that never counts ``ops.spectra_bytes`` (an earlier
    version of it) gives no reading, and raises nothing."""
    ctx = SimpleNamespace(blocks=3)
    reader = run.load_reader("ops.spectra_bytes")
    monkeypatch.setattr(profiling, "counters", lambda: {"ops.host_ns": 5})
    assert reader(ctx) is None
    monkeypatch.delattr(profiling, "counters")
    assert reader(ctx) is None
