"""The port's spans and counters (``utils/profiling``) on the CPU: off
without a profiler, the span tree of the benchmark's three entries,
``ops.state_bytes`` by hand, the spans kept off the device's list, and the
benchmark's readers of them (``portbench/metrics``).

The device half (no span among the card's operations, the readers on the
card) runs on the card: ``python3 portbench/run.py --workload <cell>
--seed <n> --seconds 10 --trace 1`` and ``python scripts/trace_layers.py
<cell>``.
"""
from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import run, trace  # noqa: E402
from portbench.tests.test_portbench_harness import tiny  # noqa: E402
from spatial_audio_framework_tpu_torch.models import (  # noqa: E402
    ambi_bin, ambi_dec, binauraliser)
from spatial_audio_framework_tpu_torch.ops import (  # noqa: E402
    afstft_kernels as ak)
from spatial_audio_framework_tpu_torch.utils import profiling  # noqa: E402

HOP, TAIL_HOPS, S = 128, 15, 2
N_SRC = 20          # more than 16 sources: the binauraliser's two-pass route
READERS = (("ops.host_ms", "ms"), ("kernels.host_ms", "ms"),
           ("ops.state_bytes", "MB"))

TREES = {
    "ambi_bin": {
        "models.ambi_bin.process_ri_batched": None,
        "ops.render_one_pass": "models.ambi_bin.process_ri_batched",
        "ops.decode_taps": "ops.render_one_pass",
        "kernels.render_full_ri": "ops.render_one_pass",
        "ops.next_in_tail": "ops.render_one_pass",
    },
    # the rotation, the lookup and the taps are one kernel entry, whose taps
    # the route takes as they are: no ops.rotate_dirs, ops.interp_hrtfs or
    # ops.decode_taps on this path
    "binauraliser": {
        "models.binauraliser.process_ri_batched": None,
        "kernels.hrtf_taps_ri": "models.binauraliser.process_ri_batched",
        "ops.render_two_pass": "models.binauraliser.process_ri_batched",
        "kernels.analysis_front_dg_ri": "ops.render_two_pass",
        "kernels.render_decode_synthesis_dg_ri": "ops.render_two_pass",
        "ops.next_in_tail": "ops.render_two_pass",
    },
    # 16 → 22 is 352 channel pairs: the wide route, three kernel entries
    # (the hybrid stage and the per-band mix are one, wide_mix_ri)
    "ambi_dec": {
        "models.ambi_dec.process_ri_batched": None,
        "ops.render_wide": "models.ambi_dec.process_ri_batched",
        "kernels.analysis_front_ri": "ops.render_wide",
        "ops.next_in_tail": "ops.render_wide",
        "kernels.wide_mix_ri": "ops.render_wide",
        "kernels.synthesis_back_ri": "ops.render_wide",
    },
}
CIN = {"ambi_bin": 16, "binauraliser": N_SRC, "ambi_dec": 16}
COUT = {"ambi_bin": 2, "binauraliser": 2, "ambi_dec": 22}


def _entry(name: str, hops: int):
    """A call of the entry ``name`` on S streams, a block of ``hops`` hops,
    random weights, on the CPU."""
    rng = np.random.default_rng(7)
    cin = CIN[name]
    x = torch.from_numpy(
        rng.uniform(-1, 1, (S, cin, hops * HOP)).astype(np.float32))
    if name == "ambi_bin":
        cfg = ambi_bin.AmbiBinConfig(order=3)
        w = ambi_bin.weights_from_numpy(rng.standard_normal((133, 2, cin)),
                                        rng.standard_normal((133, 2, cin)),
                                        "cpu")
        st = ambi_bin.init_state_batched(cfg, S, device="cpu")
        return lambda: ambi_bin.process_ri_batched(cfg, w, st, x)
    if name == "ambi_dec":
        cfg = ambi_dec.AmbiDecConfig(master_order=3)
        w = ambi_dec.weights_from_numpy(
            rng.standard_normal((133, COUT[name], cin)), None, "cpu")
        st = ambi_dec.init_state_batched(cfg, S, COUT[name], device="cpu")
        return lambda: ambi_dec.process_ri_batched(cfg, w, st, x)
    cfg = binauraliser.BinauraliserConfig(n_sources=cin,
                                          enable_rotation=True)
    n_dirs, n_table = 40, (int(360 / cfg.azi_res + 0.5) + 1) * 37
    w = binauraliser.weights_from_numpy(
        rng.standard_normal((133, 2, n_dirs)),
        rng.standard_normal((133, 2, n_dirs)),
        rng.uniform(0, 1, (133, 2, n_dirs)), rng.uniform(0, 1e-3, n_dirs),
        rng.dirichlet(np.ones(3), n_table),
        rng.integers(0, n_dirs, (n_table, 3)), np.linspace(0, 24e3, 133),
        "cpu")
    st = binauraliser.init_state_batched(cfg, S, device="cpu")
    dirs = torch.from_numpy(np.stack(
        [rng.uniform(-180, 180, (S, cin)), rng.uniform(-80, 80, (S, cin))],
        axis=-1).astype(np.float32))
    ypr = torch.from_numpy(rng.uniform(-0.5, 0.5, (S, 3)).astype(np.float32))
    return lambda: binauraliser.process_ri_batched(
        cfg, w, st, x, src_dirs_deg=dirs, ypr=ypr)


def _profiled(call):
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = call()
    return out, prof


def _program_spans(prof):
    return [e for e in prof.events() if e.name not in trace.SPANS
            and e.name.split(".", 1)[0] in ("models", "ops", "kernels")]


def _raise(*a, **k):
    raise AssertionError("a record function was built without a profiler")


@pytest.mark.parametrize("name", sorted(TREES))
def test_spans_off_build_no_record_function(name, monkeypatch):
    call = _entry(name, 4)
    monkeypatch.setattr(profiling, "_RecordFunctionFast", _raise)
    monkeypatch.setattr(torch.profiler, "record_function", _raise)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", _raise)
    profiling.reset_counters()
    assert profiling.span("ops.a") is profiling.span("kernels.b")
    profiling.count("ops.state_bytes", 123)
    y, _ = call()
    assert tuple(y.shape) == (S, COUT[name], 4 * HOP)
    assert bool(torch.isfinite(y).all())
    assert profiling.counters() == {}            # no profiler, no count
    # the launches are the kernel layer's: a count a kernel, none on the CPU
    assert set(ak.LAUNCHES) == {
        "analysis_front_ri", "analysis_front_dg_ri", "synthesis_back_ri",
        "render_decode_synthesis_ri", "render_decode_synthesis_dg_ri",
        "render_full_ri", "wide_mix_ri", "hrtf_taps_ri"}
    assert not any(ak.LAUNCHES.values())


@pytest.mark.parametrize("name", sorted(TREES))
def test_span_tree_of_each_entry(name):
    call = _entry(name, 4)
    _, prof = _profiled(call)
    spans = _program_spans(prof)
    tree = {e.name: e.cpu_parent.name if e.cpu_parent else None
            for e in spans}
    assert tree == TREES[name]
    assert len(spans) == len(TREES[name])       # each span once a call


@pytest.mark.parametrize("hops", [4, 14, 15, 20])
@pytest.mark.parametrize("name", sorted(TREES))
def test_state_bytes_by_hand(name, hops):
    """The input tail's 15 hops a block: written by a cat below 15 hops, a
    dense copy of the block's last 15 hops above; at 15 the tail is the
    block itself, and nothing is copied.  The wide route (ambi_dec) copies
    nothing more: its mix writes the dense rows ``synthesis_back_ri``
    reads."""
    call = _entry(name, hops)
    profiling.reset_counters()
    _profiled(call)
    want = 0 if hops == TAIL_HOPS else S * CIN[name] * TAIL_HOPS * HOP * 4
    assert profiling.counters().get("ops.state_bytes", 0) == want
    profiling.reset_counters()
    call()                                   # no profiler, no count
    assert "ops.state_bytes" not in profiling.counters()


@pytest.mark.parametrize("S,cin,cout,H,want", [
    (1024, 16, 2, 8, 229_376),         # rt1024: one short tile, 14 frames
    (1024, 16, 2, 64, 1_245_184),      # batch1024: two long tiles of 38
    (2, 4, 5, 8, 2 * 4 * 3 * 14),      # three passes over five ears
    (1, 16, 11, 65, 16 * 6 * (38 + 38 + 7)),  # six passes; a last tile of
                                              # one hop
    (3, 16, 2, 7, 3 * 16 * 13),
    (1, 4, 1, 1, 4 * 7),
])
def test_render_full_frames_by_hand(S, cin, cout, H, want):
    """``kernels.frames``: the frames the one-pass kernel folds and
    transforms, a tile's output hops + 6 for each stream, input channel and
    pass over two ears."""
    assert ak.render_full_frames(S, cin, cout, H) == want


@pytest.mark.parametrize("cout,H", [(2, 8), (2, 64), (5, 8)])
def test_render_full_frames_counted_by_the_kernels_wrapper(cout, H):
    """The kernel's wrapper counts ``kernels.frames`` from the shapes
    while a profiler records, and nothing otherwise.  It runs on the CPU
    here up to the launch, which only a card makes."""
    prepare = ak.render_full_ri.__wrapped__.__wrapped__
    rng = np.random.default_rng(3)
    cin = 4

    def u(*shape):
        return torch.from_numpy(rng.uniform(-1, 1, shape).astype(np.float32))

    taps = ak.decode_taps(u(133, cout, cin), u(133, cout, cin)).contiguous()
    args = (u(S, cin, TAIL_HOPS * HOP), u(S, cin, H * HOP),
            u(S, cout, 9, HOP), taps)
    profiling.reset_counters()
    prepare(*args)
    assert "kernels.frames" not in profiling.counters()
    _profiled(lambda: prepare(*args))
    assert profiling.counters()["kernels.frames"] == ak.render_full_frames(
        S, cin, cout, H)
    profiling.reset_counters()


def test_host_ns_is_self_time_by_layer():
    """Each layer's ``host_ns`` is its spans' host time less the spans
    nested in them: the three layers add up to the entry's span."""
    call = _entry("binauraliser", 4)
    profiling.reset_counters()
    _, prof = _profiled(call)
    got = profiling.counters()
    layers = [got[f"{k}.host_ns"] for k in ("models", "ops", "kernels")]
    assert all(v > 0 for v in layers)
    root = next(e for e in _program_spans(prof) if e.cpu_parent is None)
    total_us = sum(layers) / 1e3
    assert total_us <= root.cpu_time_total * 1.05 + 50
    assert total_us >= root.cpu_time_total * 0.8


@pytest.mark.parametrize("name", sorted(TREES))
def test_program_spans_stay_off_the_device_list(name, monkeypatch):
    """The program's spans are function-scope record functions, not user
    annotations: the profiler derives no device-side annotation from them,
    and ``trace.collect`` reads the same spans and operations with them as
    with the spans switched off (a program without them)."""
    call = _entry(name, 4)

    def traced():
        with trace.span("models.process", True):
            return call()

    _, prof = _profiled(traced)
    spans = _program_spans(prof)
    assert spans and not any(e.is_user_annotation for e in spans)
    assert [e.is_user_annotation for e in prof.events()
            if e.name == "models.process"] == [True]
    on = trace.collect(prof)
    monkeypatch.setattr(profiling, "_tracing", lambda: False)
    _, prof_off = _profiled(traced)
    assert not _program_spans(prof_off)
    off = trace.collect(prof_off)
    assert [n for n, _, _ in on.spans] == [n for n, _, _ in off.spans] == [
        "models.process"]
    assert on.ops == off.ops == []           # no device on the CPU


@pytest.mark.parametrize("cell", ["ambi_bin_o3.batch1024",
                                  "binauraliser_64src.track1024"])
def test_readers_on_a_cpu_traced_run(cell):
    config, mix = tiny(cell)
    profiling.reset_counters()
    r = run.run_cell(config, mix, 2 ** 31 + 5, 0.2, True,
                     torch.device("cpu"), per_layer=READERS)
    assert r["correct"]
    m = {k: v["value"] for k, v in r["metrics"].items()}
    assert m["ops.host_ms"] > 0 and m["kernels.host_ms"] > 0
    cin = 16 if cell.startswith("ambi") else 64
    hops = mix["block_samples"] // HOP
    assert hops < TAIL_HOPS
    assert m["ops.state_bytes"] == pytest.approx(
        mix["streams"] * cin * TAIL_HOPS * HOP * 4 / 1e6, rel=1e-12)


def test_readers_give_nothing_without_the_programs_counters(monkeypatch):
    """A program without counters (an earlier version of it) gives no
    reading, and raises nothing."""
    monkeypatch.delattr(profiling, "counters")
    ctx = type("Ctx", (), {"blocks": 3})()
    for name, _ in READERS:
        assert run.load_reader(name)(ctx) is None
