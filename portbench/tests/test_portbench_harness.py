"""The benchmark's own tests, on the CPU at small sizes:
``python -m pytest -q portbench/tests`` from the repository's root.

They check that every file ``BENCHMARK.json`` names is found by name, the
contract's characters and lengths, the roofline's byte count by hand, the
plain reference against the port's plain path, the comparison's control
and faults (a run with the timed path broken comes out not correct), that
nothing the benchmark imports is JAX or the JAX package, and that the
harness refuses to run without a card.
"""
from __future__ import annotations

import ast
import hashlib
import json
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
sys.path.insert(0, str(ROOT))

from portbench import run, traffic, work_bytes  # noqa: E402
from portbench.reference.render import Reference, history_blocks  # noqa: E402

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
# sha256 of the data files as copied from the port's data/ directory
DATA_SHA256 = {
    "default_hrirs.npz":
        "cd109dffc80a9396c26b855b9c6cd3532a29223b5183a8b6dc2ed72e7ef82245",
    "afstft_proto.npz":
        "7ccea36215fd915150c0e1a19c2a3f9b8b3379aa5ed68888b9e8076a0fd7d984",
}
CPU = torch.device("cpu")


def tiny(cell: str, **over) -> tuple[dict, dict]:
    """A cell's configuration and its mix cut to a size the CPU holds."""
    entry = next(w for w in SPEC["workloads"] if w["name"] == cell)
    config = run.load_config(entry["config"])
    mix = traffic.load(entry["traffic"])
    mix.update(streams=4, block_samples=min(mix["block_samples"], 512),
               warmup_blocks=6, trace_blocks=3, check_blocks=2)
    if "controls" in mix:
        mix["controls"]["ring_blocks"] = 5
    mix.update(over)
    return config, mix


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_every_cell_finds_its_files(cell):
    entry, config, mix, per_layer = run.cell(cell)
    assert config["name"] == entry["config"]
    assert (BENCH / "systems" / f"{config['system']}.py").is_file()
    for key in ("streams", "block_samples", "inflight", "ring_blocks",
                "signal", "warmup_blocks", "trace_blocks", "check_blocks"):
        assert key in mix, key
    assert per_layer, "every cell reports a per-layer metric"
    assert mix["warmup_blocks"] > history_blocks(mix["block_samples"] // 128)


@pytest.mark.parametrize("metric", [m["name"] for m in SPEC["per_layer"]])
def test_every_per_layer_metric_has_a_reader(metric):
    assert callable(run.load_reader(metric))


def test_names_units_and_limits_of_the_contract():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    names = [c["name"] for c in SPEC["configs"]]
    names += [w["name"] for w in SPEC["workloads"]]
    names += [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    for n in names + [w["traffic"] for w in SPEC["workloads"]]:
        assert NAME.match(n), n
    assert len(set(names)) == len(names)
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    for c in SPEC["configs"]:
        assert (ROOT / c["file"]).is_file()
        assert json.loads((ROOT / c["file"]).read_text())["reduced"] == \
            c["reduced"]
        for text in (c["source"], c["why"]):
            assert 1 <= len(text) <= 200 and "\n" not in text
    for w in SPEC["workloads"]:
        assert w["chips"] == 1 and 1 <= len(w["why"]) <= 200
    layers = {m["layer"] for m in SPEC["per_layer"]}
    assert layers == {"models", "ops", "kernels", "device"}
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_data_files_are_the_copies_they_were():
    for name, digest in DATA_SHA256.items():
        assert hashlib.sha256((BENCH / "data" / name).read_bytes()
                              ).hexdigest() == digest, name


def test_roofline_bytes_of_ambi_bin_blocks_by_hand():
    # signal and state: 256 streams x 16 channels x 8192 samples in,
    # x 2 ears out, the 15-hop input tail and the 9-hop overlap-add tail
    # each read and written, float32
    signal = 4 * (256 * 16 * 8192 + 256 * 2 * 8192
                  + 2 * 256 * 16 * 15 * 128 + 2 * 256 * 2 * 9 * 128)
    assert signal == 218_628_096
    decoder = 133 * 2 * 16 * 2 * 4
    assert decoder == 34_048
    assert work_bytes.block_bytes(256, 16, 2, 8192,
                                  work_bytes.decoder_bytes(133, 2, 16)) == \
        218_628_096 + 34_048
    # the batch1024 cell: four times the signal and state, one decoder
    assert work_bytes.block_bytes(1024, 16, 2, 8192, decoder) == \
        874_512_384 + 34_048


@pytest.mark.parametrize("cell", ["ambi_bin_o3.batch1024",
                                  "binauraliser_64src.track1024"])
def test_reference_matches_the_ports_plain_path(cell):
    """Blocks 1 and 2 of a stream with state carried, each rendered by the
    reference from its own history (one block back at 25 hops a block), at
    a tiny size on the CPU."""
    config, mix = tiny(cell, block_samples=3200)
    system = run.load_system(config, mix, 987654321, CPU)
    model = system.model
    state = model.init_state_batched(system.cfg, system.streams, device=CPU)
    assert history_blocks(25) == 1 and history_blocks(24) == 1
    for g in range(3):
        kw = {}
        if hasattr(system, "ctl"):
            c = g % system.ctl["ypr"].shape[0]
            kw = dict(src_dirs_deg=system.ctl["dirs"][c],
                      ypr=system.ctl["ypr"][c])
        y, state = model.process_ri_batched(
            system.cfg, system.w, state, system.ring[g], fused=False, **kw)
        if g == 0:
            continue      # block 0 follows silence, not ring block -1
        ref = system.reference(g)
        err = float((y - ref).abs().max() / ref.abs().max())
        assert err < 1e-5, (g, err)


def test_reference_history_covers_the_filters_memory():
    """A render from silence 24 hops back is the render from further back,
    to the last bit, and one from 23 hops back is not: the pipeline's
    memory is what ``history_blocks`` covers."""
    ref = Reference(CPU)
    gen = torch.Generator().manual_seed(5)
    T = 512
    x = torch.randn((1, 2, 40 * 128), generator=gen)
    Mre = torch.randn((1, 1, 133, 2, 2), generator=gen)
    Mim = torch.randn((1, 1, 133, 2, 2), generator=gen)
    long = ref.render(x, Mre, Mim, 1)[..., -T:]
    for hops, exact in ((24, True), (23, False)):
        part = ref.render(x[..., -(T + hops * 128):], Mre, Mim, 1)[..., -T:]
        assert bool((long == part).all()) == exact, hops
    assert history_blocks(8) * 8 >= 24 and history_blocks(64) == 1


@pytest.mark.parametrize("cell", ["ambi_bin_o3.batch1024",
                                  "binauraliser_64src.track1024"])
def test_control_fails_and_the_program_passes(cell):
    """The reference in TF32 in the program's place comes out over the
    limit; the program under it."""
    config, mix = tiny(cell)
    r = run.run_cell(config, mix, 2 ** 31 + 11, 0.2, False, CPU,
                     control=True)
    limit = r["checks"]["max_rel_err"]["limit"]
    assert r["correct"] and r["checks"]["max_rel_err"]["value"] < limit
    assert r["control"]["max_rel_err"] > 3 * limit


def _broken(model, fault):
    real = model.process_ri_batched

    def process(cfg, w, state, x, *a, **kw):
        y, new_state = real(cfg, w, state, x, *a, **kw)
        if fault == "state_unchanged":
            return y, state
        y = y.clone()
        if fault == "half_the_batch":
            half = y.shape[0] // 2
            y[half:] = y[:y.shape[0] - half]
        elif fault == "answer_altered":
            y[0, 0, y.shape[-1] // 2] += 0.01 * float(y.abs().max())
        return y, new_state

    return process


@pytest.mark.parametrize("fault", ["state_unchanged", "half_the_batch",
                                   "answer_altered"])
@pytest.mark.parametrize("cell", ["ambi_bin_o3.batch1024",
                                  "binauraliser_64src.track1024"])
def test_a_broken_timed_path_is_not_correct(cell, fault, monkeypatch):
    """A whole run but the look for a card, with the program broken under
    the harness: ``correct`` comes out false.  (One card: no exchange
    between chips to leave out.)"""
    config, mix = tiny(cell)
    mod = __import__(
        f"spatial_audio_framework_tpu_torch.models.{config['system']}",
        fromlist=["process_ri_batched"])
    monkeypatch.setattr(mod, "process_ri_batched", _broken(mod, fault))
    r = run.run_cell(config, mix, 77, 0.2, False, CPU)
    assert not r["correct"] and r["failed"] >= 1


def test_a_traced_run_reads_its_spans():
    config, mix = tiny("ambi_bin_o3.batch1024")
    r = run.run_cell(config, mix, 3, 0.2, True, CPU,
                     per_layer=[("models.enqueue_ms", "ms"),
                                ("ops.launches", "launches")])
    assert r["correct"]
    assert r["metrics"]["models.enqueue_ms"]["value"] > 0
    assert "ops.launches" not in r["metrics"]   # no device trace on the CPU
    assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
    assert list(r)[-1] == "checks"


def test_no_card_no_result(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", SPEC["workloads"][0]["name"], "--seed",
                   "1", "--seconds", "1", "--trace", "0"])
    assert rc != 0
    assert capsys.readouterr().out == ""


FORBIDDEN = {"jax", "jaxlib", "flax", "spatial_audio_framework_tpu"}


def _imports(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module)
        elif (isinstance(node, ast.Call) and getattr(node.func, "id", "")
              == "__import__" and node.args
              and isinstance(node.args[0], ast.Constant)):
            names.add(str(node.args[0].value))
    return names


@pytest.mark.parametrize("path", sorted(BENCH.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_nothing_imports_jax_or_the_jax_package(path):
    """Top-level names compared whole: the port's name begins with the
    JAX package's, and is allowed outside the reference."""
    top = {n.split(".")[0] for n in _imports(path)}
    assert not top & FORBIDDEN, (path, top & FORBIDDEN)
    if "reference" in path.parts:
        assert "spatial_audio_framework_tpu_torch" not in top, path


def test_a_run_loads_no_jax():
    """A run in a fresh process, the port and its libraries loaded: no
    module of JAX or of the JAX package in ``sys.modules`` after it."""
    code = (
        "import sys, json, torch\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        "from portbench import run\n"
        "from portbench.tests.test_portbench_harness import tiny\n"
        "config, mix = tiny('ambi_bin_o3.batch1024')\n"
        "r = run.run_cell(config, mix, 5, 0.1, False, torch.device('cpu'))\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=ROOT, check=True)
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "spatial_audio_framework_tpu_torch" in loaded
    assert not loaded & FORBIDDEN, loaded & FORBIDDEN
