"""BENCHMARK.json against the rules of its format, and the harness
finding a cell, a mix, a configuration and a metric by name, including
ones added as new files without editing any file that is there."""

from __future__ import annotations

import json
import re
import shutil
from pathlib import Path

import pytest

from portbench import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
WIDTH_WORDS = ("hidden", "intermediate", "latent", "state", "projection", "head", "expansion")


@pytest.fixture(scope="module")
def bench() -> dict:
    return spec.load_benchmark()


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert len(json.dumps(bench)) <= 64 * 1024
    assert 1 <= len(bench["command"]) <= 32 and all(_line(w) for w in bench["command"])
    assert not any(w.startswith("/") or ".." in w for w in bench["command"])
    assert 1 <= len(bench["paths"]) <= 16 and all(PATH.match(p) for p in bench["paths"])
    assert isinstance(bench["run_seconds"], int) and 1 <= bench["run_seconds"] <= 51


def test_a_full_check_fits_its_time_with_24_cells(bench):
    runs = 2 + 14 * 24
    assert runs * (bench["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_units_and_entry_keys(bench):
    names = [e["name"] for group in ("configs", "workloads", "end_to_end", "per_layer")
             for e in bench[group]]
    assert all(NAME.match(n) for n in names)
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        group_names = [e["name"] for e in bench[group]]
        assert len(group_names) == len(set(group_names)), group
    metric_names = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(metric_names) == len(set(metric_names))
    for config in bench["configs"]:
        assert set(config) == {"name", "source", "file", "reduced", "why"}
        assert _line(config["source"]) and _line(config["why"])
        assert len(config["reduced"]) <= 16 and all(NAME.match(k) for k in config["reduced"])
        assert not any(k.endswith(("_dim", "_rank")) or any(w in k for w in WIDTH_WORDS)
                       for k in config["reduced"])
    for cell in bench["workloads"]:
        assert set(cell) == {"name", "config", "traffic", "chips", "why"}
        assert cell["chips"] in (1, 4) and _line(cell["why"])
        assert NAME.match(cell["config"]) and NAME.match(cell["traffic"])
    for metric in bench["end_to_end"]:
        assert set(metric) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert metric["source"] in {"host_clock", "device_trace"}
        assert 0.01 <= metric["bound"] <= 0.25
    for metric in bench["per_layer"]:
        assert set(metric) - {"workloads"} == {"name", "unit", "better", "source", "layer",
                                               "moves"}
        assert metric["source"] in SOURCES and _line(metric["layer"])
    for metric in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(metric["unit"]) and metric["better"] in ("lower", "higher")
        if "roofline" in metric["name"] or "mfu" in metric["name"]:
            assert metric["unit"] == "%"


def test_cells_configs_and_metrics_hang_together(bench):
    configs = {c["name"] for c in bench["configs"]}
    used = {cell["config"] for cell in bench["workloads"]}
    assert used == configs
    pairs = [(c["config"], c["traffic"]) for c in bench["workloads"]]
    assert len(pairs) == len(set(pairs))
    four = sum(c["chips"] == 4 for c in bench["workloads"])
    assert four <= max(1, len(bench["workloads"]) // 4)
    end_to_end = {m["name"]: m for m in bench["end_to_end"]}
    assert end_to_end["setup_s"]["bound"] <= 0.25 and "workloads" not in end_to_end["setup_s"]
    for cell in bench["workloads"]:
        reported = [m["name"] for m in spec.cell_metrics(bench, cell, trace=False)]
        assert "setup_s" in reported and len(reported) >= 2, cell["name"]
        assert spec.cell_metrics(bench, cell, trace=True), cell["name"]
    for metric in bench["per_layer"]:
        assert metric["moves"] in end_to_end
        for name in metric["workloads"]:
            cell = spec.cell(bench, name)
            assert spec.reports(end_to_end[metric["moves"]], cell, bench), (metric, name)
    layers = {}
    for metric in bench["per_layer"]:
        layers.setdefault(metric["layer"], []).append(metric["name"])
    assert set(layers) <= {"upgrade", "tpu.health", "ops.flash_attention", "ops.matmul",
                           "models.burnin", "ops.collectives", "kernels", "device"}


def test_every_file_is_found_by_name(bench):
    for cell in bench["workloads"]:
        config = spec.config(bench, cell)
        assert config["name"] == cell["config"]
        assert spec.driver(config["system"]).run_cell
        assert isinstance(spec.traffic(cell["traffic"]), dict)
        assert set(config["limits"]) >= {"k1_rel_err", "k2_rel_err", "verdicts_not_ok"}
    for metric in bench["per_layer"]:
        assert callable(spec.reader(metric["name"]))
    for config in bench["configs"]:
        assert config["file"].startswith(tuple(p + "/" for p in bench["paths"]))


def test_unknown_names_are_refused(bench):
    with pytest.raises(spec.SpecError):
        spec.cell(bench, "no_such.cell")
    with pytest.raises(spec.SpecError):
        spec.traffic("no_such_mix")
    with pytest.raises(spec.SpecError):
        spec.reader("no_such_metric")
    with pytest.raises(spec.SpecError):
        spec.driver("no_such_system")


def test_a_cell_mix_config_and_metric_added_as_new_files(tmp_path: Path, bench):
    """A later change adds files and entries; no file that is there is
    edited, and the harness finds the new ones by name."""
    package = tmp_path / "portbench"
    shutil.copytree(spec.PACKAGE / "configs", package / "configs")
    shutil.copytree(spec.PACKAGE / "traffic", package / "traffic")
    shutil.copytree(spec.PACKAGE / "metrics", package / "metrics")
    before = {p: p.read_bytes() for p in package.rglob("*") if p.is_file()}
    config = json.loads((package / "configs" / "gpu_node_gate.json").read_text())
    config["name"] = "gpu_node_gate_deep"
    config["gate"]["matmul_size"] = 8192
    (package / "configs" / "gpu_node_gate_deep.json").write_text(json.dumps(config))
    (package / "traffic" / "deep.json").write_text(json.dumps(
        {"loop": "closed", "callers": 1, "warmup_batteries": 2, "sample_outputs": 8}))
    (package / "metrics" / "probe_count.mxu.py").write_text(
        "def read(run):\n    spans = run.spans.get('probe.mxu')\n"
        "    return float(len(spans)) if spans else None\n")
    extended = json.loads(json.dumps(bench))
    extended["configs"].append({"name": "gpu_node_gate_deep", "source": "https://example.org",
                                "file": "portbench/configs/gpu_node_gate_deep.json",
                                "reduced": [], "why": "K1 at 8192"})
    extended["workloads"].append({"name": "gpu_node_gate_deep.deep",
                                  "config": "gpu_node_gate_deep", "traffic": "deep",
                                  "chips": 1, "why": "the matmul probe at 8192"})
    extended["per_layer"].append({"name": "probe_count.mxu", "unit": "calls",
                                  "better": "higher", "source": "program_span",
                                  "layer": "ops.matmul", "moves": "setup_s",
                                  "workloads": ["gpu_node_gate_deep.deep"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(extended))
    loaded = spec.load_benchmark(tmp_path)
    cell = spec.cell(loaded, "gpu_node_gate_deep.deep")
    assert spec.config(loaded, cell, root=tmp_path)["gate"]["matmul_size"] == 8192
    assert spec.traffic("deep", package=package)["callers"] == 1
    assert [m["name"] for m in spec.cell_metrics(loaded, cell, trace=True)] == ["probe_count.mxu"]
    from portbench.record import Run

    run = Run()
    run.spans["probe.mxu"] = [(0.0, 1.0), (1.0, 2.0)]
    assert spec.reader("probe_count.mxu", package=package)(run) == 2.0
    assert spec.reader("probe_s.mxu", package=package)(run) == 1.0
    for path, data in before.items():
        assert path.read_bytes() == data
