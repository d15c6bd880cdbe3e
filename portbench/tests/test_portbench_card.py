"""Each cell run briefly on the card, as the benchmark's command runs it:
the result line last, ``correct`` true, the checks last on standard
error. Needs a card and ``nvcc``; skips elsewhere."""

from __future__ import annotations

import json
import shutil
import subprocess
import sys

import pytest

from portbench import spec


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    if shutil.which("nvcc") is None and not shutil.os.path.exists("/usr/local/cuda/bin/nvcc"):
        pytest.skip("no nvcc: the kernels are built at first use")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [c["name"] for c in spec.load_benchmark()["workloads"]])
@pytest.mark.parametrize("trace", [0, 1])
def test_a_short_run_of_each_cell(card, cell, trace):
    import torch

    chips = spec.cell(spec.load_benchmark(), cell)["chips"]
    if torch.cuda.device_count() < chips:
        pytest.skip(f"the cell asks for {chips} cards")
    out = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload", cell, "--seed", str(2**31 + 3),
         "--seconds", "5", "--trace", str(trace)],
        cwd=spec.ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]
    assert list(line)[-1] == "checks"
    assert line["device"]["platform"] == "gpu" and line["device"]["count"] == chips
    assert out.stderr.strip().splitlines()[-1].startswith("check ")
    if trace:
        assert 0 < line["device"]["busy_s"] <= line["device"]["window_s"]
        assert line["breakdown"]["device_ops"]
