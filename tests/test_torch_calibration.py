"""The port's calibration line against the JAX harness's, on the CPU.

``bench.run_calibration()`` (the JAX harness) and the port's
``tools.calibration.run_calibration(device="cpu")`` each run one
full-battery gate on one CPU device and the plain product beside it. Their
keys must be the same through the port's four renames, and what they say
about one CPU device must agree. The JAX function reads every device JAX
sees, and this suite gives JAX an 8-device CPU mesh, so the JAX side runs
in a child process that sees one device.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from k8s_operator_libs_tpu.utils.jaxenv import hermetic_cpu_env
from k8s_operator_libs_tpu_torch.tools import calibration

REPO = Path(__file__).resolve().parents[1]

#: JAX key -> the port's key (the module docstring of tools/calibration.py).
RENAMED = {
    "ici_links_exercised": "links_exercised",
    "xla_dot_tflops": "torch_matmul_tflops",
    "pallas_vs_xla": "kernel_vs_torch_matmul",
    "pallas_matmul_compiled": "matmul_kernel_launched",
}


@pytest.fixture(scope="module")
def jax_line() -> dict:
    env = hermetic_cpu_env(1)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run(
        [sys.executable, "-c", "import json, bench; print(json.dumps(bench.run_calibration()))"],
        cwd=str(REPO), env=env, capture_output=True, text=True, timeout=240,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def port_line() -> dict:
    return calibration.run_calibration(device="cpu")


def test_keys_are_the_jax_keys_through_the_renames(jax_line, port_line):
    assert set(port_line) == {RENAMED.get(key, key) for key in jax_line}


def test_one_cpu_device_reads_the_same(jax_line, port_line):
    for line in (jax_line, port_line):
        assert line["platform"] == "cpu"
        assert line["n_devices"] == 1
    assert jax_line["ici_links_exercised"] == port_line["links_exercised"] == 0
    assert jax_line["ok"] is port_line["ok"] is True
    assert jax_line["failures"] == port_line["failures"] == []
    # One device's ring is a self-permute: no bandwidth is claimed.
    assert jax_line["ring_gbytes_per_s"] == port_line["ring_gbytes_per_s"] == 0.0


def test_no_kernel_and_no_flash_off_the_card(jax_line, port_line):
    assert jax_line["pallas_matmul_compiled"] is False
    assert port_line["matmul_kernel_launched"] is False
    assert jax_line["flash_attention_ok"] is None
    assert port_line["flash_attention_ok"] is None


def test_rates_are_measured_and_the_ratio_is_theirs(port_line):
    assert port_line["mxu_tflops"] > 0
    assert port_line["torch_matmul_tflops"] > 0
    # All three are rounded to 3 decimals, so the printed ratio differs
    # from the quotient of the printed rates by at most its own rounding
    # (0.0005) plus what the rates' rounding moves the quotient.
    mxu, torch_mm = port_line["mxu_tflops"], port_line["torch_matmul_tflops"]
    quotient = mxu / torch_mm
    rounding = 0.0005 + quotient * (0.0005 / mxu + 0.0005 / torch_mm)
    assert abs(port_line["kernel_vs_torch_matmul"] - quotient) <= rounding + 1e-12
    assert port_line["elapsed_s"] > 0


def test_the_default_device_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calibration.run_calibration()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calibration.run_calibration(device="cuda")


def test_the_command_prints_no_line_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run(
        [sys.executable, "-m", "k8s_operator_libs_tpu_torch.tools.calibration"],
        cwd=str(REPO), env=env, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "no CUDA device" in proc.stderr
