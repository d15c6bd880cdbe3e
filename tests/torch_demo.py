"""Runs of the port's ``upgrade_controller --demo`` and of the JAX
example's ``--demo`` as child processes, for ``tests/test_torch_demo.py``
and ``tests/test_torch_demo_modes.py``."""

from __future__ import annotations

import os
import re
import subprocess
import sys

from k8s_operator_libs_tpu.utils.jaxenv import hermetic_cpu_env

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_CLI = os.path.join(REPO, "examples", "upgrade_controller.py")
#: The demo pool's nodes (``upgrade_controller.DEMO_POOL``, four of them).
DEMO_NODES = [f"h100-pool-{i}" for i in range(4)]
GATE_LINE = re.compile(r"^demo gate: node=(\S+) ok=(True|False) seconds=([0-9.]+)$")


def port_demo(*flags: str, gate_device: str = "cpu", env=None) -> subprocess.Popen:
    """The port's command with ``--demo`` (and ``--gate-device``, unless
    ``gate_device`` is empty), started, its output captured."""
    args = [sys.executable, "-m", "k8s_operator_libs_tpu_torch.upgrade_controller", "--demo"]
    if gate_device:
        args += ["--gate-device", gate_device]
    child_env = dict(env if env is not None else os.environ)
    child_env["PYTHONPATH"] = REPO + os.pathsep + child_env.get("PYTHONPATH", "")
    # One intra-op thread: a CPU gate's numbers do not matter here, and the
    # suite's other workers share the machine.
    child_env.setdefault("OMP_NUM_THREADS", "1")
    return subprocess.Popen(args + list(flags), cwd=REPO, env=child_env, text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE)


def jax_demo(*flags: str) -> subprocess.Popen:
    return subprocess.Popen([sys.executable, JAX_CLI, "--demo", *flags], cwd=REPO,
                            env=hermetic_cpu_env(4), text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE)


def finish(proc: subprocess.Popen, timeout: float = 240) -> tuple[int, str, str]:
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, err = proc.communicate()
        raise AssertionError(f"demo still running after {timeout} s:\n{out[-2000:]}\n{err[-1000:]}")
    return proc.returncode, out, err


def passes(out: str) -> list[str]:
    """The per-pass lines: ``pass N: <state counts> | in-progress=...``."""
    return [line for line in out.splitlines() if line.startswith("pass ")]


def gate_verdicts(out: str) -> dict[str, bool]:
    verdicts = {}
    for line in out.splitlines():
        m = GATE_LINE.match(line)
        if m:
            verdicts[m.group(1)] = m.group(2) == "True"
    return verdicts
