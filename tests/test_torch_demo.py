"""The port's ``upgrade_controller --demo`` against the JAX example's.

``python -m k8s_operator_libs_tpu_torch.upgrade_controller --demo`` rolls a
driver update over the port's in-memory cluster: four GPU nodes of one
NVLink domain, each uncordon gated in process by the health gate, here on
the CPU (``--gate-device cpu``). For the plain, ``--slice-aware`` and
``--requestor`` flag sets of ``tests/test_example_cli.py`` the JAX
example's ``--demo`` (four TPU hosts of one v5e-16 slice) runs beside it,
and the two must print the same sequence of per-pass lines (the nodes by
state and the in-progress, done and failed counts). ``--once`` stops after
one pass; without a card and without ``--gate-device cpu`` the gate
raises, so the roll cannot pass validation on the CPU. The other flag
sets, and a CPU rehearsal of ``chip_smoke.py``'s in-memory phase, are in
``tests/test_torch_demo_modes.py``.
"""

from __future__ import annotations

import pytest

from torch_demo import DEMO_NODES, finish, gate_verdicts, jax_demo, passes, port_demo


@pytest.mark.parametrize("flags", [(), ("--slice-aware",), ("--requestor",)],
                         ids=["plain", "slice-aware", "requestor"])
def test_demo_passes_match_the_jax_demo(flags):
    rc, out, err = finish(port_demo(*flags))
    jax_rc, jax_out, jax_err = finish(jax_demo(*flags))
    assert rc == 0, out[-2000:] + err[-1000:]
    assert jax_rc == 0, jax_out[-2000:] + jax_err[-1000:]
    ours, theirs = passes(out), passes(jax_out)
    assert ours and ours == theirs
    assert out.splitlines()[-1] == f"demo: rolling upgrade complete in {len(ours)} passes"
    assert jax_out.splitlines()[-1] == out.splitlines()[-1]
    # Every node went through the gate on the CPU, and passed it.
    assert gate_verdicts(out) == {name: True for name in DEMO_NODES}


def test_demo_once_stops_after_one_pass():
    rc, out, err = finish(port_demo("--once"), timeout=120)
    assert rc == 0, out[-2000:] + err[-1000:]
    assert passes(out) == ["pass 1: unknown=4 | in-progress=0 done=0 failed=0"]
    assert "rolling upgrade complete" not in out


def test_demo_gate_raises_without_a_card_unless_asked_for_the_cpu():
    env = dict(__import__("os").environ, CUDA_VISIBLE_DEVICES="")
    rc, out, err = finish(port_demo(gate_device="", env=env), timeout=120)
    assert rc == 1, out[-2000:] + err[-1000:]
    assert "demo: did not converge within 100 passes" in err
    assert "no CUDA device" in err
    assert gate_verdicts(out) == {}
    # The first node stays in validation: the gate never passed it.
    assert passes(out)[-1].startswith("pass 100: upgrade-required=3 validation-required=1 ")

