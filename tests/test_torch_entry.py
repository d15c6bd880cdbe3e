"""The port's entry points, on the CPU.

``dryrun_multichip`` in a gloo world of 4 CPU ranks runs the JAX dry run's
three programs ({dp1, ep1, tp2, sp2} with MoE, {dp1, ep2, tp2}, {dp2, pp2})
and prints their lines in the JAX form, each loss finite and equal to the
port's own sharded or pipelined step's for that program. ``entry`` gives
the flagship forward on the device asked for, and raises without a card
by default. ``mesh_axes_for_topology`` matches the JAX package's on equal
facts.
"""

import math
import re

import numpy as np
import pytest
import torch

from k8s_operator_libs_tpu.parallel import SliceTopology as JaxSliceTopology
from k8s_operator_libs_tpu.parallel import mesh_axes_for_topology as jax_mesh_axes
from k8s_operator_libs_tpu_torch import entry as port_entry
from k8s_operator_libs_tpu_torch.models import burnin
from k8s_operator_libs_tpu_torch.models.pipeline import pipeline_losses
from k8s_operator_libs_tpu_torch.parallel.mesh import World, mesh_axes_for_topology
from k8s_operator_libs_tpu_torch.parallel.topology import SliceTopology

LINE = re.compile(r"^dryrun_multichip: (expert |pipeline )?mesh=(\{.*\}) loss=(\S+) ok$")


@pytest.fixture(scope="module")
def world4():
    world = World(["cpu"] * 4)
    yield world
    world.close()


def test_dryrun_runs_the_jax_programs_in_a_world_of_four(world4, capsys):
    results = port_entry.dryrun_multichip(world4)
    lines = capsys.readouterr().out.strip().splitlines()
    assert [LINE.match(line).group(1, 2) for line in lines] == [
        (None, "{'dp': 1, 'ep': 1, 'tp': 2, 'sp': 2}"),
        ("expert ", "{'dp': 1, 'ep': 2, 'tp': 2}"),
        ("pipeline ", "{'dp': 2, 'pp': 2}"),
    ]
    assert [r["name"] for r in results] == ["sharded", "expert", "pipeline"]
    for line, result in zip(lines, results):
        assert math.isfinite(result["loss"])
        assert LINE.match(line).group(3) == f"{result['loss']:.4f}"
        assert len(result["seconds"]) == 1 and result["seconds"][0] > 0


def test_each_dryrun_loss_is_the_ports_own_step(world4):
    programs = port_entry.dryrun_programs(4)
    results = port_entry.dryrun_multichip(world4)
    assert programs[0]["cfg"].n_experts == 2  # MoE even at ep 1
    for program, result in zip(programs, results):
        if "n_microbatches" in program:
            theirs = world4.run(
                pipeline_losses, program["axes"], program["cfg"], 1, program["n_microbatches"]
            )[0]
        else:
            theirs = world4.run(burnin.sharded_losses, program["axes"], program["cfg"], 1)[0]
        assert result["losses"] == theirs


@pytest.mark.parametrize("n", [1, 2, 8, 16])
def test_dryrun_axes_follow_the_jax_program(n):
    """The JAX program's choice of axes, by world size: tp and sp 2 where
    they divide, ep only from 16, and the expert and pipeline programs
    where 4 and 2 divide the world."""
    programs = port_entry.dryrun_programs(n)
    main = programs[0]["axes"]
    assert math.prod(main.values()) == n
    assert main["tp"] == (2 if n % 2 == 0 else 1)
    assert main["ep"] == (2 if n >= 16 else 1)
    names = [p["name"] for p in programs]
    assert ("expert" in names) == (main["ep"] == 1 and n % 4 == 0)
    assert ("pipeline" in names) == (n % 2 == 0)
    for program in programs:
        assert math.prod(program["axes"].values()) == n


def test_entry_forward_on_the_cpu():
    fn, (params, tokens) = port_entry.entry(device="cpu")
    cfg = port_entry.ENTRY_CFG
    assert (cfg.vocab, cfg.d_model, cfg.n_heads, cfg.d_ff, cfg.n_layers) == (1024, 256, 8, 1024, 4)
    assert tuple(tokens.shape) == (cfg.batch, cfg.seq_len)
    logits = fn(params, tokens)
    assert logits.dtype == torch.float32 and tuple(logits.shape) == (4, 256, 1024)
    assert bool(torch.isfinite(logits).all())


def test_entry_defaults_to_cuda_and_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_entry.entry()


@pytest.mark.parametrize("devices", [None, 8, 2])
def test_mesh_axes_for_topology_match_jax(devices):
    # 4 nodes of 4 cards against a v5e-16 (4 hosts of 4 chips).
    ours = SliceTopology(accelerator="NVIDIA-H100-80GB-HBM3", topology=(16,), chips_per_host=4)
    assert ours.num_hosts == 4
    theirs = JaxSliceTopology.v5e(16)
    assert mesh_axes_for_topology(ours, devices) == jax_mesh_axes(theirs, devices)
    if devices is None:
        assert mesh_axes_for_topology(ours) == {"dp": 4, "tp": 4}
    elif devices == 8:
        assert mesh_axes_for_topology(ours, devices) == {"dp": 2, "tp": 4}


def test_mesh_axes_for_one_node():
    node = SliceTopology.from_labels(
        {"nvidia.com/gpu.present": "true", "nvidia.com/gpu.count": "8"}
    )
    assert mesh_axes_for_topology(node) == {"dp": 1, "tp": 8}
    assert np.prod(list(mesh_axes_for_topology(node, 4).values())) == 4
