"""The port's ring and Ulysses attention against the JAX package's, on the
CPU.

The same numpy q/k/v go through the JAX function on a mesh of
``jax.devices()[:n]`` and through the port's on a gloo world of n CPU
ranks, each rank taking its block of the sequence, for n in {2, 4}: f32
outputs within ``atol=1e-5``. Both packages' probes report ok with their
default ``tol=2e-2``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from k8s_operator_libs_tpu.ops.ring_attention import (
    ring_attention as jax_ring_attention,
    ring_attention_probe as jax_ring_probe,
)
from k8s_operator_libs_tpu.ops.ulysses import (
    ulysses_attention as jax_ulysses_attention,
    ulysses_probe as jax_ulysses_probe,
)
from k8s_operator_libs_tpu.parallel.mesh import single_axis_mesh as jax_mesh
from k8s_operator_libs_tpu_torch.ops import ring_attention as port_ring
from k8s_operator_libs_tpu_torch.ops import ulysses as port_ulysses
from k8s_operator_libs_tpu_torch.parallel.mesh import Mesh, World

ATOL = 1e-5
#: Probe widths: smaller than the gate's (64 a rank, head_dim 32), same code.
PROBE = dict(seq_per_device=16, head_dim=16)


@pytest.fixture(scope="module", params=[2, 4], ids=lambda n: f"n{n}")
def pair(request):
    """(port world, JAX mesh) of n ranks / devices, on axis ``sp``."""
    n = request.param
    world = World(["cpu"] * n)
    yield world, jax_mesh("sp", devices=jax.devices()[:n])
    world.close()


def _qkv(n, heads=4, seq_per_device=8, head_dim=16, seed=3):
    rng = np.random.default_rng(seed)
    shape = (2, heads, seq_per_device * n, head_dim)
    return tuple(rng.standard_normal(shape, dtype=np.float32) for _ in range(3))


def _jax(fn, mesh, qkv, **kwargs):
    sharding = NamedSharding(mesh, P(None, None, "sp", None))
    q, k, v = (jax.device_put(jnp.asarray(t), sharding) for t in qkv)
    return np.asarray(fn(q, k, v, mesh, "sp", **kwargs))


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_ring_attention_matches_jax(pair, causal):
    world, mesh = pair
    qkv = _qkv(world.size)
    ours = port_ring.on_host_arrays(
        world, port_ring.ring_attention, *qkv, axis="sp", causal=causal
    )
    theirs = _jax(jax_ring_attention, mesh, qkv, causal=causal)
    np.testing.assert_allclose(ours, theirs, atol=ATOL, rtol=0)
    np.testing.assert_allclose(
        ours, port_ring.reference_attention(*qkv, causal=causal), atol=ATOL, rtol=0
    )


def test_ulysses_attention_matches_jax(pair):
    world, mesh = pair
    qkv = _qkv(world.size, heads=8)
    ours = port_ring.on_host_arrays(
        world, port_ulysses.ulysses_attention, *qkv, axis="sp"
    )
    theirs = _jax(jax_ulysses_attention, mesh, qkv, causal=True)
    np.testing.assert_allclose(ours, theirs, atol=ATOL, rtol=0)


def test_ring_probe_is_ok_as_in_jax(pair):
    world, mesh = pair
    ours = port_ring.ring_attention_probe(world, "sp", **PROBE)
    theirs = jax_ring_probe(mesh, "sp", **PROBE)
    assert ours.ok and theirs.ok, (ours.error, theirs.error)
    assert ours.max_abs_err <= 2e-2 and ours.tokens_per_s > 0


@pytest.mark.parametrize("heads", [8, 3], ids=["heads8", "heads3"])
def test_ulysses_probe_is_ok_as_in_jax(pair, heads):
    # 3 heads divide no axis here: both fall back to one head per rank.
    world, mesh = pair
    ours = port_ulysses.ulysses_probe(world, "sp", heads=heads, **PROBE)
    theirs = jax_ulysses_probe(mesh, "sp", heads=heads, **PROBE)
    assert ours.ok and theirs.ok, (ours.error, theirs.error)
    assert ours.max_abs_err <= 2e-2 and ours.tokens_per_s > 0


def test_probe_numerics_mismatch_fails_on_every_rank(pair):
    world, _ = pair
    report = port_ring.ring_attention_probe(world, "sp", tol=0.0, **PROBE)
    assert not report.ok and "numerics mismatch" in report.error
    # The world survives a failed probe: every rank took the same branch.
    assert world.error is None
    assert port_ring.ring_attention_probe(world, "sp", **PROBE).ok


def test_ulysses_needs_heads_divisible_by_the_axis():
    mesh = Mesh(
        shape={"sp": 2}, coords={"sp": 0}, groups={"sp": None},
        ranks={"sp": (0, 1)}, device=torch.device("cpu"),
    )
    q = torch.zeros(1, 3, 4, 8)
    with pytest.raises(ValueError, match="divisible"):
        port_ulysses.ulysses_attention(q, q, q, mesh, "sp")
    with pytest.raises(NotImplementedError, match="causal-only"):
        port_ulysses.ulysses_attention(q, q, q, mesh, "sp", causal=False)
