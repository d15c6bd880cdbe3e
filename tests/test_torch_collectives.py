"""The port's collective battery and quick battery against the JAX
package's, on the CPU.

A JAX mesh over ``jax.devices()[:n]`` (the 8-device host platform of
``conftest.py``) faces a gloo world of n CPU rank processes, for n in
{1, 2, 4}: the same ``op`` strings, verdicts, error texts, link keys and
values. One world per n serves the whole module.
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

from k8s_operator_libs_tpu.ops import collectives as jax_coll
from k8s_operator_libs_tpu.ops import probe_harness as jax_harness
from k8s_operator_libs_tpu.parallel.mesh import single_axis_mesh as jax_mesh
from k8s_operator_libs_tpu_torch.ops import collectives as port
from k8s_operator_libs_tpu_torch.ops import probe_harness as port_harness
from k8s_operator_libs_tpu_torch.parallel.mesh import FORM_PHASES, World, WorldError

try:
    from jax import shard_map
except ImportError:  # pragma: no cover - older jax
    from jax.experimental.shard_map import shard_map

#: Small payloads: the checks are exact at any size.
PAYLOAD_MB = 0.05
#: A dead or silent world must fail well inside this many seconds.
BOUND_S = 30.0


@pytest.fixture(scope="module", params=[1, 2, 4], ids=lambda n: f"n{n}")
def pair(request):
    """(port world, JAX mesh) of n ranks / devices."""
    n = request.param
    world = World(["cpu"] * n)
    yield world, jax_mesh("x", devices=jax.devices()[:n])
    world.close()


def _key(report):
    return report.op, report.ok, report.error


CHECKS = [
    ("psum_check", {}),
    ("all_gather_check", {}),
    ("reduce_scatter_check", {}),
    ("ppermute_ring", {"payload_mb": PAYLOAD_MB}),
    ("psum_bandwidth", {"payload_mb": PAYLOAD_MB}),
]


@pytest.mark.parametrize("name,kwargs", CHECKS, ids=[c[0] for c in CHECKS])
def test_battery_op_matches_jax(pair, name, kwargs):
    world, mesh = pair
    ours = getattr(port, name)(world, "x", **kwargs)
    theirs = getattr(jax_coll, name)(mesh, "x", **kwargs)
    assert _key(ours) == _key(theirs)
    assert ours.ok, ours.error
    # A rate only where a time was taken, in both.
    assert bool(ours.gbytes_per_s) == bool(theirs.gbytes_per_s)


def _jax_collective(mesh, body, x):
    return np.asarray(
        shard_map(body, mesh=mesh, in_specs=P("x"), out_specs=P("x"))(x)
    )


def test_checked_values_equal_jax(pair):
    world, mesh = pair
    n = world.size
    arange = jnp.arange(n, dtype=jnp.float32)
    psum = _jax_collective(mesh, lambda s: jax.lax.psum(s, "x"), arange)
    gathered = _jax_collective(
        mesh, lambda s: jax.lax.all_gather(s, "x", tiled=True), arange
    )
    scattered = _jax_collective(
        mesh, lambda s: jax.lax.psum_scatter(s, "x", tiled=True),
        jnp.ones((n * n,), jnp.float32),
    )
    flat = lambda parts: np.asarray([v for part in parts for v in part], np.float32)  # noqa: E731
    np.testing.assert_array_equal(flat(world.run(port._psum_rank, "x")), psum)
    np.testing.assert_array_equal(flat(world.run(port._all_gather_rank, "x")), gathered)
    np.testing.assert_array_equal(
        flat(world.run(port._reduce_scatter_rank, "x")), scattered
    )


def test_run_ici_probes_matches_jax(pair):
    world, mesh = pair
    ours = port.run_ici_probes(world, "x", payload_mb=PAYLOAD_MB)
    theirs = jax_coll.run_ici_probes(mesh, "x", payload_mb=PAYLOAD_MB)
    assert [_key(r) for r in ours] == [_key(r) for r in theirs]
    assert [r.op for r in ours] == ["psum", "all_gather", "reduce_scatter", "ppermute_ring"]


def test_links_match_jax(pair):
    world, mesh = pair
    ours = port.ppermute_per_link(world, "x", payload_mb=PAYLOAD_MB)
    theirs = jax_coll.ppermute_per_link(mesh, "x", payload_mb=PAYLOAD_MB)
    key = lambda h: (h.src, h.dst, h.peer, h.ok, h.error)  # noqa: E731
    assert [key(h) for h in ours] == [key(h) for h in theirs]
    assert len(ours) == (world.size if world.size > 1 else 0)
    assert all(h.latency_s > 0 and h.gbytes_per_s > 0 for h in ours)
    assert [h.observation().keys() for h in ours] == [
        h.observation().keys() for h in theirs
    ]


def test_peer_resolver_matches_jax(pair):
    world, mesh = pair
    names = ["node-a", "node-b"]
    jax_peer, jax_owns = jax_coll.make_peer_resolver(names)
    our_peer, our_owns = port.make_peer_resolver(names)
    for device in mesh.devices.flat:
        assert our_peer(device.id) == jax_peer(device) == port.default_peer_name(device.id)
    hops = port.ppermute_per_link(world, "x", payload_mb=PAYLOAD_MB, peer_of=our_peer)
    assert all(our_owns(h) and jax_owns(h) for h in hops)


def test_world_times_each_phase_of_forming(pair):
    world, _ = pair
    world.start()
    assert list(world.form_times) == [*FORM_PHASES, "total"]
    total = world.form_times["total"]
    assert total > 0 and world.form_times["spawn_import"] > 0
    # Each phase is one rank's stretch of what the caller waited for; the
    # ranks' clock is the host's, read apart by a few milliseconds at most.
    assert all(0 <= v <= total + 0.5 for v in world.form_times.values())


def test_slice_agreement(pair):
    world, mesh = pair
    n = world.size
    assert port.slice_agreement(world, "x", local_ok=True) == (n, n)
    assert port.slice_agreement(world, "x", local_ok=False) == (0, n)
    assert jax_coll.slice_agreement(mesh, "x", local_ok=True) == (n, n)


# ----------------------------------------------------------------------
# The quick battery.
# ----------------------------------------------------------------------

QUICK = dict(payload_mb=PAYLOAD_MB, matmul_size=64)


def _quick_keys(report):
    return (
        report.ok,
        report.checks,
        set(report.metrics),
        None if report.links is None else set(report.links),
    )


def test_quick_battery_keys_match_jax(pair):
    world, mesh = pair
    ours = port_harness.quick_battery(world, "x", **QUICK)
    theirs = jax_harness.quick_battery(mesh, "x", **QUICK)
    assert _quick_keys(ours) == _quick_keys(theirs)
    assert ours.ok and ours.checks["mxu"] and ours.checks["ring_allreduce"]
    assert {"mxu_tflops", "probe_latency_s"} <= set(ours.metrics)


def test_slice_gang_quick_battery_keys_match_jax(pair):
    world, mesh = pair
    names = ["node-a", "node-b"]
    ours = port_harness.slice_gang_quick_battery(world, "x", member_names=names, **QUICK)
    theirs = jax_harness.slice_gang_quick_battery(mesh, "x", member_names=names, **QUICK)
    assert _quick_keys(ours) == _quick_keys(theirs)


class _Publisher:
    def __init__(self):
        self.calls = []

    def publish(self, checks, metrics, links=None):
        self.calls.append((checks, metrics, links))


def test_quick_probe_cycle_publishes_what_jax_publishes(pair):
    world, mesh = pair
    ours, theirs = _Publisher(), _Publisher()
    port_harness.run_quick_probe_cycle(
        ours, lambda: port_harness.quick_battery(world, "x", **QUICK)
    )
    jax_harness.run_quick_probe_cycle(
        theirs, lambda: jax_harness.quick_battery(mesh, "x", **QUICK)
    )
    (our_checks, our_metrics, our_links), = ours.calls
    (their_checks, their_metrics, their_links), = theirs.calls
    assert our_checks == their_checks
    assert set(our_metrics) == set(their_metrics)
    if world.size == 1:
        assert our_links is None and their_links is None
    else:
        assert set(our_links) == set(their_links) == {
            f"device-{i}" for i in range(world.size)
        }


# ----------------------------------------------------------------------
# Failures are bounded and become failed reports.
# ----------------------------------------------------------------------

def test_killed_rank_is_a_failed_report_not_a_hang():
    world = World(["cpu"] * 2, call_timeout_s=BOUND_S)
    try:
        assert port.psum_check(world).ok
        world._procs[1].kill()
        start = time.monotonic()
        reports = port.run_ici_probes(world, payload_mb=PAYLOAD_MB)
        assert time.monotonic() - start < BOUND_S
        assert [r.op for r in reports] == [
            "psum", "all_gather", "reduce_scatter", "ppermute_ring",
        ]
        assert not any(r.ok for r in reports)
        assert "rank 1" in reports[0].error
        assert world.error is not None
        assert not any(p.is_alive() for p in world._procs)
        assert port.ppermute_per_link(world)[0].ok is False
    finally:
        world.close()


def test_world_that_never_forms_is_a_failed_report():
    world = World(["cpu"] * 2, form_timeout_s=0.05)
    start = time.monotonic()
    reports = port.run_ici_probes(world)
    assert time.monotonic() - start < BOUND_S
    assert not any(r.ok for r in reports)
    assert "did not answer within" in reports[0].error
    assert not any(p.is_alive() for p in world._procs)


def test_silent_rank_is_killed_at_the_call_timeout():
    world = World(["cpu"] * 2)
    try:
        start = time.monotonic()
        with pytest.raises(WorldError, match="did not answer within"):
            world.run(time.sleep, 60, timeout_s=1.0)
        assert time.monotonic() - start < BOUND_S
        assert not any(p.is_alive() for p in world._procs)
        with pytest.raises(WorldError):
            world.run(port._psum_rank, "x")
    finally:
        world.close()


def test_world_takes_one_kind_of_device():
    with pytest.raises(ValueError, match="one kind"):
        World(["cpu", "cuda:0"])
    with pytest.raises(ValueError, match="one kind"):
        World([])
