"""The port's ``NodeUpgradeStateProvider`` with a cached reader, against the
JAX package's.

The reader cases of ``tests/test_state_provider.py``
(``test_waits_for_stale_cache_to_catch_up``,
``test_raises_when_cache_never_syncs``, ``test_auto_cache_mode_end_to_end``)
run on twin clusters: the JAX provider writes to a ``FakeCluster`` and
reads through the JAX ``CachedClient`` of it; the port's provider writes
through the port's ``RestClient`` at a ``LocalApiServer`` serving the
other, and reads through the JAX ``CachedClient`` of that one (the
provider reads only ``.raw``, so any client's objects do). The cache lags
on purpose (manual sync, or a lag in the auto mode). Each run makes the
JAX case's checks and returns what it observed (whether the write waited
for the cache, raised, and what the cache and the cluster hold), and the
two packages' observations must be equal. The same cases run once more
with the port's provider over the port's own ``FakeCluster``, reading
back through the port's ``CachedClient`` of it (``port-fake``), against
the JAX side.
"""

from __future__ import annotations

import contextlib
import threading
import time

import pytest

from builders import make_node
from k8s_operator_libs_tpu.kube import CachedClient, FakeCluster, LocalApiServer
from k8s_operator_libs_tpu.upgrade import consts as jax_consts
from k8s_operator_libs_tpu.upgrade import state_provider as jax_provider
from k8s_operator_libs_tpu_torch.kube.cache import CachedClient as PortCachedClient
from k8s_operator_libs_tpu_torch.kube.fake import FakeCluster as PortFakeCluster
from k8s_operator_libs_tpu_torch.kube.objects import Node
from k8s_operator_libs_tpu_torch.kube.rest import RestClient, RestConfig
from k8s_operator_libs_tpu_torch.upgrade import consts as port_consts
from k8s_operator_libs_tpu_torch.upgrade import state_provider as port_provider


class Side:
    """One package's provider over a cluster holding node ``n1``, reading
    through a ``CachedClient`` of the cluster."""

    def __init__(self, name: str, stack: contextlib.ExitStack, **cache_kwargs) -> None:
        self.consts = jax_consts if name == "jax" else port_consts
        self.mod = jax_provider if name == "jax" else port_provider
        self.keys = self.consts.UpgradeKeys(self.consts.DeviceClass.nvidia("gpu"))
        own = name == "port-fake"
        self.cluster = PortFakeCluster() if own else FakeCluster()
        stack.callback(self.cluster.close)
        self.cluster.create(Node(make_node("n1").raw) if own else make_node("n1"))
        client = self.cluster
        if name == "port":
            server = stack.enter_context(LocalApiServer(cluster=self.cluster))
            client = RestClient(RestConfig(server=server.url))
        self.cached = (PortCachedClient if own else CachedClient)(self.cluster, **cache_kwargs)
        stack.callback(self.cached.close)
        self.client = client
        self.name = name
        self.patch = stack.enter_context(pytest.MonkeyPatch.context())

    def provider(self, timeout: float = 5.0):
        # The JAX provider takes the reader's timeout as an argument; the
        # port's reads its module constant.
        if self.name == "jax":
            return self.mod.NodeUpgradeStateProvider(self.client, self.keys, reader=self.cached,
                                                     cache_sync_timeout=timeout)
        self.patch.setattr(self.mod, "CACHE_SYNC_TIMEOUT_SECONDS", timeout)
        return self.mod.NodeUpgradeStateProvider(self.client, self.keys, reader=self.cached)

    def node_from_backing(self):
        """The node read past the cache, in this package's view."""
        raw = self.cluster.get("Node", "n1").raw
        return jax_provider.Node(raw) if self.name == "jax" else Node(raw)

    def state_in(self, client) -> str:
        return client.get("Node", "n1").labels.get(self.keys.state_label, "")


def on_both(case, port="port", **cache_kwargs):
    outcomes = {}
    for name in ("jax", port):
        with contextlib.ExitStack() as stack:
            outcomes[name] = case(Side(name, stack, **cache_kwargs))
    assert outcomes[port] == outcomes["jax"]
    return outcomes[port]


def test_waits_for_stale_cache_to_catch_up(port="port"):
    def case(s):
        p = s.provider()
        node = s.node_from_backing()
        t = threading.Timer(0.15, s.cached.sync)
        t.start()
        began = time.monotonic()
        # Blocks about 0.15 s, then succeeds, rather than failing at once.
        p.change_node_upgrade_state(node, s.consts.UpgradeState.CORDON_REQUIRED)
        waited = time.monotonic() - began >= 0.1
        t.join()
        assert waited and s.state_in(s.cached) == "cordon-required"
        return waited, s.state_in(s.cached)

    on_both(case, port, sync_mode="manual")


def test_raises_when_cache_never_syncs(port="port"):
    def case(s):
        p = s.provider(timeout=0.3)
        node = s.node_from_backing()
        with pytest.raises(s.mod.StateWriteError):
            p.change_node_upgrade_state(node, s.consts.UpgradeState.CORDON_REQUIRED)
        # The write itself landed: the ambiguity is reported, not rolled back.
        assert s.state_in(s.cluster) == "cordon-required"
        return s.state_in(s.cluster), s.state_in(s.cached)

    on_both(case, port, sync_mode="manual")


def test_auto_cache_mode_end_to_end(port="port"):
    def case(s):
        p = s.provider()
        node = p.get_node("n1")
        states = s.consts.UpgradeState
        for state in (states.UPGRADE_REQUIRED, states.CORDON_REQUIRED,
                      states.WAIT_FOR_JOBS_REQUIRED):
            p.change_node_upgrade_state(node, state)
        assert s.state_in(s.cluster) == "wait-for-jobs-required"
        return s.state_in(s.cluster), node.labels.get(s.keys.state_label)

    on_both(case, port, sync_mode="auto", lag_seconds=0.02)


@pytest.mark.parametrize("case", [
    test_waits_for_stale_cache_to_catch_up,
    test_raises_when_cache_never_syncs,
    test_auto_cache_mode_end_to_end,
], ids=lambda f: f.__name__[len("test_"):])
def test_reads_back_through_the_ports_own_cache(case):
    """The port's provider over the port's ``FakeCluster``, its read-back
    waiting on the port's ``CachedClient``, against the JAX side."""
    case(port="port-fake")
