"""The port's test doubles (``k8s_operator_libs_tpu_torch.testing``) against
the JAX package's, case by case.

Every case of ``tests/test_mocks.py`` runs on twin clusters: the JAX
machine over a ``FakeCluster`` with the JAX ``DaemonSetSimulator`` and the
JAX mocks, the port's machine over the port's ``RestClient`` at a
``LocalApiServer`` serving another one, with the port's
``DaemonSetSimulator`` (over that client) and the port's mocks. Each run
makes the JAX case's checks and returns what it observed (the nodes'
state labels, each mock's recorded calls), and the two sides must be
equal. Both use the GPU device class (``DeviceClass.nvidia("gpu")``), the
port's only one, where the JAX case uses the TPU's; the keys differ only
in their domain.
"""

from __future__ import annotations

import contextlib

from builders import make_node
from k8s_operator_libs_tpu import testing as jax_testing
from k8s_operator_libs_tpu import upgrade as jax_upgrade
from k8s_operator_libs_tpu.api import DriverUpgradePolicySpec as JaxPolicy
from k8s_operator_libs_tpu.kube import FakeCluster, LocalApiServer
from k8s_operator_libs_tpu.kube import Node as JaxNode
from k8s_operator_libs_tpu.kube import sim as jax_sim
from k8s_operator_libs_tpu_torch import testing as port_testing
from k8s_operator_libs_tpu_torch import upgrade as port_upgrade
from k8s_operator_libs_tpu_torch.api.upgrade_v1alpha1 import DriverUpgradePolicySpec
from k8s_operator_libs_tpu_torch.kube import sim as port_sim
from k8s_operator_libs_tpu_torch.kube.objects import Node
from k8s_operator_libs_tpu_torch.kube.rest import RestClient, RestConfig

NS = "driver-ns"
LABELS = {"app": "driver"}
POLICY = {"autoUpgrade": True}
DRAIN_POLICY = {"autoUpgrade": True, "drain": {"enable": True}}


class Side:
    """One package's machine with its mocks installed, over a cluster of
    ``node_count`` nodes (``node_states`` their labels) and the driver
    DaemonSet settled on them."""

    def __init__(self, name: str, stack: contextlib.ExitStack, node_count=2,
                 node_states=None) -> None:
        jax = name == "jax"
        self.up = jax_upgrade if jax else port_upgrade
        self.testing = jax_testing if jax else port_testing
        self.policy_cls = JaxPolicy if jax else DriverUpgradePolicySpec
        self.Node = JaxNode if jax else Node
        self.keys = self.up.UpgradeKeys(self.up.DeviceClass.nvidia("gpu"))
        self.cluster = FakeCluster()
        for i in range(node_count):
            labels = {}
            if node_states and node_states[i]:
                labels[self.keys.state_label] = node_states[i]
            self.cluster.create(make_node(f"node-{i}", labels=labels))
        self.client = self.cluster
        if not jax:
            server = stack.enter_context(LocalApiServer(cluster=self.cluster))
            self.client = RestClient(RestConfig(server=server.url))
        sim_mod = jax_sim if jax else port_sim
        self.sim = sim_mod.DaemonSetSimulator(self.client, name="driver", namespace=NS,
                                              match_labels=LABELS)
        self.sim.settle()
        self.mgr = self.up.ClusterUpgradeStateManager(
            self.client, self.up.DeviceClass.nvidia("gpu"), runner=self.up.TaskRunner(inline=True)
        )
        self.mocks = self.testing.install_mocks(self.mgr)

    def state(self, name: str) -> str:
        return self.cluster.get("Node", name).labels.get(self.keys.state_label, "")

    def states(self) -> dict:
        return {n.name: n.labels.get(self.keys.state_label, "") for n in self.cluster.list("Node")}

    def run_pass(self, policy=POLICY) -> None:
        state = self.mgr.build_state(NS, LABELS)
        self.mgr.apply_state(state, self.policy_cls.from_dict(policy))


def calls(mock) -> list:
    return [(c.method, c.args, c.kwargs) for c in mock.calls]


def on_both(case, **harness):
    outcomes = {}
    for name in ("jax", "port"):
        with contextlib.ExitStack() as stack:
            outcomes[name] = case(Side(name, stack, **harness))
    assert outcomes["port"] == outcomes["jax"]
    return outcomes["port"]


def test_install_mocks_swaps_all_four_managers():
    def case(s):
        cordon, drain, pod, validation = s.mocks
        common = s.mgr.common
        swapped = (common.cordon_manager is cordon, common.drain_manager is drain,
                   common.pod_manager is pod, common.validation_manager is validation)
        assert all(swapped)
        return swapped

    on_both(case)


def test_cordon_required_goes_through_mock_and_records():
    def case(s):
        cordon = s.mocks[0]
        s.run_pass()
        assert cordon.cordoned == ["node-0"]
        assert [c.method for c in cordon.calls] == ["cordon"]
        assert s.state("node-0") == "wait-for-jobs-required"
        return cordon.cordoned, calls(cordon), s.state("node-0")

    on_both(case, node_count=1, node_states=["cordon-required"])


def test_mock_cordon_failure_aborts_the_pass():
    def case(s):
        s.testing.install_mocks(s.mgr, cordon=s.testing.MockCordonManager(fail_on={"node-0"}))
        try:
            s.run_pass()
        except RuntimeError as e:
            assert "mock cordon failure" in str(e)
            return str(e), s.states()
        raise AssertionError("expected the mocked failure to propagate")

    on_both(case, node_count=1, node_states=["cordon-required"])


def test_mock_drain_records_scheduled_nodes_without_acting():
    def case(s):
        drain = s.mocks[1]
        s.run_pass(DRAIN_POLICY)
        (call,) = drain.calls_to("schedule_nodes_drain")
        assert sorted(call.args[0]) == ["node-0", "node-1"]
        # The asynchronous contract: the mock took the request, nothing moved.
        assert set(s.states().values()) == {"drain-required"}
        return sorted(call.args[0]), s.states()

    on_both(case, node_count=2, node_states=["drain-required"] * 2)


def test_mock_drain_on_schedule_drives_outcomes():
    def case(s):
        def complete_all(config):
            for node in config.nodes:
                s.mgr.provider.change_node_upgrade_state(
                    node, s.up.UpgradeState.POD_RESTART_REQUIRED
                )

        s.testing.install_mocks(s.mgr, drain=s.testing.MockDrainManager(on_schedule=complete_all))
        s.run_pass(DRAIN_POLICY)
        assert s.state("node-0") == "pod-restart-required"
        return s.states()

    on_both(case, node_count=1, node_states=["drain-required"])


def test_mock_pod_manager_out_of_sync_drives_upgrade_required():
    def case(s):
        pod_name = s.sim.pod_name("node-0")
        s.testing.install_mocks(s.mgr, pod=s.testing.MockPodManager(out_of_sync_pods={pod_name}))
        s.run_pass()
        assert s.state("node-0") == "upgrade-required"
        return s.states()

    on_both(case, node_count=1)


def test_mock_pod_manager_in_sync_marks_done():
    def case(s):
        pod = s.mocks[2]
        s.run_pass()
        assert s.state("node-0") == "upgrade-done"
        assert pod.calls_to("get_pod_controller_revision_hash")
        return s.states(), calls(pod)

    on_both(case, node_count=1)


def test_mock_validation_verdicts_gate_per_node():
    def case(s):
        validation = s.testing.MockValidationManager(verdicts={"node-1": False})
        s.testing.install_mocks(s.mgr, validation=validation)
        s.mgr.common.validation_enabled = True
        s.run_pass()
        # A false verdict alone leaves the node waiting in validation.
        assert s.states() == {"node-0": "uncordon-required", "node-1": "validation-required"}
        validated = {c.args[0] for c in validation.calls_to("validate")}
        assert validated == {"node-0", "node-1"}
        return s.states(), sorted(validated)

    on_both(case, node_count=2, node_states=["validation-required"] * 2)


def test_stateful_provider_mock_mutates_in_memory_nodes():
    def case(s):
        provider = s.testing.MockNodeUpgradeStateProvider(s.keys)
        node = s.Node.new("n0")
        provider.add_node(node)
        provider.change_node_upgrade_state(node, s.up.UpgradeState.UPGRADE_REQUIRED)
        seen = [node.labels[s.keys.state_label], str(provider.get_upgrade_state(node))]
        provider.change_node_upgrade_annotation(node, "k", "v")
        seen.append(node.annotations["k"])
        provider.change_node_upgrade_annotation(node, "k", "null")
        seen.append("k" in node.annotations)
        provider.change_node_upgrade_state(node, s.up.UpgradeState.UNKNOWN)
        seen.append(s.keys.state_label in node.labels)
        methods = [c.method for c in provider.calls]
        assert seen == ["upgrade-required", "upgrade-required", "v", False, False]
        assert methods.count("change_node_upgrade_state") == 2
        assert methods.count("change_node_upgrade_annotation") == 2
        return seen, calls(provider)

    on_both(case, node_count=0)
