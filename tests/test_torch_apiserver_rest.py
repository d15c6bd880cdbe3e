"""The port's ``LocalApiServer`` behind bearer-token auth, TLS and its
kubeconfig, held to the JAX package's.

The auth, TLS and kubeconfig cases of ``tests/test_rest_client.py`` that
start a server run here once more with the port's, serving twin
clusters (``tests/torch_cluster_twins.py``); the JAX client reads the
kubeconfig the port's server writes.
"""

import pytest

import test_rest_client
from torch_cluster_twins import adopt_cases, twin_world

adopt_cases(test_rest_client, globals(), server=True, only=[
    "TestAuth", "TestTls",
    "TestKubeconfig.test_written_kubeconfig_connects",
    "TestKubeconfig.test_kubeconfig_with_token_and_namespace",
    "TestKubeconfig.test_kubeconfig_env_paths_merge",
])


@pytest.fixture(autouse=True)
def twins(twin_world):
    return twin_world
