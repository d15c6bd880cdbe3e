"""The port's Table transform (``kube/table.py``) and JSONPath evaluator
(``kube/jsonpath.py``), and its server's Table output, held to the JAX
package's.

Every case of ``tests/test_table.py`` runs here once more: the
``render_table``, ``accepts_table`` and ``evaluate`` the case calls run
on both packages and are compared, and the case reads the port's; the
``LocalApiServer`` it starts is the port's, serving twin clusters
(``tests/torch_cluster_twins.py``), and the case's HTTP requests read
its Table answers.
"""

import pytest

import test_table
from torch_cluster_twins import adopt_cases, twin_world

adopt_cases(test_table, globals(), server=True)


@pytest.fixture(autouse=True)
def twins(twin_world):
    return twin_world
