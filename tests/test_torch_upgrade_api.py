"""The port's upgrade policy types against the JAX package's.

Every policy document the JAX package's own tests hand to a spec's
``from_dict`` (found by reading those files' source), and every
``upgradePolicy`` of the YAML examples in ``docs/``, parses into the
port's type of the same name with a ``to_dict`` equal to the JAX type's,
and ``from_dict(to_dict())`` gives it back; a document the JAX type
refuses, the port's refuses too. Seeded documents over every field check
the same beyond the literal ones, and ``IntOrString`` scales as the JAX
one does.
"""

from __future__ import annotations

import ast
from pathlib import Path

import numpy as np
import pytest
import yaml

from k8s_operator_libs_tpu.api import upgrade_v1alpha1 as jax_api
from k8s_operator_libs_tpu.utils import IntOrString as JaxIntOrString
from k8s_operator_libs_tpu_torch.api import upgrade_v1alpha1 as port_api
from k8s_operator_libs_tpu_torch.utils.intstr import IntOrString

TESTS = Path(__file__).resolve().parent
DOCS = TESTS.parent / "docs"
SPECS = (
    "DriverUpgradePolicySpec",
    "DrainSpec",
    "PodDeletionSpec",
    "WaitForCompletionSpec",
    "CheckpointSpec",
    "QuarantineSpec",
)


def _documents():
    """``(spec name, document, where)`` for each dict literal given to a
    spec's ``from_dict`` in the JAX tests, directly or through a name it
    was bound to, and for the examples in ``docs/``."""
    found = []
    for path in sorted(TESTS.glob("test_*.py")):
        if path.name.startswith("test_torch_"):
            continue
        tree = ast.parse(path.read_text())
        named: dict[str, ast.Dict] = {}
        for node in ast.walk(tree):
            if isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict):
                for target in node.targets:
                    if isinstance(target, ast.Name):
                        named[target.id] = node.value
        for node in ast.walk(tree):
            if not (
                isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr == "from_dict"
                and isinstance(node.func.value, ast.Name)
                and node.func.value.id in SPECS
                and node.args
            ):
                continue
            arg = node.args[0]
            if isinstance(arg, ast.Name):
                arg = named.get(arg.id)
            if not isinstance(arg, ast.Dict):
                continue
            try:
                doc = ast.literal_eval(arg)
            except ValueError:
                continue
            found.append((node.func.value.id, doc, f"{path.name}:{node.lineno}"))
    return found + _doc_examples()


def _upgrade_policies(tree):
    if isinstance(tree, dict):
        for key, value in tree.items():
            if key == "upgradePolicy" and isinstance(value, dict):
                yield value
            else:
                yield from _upgrade_policies(value)
    elif isinstance(tree, list):
        for value in tree:
            yield from _upgrade_policies(value)


def _doc_examples():
    """Each ``upgradePolicy`` mapping in a YAML block of ``docs/*.md``."""
    found = []
    for path in sorted(DOCS.glob("*.md")):
        for i, block in enumerate(path.read_text().split("```yaml")[1:]):
            try:
                tree = yaml.safe_load(block.split("```", 1)[0])
            except yaml.YAMLError:
                continue
            for doc in _upgrade_policies(tree):
                found.append(("DriverUpgradePolicySpec", doc, f"{path.name}:yaml{i}"))
    return found


DOCUMENTS = _documents()


def test_the_jax_tests_hold_policy_documents():
    assert {name for name, _, _ in DOCUMENTS} >= {"DriverUpgradePolicySpec", "CheckpointSpec"}
    assert any("quarantine" in doc for _, doc, _ in DOCUMENTS)
    assert any(".md:" in where for _, _, where in DOCUMENTS)


def _same(name: str, doc: dict) -> None:
    try:
        theirs = getattr(jax_api, name).from_dict(doc)
    except ValueError:
        with pytest.raises(ValueError):
            getattr(port_api, name).from_dict(doc)
        return
    ours = getattr(port_api, name).from_dict(doc)
    assert ours.to_dict() == theirs.to_dict()
    assert type(ours).from_dict(ours.to_dict()) == ours


@pytest.mark.parametrize(
    "name, doc", [(n, d) for n, d, _ in DOCUMENTS], ids=[w for _, _, w in DOCUMENTS]
)
def test_jax_test_documents_parse_alike(name, doc):
    _same(name, doc)


def _seeded_policy(rng) -> dict:
    doc = {
        "autoUpgrade": bool(rng.integers(2)),
        "maxParallelUpgrades": int(rng.integers(0, 9)),
        "maxUnavailable": [None, int(rng.integers(0, 5)), f"{int(rng.integers(0, 101))}%"][
            int(rng.integers(3))
        ],
    }
    if rng.random() < 0.5:
        doc["drain"] = {
            "enable": bool(rng.integers(2)), "force": bool(rng.integers(2)),
            "podSelector": "app=train", "timeoutSeconds": int(rng.integers(0, 600)),
            "deleteEmptyDir": bool(rng.integers(2)),
        }
    if rng.random() < 0.5:
        doc["podDeletion"] = {
            "force": bool(rng.integers(2)), "timeoutSeconds": int(rng.integers(0, 600)),
            "deleteEmptyDir": bool(rng.integers(2)),
        }
    if rng.random() < 0.5:
        doc["waitForCompletion"] = {"podSelector": "job=batch", "timeoutSeconds": int(rng.integers(0, 99))}
    if rng.random() < 0.3:
        doc["checkpoint"] = {"enable": False, "timeoutSeconds": int(rng.integers(1, 600))}
    if rng.random() < 0.3:
        doc["quarantine"] = {"enable": bool(rng.integers(2)), "recoveryScore": 75.0}
    if rng.random() < 0.3:
        doc["policy"] = ["default"]
    return doc


@pytest.mark.parametrize("seed", range(4))
def test_seeded_policies_parse_alike(seed):
    rng = np.random.default_rng(seed)
    for _ in range(25):
        _same("DriverUpgradePolicySpec", _seeded_policy(rng))


@pytest.mark.parametrize("raw", [0, 3, "0%", "25%", "33%", "100%", "7"])
def test_int_or_string_scales_alike(raw):
    for total in (0, 1, 3, 8, 32, 257):
        for round_up in (True, False):
            assert IntOrString(raw).scaled_value(total, round_up) == JaxIntOrString(raw).scaled_value(
                total, round_up
            )
