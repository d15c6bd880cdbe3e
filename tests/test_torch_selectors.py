"""The port's label and field selectors against the JAX package's, on every
case of ``tests/test_selectors.py``: the same parse (each requirement's
key, operator and values), the same ``matches`` result, which is also the
one the JAX suite expects, and the same ``SelectorError`` on invalid input.
The tolerance is exact equality.
"""

from __future__ import annotations

import pytest

from k8s_operator_libs_tpu.kube import selectors as jax_sel
from k8s_operator_libs_tpu_torch.kube import selectors as port_sel

#: (selector, labels, expected match).
LABEL_CASES = [
    ("", {"a": "b"}, True),
    ("", None, True),
    ("app=driver", {"app": "driver"}, True),
    ("app=driver", {"app": "other"}, False),
    ("app=driver", {}, False),
    ("app==driver", {"app": "driver"}, True),
    ("app!=driver", {"app": "x"}, True),
    ("app!=driver", {}, True),
    ("app!=driver", {"app": "driver"}, False),
    ("env in (prod, staging)", {"env": "prod"}, True),
    ("env in (prod, staging)", {"env": "staging"}, True),
    ("env in (prod, staging)", {"env": "dev"}, False),
    ("env in (prod, staging)", {}, False),
    ("env notin (prod)", {"env": "dev"}, True),
    ("env notin (prod)", {}, True),
    ("env notin (prod)", {"env": "prod"}, False),
    ("gpu", {"gpu": ""}, True),
    ("gpu", {}, False),
    ("!gpu", {}, True),
    ("!gpu", {"gpu": "1"}, False),
    ("app=driver,env in (prod,dev),!legacy", {"app": "driver", "env": "prod"}, True),
    ("app=driver,env in (prod,dev),!legacy", {"app": "driver", "env": "prod", "legacy": "1"}, False),
    ("app=driver,env in (prod,dev),!legacy", {"app": "driver", "env": "qa"}, False),
    ("env in (a,b),app=x", {"env": "a", "app": "x"}, True),
    ("nvidia.com/gpu.present=true", {"nvidia.com/gpu.present": "true"}, True),
]

#: (selector, data, expected match).
FIELD_CASES = [
    ("spec.nodeName=node-1", {"spec": {"nodeName": "node-1"}}, True),
    ("spec.nodeName=node-1", {"spec": {"nodeName": "node-2"}}, False),
    ("spec.nodeName=node-1", {"spec": {}}, False),
    ("spec.nodeName=node-1", {}, False),
    (None, {"anything": "goes"}, True),
    ("", {"anything": "goes"}, True),
    ("spec.nodeName!=node-1", {"spec": {"nodeName": "node-1"}}, False),
    ("spec.nodeName!=node-1", {"spec": {"nodeName": "node-2"}}, True),
    ("spec.nodeName!=node-1", {}, True),
    ("spec.nodeName=node-1,metadata.name!=skip",
     {"spec": {"nodeName": "node-1"}, "metadata": {"name": "keep"}}, True),
    ("spec.nodeName=node-1,metadata.name!=skip",
     {"spec": {"nodeName": "node-1"}, "metadata": {"name": "skip"}}, False),
]

#: (parser name, invalid selector).
INVALID_CASES = [
    ("parse_selector", "env in ()"),
    ("parse_selector", "!"),
    ("parse_selector", "bad key=x"),
    ("parse_field_selector", "metadata.name"),
    ("parse_field_selector", "!=x"),
]


def _parsed(selector) -> list[tuple]:
    return [(r.key, r.op, tuple(r.values)) for r in selector.requirements]


@pytest.mark.parametrize("selector,labels,expected", LABEL_CASES)
def test_label_selector_matches_as_jax_does(selector, labels, expected):
    theirs, ours = jax_sel.parse_selector(selector), port_sel.parse_selector(selector)
    assert _parsed(ours) == _parsed(theirs)
    assert ours.empty == theirs.empty
    assert ours.matches(labels) == theirs.matches(labels) == expected


def test_set_values_are_not_split_as_terms():
    ours = port_sel.parse_selector("env in (a,b),app=x")
    assert len(ours.requirements) == 2
    assert _parsed(ours) == _parsed(jax_sel.parse_selector("env in (a,b),app=x"))


@pytest.mark.parametrize(
    "labels,expected",
    [({"k8s-app": "libtpu", "extra": "1"}, True), ({"k8s-app": "other"}, False)],
)
def test_from_match_labels_as_jax_does(labels, expected):
    match = {"k8s-app": "libtpu"}
    theirs = jax_sel.LabelSelector.from_match_labels(match)
    ours = port_sel.LabelSelector.from_match_labels(match)
    assert _parsed(ours) == _parsed(theirs)
    assert ours.matches(labels) == theirs.matches(labels) == expected


@pytest.mark.parametrize("selector,data,expected", FIELD_CASES)
def test_field_selector_matches_as_jax_does(selector, data, expected):
    theirs = jax_sel.parse_field_selector(selector)
    ours = port_sel.parse_field_selector(selector)
    assert [(r.key, r.op, r.value) for r in ours.requirements] == [
        (r.key, r.op, r.value) for r in theirs.requirements
    ]
    assert ours.empty == theirs.empty
    assert ours.matches(data) == theirs.matches(data) == expected


@pytest.mark.parametrize("parser,selector", INVALID_CASES)
def test_invalid_selector_raises_the_same_error(parser, selector):
    with pytest.raises(jax_sel.SelectorError) as theirs:
        getattr(jax_sel, parser)(selector)
    with pytest.raises(port_sel.SelectorError) as ours:
        getattr(port_sel, parser)(selector)
    assert str(ours.value) == str(theirs.value)
    assert isinstance(ours.value, ValueError)
