"""Structural-schema admission for custom resources — the apiserver's
prune → default → validate pipeline.

The port's copy of the JAX package's ``kube/structural.py``, with its
public names and its semantics.

The reference's test strategy stands on envtest booting a REAL
kube-apiserver with the NodeMaintenance CRD installed
(the reference's ``pkg/upgrade/upgrade_suit_test.go:87-89``), which means
every CR its suite writes is pruned against the CRD's structural
openAPIV3Schema, defaulted from it, and validated by it before storage.
`FakeCluster` replicates that admission here so a stored CRD activates
the same contract: unknown fields are pruned (unless
``x-kubernetes-preserve-unknown-fields``), ``default``s are applied into
existing objects, and violations answer 422 Invalid with apiserver-shaped
field paths.

Scope (the structural subset, mirroring
apiextensions-apiserver/pkg/apiserver/schema semantics):

* types ``object``/``array``/``string``/``integer``/``number``/
  ``boolean``; ``x-kubernetes-int-or-string``; ``nullable``
* ``properties`` / ``items`` / ``additionalProperties`` (schema or
  ``true``)
* ``required``, ``enum``, ``minimum``/``maximum`` (+ boolean
  ``exclusiveMinimum``/``exclusiveMaximum``), ``minLength``/
  ``maxLength``, ``pattern``, ``minItems``/``maxItems``,
  ``allOf``/``anyOf``/``oneOf``/``not``; ``uniqueItems: true`` is
  REJECTED at CRD admission like upstream apiextensions (the 422 a
  real apiserver answers — a CRD never gains non-upstream validation)
* ``format`` is accepted but not enforced (upstream treats most formats
  as annotations for CRDs; enforcing none is the closest uniform rule)

At the document root, ``apiVersion``/``kind``/``metadata`` are server
territory: never pruned, never validated by the CR schema (upstream
coerces metadata through ObjectMeta instead of the schema).
"""

from __future__ import annotations

import copy
import re
from typing import Any, Mapping, Optional

_ROOT_SERVER_KEYS = frozenset({"apiVersion", "kind", "metadata"})


def validate_crd_structural(crd_data: Mapping[str, Any]) -> list[str]:
    """apiextensions' structural-schema requirements for the CRD object
    itself — upstream rejects a v1 CRD whose declared schemas are not
    structural. Checked for EVERY version carrying a schema — served or
    not, like upstream (a version with NO schema stays admitted,
    matching this package's schema-less activation rule):

    * the root must be ``type: object``;
    * every specified field must declare a ``type`` (or be
      int-or-string / preserve-unknown-fields); an empty field schema
      is rejected, and a typeless node is tolerated only when its
      constraints live entirely in junctors;
    * ``items`` must be a single schema (upstream forbids the array
      form);
    * ``properties`` and ``additionalProperties`` are mutually
      exclusive on one node; ``additionalProperties`` must be ``true``
      or a schema (``false`` is upstream-invalid);
    * inside junctor subtrees (allOf/anyOf/oneOf/not), ``type``,
      ``additionalProperties``, and ``default`` are forbidden —
      upstream exempts junctors from the type REQUIREMENT but forbids
      those keywords there."""
    errors: list[str] = []
    for v in (crd_data.get("spec") or {}).get("versions") or []:
        raw = ((v.get("schema") or {}).get("openAPIV3Schema")) or None
        if not raw:
            continue
        version = v.get("name", "?")
        if raw.get("type") != "object":
            errors.append(
                f"spec.versions[{version}].schema.openAPIV3Schema.type: "
                "Required value: must be object"
            )
        _check_structural(raw, f"spec.versions[{version}].schema"
                               ".openAPIV3Schema", errors, root=True)
    return errors


_JUNCTORS = ("allOf", "anyOf", "oneOf", "not")


def _check_structural(
    node: Any, path: str, errors: list[str], root: bool = False
) -> None:
    if not isinstance(node, Mapping):
        return
    props = node.get("properties")
    addl = node.get("additionalProperties")
    items = node.get("items")
    if props is not None and addl is not None:
        errors.append(
            f"{path}: Forbidden: properties and additionalProperties "
            "are mutually exclusive"
        )
    if addl is False:
        errors.append(
            f"{path}.additionalProperties: Forbidden: must be true or "
            "a schema"
        )
    if isinstance(items, list):
        errors.append(
            f"{path}.items: Forbidden: must be a schema, not an array "
            "of schemas"
        )
        items = None
    if node.get("uniqueItems"):
        # apiextensions forbids uniqueItems: true ANYWHERE in a
        # structural schema (deep-equality dedup is O(n^2) server work
        # an admitted object could weaponize) — the CRD is 422'd at
        # admission, it does not gain non-upstream validation behavior.
        errors.append(
            f"{path}.uniqueItems: Forbidden: uniqueItems cannot be set "
            "to true"
        )
    typed = (
        node.get("type")
        or node.get("x-kubernetes-int-or-string")
        or node.get("x-kubernetes-preserve-unknown-fields")
    )
    has_core = (
        props is not None or addl is not None or items is not None
    )
    has_junctor = any(j in node for j in _JUNCTORS)
    if not typed and not root:
        if has_core:
            errors.append(f"{path}.type: Required value")
        elif not has_junctor:
            errors.append(
                f"{path}: Required value: must not be empty for "
                "specified fields"
            )
    if isinstance(props, Mapping):
        for key, sub in props.items():
            _check_structural(sub, f"{path}.properties[{key}]", errors)
    if isinstance(addl, Mapping):
        _check_structural(addl, f"{path}.additionalProperties", errors)
    if isinstance(items, Mapping):
        _check_structural(items, f"{path}.items", errors)
    # x-kubernetes-int-or-string carries upstream's one junctor-type
    # exception: its canonical anyOf [{type: integer}, {type: string}]
    # branches may name types.
    allow_type = bool(node.get("x-kubernetes-int-or-string"))
    for junctor in _JUNCTORS:
        subtree = node.get(junctor)
        branches = (
            [subtree] if isinstance(subtree, Mapping)
            else subtree if isinstance(subtree, list) else []
        )
        for i, branch in enumerate(branches):
            _check_junctor(
                branch, f"{path}.{junctor}[{i}]", errors,
                allow_type=allow_type,
            )


def _check_junctor(
    node: Any, path: str, errors: list[str], allow_type: bool = False
) -> None:
    """Inside allOf/anyOf/oneOf/not: value validations only — type,
    additionalProperties, and default are forbidden (apiextensions'
    junctor rules; ``allow_type`` covers the int-or-string
    exception)."""
    if not isinstance(node, Mapping):
        return
    forbidden_keys = ("additionalProperties", "default") if allow_type \
        else ("type", "additionalProperties", "default")
    for forbidden in forbidden_keys:
        if forbidden in node:
            errors.append(
                f"{path}.{forbidden}: Forbidden: must not be set "
                "inside allOf/anyOf/oneOf/not"
            )
    if node.get("uniqueItems"):
        # Forbidden in junctor subtrees too — upstream's rule is
        # schema-wide, not structure-subtree-only.
        errors.append(
            f"{path}.uniqueItems: Forbidden: uniqueItems cannot be set "
            "to true"
        )
    props = node.get("properties")
    if isinstance(props, Mapping):
        for key, sub in props.items():
            _check_junctor(sub, f"{path}.properties[{key}]", errors)
    items = node.get("items")
    if isinstance(items, Mapping):
        _check_junctor(items, f"{path}.items", errors)
    for junctor in _JUNCTORS:
        subtree = node.get(junctor)
        branches = (
            [subtree] if isinstance(subtree, Mapping)
            else subtree if isinstance(subtree, list) else []
        )
        for i, branch in enumerate(branches):
            # allow_type propagates through nested junctors: the other
            # canonical int-or-string wrap is allOf -> anyOf -> types.
            _check_junctor(branch, f"{path}.{junctor}[{i}]", errors,
                           allow_type=allow_type)


def error_root_field(error: str) -> str:
    """The root field segment of a validation error's path — the text
    before the first ``.``, ``[``, or ``:``. Used for exact-field
    filtering (a field named ``statusHistory`` is not ``status``)."""
    head = error.split(":", 1)[0]
    for sep in (".", "["):
        head = head.split(sep, 1)[0]
    return head.strip()


def schema_for_crd_version(
    crd_data: Mapping[str, Any], version: str
) -> Optional["StructuralSchema"]:
    """The version's openAPIV3Schema as a ``StructuralSchema``, or None
    when that version carries no schema (schema-less CRDs admit
    anything, like upstream with preserveUnknownFields)."""
    for v in (crd_data.get("spec") or {}).get("versions") or []:
        if v.get("name") != version:
            continue
        raw = ((v.get("schema") or {}).get("openAPIV3Schema")) or None
        return StructuralSchema(raw) if raw else None
    return None


class StructuralSchema:
    def __init__(self, root: Mapping[str, Any]) -> None:
        self.root = root

    # -- the admission pipeline -------------------------------------------
    def admit(self, data: dict[str, Any]) -> list[str]:
        """Prune, then default, then validate ``data`` in place —
        upstream's write-path order. Returns validation errors
        (empty = admitted)."""
        self.prune(data)
        self.apply_defaults(data)
        return self.validate(data)

    # The root is an ordinary object node EXCEPT that
    # apiVersion/kind/metadata are server territory: they are set aside
    # before each walk (so the schema can neither prune, default into,
    # nor validate them) and restored after. Everything else — including
    # root-level additionalProperties, enum, and combinators — goes
    # through the same node walkers as every nested level.

    # -- pruning -----------------------------------------------------------
    def prune(self, data: dict[str, Any]) -> None:
        """Drop fields the schema does not specify (the apiserver's
        field pruning). Root server-owned keys are untouched."""
        aside = {
            k: data.pop(k) for k in list(data) if k in _ROOT_SERVER_KEYS
        }
        try:
            _prune_value(data, self.root)
        finally:
            data.update(aside)

    # -- defaulting --------------------------------------------------------
    def apply_defaults(self, data: dict[str, Any]) -> None:
        aside = {
            k: data.pop(k) for k in list(data) if k in _ROOT_SERVER_KEYS
        }
        try:
            _default_value(data, self.root)
        finally:
            data.update(aside)

    # -- validation --------------------------------------------------------
    def validate(self, data: Mapping[str, Any]) -> list[str]:
        view = {
            k: v for k, v in data.items() if k not in _ROOT_SERVER_KEYS
        }
        errors: list[str] = []
        _validate_value(view, self.root, "", errors)
        # A schema demanding server keys (required: [metadata]) is not
        # the CR author's problem — those live outside the schema. Match
        # the error path's ROOT SEGMENT exactly: a field merely named
        # "kinds" or "metadataPolicy" must not be silently excused.
        return [
            e for e in errors
            if error_root_field(e) not in _ROOT_SERVER_KEYS
        ]


# ---------------------------------------------------------------------------
# Node-level walkers
# ---------------------------------------------------------------------------


def _prune_value(value: Any, schema: Mapping[str, Any]) -> None:
    if isinstance(value, dict):
        if schema.get("x-kubernetes-int-or-string"):
            return  # int-or-string holds scalars; leave malformed input
            # for validation to report rather than silently emptying it
        props = schema.get("properties") or {}
        addl = schema.get("additionalProperties")
        preserve = schema.get("x-kubernetes-preserve-unknown-fields")
        for key in list(value):
            if key in props:
                _prune_value(value[key], props[key])
            elif isinstance(addl, Mapping):
                _prune_value(value[key], addl)
            elif addl is True or preserve:
                continue
            else:
                del value[key]
    elif isinstance(value, list):
        items = schema.get("items")
        if isinstance(items, Mapping):
            for element in value:
                _prune_value(element, items)


def _default_value(value: Any, schema: Mapping[str, Any]) -> None:
    if isinstance(value, dict):
        props = schema.get("properties") or {}
        for key, sub in props.items():
            if key not in value and "default" in sub:
                value[key] = copy.deepcopy(sub["default"])
            if key in value:
                _default_value(value[key], sub)
        addl = schema.get("additionalProperties")
        if isinstance(addl, Mapping):
            for key, element in value.items():
                if key not in props:
                    _default_value(element, addl)
    elif isinstance(value, list):
        items = schema.get("items")
        if isinstance(items, Mapping):
            for element in value:
                _default_value(element, items)


def _type_ok(value: Any, type_name: str) -> bool:
    if type_name == "object":
        return isinstance(value, dict)
    if type_name == "array":
        return isinstance(value, list)
    if type_name == "string":
        return isinstance(value, str)
    if type_name == "boolean":
        return isinstance(value, bool)
    if type_name == "integer":
        return isinstance(value, int) and not isinstance(value, bool)
    if type_name == "number":
        return (
            isinstance(value, (int, float)) and not isinstance(value, bool)
        )
    return True  # unknown type names admit (upstream rejects at CRD
    # creation; a stored schema never carries one)


def _fmt(value: Any) -> str:
    return repr(value) if not isinstance(value, str) else f'"{value}"'


def _child(path: str, key: str) -> str:
    return f"{path}.{key}" if path else key


def _validate_value(
    value: Any,
    schema: Mapping[str, Any],
    path: str,
    errors: list[str],
) -> None:
    label = path or "<root>"
    if value is None:
        if not schema.get("nullable"):
            errors.append(f"{label}: Invalid value: null")
        return
    if schema.get("x-kubernetes-int-or-string"):
        if not (
            isinstance(value, str)
            or (isinstance(value, int) and not isinstance(value, bool))
        ):
            errors.append(
                f"{label}: Invalid value: {_fmt(value)}: "
                "expected integer or string"
            )
            return
    else:
        type_name = schema.get("type", "")
        if type_name and not _type_ok(value, type_name):
            errors.append(
                f"{label}: Invalid value: {_fmt(value)}: "
                f"expected {type_name}"
            )
            return

    if "enum" in schema and value not in schema["enum"]:
        allowed = ", ".join(_fmt(v) for v in schema["enum"])
        errors.append(
            f"{label}: Unsupported value: {_fmt(value)}: "
            f"supported values: {allowed}"
        )

    if isinstance(value, (int, float)) and not isinstance(value, bool):
        minimum = schema.get("minimum")
        if minimum is not None:
            if schema.get("exclusiveMinimum"):
                if value <= minimum:
                    errors.append(
                        f"{label}: Invalid value: {value}: must be greater "
                        f"than {minimum}"
                    )
            elif value < minimum:
                errors.append(
                    f"{label}: Invalid value: {value}: must be greater than "
                    f"or equal to {minimum}"
                )
        maximum = schema.get("maximum")
        if maximum is not None:
            if schema.get("exclusiveMaximum"):
                if value >= maximum:
                    errors.append(
                        f"{label}: Invalid value: {value}: must be less "
                        f"than {maximum}"
                    )
            elif value > maximum:
                errors.append(
                    f"{label}: Invalid value: {value}: must be less than "
                    f"or equal to {maximum}"
                )

    if isinstance(value, str):
        min_len = schema.get("minLength")
        if min_len is not None and len(value) < min_len:
            errors.append(
                f"{label}: Invalid value: {_fmt(value)}: must be at least "
                f"{min_len} chars long"
            )
        max_len = schema.get("maxLength")
        if max_len is not None and len(value) > max_len:
            errors.append(
                f"{label}: Invalid value: {_fmt(value)}: may not be longer "
                f"than {max_len}"
            )
        pattern = schema.get("pattern")
        if pattern is not None and re.search(pattern, value) is None:
            errors.append(
                f"{label}: Invalid value: {_fmt(value)}: must match "
                f"pattern {pattern}"
            )

    if isinstance(value, list):
        min_items = schema.get("minItems")
        if min_items is not None and len(value) < min_items:
            errors.append(
                f"{label}: Invalid value: must have at least {min_items} "
                "items"
            )
        max_items = schema.get("maxItems")
        if max_items is not None and len(value) > max_items:
            errors.append(
                f"{label}: Invalid value: must have at most {max_items} "
                "items"
            )
        if schema.get("uniqueItems"):
            seen: list[Any] = []
            for element in value:
                if element in seen:
                    errors.append(
                        f"{label}: Duplicate value: {_fmt(element)}"
                    )
                    break
                seen.append(element)
        items = schema.get("items")
        if isinstance(items, Mapping):
            for i, element in enumerate(value):
                _validate_value(element, items, f"{path}[{i}]", errors)

    if isinstance(value, dict) and not schema.get("x-kubernetes-int-or-string"):
        props = schema.get("properties") or {}
        for key in schema.get("required") or []:
            if key not in value:
                errors.append(f"{_child(path, key)}: Required value")
        addl = schema.get("additionalProperties")
        for key, element in value.items():
            if key in props:
                _validate_value(element, props[key], _child(path, key), errors)
            elif isinstance(addl, Mapping):
                _validate_value(element, addl, _child(path, key), errors)

    # Value-validation combinators (structural schemas restrict these to
    # validation-only subtrees; we evaluate them as predicates).
    for sub in schema.get("allOf") or []:
        _validate_value(value, sub, path, errors)
    any_of = schema.get("anyOf")
    if any_of:
        if not any(_passes(value, sub, path) for sub in any_of):
            errors.append(
                f"{label}: Invalid value: {_fmt(value)}: must validate "
                "against at least one schema (anyOf)"
            )
    one_of = schema.get("oneOf")
    if one_of:
        matches = sum(1 for sub in one_of if _passes(value, sub, path))
        if matches != 1:
            errors.append(
                f"{label}: Invalid value: {_fmt(value)}: must validate "
                f"against exactly one schema (oneOf), matched {matches}"
            )
    if "not" in schema and _passes(value, schema["not"], path):
        errors.append(
            f"{label}: Invalid value: {_fmt(value)}: must not validate "
            "against the schema (not)"
        )


def _passes(value: Any, schema: Mapping[str, Any], path: str) -> bool:
    probe: list[str] = []
    _validate_value(value, schema, path, probe)
    return not probe
