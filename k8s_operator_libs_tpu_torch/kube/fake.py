"""An in-memory Kubernetes apiserver for tests and simulation.

The port's copy of the JAX package's ``kube/fake.py``: the patch engines
(RFC 7386 merge, strategic merge, RFC 6902 JSON patch), the watch framing
an HTTP server shares (``classify_watch_event``, ``WatchFrameSource``) and
``FakeCluster``, which implements the port's ``kube/client.py`` ``Client``.
The HTTP server over it (``LocalApiServer``) is not ported yet (ROADMAP
A19 (b)); its watch handler would read the framing here.

Plays the role envtest plays in the reference's suites — a real apiserver+etcd
booted locally with no kubelets, against which Node/Pod/CR objects are plain
API objects (reference: upgrade_suit_test.go:87-93, §4 of SURVEY.md). This
implementation keeps the apiserver *semantics* the framework depends on:

* monotonic resourceVersion, bumped on every write,
* optimistic concurrency (Conflict on stale resourceVersion for updates),
* RFC 7386 merge patch with ``null`` deleting keys,
* finalizers: delete marks ``deletionTimestamp`` and the object lingers until
  finalizers are cleared (the reference's suites strip NodeMaintenance
  finalizers in cleanup, upgrade_state_test.go:1797-1813),
* label/field selector list filtering,
* watch events for cache emulation,
* injectable reactors for fault injection (client-go fake style).
"""

from __future__ import annotations

import itertools
import os
import random
import threading
import time
import uuid
from collections import deque
from typing import Any, Callable, Mapping, Optional

from .client import (
    AlreadyExistsError,
    BadRequestError,
    ClientBase,
    ConflictError,
    InvalidError,
    ListDelta,
    NotFoundError,
    UnsupportedMediaTypeError,
    WatchExpiredError,
)
from .objects import (
    KINDS,
    deep_copy_json,
    CustomResourceDefinition,
    KubeObject,
    rfc3339_now,
    wrap,
)
from .resources import resource_for_kind
from .selectors import LabelSelector, parse_field_selector, parse_selector
from ..utils import tracing
from .ssa import reassign_on_write, server_side_apply
from .structural import (
    error_root_field,
    schema_for_crd_version,
    validate_crd_structural,
)

#: reactor signature: (verb, kind, payload) -> None; raise to inject a failure.
Reactor = Callable[[str, str, dict[str, Any]], None]

#: uid generation: ``uuid.uuid4`` reads ``os.urandom`` on every call, a
#: measurable per-create cost on the pod-churn hot path (the simulated
#: kubelet recreates one driver pod per node per roll). A process-local
#: PRNG seeded once from urandom keeps uids RFC 4122 v4-shaped and
#: unique-in-practice at ``getrandbits`` speed.
_UID_RNG = random.Random(int.from_bytes(os.urandom(16), "big"))


def _new_uid() -> str:
    return str(uuid.UUID(int=_UID_RNG.getrandbits(128), version=4))


_WATCH_ADDED = "ADDED"
_WATCH_MODIFIED = "MODIFIED"
_WATCH_DELETED = "DELETED"


def merge_patch(target: dict[str, Any], patch: Mapping[str, Any]) -> dict[str, Any]:
    """Apply an RFC 7386 JSON merge patch in place; null values delete keys.

    This is the write primitive the whole state machine rides on — label and
    annotation writes are merge patches with ``null`` used for key deletion
    (reference: pkg/upgrade/node_upgrade_state_provider.go:80-82, 147-150).
    """
    for key, value in patch.items():
        if value is None:
            target.pop(key, None)
        elif isinstance(value, Mapping):
            existing = target.get(key)
            if not isinstance(existing, dict):
                existing = {}
                target[key] = existing
            merge_patch(existing, value)
        else:
            target[key] = deep_copy_json(value)
    return target


#: Field-name-keyed mirror of the ``patchStrategy:"merge"`` /
#: ``patchMergeKey:"..."`` struct tags in k8s.io/api. apimachinery resolves
#: these per Go type; schema-less, this engine keys them by FIELD NAME —
#: Kubernetes API conventions keep the names consistent across types, and
#: the one ambiguous name (``ports``: ContainerPort keys by containerPort,
#: ServicePort by port) carries every upstream candidate, resolved against
#: the elements actually present. Fields without a ``patchStrategy`` tag
#: upstream (e.g. tolerations, args) are deliberately absent: they stay
#: atomic/replace here too. ``name`` remains the universal fallback key —
#: it is the K8s default merge key and the convention CRDs follow.
_LIST_MERGE_KEYS: dict[str, tuple[str, ...]] = {
    "containers": ("name",),
    "initContainers": ("name",),
    "ephemeralContainers": ("name",),
    "env": ("name",),
    "ports": ("containerPort", "port"),
    "volumes": ("name",),
    "volumeMounts": ("mountPath",),
    "volumeDevices": ("devicePath",),
    "imagePullSecrets": ("name",),
    "secrets": ("name",),
    "resourceClaims": ("name",),
    "hostAliases": ("ip",),
    "podIPs": ("ip",),
    "hostIPs": ("ip",),
    "taints": ("key",),
    "conditions": ("type",),
    "addresses": ("type",),
    "ownerReferences": ("uid",),
    "topologySpreadConstraints": ("topologyKey",),
}

#: ``patchStrategy:"merge"`` on PRIMITIVE lists (``[]string``) upstream:
#: ObjectMeta.finalizers, NodeStatus.volumesInUse. Patch values union into
#: the live list (live order first, new values in patch order); removals
#: go through ``$deleteFromPrimitiveList/<field>``.
_PRIMITIVE_MERGE_FIELDS = frozenset({"finalizers", "volumesInUse"})


def strategic_merge_patch(
    target: dict[str, Any], patch: Mapping[str, Any]
) -> dict[str, Any]:
    """Apply a Kubernetes strategic-merge patch in place.

    The reference writes the node state label with a *strategic* merge
    patch (node_upgrade_state_provider.go:80-82) while annotations go via
    RFC 7386 merge patch (:147-150); this fake supports both content types
    so the distinction is honest rather than papered over. For the map
    fields this library patches (labels/annotations), the two are
    equivalent — ``tests/test_patch_semantics.py`` pins that equivalence.

    Supported strategic semantics:

    * maps merge recursively; ``null`` deletes a key (same as merge patch),
    * a map containing ``{"$patch": "replace"}`` replaces wholesale; a map
      value of ``{"$patch": "delete"}`` deletes the key,
    * ``$retainKeys: [k...]`` on a map drops every key of the merged
      result not in the list (apimachinery's retainKeys strategy),
    * lists of objects merge by the upstream merge key — resolved from
      ``_LIST_MERGE_KEYS`` by field name, ``name`` as the fallback; an
      item ``{"$patch": "delete", <key>: x}`` removes the matching
      element, and any ``{"$patch": "replace"}`` element makes the
      remaining items replace the list wholesale (apimachinery's
      mergeSliceWithSpecialElements),
    * ``$setElementOrder/<field>: [...]`` reorders the merged list: listed
      elements take the directive's order, server-only elements keep their
      relative position by live index (apimachinery's normalizeElementOrder),
    * merge-strategy primitive lists (``_PRIMITIVE_MERGE_FIELDS``) union;
      ``$deleteFromPrimitiveList/<field>: [v...]`` removes values,
    * other primitive lists are replaced (the K8s atomic default).

    Remaining deviations from apimachinery (PARITY.md, pinned by
    tests/test_conformance_vectors.py): merge keys resolve by field name
    rather than by typed schema, and invalid patches apimachinery rejects
    (e.g. a ``$setElementOrder`` list omitting a patched element) apply
    leniently instead of erroring.
    """
    orders: dict[str, list[Any]] = {}
    live_before: dict[str, Any] = {}
    for key, value in patch.items():
        if key.startswith("$setElementOrder/") and isinstance(value, list):
            field_name = key.split("/", 1)[1]
            orders[field_name] = value
            live_before[field_name] = deep_copy_json(target.get(field_name))
    for key, value in patch.items():
        if key in ("$patch", "$retainKeys"):
            continue
        if key.startswith("$setElementOrder/"):
            continue
        if key.startswith("$deleteFromPrimitiveList/"):
            field_name = key.split("/", 1)[1]
            current = target.get(field_name)
            if isinstance(current, list) and isinstance(value, list):
                target[field_name] = [v for v in current if v not in value]
            continue
        if value is None:
            target.pop(key, None)
        elif isinstance(value, Mapping):
            directive = value.get("$patch")
            if directive == "delete":
                target.pop(key, None)
                continue
            if directive == "replace":
                target[key] = _strip_directives(value)
                continue
            existing = target.get(key)
            if not isinstance(existing, dict):
                existing = {}
                target[key] = existing
            strategic_merge_patch(existing, value)
        elif isinstance(value, list):
            merged_list = _strategic_merge_list(key, target.get(key), value)
            # Pure-directive patches ($patch:delete of absent elements)
            # must not conjure the key into existence — a real apiserver
            # treats them as a no-op. An explicit empty list still sets.
            if key not in target and not merged_list and value:
                continue
            target[key] = merged_list
        else:
            target[key] = deep_copy_json(value)
    for field_name, order in orders.items():
        current = target.get(field_name)
        if isinstance(current, list):
            target[field_name] = _reorder_list(
                field_name, current, order, live_before.get(field_name)
            )
    retain = patch.get("$retainKeys")
    if isinstance(retain, list):
        for key in list(target):
            if key not in retain:
                target.pop(key)
    return target


def _is_directive_key(key: Any) -> bool:
    return isinstance(key, str) and (
        key in ("$patch", "$retainKeys")
        or key.startswith(("$setElementOrder/", "$deleteFromPrimitiveList/"))
    )


def _strip_directives(item: Mapping[str, Any]) -> dict[str, Any]:
    """Deep-copy a patch element minus directive keys — directives are
    instructions to the merge, never data a real apiserver persists."""
    return {
        k: deep_copy_json(v) for k, v in item.items() if not _is_directive_key(k)
    }


def _merge_key_for(
    field: str, current_items: list[Any], patch_items: list[Any]
) -> Optional[str]:
    """Pick the upstream merge key for a list field, or None for the
    atomic/replace strategy. Every element on both sides must carry the
    key — mirroring apimachinery, which errors on keyless elements (we
    fall back to replace instead of erroring)."""
    pool = list(current_items) + list(patch_items)
    if not pool:
        return "name"
    if not all(isinstance(i, Mapping) for i in pool):
        return None
    for key in _LIST_MERGE_KEYS.get(field, ()) + ("name",):
        if all(key in i for i in pool):
            return key
    return None


def _strategic_merge_list(
    field: str, current: Any, patch_items: list[Any]
) -> list[Any]:
    if any(
        isinstance(i, Mapping) and i.get("$patch") == "replace"
        for i in patch_items
    ):
        # apimachinery (mergeSliceWithSpecialElements): ANY element
        # carrying {"$patch": "replace"} makes the remaining items replace
        # the list wholesale; directive elements themselves are dropped.
        result: list[Any] = []
        for i in patch_items:
            if isinstance(i, Mapping):
                if i.get("$patch") == "delete":
                    continue
                stripped = _strip_directives(i)
                if stripped or "$patch" not in i:
                    result.append(stripped)
            else:
                result.append(deep_copy_json(i))
        return result
    cur_list = current if isinstance(current, list) else []
    if field in _PRIMITIVE_MERGE_FIELDS and all(
        not isinstance(i, Mapping)
        for i in itertools.chain(cur_list, patch_items)
    ):
        merged = [deep_copy_json(v) for v in cur_list]
        for v in patch_items:
            if v not in merged:
                merged.append(deep_copy_json(v))
        return merged
    key = _merge_key_for(field, cur_list, patch_items)
    if key is None or (current is not None and not isinstance(current, list)):
        # Replace strategy — but directives are instructions, not data: a
        # $patch:delete of an absent element is a no-op on a real
        # apiserver, never a stored phantom object, and directive keys
        # are never persisted.
        return [
            _strip_directives(i) if isinstance(i, Mapping) else deep_copy_json(i)
            for i in patch_items
            if not (isinstance(i, Mapping) and i.get("$patch") == "delete")
        ]
    merged = [deep_copy_json(i) for i in cur_list]
    index = {item[key]: pos for pos, item in enumerate(merged)}
    for item in patch_items:
        kval = item[key]
        directive = item.get("$patch")
        if directive == "delete":
            if kval in index:
                merged = [m for m in merged if m[key] != kval]
                index = {m[key]: pos for pos, m in enumerate(merged)}
            continue
        if kval in index:
            strategic_merge_patch(merged[index[kval]], item)
        else:
            # Appending still interprets the element AS a patch (against
            # nothing) so nested directives are consumed, never stored.
            fresh: dict[str, Any] = {}
            strategic_merge_patch(fresh, item)
            merged.append(fresh)
            index[kval] = len(merged) - 1
    return merged


def _reorder_list(
    field: str, merged: list[Any], order: list[Any], live_before: Any
) -> list[Any]:
    """Apply a ``$setElementOrder/<field>`` directive to the merged list.

    apimachinery's normalizeElementOrder: elements named by the directive
    take the directive's order; elements the patch never mentioned
    ("server-only") keep their relative order and slot in by comparing
    live-list indexes against the directive elements. Elements in neither
    the directive nor the live list (lenient here, an error upstream)
    append at the end.
    """
    if not order or not merged:
        return merged
    if all(isinstance(o, Mapping) for o in order):
        key = None
        for cand in _LIST_MERGE_KEYS.get(field, ()) + ("name",):
            if all(cand in o for o in order) and all(
                isinstance(m, Mapping) and cand in m for m in merged
            ):
                key = cand
                break
        if key is None:
            return merged

        def keyfn(item: Any) -> Any:
            return item.get(key) if isinstance(item, Mapping) else None

    else:

        def keyfn(item: Any) -> Any:
            return None if isinstance(item, Mapping) else item

    try:
        pos_in_order: dict[Any, int] = {}
        for i, o in enumerate(order):
            pos_in_order.setdefault(keyfn(o), i)
        live = live_before if isinstance(live_before, list) else []
        live_idx: dict[Any, int] = {}
        for i, item in enumerate(live):
            live_idx.setdefault(keyfn(item), i)
        ordered = sorted(
            (m for m in merged if keyfn(m) in pos_in_order),
            key=lambda m: pos_in_order[keyfn(m)],
        )
        server_only = [m for m in merged if keyfn(m) not in pos_in_order]
    except TypeError:
        # Unhashable keys — leave the merge result's order untouched.
        return merged
    inf = float("inf")
    result: list[Any] = []
    i = j = 0
    while i < len(server_only) and j < len(ordered):
        s_idx = live_idx.get(keyfn(server_only[i]), inf)
        p_idx = live_idx.get(keyfn(ordered[j]), inf)
        if s_idx < p_idx:
            result.append(server_only[i])
            i += 1
        else:
            result.append(ordered[j])
            j += 1
    result.extend(server_only[i:])
    result.extend(ordered[j:])
    return result


#: API groups whose types carry strategic-merge struct tags upstream —
#: i.e. the groups LocalApiServer/FakeCluster store as built-ins. Every
#: other group is CRD-backed and (like a real apiserver) answers 415 to a
#: strategic-merge-patch content type.
_STRATEGIC_GROUPS = frozenset(
    {"", "apps", "apiextensions.k8s.io", "coordination.k8s.io"}
)


def _supports_strategic(data: Mapping[str, Any]) -> bool:
    api_version = data.get("apiVersion") or ""
    group = api_version.rsplit("/", 1)[0] if "/" in api_version else ""
    return group in _STRATEGIC_GROUPS


def _json_pointer_tokens(pointer: str) -> list[str]:
    """RFC 6901: split and unescape a JSON Pointer (``~1`` → ``/``, then
    ``~0`` → ``~``; that order, or ``~01`` would wrongly become ``/``)."""
    if pointer == "":
        return []
    if not pointer.startswith("/"):
        raise BadRequestError(
            f"json patch pointer must start with '/': {pointer!r}"
        )
    return [
        t.replace("~1", "/").replace("~0", "~")
        for t in pointer.split("/")[1:]
    ]


def _jp_index(tok: str, pointer: str, length: int, allow_append: bool) -> int:
    if tok == "-" and allow_append:
        return length
    # RFC 6901 array index: "0" or digits with no leading zero, no sign.
    if not (tok == "0" or (tok.isdigit() and not tok.startswith("0"))):
        raise InvalidError(
            f"json patch path {pointer!r}: invalid array index {tok!r}"
        )
    idx = int(tok)
    limit = length + 1 if allow_append else length
    if idx >= limit:
        raise InvalidError(
            f"json patch path {pointer!r}: index {idx} out of bounds "
            f"for array of length {length}"
        )
    return idx


def _jp_step(cur: Any, tok: str, pointer: str) -> Any:
    if isinstance(cur, Mapping):
        if tok not in cur:
            raise InvalidError(
                f"json patch path {pointer!r} does not exist"
            )
        return cur[tok]
    if isinstance(cur, list):
        return cur[_jp_index(tok, pointer, len(cur), allow_append=False)]
    raise InvalidError(
        f"json patch path {pointer!r} traverses a non-container value"
    )


def _jp_get(doc: Any, pointer: str) -> Any:
    cur = doc
    for tok in _json_pointer_tokens(pointer):
        cur = _jp_step(cur, tok, pointer)
    return cur


def _jp_parent(doc: Any, tokens: list[str], pointer: str) -> tuple[Any, str]:
    """Walk to the container holding the final token (which must exist
    per RFC 6902 for every op — only the *final* location may be new)."""
    cur = doc
    for tok in tokens[:-1]:
        cur = _jp_step(cur, tok, pointer)
    return cur, tokens[-1]


def _jp_root_replace(doc: dict[str, Any], value: Any) -> None:
    if not isinstance(value, Mapping):
        raise InvalidError(
            "json patch cannot replace the document root with a non-object"
        )
    doc.clear()
    doc.update(deep_copy_json(value))


def _jp_add(
    doc: dict[str, Any], pointer: str, value: Any, copy_value: bool = True
) -> None:
    # copy_value=False is for values the caller already exclusively owns
    # (a just-removed ``move`` source) — skips a redundant deepcopy.
    tokens = _json_pointer_tokens(pointer)
    if not tokens:
        _jp_root_replace(doc, value)
        return
    parent, last = _jp_parent(doc, tokens, pointer)
    if copy_value:
        value = deep_copy_json(value)
    if isinstance(parent, Mapping):
        parent[last] = value  # type: ignore[index]
    elif isinstance(parent, list):
        idx = _jp_index(last, pointer, len(parent), allow_append=True)
        parent.insert(idx, value)
    else:
        raise InvalidError(
            f"json patch path {pointer!r}: parent is not a container"
        )


def _jp_remove(doc: dict[str, Any], pointer: str) -> Any:
    tokens = _json_pointer_tokens(pointer)
    if not tokens:
        raise InvalidError("json patch cannot remove the document root")
    parent, last = _jp_parent(doc, tokens, pointer)
    if isinstance(parent, Mapping):
        if last not in parent:
            raise InvalidError(
                f"json patch path {pointer!r} does not exist"
            )
        return parent.pop(last)  # type: ignore[attr-defined]
    if isinstance(parent, list):
        return parent.pop(_jp_index(last, pointer, len(parent), False))
    raise InvalidError(
        f"json patch path {pointer!r}: parent is not a container"
    )


def _json_equal(a: Any, b: Any) -> bool:
    """Deep equality with JSON semantics: bool is its own type (Python's
    ``True == 1`` must not make a ``test`` op pass)."""
    if isinstance(a, bool) != isinstance(b, bool):
        return False
    if isinstance(a, Mapping) and isinstance(b, Mapping):
        return a.keys() == b.keys() and all(
            _json_equal(a[k], b[k]) for k in a
        )
    if isinstance(a, list) and isinstance(b, list):
        return len(a) == len(b) and all(map(_json_equal, a, b))
    return a == b


def _jp_op_touches_spec(op: Any) -> bool:
    """Whether a JSON-patch op can change ``/spec``: its path (or, for
    ``move``, its source) is the root, ``/spec`` itself, or under it.
    (``copy`` *from* spec reads it without changing it.)"""
    if not isinstance(op, Mapping):
        return False
    pointers = [str(op.get("path", ""))]
    if op.get("op") == "move":
        pointers.append(str(op.get("from", "")))
    return any(
        p == "" or p == "/spec" or p.startswith("/spec/") for p in pointers
    )


def json_patch(target: dict[str, Any], ops: Any) -> dict[str, Any]:
    """Apply an RFC 6902 JSON patch in place (``application/json-patch+json``,
    client-go's types.JSONPatchType — the third patch flavor the real
    apiserver accepts alongside merge and strategic).

    Error mapping mirrors apiserver/pkg/endpoints/handlers/patch.go: a
    malformed patch *document* (not an array, op not an object, unknown op,
    missing value/from, bad pointer syntax) answers 400 BadRequest; an
    *inapplicable* operation (missing path, index out of bounds, failed
    ``test``) answers 422 Invalid/UnprocessableEntity.

    Atomic per RFC 6902: ops apply to a working copy, and ``target`` is
    only updated (in place) once every op succeeded — a failure mid-array
    leaves ``target`` untouched.
    """
    if not isinstance(ops, list):
        raise BadRequestError("json patch must be an array of operations")
    work = deep_copy_json(target)
    for i, op in enumerate(ops):
        if not isinstance(op, Mapping) or not isinstance(op.get("op"), str):
            raise BadRequestError(
                f"json patch operation {i} is not an object with an 'op'"
            )
        name = op["op"]
        pointer = op.get("path")
        if not isinstance(pointer, str):
            raise BadRequestError(
                f"json patch operation {i} ({name}) has no 'path'"
            )
        if name in ("add", "replace", "test") and "value" not in op:
            raise BadRequestError(
                f"json patch operation {i} ({name}) has no 'value'"
            )
        if name in ("move", "copy") and not isinstance(op.get("from"), str):
            raise BadRequestError(
                f"json patch operation {i} ({name}) has no 'from'"
            )
        if name == "add":
            _jp_add(work, pointer, op["value"])
        elif name == "remove":
            _jp_remove(work, pointer)
        elif name == "replace":
            _jp_get(work, pointer)  # must exist (RFC 6902 §4.3)
            if not _json_pointer_tokens(pointer):
                _jp_root_replace(work, op["value"])
            else:
                _jp_remove(work, pointer)
                _jp_add(work, pointer, op["value"])
        elif name == "move":
            src = op["from"]
            src_tokens = _json_pointer_tokens(src)
            dst_tokens = _json_pointer_tokens(pointer)
            if (
                len(src_tokens) < len(dst_tokens)
                and dst_tokens[: len(src_tokens)] == src_tokens
            ):
                raise InvalidError(
                    f"json patch cannot move {src!r} into its own child "
                    f"{pointer!r}"
                )
            moved = _jp_remove(work, src)
            _jp_add(work, pointer, moved, copy_value=False)
        elif name == "copy":
            _jp_add(work, pointer, _jp_get(work, op["from"]))
        elif name == "test":
            actual = _jp_get(work, pointer)
            if not _json_equal(actual, op["value"]):
                raise InvalidError(
                    f"json patch test failed at {pointer!r}: "
                    f"expected {op['value']!r}, found {actual!r}"
                )
        else:
            raise BadRequestError(
                f"json patch operation {i}: unknown op {name!r}"
            )
    target.clear()
    target.update(work)
    return target


def classify_watch_event(
    event_type: str,
    data: Mapping[str, Any],
    old: Optional[Mapping[str, Any]],
    selector,
    fields,
) -> Optional[str]:
    """Classify a store event against a selector scope by old-vs-new state —
    the real watch cache's logic: entering scope is ADDED, leaving it is
    DELETED, staying in is MODIFIED; None = out of scope throughout.
    Stateless, so replayed and live events classify identically. Shared by
    the HTTP apiserver's watch handler and FakeCluster.watch — the
    server-side selector evaluation that keeps scoped watch streams (and
    hub scopes riding them) carrying only in-scope bytes.
    ``fields`` is a :class:`~.selectors.FieldSelector`."""

    def in_scope(obj: Mapping[str, Any]) -> bool:
        meta = obj.get("metadata") or {}
        return selector.matches(meta.get("labels") or {}) and fields.matches(
            obj
        )

    new_matches = event_type != _WATCH_DELETED and in_scope(data)
    old_matches = old is not None and in_scope(old)
    if new_matches and old_matches:
        return _WATCH_MODIFIED
    if new_matches:
        return _WATCH_ADDED
    if old_matches:
        return _WATCH_DELETED
    return None


class WatchFrameSource:
    """The frame source behind a watch stream — everything between the
    cluster's raw event journal and one consumer's ordered frames:
    static scoping (kind + namespace, applied before an event is ever
    queued), journal replay from a resumption ``resourceVersion``,
    selector-scope classification (``classify_watch_event``), and the
    BOOKMARK payload contract. Shared by ``FakeCluster.watch`` (the
    in-process sync generator) and the HTTP apiserver's streaming watch
    (which bridges ``emit`` into its event loop) so both speak one
    protocol — a frame the wire stream sends is byte-for-byte the frame
    the in-process watch would have yielded.

    Usage: ``open(emit, resource_version)`` subscribes and returns the
    classified replay frames; live events arrive through ``emit(
    event_type, data, old)`` (called from the WRITER's thread — keep it
    to an enqueue) and are classified consumer-side via ``classify``;
    ``bookmark()`` builds the resume-point frame; ``close()``
    unsubscribes (idempotent)."""

    def __init__(
        self,
        cluster: "FakeCluster",
        kind: str,
        api_version: str,
        namespace: str = "",
        label_selector: Optional[str | Mapping[str, str]] = None,
        field_selector: Optional[str] = None,
    ) -> None:
        self._cluster = cluster
        self.kind = kind
        self.api_version = api_version
        self.namespace = namespace
        if isinstance(label_selector, Mapping):
            self._selector = LabelSelector.from_match_labels(label_selector)
        else:
            self._selector = parse_selector(label_selector)
        self._fields = parse_field_selector(field_selector)
        self._on_event: Optional[Callable] = None

    def in_static_scope(self, data: Mapping[str, Any]) -> bool:
        """The cheap pre-queue filter: kind and namespace only. Selector
        scope needs old-vs-new classification and happens consumer-side
        (``classify``), off the writer's emit path."""
        if data.get("kind") != self.kind:
            return False
        if self.namespace:
            meta = data.get("metadata") or {}
            if meta.get("namespace", "") != self.namespace:
                return False
        return True

    def open(
        self,
        emit: Callable[[str, dict[str, Any], Optional[dict[str, Any]]], None],
        resource_version: Optional[str] = None,
    ) -> list[tuple[str, dict[str, Any]]]:
        """Subscribe ``emit`` for live events (statically pre-scoped) and
        return the classified journal replay since ``resource_version``
        — atomically, so no event between replay and subscription can be
        lost (``subscribe_since``'s contract). Raises
        ``WatchExpiredError`` when the revision fell out of the journal."""

        def on_event(event_type, data, old):
            if self.in_static_scope(data):
                emit(event_type, data, old)

        replay = self._cluster.subscribe_since(on_event, resource_version)
        self._on_event = on_event
        mapped: list[tuple[str, dict[str, Any]]] = []
        for event_type, data, old in replay:
            if not self.in_static_scope(data):
                continue
            frame = self.classify(event_type, data, old)
            if frame is not None:
                mapped.append((frame, data))
        return mapped

    def classify(
        self,
        event_type: str,
        data: Mapping[str, Any],
        old: Optional[Mapping[str, Any]],
    ) -> Optional[str]:
        """Selector-scope classification for one queued event; None =
        out of scope (drop the frame)."""
        return classify_watch_event(
            event_type, data, old, self._selector, self._fields
        )

    def bookmark(self) -> tuple[str, dict[str, Any]]:
        """The BOOKMARK frame: an object of the watched kind carrying
        ONLY ``metadata.resourceVersion`` (the real server's bookmark
        payload). The rv must be read BEFORE the caller re-checks queue
        emptiness — ``_emit`` bumps the rv and enqueues under one lock
        hold, so an rv observed here implies its event is already
        enqueued, and an empty queue then implies it was delivered."""
        return "BOOKMARK", {
            "kind": self.kind,
            "apiVersion": self.api_version,
            "metadata": {
                "resourceVersion": self._cluster.current_resource_version()
            },
        }

    def close(self) -> None:
        on_event = self._on_event
        if on_event is not None:
            self._on_event = None
            self._cluster.unsubscribe(on_event)


class FakeCluster(ClientBase):
    """Thread-safe in-memory object store with apiserver semantics."""

    def __init__(
        self,
        auto_establish_crds: bool = True,
        crd_establish_delay: float = 0.0,
        crd_discovery_delay: float = 0.0,
        enable_owner_gc: bool = True,
    ) -> None:
        self._lock = threading.RLock()
        self._store: dict[tuple[str, str, str], dict[str, Any]] = {}
        #: Kind-bucketed mirror of ``_store`` so list/deleteCollection
        #: scan O(kind bucket) instead of the whole store — the
        #: difference between O(pool) and O(cluster) per list at
        #: 256-node scale. Maintained ONLY via _store_put/_store_del;
        #: ``_store`` stays the source of truth (tests introspect it).
        self._by_kind: dict[str, dict[tuple[str, str, str], dict[str, Any]]] = {}
        #: Owner-reference GC index: owner uid -> keys of (possible)
        #: dependents, with the reverse map for cheap diffs. Synced on
        #: every persisted write (_bump) and on delete — turns the GC's
        #: whole-store dependent scan into an O(dependents) lookup.
        self._owner_index: dict[str, set[tuple[str, str, str]]] = {}
        self._owners_of: dict[tuple[str, str, str], frozenset[str]] = {}
        #: Keys whose object is foreground-terminating (deletionTimestamp
        #: set + ``foregroundDeletion`` finalizer) — the only objects the
        #: GC sweep must visit. Maintained by _store_put/_store_del, the
        #: choke points every store change flows through under the
        #: copy-on-write write discipline; turns the per-delete sweep
        #: from O(store) into O(pending), which is almost always O(0).
        self._fg_pending: set[tuple[str, str, str]] = set()
        self._rv = itertools.count(1)
        self._reactors: list[tuple[str, str, Reactor]] = []
        self._watchers: list[
            Callable[[str, dict[str, Any], Optional[dict[str, Any]]], None]
        ] = []
        # Bounded event journal for watch resumption: (rv, event, object).
        # A watcher resuming from a resourceVersion older than the oldest
        # entry gets a 410 Gone analog (WatchExpiredError), like etcd.
        self._history: deque[
            tuple[int, str, dict[str, Any], Optional[dict[str, Any]]]
        ] = deque(maxlen=4096)
        self._changed = threading.Condition(self._lock)
        self._generation = 0
        # Paginated-list continuations: token id -> (item raws, revision,
        # expiry info). A real apiserver serves every page of one list
        # from the SAME storage snapshot and answers a stale/compacted
        # continue token with 410 reason=Expired; this bounded FIFO cache
        # reproduces both behaviors (eviction = compaction).
        # Owner-reference garbage collection (real-cluster semantics; the
        # reference's envtest runs NO controller-manager, so cascade
        # deletion never happens there — pass False to emulate that).
        self._enable_owner_gc = enable_owner_gc
        self._continues: dict[
            str,
            tuple[list[dict[str, Any]], str, tuple[str, str, str, str]],
        ] = {}
        self._continue_order: deque[str] = deque()
        self._continue_cap = 32
        # Emulate the apiserver's CRD controller: created CRDs gain the
        # Established condition (immediately, or after a delay to exercise
        # wait-for-established logic, reference: pkg/crdutil/crdutil.go:275-319).
        self._auto_establish_crds = auto_establish_crds
        # Sticky flag: set on the first CRD entering the store, never
        # cleared (deletes are rare; a stale True only costs the scan).
        # Lets the admission fallback skip an O(store) scan per custom
        # write on the common schema-less cluster.
        self._crds_ever_stored = False
        self._crd_establish_delay = crd_establish_delay
        # The real apiserver's Established-but-undiscoverable window: a
        # CRD's condition flips before its served versions appear in the
        # discovery document (the race pkg/crdutil/crdutil.go:275-319
        # polls discovery to guard against). >0 reproduces that window.
        self._crd_discovery_delay = crd_discovery_delay
        self._discoverable: dict[str, set[str]] = {}
        #: CRD names with a discovery timer in flight — every CRD write
        #: path runs the discoverability sync, and without this guard a
        #: busy write stream would stack redundant timers per name.
        self._discovery_pending: set[str] = set()
        self._pending_timers: list[threading.Timer] = []
        #: Optional API call log (see start_call_log): (verb, kind, name)
        #: per client call, appended under the store lock. Benches and
        #: tests count traffic with it — load-immune, unlike wall-clock.
        self._call_log: Optional[list[tuple[str, str, str]]] = None

    # -- fault injection ---------------------------------------------------
    def add_reactor(self, verb: str, kind: str, fn: Reactor) -> None:
        """Install a hook run before ``verb`` ("*" matches all) on ``kind``."""
        self._reactors.append((verb, kind, fn))

    # -- call log ----------------------------------------------------------
    def start_call_log(self) -> list[tuple[str, str, str]]:
        """Begin recording every API call as ``(verb, kind, name)`` and
        return the LIVE list (it keeps growing until stop_call_log).
        Restarting truncates. The log records calls the fake *received* —
        including ones a reactor then failed."""
        with self._lock:
            self._call_log = []
            return self._call_log

    def stop_call_log(self) -> list[tuple[str, str, str]]:
        """Stop recording; returns the captured log (empty if never
        started)."""
        with self._lock:
            log, self._call_log = self._call_log, None
            return log if log is not None else []

    def _react(self, verb: str, kind: str, payload: dict[str, Any]) -> None:
        if self._call_log is not None:
            name = payload.get("name") or (
                (payload.get("metadata") or {}).get("name", "")
            )
            self._call_log.append((verb, kind, str(name)))
        for v, k, fn in self._reactors:
            if v in ("*", verb) and k in ("*", kind):
                fn(verb, kind, payload)

    # -- watch -------------------------------------------------------------
    def subscribe(
        self, fn: Callable[[str, dict[str, Any], Optional[dict[str, Any]]], None]
    ) -> None:
        """Register a watcher receiving ``(event_type, object, old_object)``
        on every write — ``old_object`` is the pre-mutation state (None for
        ADDED), which is what lets selector-scoped watches classify
        transitions exactly as the real watch cache does.

        Delivered objects are FROZEN journal references (see ``_emit``):
        read-only by contract. ``watch()`` yields these same frozen
        references (zero copies per delivered event); any consumer that
        hands them to code which may mutate must copy first — the
        informer does so on its own reads, not at delivery."""
        with self._lock:
            self._watchers.append(fn)

    def unsubscribe(self, fn) -> None:
        """Remove a subscribed watcher (no-op when absent — a watch may be
        torn down from a thread racing the subscription)."""
        with self._lock:
            try:
                self._watchers.remove(fn)
            except ValueError:
                pass

    def subscribe_since(
        self,
        fn: Callable[[str, dict[str, Any]], None],
        resource_version: Optional[str] = None,
    ) -> list[tuple[str, dict[str, Any]]]:
        """Atomically subscribe and return the journal entries newer than
        ``resource_version`` — the list-then-watch resumption primitive: no
        event between the caller's list and this subscription can be lost,
        because replay collection and watcher registration happen under the
        same lock every mutation holds while emitting.

        Raises :class:`WatchExpiredError` when ``resource_version`` is
        older than the journal's oldest entry (the 410 Gone analog —
        the client must re-list).
        """
        with self._lock:
            replay: list[tuple[str, dict[str, Any], Optional[dict[str, Any]]]] = []
            if resource_version is not None and resource_version != "":
                try:
                    since = int(resource_version)
                except ValueError:
                    raise InvalidError(
                        f"invalid resourceVersion {resource_version!r}"
                    ) from None
                if self._history and self._history[0][0] > since + 1:
                    raise WatchExpiredError(
                        f"resourceVersion {since} is too old "
                        f"(oldest journaled: {self._history[0][0]})"
                    )
                last_rv = getattr(self, "_last_rv", 0)
                if not self._history and since < last_rv:
                    # Journal fully compacted: nothing to replay, but the
                    # cluster has moved past the caller's revision, so
                    # events WERE lost. Resuming live here would silently
                    # drop them — the real apiserver answers 410 Gone and
                    # the client re-lists (the exact repair the informer's
                    # relist-after-expiry path implements).
                    raise WatchExpiredError(
                        f"resourceVersion {since} is too old "
                        f"(journal compacted; current: {last_rv})"
                    )
                # Journal entries are frozen (copy-on-write store): replay
                # hands out references under the same read-only contract
                # live delivery uses — no per-entry copy on informer resume.
                replay = [
                    (event, data, old)
                    for rv, event, data, old in self._history
                    if rv > since
                ]
            self._watchers.append(fn)
            return replay

    def watch(
        self,
        kind: str,
        namespace: str = "",
        label_selector: Optional[str | Mapping[str, str]] = None,
        field_selector: Optional[str] = None,
        timeout_seconds: Optional[int] = None,
        resource_version: Optional[str] = None,
        handle=None,
        allow_bookmarks: bool = False,
        bookmark_interval_s: float = 15.0,
    ):
        """In-process watch generator with the same semantics as
        ``RestClient.watch`` against the HTTP apiserver: journal resumption
        from ``resource_version``, selector-scope transitions via
        old-vs-new classification, ``timeout_seconds`` ending the stream.
        ``handle`` accepts a ``WatchHandle``-shaped object; its
        ``cancelled`` flag ends the stream at the next poll tick.
        ``timeout_seconds=None`` applies the same default window as
        RestClient (DEFAULT_WATCH_TIMEOUT_SECONDS) — code tested against
        the fake must see the real client's bounded-stream behavior.
        ``allow_bookmarks`` opts into periodic BOOKMARK events carrying
        only the current collection resourceVersion (the real server's
        watch-bookmark contract): a quiet scoped watch keeps a fresh
        resume point while the shared journal advances under it, instead
        of decaying toward 410 + full re-list."""
        import queue

        if timeout_seconds is None:
            from .rest import DEFAULT_WATCH_TIMEOUT_SECONDS

            timeout_seconds = DEFAULT_WATCH_TIMEOUT_SECONDS

        source = WatchFrameSource(
            self,
            kind,
            KINDS.get(kind, KubeObject).API_VERSION or "v1",
            namespace=namespace,
            label_selector=label_selector,
            field_selector=field_selector,
        )
        events: queue.Queue = queue.Queue(maxsize=1024)

        def emit(event_type, data, old):
            try:
                events.put_nowait((event_type, data, old))
            except queue.Full:
                pass  # in-process consumer this slow has bigger problems

        replay = source.open(emit, resource_version)
        try:
            for mapped, data in replay:
                # Yielded objects are frozen journal references (see
                # _emit) — read-only by contract, same as the shared
                # snapshot every consumer of this generator always
                # got. The informer rides on this: zero copies per
                # delivered event; its own reads copy on the way out.
                yield mapped, wrap(data)
            deadline = (
                time.monotonic() + timeout_seconds
                if timeout_seconds is not None
                else None
            )
            next_bookmark = time.monotonic() + bookmark_interval_s
            while not (handle is not None and handle.cancelled):
                if deadline is not None:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        return
                    poll = min(0.2, remaining)
                else:
                    poll = 0.2
                if allow_bookmarks:
                    poll = min(
                        poll, max(0.01, next_bookmark - time.monotonic())
                    )
                try:
                    event_type, data, old = events.get(timeout=poll)
                except queue.Empty:
                    # Bookmark only from a DRAINED queue — the contract is
                    # "every event up to this rv has been delivered"; see
                    # WatchFrameSource.bookmark for the rv-before-recheck
                    # ordering this leans on.
                    if allow_bookmarks and time.monotonic() >= next_bookmark:
                        frame, data = source.bookmark()
                        if events.empty():
                            next_bookmark = (
                                time.monotonic() + bookmark_interval_s
                            )
                            yield frame, wrap(data)
                    continue
                mapped = source.classify(event_type, data, old)
                if mapped is not None:
                    yield mapped, wrap(data)
        finally:
            source.close()

    def _emit(
        self,
        event: str,
        data: dict[str, Any],
        old: Optional[dict[str, Any]] = None,
    ) -> None:
        # Ownership contract (the copy-on-write store discipline): a dict
        # is FROZEN the moment it is stored or emitted — every mutating
        # path works on a private copy and swaps it in via _store_put, so
        # the journal and the subscribers can take both ``data`` (the
        # just-stored object) and ``old`` (the previously-stored object,
        # or the caller's private pre-delete copy) by reference instead
        # of paying a whole-object copy per write. (An old shared by two
        # journal entries — a releasing write's MODIFIED + its DELETED —
        # stays correct for the same reason: nothing mutates it.)
        snapshot = data
        old_snapshot = old
        if old_snapshot is None and event != _WATCH_ADDED:
            # DELETED with no explicit prior: the object itself is the
            # pre-deletion state.
            old_snapshot = snapshot if event == _WATCH_DELETED else None
        try:
            rv = int((snapshot.get("metadata") or {}).get("resourceVersion"))
        except (TypeError, ValueError):
            rv = next(self._rv)  # defensive: journal stays ordered
        # Trace write-origin hook (docs/tracing.md): remember which trace
        # performed this write, keyed by rv. Informer deliveries — over a
        # direct watch, a hub resume replay, or a reconnected wire stream
        # alike — link their span to it, so a reconcile pass can be
        # traced back to the write that woke it. One global read when
        # tracing is off.
        tracing.record_write_origin(rv)
        self._history.append((rv, event, snapshot, old_snapshot))
        for fn in list(self._watchers):
            fn(event, snapshot, old_snapshot)
        with self._changed:
            self._generation += 1
            self._changed.notify_all()

    @property
    def generation(self) -> int:
        """Monotonic write counter; compare across calls to detect changes
        without relying on notification delivery."""
        with self._changed:
            return self._generation

    def wait_for_change(self, timeout: float, after_generation: int = -1) -> int:
        """Block until the write generation exceeds ``after_generation`` (or
        the timeout elapses) and return the current generation. Immune to
        lost notifications: callers track the generation they last saw."""
        deadline = time.monotonic() + timeout
        with self._changed:
            while self._generation <= after_generation:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                self._changed.wait(remaining)
            return self._generation

    # -- helpers -----------------------------------------------------------
    @staticmethod
    def _key(kind: str, namespace: str, name: str) -> tuple[str, str, str]:
        cls = KINDS.get(kind)
        if cls is not None and not cls.NAMESPACED:
            namespace = ""
        return (kind, namespace, name)

    def _bump(self, data: dict[str, Any]) -> None:
        # Revision assignment only: index maintenance lives in
        # _store_put, which every persisted write now reaches (the
        # copy-on-write discipline swaps a fresh dict in per mutation).
        # Deletes _bump a private copy after _store_del — nothing to
        # index there.
        self._last_rv = next(self._rv)
        meta = data.setdefault("metadata", {})
        meta["resourceVersion"] = str(self._last_rv)

    def _sync_owner_index(
        self, key: tuple[str, str, str], data: dict[str, Any]
    ) -> None:
        """Diff the object's ownerReferences into the GC index; caller
        holds the lock."""
        refs = (data.get("metadata") or {}).get("ownerReferences") or []
        new_owners = frozenset(
            r.get("uid") for r in refs if r.get("uid")
        )
        old_owners = self._owners_of.get(key, frozenset())
        if new_owners == old_owners:
            return
        for uid in old_owners - new_owners:
            bucket = self._owner_index.get(uid)
            if bucket is not None:
                bucket.discard(key)
                if not bucket:
                    del self._owner_index[uid]
        for uid in new_owners - old_owners:
            self._owner_index.setdefault(uid, set()).add(key)
        if new_owners:
            self._owners_of[key] = new_owners
        else:
            self._owners_of.pop(key, None)

    @staticmethod
    def _spec_view(data: Mapping[str, Any]) -> dict[str, Any]:
        """Everything outside metadata/status — what generation tracks."""
        return {
            k: v for k, v in data.items() if k not in ("metadata", "status")
        }

    def _sync_generation(
        self, data: dict[str, Any], old: Optional[Mapping[str, Any]]
    ) -> None:
        """metadata.generation is server-owned: 1 on create, +1 whenever
        the desired state (anything outside metadata/status) changes,
        never on status-only writes. One uniform rule for every kind —
        the modern apiserver behavior (CRs with a status subresource,
        apps types); legacy core types that skip generation entirely are
        deliberately not special-cased (PARITY)."""
        meta = data.setdefault("metadata", {})
        if old is None:
            meta["generation"] = 1
            return
        previous = (old.get("metadata") or {}).get("generation", 1)
        if self._spec_view(data) != self._spec_view(old):
            meta["generation"] = previous + 1
        else:
            meta["generation"] = previous

    # -- structural-schema admission (custom resources) --------------------
    def _admit_custom_locked(
        self, data: dict[str, Any], status_only: bool = False
    ) -> None:
        """The apiserver's CR admission: when a stored CRD carries a
        structural schema for this object's group/kind/version, prune
        unknown fields, apply defaults, and validate — 422 on violation.
        Built-in groups and kinds with no stored CRD are untouched, so a
        schema-less cluster behaves exactly as before (the same
        activation rule server-side apply uses)."""
        if data.get("kind") == "CustomResourceDefinition":
            # The CRD itself is admitted too: upstream rejects v1 CRDs
            # whose declared schemas are not structural. Runs at this
            # one chokepoint so every write verb (and its atomicity
            # handling) covers it.
            crd_errors = validate_crd_structural(data)
            if crd_errors:
                name = (data.get("metadata") or {}).get("name", "")
                raise InvalidError(
                    f"CustomResourceDefinition.apiextensions.k8s.io "
                    f"{name!r} is invalid: " + "; ".join(crd_errors)
                )
            return
        if _supports_strategic(data):
            return  # built-in group: typed, never CRD-backed
        api_version = data.get("apiVersion") or ""
        group, _, version = api_version.rpartition("/")
        kind = data.get("kind", "")
        crd = self._crd_for_locked(group, kind)
        if crd is None:
            return
        schema = schema_for_crd_version(crd, version)
        if schema is None:
            return
        errors = schema.admit(data)
        if status_only:
            # ValidateStatusUpdate shape: a status write is judged on
            # its status only — a spec that predates a tightened CRD
            # must not wedge the status-writing controller. Exact root
            # field match: a spec field named "statusHistory" is not
            # "status".
            errors = [
                e for e in errors if error_root_field(e) == "status"
            ]
        if errors:
            name = (data.get("metadata") or {}).get("name", "")
            raise InvalidError(
                f"{kind}.{group} {name!r} is invalid: " + "; ".join(errors)
            )

    def _crd_for_locked(self, group: str, kind: str):
        """The stored CRD backing ``group``/``kind``, or None. Direct
        keyed lookup via the resource registry's plural first; stored
        CRDs themselves are the authoritative fallback mapping for
        unregistered or irregularly-pluralized kinds."""
        try:
            plural = resource_for_kind(kind).plural
        except KeyError:
            pass
        else:
            crd = self._store.get(
                ("CustomResourceDefinition", "", f"{plural}.{group}")
            )
            if crd is not None:
                return crd
        if not self._crds_ever_stored:
            return None  # schema-less cluster: skip the store scan
        for key, stored in self._store.items():
            if key[0] != "CustomResourceDefinition":
                continue
            spec = stored.get("spec") or {}
            if spec.get("group") == group and (
                (spec.get("names") or {}).get("kind") == kind
            ):
                return stored
        return None

    def printer_columns(
        self, kind: str, api_version: str
    ) -> Optional[list[dict[str, Any]]]:
        """The ``additionalPrinterColumns`` a stored CRD declares for
        this kind's served version — what the Table transform renders
        (reference fixture: hack/crd/bases/maintenance.nvidia.com_
        nodemaintenances.yaml:17-31). None for built-ins or unknown
        kinds."""
        group, _, version = api_version.rpartition("/")
        if not group:
            return None
        with self._lock:
            crd = self._crd_for_locked(group, kind)
            if crd is None:
                return None
            for v in (crd.get("spec") or {}).get("versions") or []:
                if v.get("name") == version:
                    cols = v.get("additionalPrinterColumns") or []
                    return deep_copy_json(cols)
        return None

    def current_resource_version(self) -> str:
        """The newest revision assigned — a list's collection
        resourceVersion (what an empty list resumes a watch from).

        Taken UNDER the store lock: a writer assigns the rv (_bump) and
        enqueues the event to watchers (_emit) in one lock hold, so a
        locked read serializes after the whole write — an rv observed
        here implies its event was already delivered to subscriber
        queues. The bookmark path's drained-queue check rides on exactly
        that ordering; a lock-free peek could see the rv of a write
        whose event was still pending and stamp a bookmark that
        overtakes it."""
        with self._lock:
            return str(getattr(self, "_last_rv", 0))

    def _store_put(
        self, key: tuple[str, str, str], data: dict[str, Any]
    ) -> None:
        """Store insert/replace + index maintenance; caller holds the
        lock. Under the copy-on-write write discipline every store
        change flows through here (mutating paths swap in a fresh dict
        rather than editing the stored one), which makes this the single
        place the owner-GC and foreground-pending indexes stay synced."""
        self._store[key] = data
        self._by_kind.setdefault(key[0], {})[key] = data
        self._sync_owner_index(key, data)
        meta = data.get("metadata") or {}
        if meta.get("deletionTimestamp") and "foregroundDeletion" in (
            meta.get("finalizers") or []
        ):
            self._fg_pending.add(key)
        else:
            self._fg_pending.discard(key)

    def _store_del(self, key: tuple[str, str, str]) -> None:
        """Store delete + kind/owner-index maintenance; caller holds
        the lock."""
        self._fg_pending.discard(key)
        del self._store[key]
        bucket = self._by_kind.get(key[0])
        if bucket is not None:
            bucket.pop(key, None)
        for uid in self._owners_of.pop(key, frozenset()):
            owner_bucket = self._owner_index.get(uid)
            if owner_bucket is not None:
                owner_bucket.discard(key)
                if not owner_bucket:
                    del self._owner_index[uid]

    # -- read-only fast paths (simulators / benches) -----------------------
    # These skip the defensive copy, NOT the API semantics: they still run
    # reactors (fault injection sees them) and the call log records them,
    # so a simulated kubelet on the fast path stays subject to the same
    # injected chaos as one on get()/list().
    def contains(self, kind: str, name: str, namespace: str = "") -> bool:
        """Existence check without the defensive copy ``get`` makes —
        the kubelet simulator's per-node per-tick probe."""
        with self._lock:
            self._react("get", kind, {"name": name, "namespace": namespace})
            return self._key(kind, namespace, name) in self._store

    def object_names(self, kind: str, namespace: str = "") -> list[str]:
        """Sorted names of stored objects of ``kind`` (no copies)."""
        with self._lock:
            self._react("list", kind, {"namespace": namespace})
            return sorted(
                name
                for (_, ns, name) in self._by_kind.get(kind, {})
                if not namespace or ns == namespace
            )

    def peek(
        self, kind: str, name: str, namespace: str = ""
    ) -> Optional[dict[str, Any]]:
        """The RAW stored object, no copy, or None. STRICTLY read-only:
        mutating the return value corrupts the store — this exists for
        simulators and benches whose per-tick reads would otherwise copy
        the whole pool; API consumers use get()/list()."""
        with self._lock:
            self._react("get", kind, {"name": name, "namespace": namespace})
            return self._store.get(self._key(kind, namespace, name))

    def list_peek(
        self,
        kind: str,
        namespace: str = "",
        label_selector: Optional[str | Mapping[str, str]] = None,
    ) -> list[dict[str, Any]]:
        """RAW stored objects of ``kind``, filtered like ``list``, no
        copies. STRICTLY read-only (``peek``'s contract) — with one
        guarantee the copy-on-write store adds: the returned dicts are
        frozen (a later write swaps in a fresh dict instead of editing
        these), so the result is a consistent point-in-time snapshot,
        not a live view. The snapshot source serves build_state's
        Pod/DaemonSet/ControllerRevision reads from this — kinds the
        upgrade managers never mutate — skipping one whole-object copy
        per object per reconcile pass. Anything that mutates results
        uses list()."""
        if isinstance(label_selector, Mapping):
            selector = LabelSelector.from_match_labels(label_selector)
        else:
            selector = parse_selector(label_selector)
        with self._lock:
            self._react("list", kind, {"namespace": namespace})
            out = []
            for (_, ns, _name), data in sorted(
                self._by_kind.get(kind, {}).items()
            ):
                if namespace and ns != namespace:
                    continue
                labels = (data.get("metadata") or {}).get("labels") or {}
                if selector.matches(labels):
                    out.append(data)
            return out

    def _get_raw(self, kind: str, name: str, namespace: str) -> dict[str, Any]:
        key = self._key(kind, namespace, name)
        data = self._store.get(key)
        if data is None:
            raise NotFoundError(f"{kind} {namespace}/{name} not found")
        return data

    @staticmethod
    def _write_becomes_delete(data: dict[str, Any]) -> bool:
        """True when this write empties a terminating object's finalizer
        list: on a real apiserver that update IS the deletion — watchers
        observe one DELETED, never a MODIFIED for the releasing write
        (pinned by the watch vectors in tests/conformance_vectors/)."""
        meta = data.get("metadata", {})
        return bool(meta.get("deletionTimestamp")) and not meta.get(
            "finalizers"
        )

    def _finalize_delete_if_due(
        self, kind: str, name: str, namespace: str, old=None
    ) -> None:
        """Remove a deletionTimestamp-marked object once finalizers are
        gone. Caller holds the lock. ``old`` is the pre-write snapshot of
        the releasing write: its MODIFIED event was suppressed (the write
        IS the deletion, see _write_becomes_delete), so the DELETED event
        must carry the pre-write state or a label-selector watcher whose
        object left scope in that same write would classify the event
        away."""
        key = self._key(kind, namespace, name)
        data = self._store.get(key)
        if data is None:
            return
        meta = data.get("metadata", {})
        if meta.get("deletionTimestamp") and not meta.get("finalizers"):
            self._store_del(key)
            if kind == "CustomResourceDefinition":
                self._discoverable.pop(name, None)
            # The real apiserver bumps rv on delete; without it the
            # DELETED journal entry reuses the object's last revision and
            # a watch resuming from exactly that revision replays PAST the
            # deletion — a lost event. The bump mutates, so it lands on a
            # private copy (the released dict is already journaled).
            data = deep_copy_json(data)
            self._bump(data)
            self._emit(_WATCH_DELETED, data, old=old)
            # A finalizer-released object is as gone as a direct delete:
            # its dependents are collected, and any Foreground owner
            # waiting on IT gets re-checked.
            if self._enable_owner_gc and meta.get("uid"):
                self._gc_on_owner_removed(meta["uid"])

    # -- Client API --------------------------------------------------------
    def get(self, kind: str, name: str, namespace: str = "") -> KubeObject:
        with self._lock:
            self._react("get", kind, {"name": name, "namespace": namespace})
            return wrap(deep_copy_json(self._get_raw(kind, name, namespace)))

    def list(
        self,
        kind: str,
        namespace: str = "",
        label_selector: Optional[str | Mapping[str, str]] = None,
        field_selector: Optional[str] = None,
    ) -> list[KubeObject]:
        if isinstance(label_selector, Mapping):
            selector = LabelSelector.from_match_labels(label_selector)
        else:
            selector = parse_selector(label_selector)
        fields = parse_field_selector(field_selector)
        with self._lock:
            self._react("list", kind, {"namespace": namespace})
            out = []
            bucket = self._by_kind.get(kind, {})
            for (_, ns, _name), data in sorted(bucket.items()):
                if namespace and ns != namespace:
                    continue
                labels = (data.get("metadata") or {}).get("labels") or {}
                if not selector.matches(labels):
                    continue
                if not fields.matches(data):
                    continue
                out.append(wrap(deep_copy_json(data)))
            return out

    def delete_collection(
        self,
        kind: str,
        namespace: str = "",
        label_selector: Optional[str | Mapping[str, str]] = None,
        field_selector: Optional[str] = None,
        propagation_policy: Optional[str] = None,
        dry_run: bool = False,
    ) -> list[KubeObject]:
        """client-go's deleteCollection verb (``kubectl delete --all`` /
        selector-scoped bulk delete): every matching object goes through
        the SAME per-object delete pipeline — finalizers hold objects in
        Terminating, owner-reference GC cascades per
        ``propagation_policy``, dry-run previews without deleting.
        Returns the objects the call addressed (upstream returns the
        deleted items' list)."""
        # Namespacedness from the REST registry first: custom kinds
        # registered via kube.resources.register_resource (the
        # framework's primary CR path) are not in KINDS, and skipping
        # them here silently deleted the kind across ALL namespaces —
        # exactly the over-deletion this guard exists to stop.
        # KINDS stays as the fallback for typed kinds a
        # test may use without registering.
        try:
            namespaced = resource_for_kind(kind).namespaced
        except KeyError:
            cls = KINDS.get(kind)
            namespaced = cls.NAMESPACED if cls is not None else False
        if namespaced and not namespace:
            # A real apiserver serves deletecollection only on the
            # namespaced collection of a namespaced resource — the
            # all-namespaces path answers 405. Refusing here keeps fake
            # -validated code from silently over-deleting cluster-wide.
            raise BadRequestError(
                f"deleteCollection on namespaced kind {kind} requires a "
                "namespace (all-namespaces deletecollection is not served "
                "by a real apiserver)"
            )
        matched = self.list(
            kind, namespace,
            label_selector=label_selector, field_selector=field_selector,
        )
        for obj in matched:
            try:
                self.delete(
                    kind, obj.name, obj.namespace,
                    propagation_policy=propagation_policy,
                    dry_run=dry_run,
                )
            except NotFoundError:
                continue  # raced with another deleter: already gone
        return matched

    def list_with_revision(
        self,
        kind: str,
        namespace: str = "",
        label_selector: Optional[str | Mapping[str, str]] = None,
        field_selector: Optional[str] = None,
    ) -> tuple[list[KubeObject], str]:
        """``list()`` plus the collection resourceVersion, RestClient
        parity (kube/rest.py list_with_revision): the revision an informer
        seeds its watch from, so the documented no-lost-event resumption
        holds over the fake too — including for an empty list, where there
        are no items to take a revision from. Items and revision are read
        under one lock acquisition (RLock) so a concurrent write cannot
        slip between them."""
        with self._lock:
            items = self.list(kind, namespace, label_selector, field_selector)
            return items, self.current_resource_version()

    def list_delta(
        self,
        kind: str,
        since_resource_version: str,
        namespace: str = "",
        label_selector: Optional[str | Mapping[str, str]] = None,
        field_selector: Optional[str] = None,
    ) -> Optional[ListDelta]:
        """Deltas-since-rv LIST (the journal-backed fast re-list,
        docs/wire-path.md): when ``since_resource_version`` is inside
        the event journal, answer the CURRENT state of every in-scope
        object touched after it plus the keys that left the collection
        (or the selector scope) — O(what changed), not O(collection).
        Returns ``None`` when the revision fell out of the journal (the
        410 analog — the HTTP layer answers Gone and the client falls
        back to a full snapshot)."""
        try:
            since = int(since_resource_version)
        except (TypeError, ValueError):
            raise InvalidError(
                f"invalid resourceVersion {since_resource_version!r}"
            ) from None
        if isinstance(label_selector, Mapping):
            selector = LabelSelector.from_match_labels(label_selector)
        else:
            selector = parse_selector(label_selector)
        fields = parse_field_selector(field_selector)
        with self._lock:
            self._react("list", kind, {"namespace": namespace})
            last_rv = getattr(self, "_last_rv", 0)
            # Same coverage rules as watch resumption (subscribe_since):
            # a gap between `since` and the oldest journal entry means
            # events were lost to compaction — only a full list repairs.
            if self._history and self._history[0][0] > since + 1:
                return None
            if not self._history and since < last_rv:
                return None
            touched: dict[tuple[str, str], None] = {}
            for rv, _event, data, _old in self._history:
                if rv <= since or data.get("kind") != kind:
                    continue
                meta = data.get("metadata") or {}
                ns = meta.get("namespace", "")
                if namespace and ns != namespace:
                    continue
                touched[(ns, meta.get("name", ""))] = None
            items: list[KubeObject] = []
            deleted: list[tuple[str, str]] = []
            for ns, name in touched:
                data = self._store.get(self._key(kind, ns, name))
                if data is None:
                    deleted.append((ns, name))
                    continue
                labels = (data.get("metadata") or {}).get("labels") or {}
                if not selector.matches(labels) or not fields.matches(data):
                    # Left the selector scope: for this consumer the
                    # object is gone (a never-matching key deletes a
                    # store entry the consumer never had — a no-op).
                    deleted.append((ns, name))
                    continue
                items.append(wrap(deep_copy_json(data)))
            return ListDelta(items, deleted, str(last_rv))

    def list_page(
        self,
        kind: str,
        namespace: str = "",
        label_selector: Optional[str | Mapping[str, str]] = None,
        field_selector: Optional[str] = None,
        limit: int = 0,
        continue_token: str = "",
    ) -> tuple[list[KubeObject], str, str, Optional[int]]:
        """One page of a chunked list — apiserver ``limit``/``continue``
        semantics (client-go reflectors always paginate; API machinery's
        chunking KEP): every page of one list is served from the SAME
        snapshot taken at the first page, the returned revision is that
        snapshot's collection resourceVersion (what the follow-up watch
        resumes from), and a stale/evicted continue token fails with the
        410 reason=Expired the real apiserver emits after compaction —
        client-go's pager then falls back to a full list, and so does
        ``RestClient``.

        Returns ``(items, revision, next_continue, remaining)`` where
        ``next_continue`` is "" on the final page and ``remaining`` is
        the listMeta remainingItemCount (None on single-page results,
        like the real server omitting the field).
        """
        if limit < 0:
            raise BadRequestError(f"limit must be non-negative, got {limit}")
        # The real server never reports remainingItemCount for
        # selector-filtered chunked lists (ListMeta contract).
        selector_used = bool(label_selector) or bool(field_selector)
        signature = (kind, namespace, str(label_selector or ""),
                     str(field_selector or ""))
        with self._lock:
            if continue_token:
                try:
                    token_id, _, offset_s = continue_token.partition(":")
                    offset = int(offset_s)
                except ValueError:
                    raise BadRequestError(
                        f"malformed continue token {continue_token!r}"
                    ) from None
                if token_id not in self._continues:
                    raise WatchExpiredError(
                        "the provided continue parameter is too old: "
                        "a consistent list is no longer possible"
                    )
                raws, revision, token_sig = self._continues[token_id]
                if offset < 0 or offset > len(raws):
                    # Tampered/corrupt token: a real server answers 400.
                    # (A live token never carries these offsets — the
                    # final page returns no token at all.)
                    raise BadRequestError(
                        f"continue token offset {offset} out of range"
                    )
                if token_sig != signature:
                    # Real apiserver: 400 when a continue key is replayed
                    # against a different resource/selector query.
                    raise BadRequestError(
                        "continue key does not match this request's "
                        f"query (issued for {token_sig!r})"
                    )
            else:
                items, revision = self.list_with_revision(
                    kind, namespace, label_selector, field_selector
                )
                raws = [o.raw for o in items]
                offset = 0
                if limit <= 0 or len(raws) <= limit:
                    return items, revision, "", None
                token_id = uuid.uuid4().hex
                self._continues[token_id] = (raws, revision, signature)
                self._continue_order.append(token_id)
                while len(self._continue_order) > self._continue_cap:
                    self._continues.pop(self._continue_order.popleft(), None)
            if limit <= 0:
                limit = len(raws) - offset
            page = raws[offset : offset + limit]
            next_offset = offset + len(page)
            remaining = len(raws) - next_offset
            if remaining <= 0:
                self._continues.pop(token_id, None)
                return (
                    [wrap(deep_copy_json(r)) for r in page], revision, "", None
                )
            return (
                [wrap(deep_copy_json(r)) for r in page],
                revision,
                f"{token_id}:{next_offset}",
                None if selector_used else remaining,
            )

    def expire_continue_tokens(self) -> None:
        """Test hook: the 'compaction' that invalidates every outstanding
        continue token (subsequent pages answer 410 Expired)."""
        with self._lock:
            self._continues.clear()
            self._continue_order.clear()

    def create(
        self,
        obj: KubeObject,
        field_manager: str = "",
        dry_run: bool = False,
    ) -> KubeObject:
        kind = obj.raw.get("kind", "")
        if not kind or not obj.name:
            raise InvalidError("object must have kind and metadata.name")
        with self._lock:
            self._react("create", kind, obj.raw)
            key = self._key(kind, obj.namespace, obj.name)
            if key in self._store:
                raise AlreadyExistsError(f"{kind} {obj.name} already exists")
            data = deep_copy_json(obj.raw)
            self._admit_custom_locked(data)
            meta = data.setdefault("metadata", {})
            meta.setdefault("uid", _new_uid())
            meta.setdefault("creationTimestamp", time.time())
            if field_manager and not meta.get("managedFields"):
                # An explicitly-managed create owns every field it wrote
                # (operation Update), so a later apply by someone else
                # sees honest conflicts. Creates that already carry
                # managedFields (create-through-apply) keep them.
                reassign_on_write({}, data, field_manager, rfc3339_now())
            self._sync_generation(data, None)
            if dry_run:
                # dryRun=All: the full admission/defaulting pipeline ran;
                # nothing persists, no events, no revision assigned.
                return wrap(deep_copy_json(data))
            self._bump(data)
            self._store_put(key, data)
            self._emit(_WATCH_ADDED, data)
            if kind == "CustomResourceDefinition":
                self._crds_ever_stored = True
                # A re-created CRD must not inherit a predecessor's
                # discoverability (its served versions may differ).
                self._discoverable.pop(obj.name, None)
                if not self._auto_establish_crds:
                    # Manual-controller mode: honor a pre-set condition.
                    self._sync_crd_discoverability_locked(data)
                elif self._crd_establish_delay > 0:
                    timer = threading.Timer(
                        self._crd_establish_delay, self._establish_crd, (obj.name,)
                    )
                    timer.daemon = True
                    self._pending_timers.append(timer)
                    timer.start()
                else:
                    data = self._establish_crd_locked(data)
            return wrap(deep_copy_json(data))

    def _establish_crd_locked(self, data: dict[str, Any]) -> dict[str, Any]:
        """Returns the (possibly replaced) stored dict — copy-on-write
        means establishing swaps in a new object, and callers that go on
        to build a response from ``data`` need the established one."""
        conds = (data.get("status") or {}).get("conditions") or []
        if not any(c.get("type") == "Established" for c in conds):
            old = data
            data = deep_copy_json(old)
            data.setdefault("status", {}).setdefault(
                "conditions", []
            ).append({"type": "Established", "status": "True"})
            key = self._key(
                "CustomResourceDefinition",
                "",
                (data.get("metadata") or {}).get("name", ""),
            )
            self._bump(data)
            self._store_put(key, data)
            self._emit(_WATCH_MODIFIED, data, old=old)
        self._sync_crd_discoverability_locked(data)
        return data

    def _sync_crd_discoverability_locked(self, data: dict[str, Any]) -> None:
        """An Established CRD becomes discoverable after the configured
        window. Runs on every CRD write path — including manual status
        writes with auto-establishment off, so tests that play the CRD
        controller themselves still reach discoverability."""
        crd = CustomResourceDefinition(data)
        if crd.name in self._discoverable:
            return
        self._schedule_discovery_refresh_locked(data)

    def _schedule_discovery_refresh_locked(self, data: dict[str, Any]) -> None:
        """Refresh the CRD's discoverable-version set (after the window).
        Unlike the sync above this runs even when the CRD is already
        discoverable — the path spec UPDATES take, so already-served
        versions stay served through the window (a real apiserver never
        un-serves v1 while v2 establishes) and the set converges to the
        new served list when the window elapses."""
        crd = CustomResourceDefinition(data)
        if not crd.is_established() or crd.name in self._discovery_pending:
            return
        if self._crd_discovery_delay > 0:
            self._discovery_pending.add(crd.name)
            timer = threading.Timer(
                self._crd_discovery_delay, self._make_discoverable, (crd.name,)
            )
            timer.daemon = True
            self._pending_timers.append(timer)
            timer.start()
        else:
            self._make_discoverable_locked(data)

    def _make_discoverable_locked(self, data: dict[str, Any]) -> None:
        crd = CustomResourceDefinition(data)
        self._discoverable[crd.name] = set(crd.served_versions)

    def _make_discoverable(self, name: str) -> None:
        with self._lock:
            self._discovery_pending.discard(name)
            key = self._key("CustomResourceDefinition", "", name)
            data = self._store.get(key)
            if data is not None:
                self._make_discoverable_locked(data)

    def _establish_crd(self, name: str) -> None:
        with self._lock:
            key = self._key("CustomResourceDefinition", "", name)
            data = self._store.get(key)
            if data is not None:
                self._establish_crd_locked(data)

    def discover(self, group: str, version: str) -> list[dict[str, Any]]:
        """APIResourceList entries for ``group/version`` — built-in kinds
        from the resource registry plus established CRDs whose served
        version has become discoverable. NotFoundError while nothing
        serves the group/version, exactly what a real apiserver's 404
        means to a discovery poller."""
        from .resources import _REGISTRY  # registry is the builtin catalog

        gv = f"{group}/{version}" if group else version
        resources: list[dict[str, Any]] = []
        for info in _REGISTRY.values():
            if info.api_version == gv:
                resources.append(
                    {
                        "name": info.plural,
                        "kind": info.kind,
                        "namespaced": info.namespaced,
                    }
                )
        with self._lock:
            for (kind, _, _), data in list(self._store.items()):
                if kind != "CustomResourceDefinition":
                    continue
                crd = CustomResourceDefinition(data)
                if crd.group != group:
                    continue
                if version not in self._discoverable.get(crd.name, ()):
                    continue
                names = crd.spec.get("names") or {}
                resources.append(
                    {
                        "name": names.get("plural", ""),
                        "kind": names.get("kind", ""),
                        "namespaced": crd.spec.get("scope") != "Cluster",
                    }
                )
        if not resources:
            raise NotFoundError(f"no resources discoverable for {gv}")
        return resources

    def _replace(
        self,
        obj: KubeObject,
        status_only: bool,
        field_manager: str = "",
        dry_run: bool = False,
    ) -> KubeObject:
        kind = obj.raw.get("kind", "")
        with self._lock:
            verb = "update_status" if status_only else "update"
            self._react(verb, kind, obj.raw)
            current = self._get_raw(kind, obj.name, obj.namespace)
            sent_rv = obj.resource_version
            if sent_rv and sent_rv != current.get("metadata", {}).get("resourceVersion"):
                raise ConflictError(
                    f"{kind} {obj.name}: resourceVersion {sent_rv} is stale"
                )
            key = self._key(kind, obj.namespace, obj.name)
            # Copy-on-write: ``old`` stays the frozen stored dict; both
            # branches build the replacement privately and swap it in.
            old = current
            if status_only:
                data = deep_copy_json(old)
                data["status"] = deep_copy_json(obj.raw.get("status") or {})
                self._admit_custom_locked(data, status_only=True)
                # statusStrategy semantics: desired state cannot change
                # through the status endpoint — whatever admission
                # pruned/defaulted outside status is restored from the
                # stored object, so generation never moves here.
                for k in [k for k in data
                          if k not in ("metadata", "status")]:
                    del data[k]
                for k, v in old.items():
                    if k not in ("metadata", "status"):
                        data[k] = deep_copy_json(v)
            else:
                data = deep_copy_json(obj.raw)
                # Immutable/server-owned fields survive a replace.
                meta = data.setdefault("metadata", {})
                cur_meta = current.get("metadata", {})
                meta["uid"] = cur_meta.get("uid")
                meta["creationTimestamp"] = cur_meta.get("creationTimestamp")
                if cur_meta.get("deletionTimestamp"):
                    meta["deletionTimestamp"] = cur_meta["deletionTimestamp"]
                # The status subresource is ignored on a main-resource update,
                # as on a real apiserver with subresources enabled.
                if "status" in current:
                    # Deep copy: admission prunes in place, and a rejected
                    # write must not have reached the stored status subtree
                    # through a shared reference.
                    data["status"] = deep_copy_json(current["status"])
                else:
                    data.pop("status", None)
                # Admission before the store swap: a rejected replace
                # must leave the stored object untouched.
                self._admit_custom_locked(data)
            # managedFields is server-owned: ownership moves to the writer
            # for every field this write changed (client-sent managedFields
            # is ignored, like a real apiserver preserving when unset).
            reassign_on_write(
                old,
                data,
                field_manager,
                rfc3339_now(),
                subresource="status" if status_only else "",
            )
            self._sync_generation(data, old)
            if dry_run:
                return wrap(data)
            self._bump(data)
            self._store_put(key, data)
            if not self._write_becomes_delete(data):
                self._emit(_WATCH_MODIFIED, data, old=old)
            if kind == "CustomResourceDefinition":
                if not status_only and self._auto_establish_crds:
                    # An updated CRD stays Established (the real apiserver
                    # re-establishes in place); already-served versions
                    # remain discoverable, and the served set refreshes
                    # to the new spec after the window.
                    data = self._establish_crd_locked(data)
                    self._schedule_discovery_refresh_locked(data)
                else:
                    # Manual-controller mode (or a status write): honor an
                    # Established condition however it got there.
                    self._sync_crd_discoverability_locked(data)
                    if not status_only:
                        self._schedule_discovery_refresh_locked(data)
            self._finalize_delete_if_due(kind, obj.name, obj.namespace, old=old)
            return wrap(deep_copy_json(data))

    def update(
        self,
        obj: KubeObject,
        field_manager: str = "",
        dry_run: bool = False,
    ) -> KubeObject:
        return self._replace(
            obj, status_only=False, field_manager=field_manager,
            dry_run=dry_run,
        )

    def update_status(
        self,
        obj: KubeObject,
        field_manager: str = "",
        dry_run: bool = False,
    ) -> KubeObject:
        return self._replace(
            obj, status_only=True, field_manager=field_manager,
            dry_run=dry_run,
        )

    def patch(
        self,
        kind: str,
        name: str,
        namespace: str = "",
        patch: Optional[Mapping[str, Any] | list[Any]] = None,
        patch_type: str = "merge",
        field_manager: str = "",
        dry_run: bool = False,
    ) -> KubeObject:
        with self._lock:
            # Private payload copy: the merge engines may graft patch
            # subtrees into the object wholesale, and under the frozen-
            # store contract neither the store nor the journal may alias
            # caller memory. Patches are small; the copy is noise next to
            # the whole-object copies it prevents corrupting.
            payload = deep_copy_json(
                patch if isinstance(patch, list) else dict(patch or {})
            )
            self._react("patch", kind, {"name": name, "namespace": namespace,
                                        "patch": payload,
                                        "patch_type": patch_type})
            key = self._key(kind, namespace, name)
            # Copy-on-write: ``old`` stays the frozen stored dict (the
            # journal will take it by reference); all merging/admission
            # below mutates a private copy that is swapped in on success.
            old = self._get_raw(kind, name, namespace)
            current = deep_copy_json(old)
            if patch_type == "strategic" and not _supports_strategic(current):
                # Real-apiserver semantics: strategic merge patch only
                # exists for built-in typed resources (their Go structs
                # carry the patch tags); custom resources answer 415.
                raise UnsupportedMediaTypeError(
                    "strategic merge patch is not supported for custom "
                    f"resources ({current.get('apiVersion', '?')} {kind})"
                )
            if patch_type == "strategic":
                strategic_merge_patch(current, payload)  # type: ignore[arg-type]
            elif patch_type == "merge":
                merge_patch(current, payload)  # type: ignore[arg-type]
            elif patch_type == "json":
                # A non-list patch is a caller bug json_patch rejects
                # with 400 — matching RestClient's client-side guard, so
                # the two backends never diverge on this.
                json_patch(current, payload)
            else:
                raise InvalidError(
                    f"unsupported patch type {patch_type!r} "
                    "(expected 'merge', 'strategic', or 'json')"
                )
            # A patch cannot rename or unscope the object (a real
            # apiserver answers 422 to attempts; restoring is our lenient
            # equivalent, and keeps the stored key and the object's own
            # metadata consistent).
            meta = current.setdefault("metadata", {})
            meta["name"] = name
            old_ns = (old.get("metadata") or {}).get("namespace")
            if old_ns:
                meta["namespace"] = old_ns
            else:
                meta.pop("namespace", None)
            # A rejected write leaves no trace: ``current`` is private,
            # so admission failure just raises — the store was never
            # touched.
            self._admit_custom_locked(current)
            # Ownership follows the write (managedFields is server-owned;
            # a patch cannot rewrite it directly).
            reassign_on_write(old, current, field_manager, rfc3339_now())
            self._sync_generation(current, old)
            if dry_run:
                return wrap(current)
            self._bump(current)
            self._store_put(key, current)
            if not self._write_becomes_delete(current):
                self._emit(_WATCH_MODIFIED, current, old=old)
            if kind == "CustomResourceDefinition":
                self._sync_crd_discoverability_locked(current)
                touched_spec = (
                    any(_jp_op_touches_spec(op) for op in patch)
                    if isinstance(patch, list)
                    else "spec" in (patch or {})
                )
                if touched_spec:
                    # A spec patch can add served versions — existing ones
                    # stay served; the set refreshes after the window
                    # (same as _replace).
                    self._schedule_discovery_refresh_locked(current)
            self._finalize_delete_if_due(kind, name, namespace, old=old)
            return wrap(deep_copy_json(current))

    def apply(
        self,
        obj: KubeObject | Mapping[str, Any],
        field_manager: str,
        force: bool = False,
        dry_run: bool = False,
    ) -> KubeObject:
        """Server-side apply (``application/apply-patch+yaml``): merge the
        manager's declared intent into the live object, tracking field
        ownership in ``metadata.managedFields``. Creates the object when
        absent. Fields the manager declared on a previous apply and omits
        now are removed (unless co-owned); a field owned by another
        manager with a different value raises ConflictError (409, message
        lists the owners) unless ``force`` — the upstream co-management
        contract (kube/ssa.py).
        """
        applied = deep_copy_json(
            obj.raw if isinstance(obj, KubeObject) else dict(obj)
        )
        kind = applied.get("kind", "")
        meta = applied.setdefault("metadata", {})
        name = meta.get("name", "")
        namespace = meta.get("namespace", "")
        if not kind or not name:
            raise InvalidError("apply requires kind and metadata.name")
        if not field_manager:
            raise BadRequestError(
                "fieldManager is required for apply requests"
            )
        # Server-owned bookkeeping a client may have round-tripped never
        # enters the applied intent.
        for f in (
            "uid",
            "resourceVersion",
            "creationTimestamp",
            "generation",
            "selfLink",
            "deletionTimestamp",
        ):
            meta.pop(f, None)
        with self._lock:
            self._react(
                "apply",
                kind,
                {
                    "name": name,
                    "namespace": namespace,
                    "manager": field_manager,
                    "force": force,
                },
            )
            key = self._key(kind, namespace, name)
            now = rfc3339_now()
            if key not in self._store:
                # Create-through-apply: an empty shell takes the full
                # config, then rides the normal create path (uid, rv,
                # watch ADDED, CRD establishment).
                live: dict[str, Any] = {
                    "apiVersion": applied.get("apiVersion"),
                    "kind": kind,
                    "metadata": {"name": name},
                }
                if namespace:
                    live["metadata"]["namespace"] = namespace
                server_side_apply(live, applied, field_manager, force, now)
                return self.create(wrap(live), dry_run=dry_run)
            # Copy-on-write (see patch): merge into a private copy, swap
            # it in on success; the frozen stored dict becomes ``old``.
            old = self._get_raw(kind, name, namespace)
            current = deep_copy_json(old)
            if "status" in current:
                # Main-resource writes never touch the status subresource
                # (same rule as _replace).
                applied.pop("status", None)
            server_side_apply(current, applied, field_manager, force, now)
            # Same identity pinning as patch.
            cur_meta = current.setdefault("metadata", {})
            cur_meta["name"] = name
            old_ns = (old.get("metadata") or {}).get("namespace")
            if old_ns:
                cur_meta["namespace"] = old_ns
            else:
                cur_meta.pop("namespace", None)
            self._admit_custom_locked(current)
            self._sync_generation(current, old)
            if dry_run:
                return wrap(current)
            self._bump(current)
            self._store_put(key, current)
            if not self._write_becomes_delete(current):
                self._emit(_WATCH_MODIFIED, current, old=old)
            if kind == "CustomResourceDefinition":
                self._sync_crd_discoverability_locked(current)
                if "spec" in applied:
                    self._schedule_discovery_refresh_locked(current)
            self._finalize_delete_if_due(kind, name, namespace, old=old)
            return wrap(deep_copy_json(current))

    def delete(
        self,
        kind: str,
        name: str,
        namespace: str = "",
        grace_period_seconds: Optional[int] = None,
        propagation_policy: Optional[str] = None,
        precondition_uid: Optional[str] = None,
        precondition_resource_version: Optional[str] = None,
        dry_run: bool = False,
    ) -> None:
        """Delete with owner-reference garbage collection.

        ``propagation_policy`` follows DeleteOptions: ``Background``
        (default — dependents are collected after the owner goes),
        ``Foreground`` (the owner lingers with the ``foregroundDeletion``
        finalizer until every dependent is gone), ``Orphan`` (dependents
        survive with the owner's reference stripped). The GC controller
        behavior is ON by default like a real cluster — note the
        reference's envtest has NO controller-manager, so there cascade
        deletion never happens; construct
        ``FakeCluster(enable_owner_gc=False)`` to emulate that.

        ``precondition_uid`` / ``precondition_resource_version`` follow
        DeleteOptions.preconditions: a mismatch answers 409 Conflict —
        the guard against deleting a same-named object that was
        deleted-and-recreated (or changed) since it was last read.
        """
        if propagation_policy not in (
            None, "Background", "Foreground", "Orphan"
        ):
            raise BadRequestError(
                f"invalid propagationPolicy {propagation_policy!r}"
            )
        with self._lock:
            self._react("delete", kind, {"name": name, "namespace": namespace})
            key = self._key(kind, namespace, name)
            data = self._get_raw(kind, name, namespace)
            meta = data.get("metadata") or {}
            if (
                precondition_uid is not None
                and meta.get("uid") != precondition_uid
            ):
                raise ConflictError(
                    f"the UID in the precondition ({precondition_uid}) does "
                    f"not match the UID in record ({meta.get('uid')})"
                )
            if (
                precondition_resource_version is not None
                and str(meta.get("resourceVersion"))
                != str(precondition_resource_version)
            ):
                raise ConflictError(
                    "the ResourceVersion in the precondition "
                    f"({precondition_resource_version}) does not match the "
                    f"record ({meta.get('resourceVersion')})"
                )
            if dry_run:
                # Existence and preconditions verified; nothing deleted.
                return
            uid = meta.get("uid", "")
            gc = self._enable_owner_gc and bool(uid)
            policy = propagation_policy or "Background"
            if gc and policy == "Orphan":
                self._gc_orphan_dependents(uid)
                gc = False  # orphaned: nothing to collect afterwards
            dependents = self._gc_dependents(uid) if gc else []
            if gc and policy == "Foreground" and dependents:
                # Copy-on-write: mark the private copy, swap it in.
                old = data
                data = deep_copy_json(old)
                work_meta = data["metadata"]
                changed = False
                if not work_meta.get("deletionTimestamp"):
                    work_meta["deletionTimestamp"] = time.time()
                    changed = True
                finalizers = work_meta.setdefault("finalizers", [])
                # Appended even on an already-terminating owner — the
                # foreground guarantee must hold regardless of which
                # delete marked the timestamp first.
                if "foregroundDeletion" not in finalizers:
                    finalizers.append("foregroundDeletion")
                    changed = True
                if changed:
                    self._bump(data)
                    self._store_put(key, data)
                    self._emit(_WATCH_MODIFIED, data, old=old)
                for dkind, dns, dname in dependents:
                    # Foreground propagates DOWN the chain (the real GC's
                    # rule): a child must in turn wait for ITS blocking
                    # dependents, so an owner can never finalize while a
                    # blocking grandchild survives.
                    self.delete(
                        dkind, dname, dns, propagation_policy="Foreground"
                    )
                self._gc_foreground_sweep()
                return
            if meta.get("finalizers"):
                if not meta.get("deletionTimestamp"):
                    old = data
                    data = deep_copy_json(old)
                    data["metadata"]["deletionTimestamp"] = time.time()
                    self._bump(data)
                    self._store_put(key, data)
                    self._emit(_WATCH_MODIFIED, data, old=old)
                return
            self._store_del(key)
            if kind == "CustomResourceDefinition":
                self._discoverable.pop(name, None)
            # The DELETED event carries a bumped rv (see
            # _finalize_delete_if_due); the bump mutates, so it lands on
            # a private copy — the stored dict may already be journaled.
            data = deep_copy_json(data)
            self._bump(data)
            self._emit(_WATCH_DELETED, data)
            if gc:
                self._gc_on_owner_removed(uid)

    # -- owner-reference garbage collection (real-cluster semantics) ------

    def _gc_dependents(
        self, uid: str, blocking_only: bool = False
    ) -> list[tuple[str, str, str]]:
        """(kind, namespace, name) of every live object referencing uid;
        ``blocking_only`` restricts to references carrying
        ``blockOwnerDeletion: true`` — the only dependents a Foreground
        owner waits for on a real cluster."""
        out = []
        for key in list(self._owner_index.get(uid, ())):
            data = self._store.get(key)
            if data is None:
                continue
            refs = (data.get("metadata") or {}).get("ownerReferences") or []
            if any(
                r.get("uid") == uid
                and (not blocking_only or r.get("blockOwnerDeletion"))
                for r in refs
            ):
                out.append(key)
        return out

    def _gc_orphan_dependents(self, uid: str) -> None:
        for dkind, dns, dname in self._gc_dependents(uid):
            dkey = self._key(dkind, dns, dname)
            dep = self._store.get(dkey)
            if dep is None:
                continue
            old = dep
            dep = deep_copy_json(old)
            meta = dep["metadata"]
            refs = [
                r for r in meta.get("ownerReferences") or []
                if r.get("uid") != uid
            ]
            if refs:
                meta["ownerReferences"] = refs
            else:
                meta.pop("ownerReferences", None)
            self._bump(dep)
            self._store_put(dkey, dep)
            self._emit(_WATCH_MODIFIED, dep, old=old)

    def _gc_on_owner_removed(self, uid: str) -> None:
        """The GC controller's reaction to a vanished owner: a dependent
        with other live owners keeps the object and only drops the
        dangling reference; a dependent owned solely by the vanished
        owner is collected with a plain delete (recursively) — its
        ownerReferences stay intact while it terminates, exactly as a
        real cluster's watch stream shows."""
        for dkind, dns, dname in self._gc_dependents(uid):
            dkey = self._key(dkind, dns, dname)
            dep = self._store.get(dkey)
            if dep is None:
                continue
            refs = [
                r for r in (dep.get("metadata") or {}).get("ownerReferences")
                or []
                if r.get("uid") != uid
            ]
            if refs:
                old = dep
                dep = deep_copy_json(old)
                dep["metadata"]["ownerReferences"] = refs
                self._bump(dep)
                self._store_put(dkey, dep)
                self._emit(_WATCH_MODIFIED, dep, old=old)
            else:
                self.delete(dkind, dname, dns)
        self._gc_foreground_sweep()

    def _gc_foreground_sweep(self) -> None:
        """Release ``foregroundDeletion`` finalizers whose owners have no
        BLOCKING dependents left (``blockOwnerDeletion: true`` — other
        dependents never hold a foreground owner on a real cluster);
        fully-released owners finalize and cascade. Caller holds the
        lock (re-entrant: the cascade re-enters ``delete``). Visits only
        ``_fg_pending`` — the keys _store_put indexed as
        foreground-terminating — so the per-delete cost is O(pending),
        not O(store)."""
        for key in list(self._fg_pending):
            data = self._store.get(key)
            if data is None:
                continue
            meta = data.get("metadata") or {}
            finalizers = meta.get("finalizers") or []
            if (
                "foregroundDeletion" not in finalizers
                or not meta.get("deletionTimestamp")
                or self._gc_dependents(
                    meta.get("uid", ""), blocking_only=True
                )
            ):
                continue
            old = data
            data = deep_copy_json(old)
            meta = data["metadata"]
            finalizers = [f for f in finalizers if f != "foregroundDeletion"]
            if finalizers:
                meta["finalizers"] = finalizers
                self._bump(data)
                self._store_put(key, data)
                self._emit(_WATCH_MODIFIED, data, old=old)
                continue
            meta.pop("finalizers", None)
            kind, _, name = key
            self._store_del(key)
            if kind == "CustomResourceDefinition":
                self._discoverable.pop(name, None)
            self._bump(data)
            self._emit(_WATCH_DELETED, data, old=old)
            if self._enable_owner_gc and meta.get("uid"):
                self._gc_on_owner_removed(meta["uid"])

    def evict(
        self, pod_name: str, namespace: str = "", dry_run: bool = False
    ) -> None:
        with self._lock:
            self._react("evict", "Pod", {"name": pod_name, "namespace": namespace})
            self.delete("Pod", pod_name, namespace, dry_run=dry_run)

    # -- test conveniences -------------------------------------------------
    def close(self) -> None:
        """Cancel pending delayed-establish timers (test teardown hygiene)."""
        for timer in self._pending_timers:
            timer.cancel()
        self._pending_timers.clear()

    def load(self, *objs: KubeObject) -> list[KubeObject]:
        return [self.create(o) for o in objs]

    def __len__(self) -> int:
        with self._lock:
            return len(self._store)
