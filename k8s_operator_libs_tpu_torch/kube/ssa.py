"""Server-side apply: field ownership, conflict detection, managedFields.

The port's copy of the JAX package's ``kube/ssa.py``, with its public
names and its semantics; the merge-key registries it shares with the
strategic engine are the port's own ``kube/fake.py``'s.

The real apiserver's fourth patch flavor (``application/apply-patch+yaml``,
client-go's ``client.Apply`` / ``kubectl apply --server-side``) is how
modern controller-runtime consumers co-manage objects: each manager sends
its *intent* (a partial object), the server tracks which manager owns which
field in ``metadata.managedFields``, removes fields a manager stops
declaring, and refuses (409) to let one manager silently overwrite
another's field unless forced. The reference's consumer operators deploy
onto clusters where this machinery arbitrates every write; envtest gets it
for free from the real apiserver — this module gives FakeCluster /
LocalApiServer the same semantics (structured-merge-diff's behavior,
re-implemented schema-less).

Internal representation: a field set is a ``set`` of leaf *paths*; each
path is a tuple of steps ``("f", name)`` (map field), ``("k", json)``
(keyed-list element, canonical-JSON key), ``("v", json)`` (set-list
member). The wire format is upstream's FieldsV1 (``f:``/``k:``/``v:``
keys, ``.`` marking ownership of a container itself) so managedFields
round-trip through clients unchanged.

Deviations from upstream (documented in PARITY.md): list merge keys come
from the field-name registry shared with the strategic engine (no OpenAPI
schema); writes without an explicit ``field_manager`` on objects that have
never been managed stay untracked (upstream derives a manager name from
the user agent); ``null`` values in an applied config are treated as
omitted; apply targets the main resource (no status apply).
"""

from __future__ import annotations

import copy
import json
from typing import Any, Iterable, Mapping, Optional

from .client import BadRequestError, ConflictError, InvalidError

#: Path step kinds.
_F = "f"  # map field
_K = "k"  # keyed-list element
_V = "v"  # set-list member

Step = tuple[str, str]
Path = tuple[Step, ...]

#: The manager name recorded for writes that did not declare one —
#: mirrors upstream's fallback behavior (it derives something like
#: "Go-http-client" from the user agent; we use a fixed sentinel).
UNKNOWN_MANAGER = "unknown"


def _canon(value: Any) -> str:
    return json.dumps(value, sort_keys=True, separators=(",", ":"))


def _json_equal(a: Any, b: Any) -> bool:
    # Duplicated from fake.py's engine-level helper to avoid an import
    # cycle; JSON-strict (bool is not a number).
    if isinstance(a, bool) != isinstance(b, bool):
        return False
    if isinstance(a, Mapping) and isinstance(b, Mapping):
        return a.keys() == b.keys() and all(_json_equal(a[k], b[k]) for k in a)
    if isinstance(a, list) and isinstance(b, list):
        return len(a) == len(b) and all(map(_json_equal, a, b))
    return a == b


def _registries():
    # Lazy: fake.py owns the merge-key registries (and imports this
    # module's engine); importing at call time breaks the cycle.
    from .fake import _LIST_MERGE_KEYS, _PRIMITIVE_MERGE_FIELDS

    return _LIST_MERGE_KEYS, _PRIMITIVE_MERGE_FIELDS


def _scalar(v: Any) -> bool:
    return not isinstance(v, (Mapping, list))


def _list_mode(field: str, items: list[Any]) -> tuple[str, Optional[str]]:
    """Classify a list field: ("map", key) | ("set", None) | ("atomic", None).

    Mirrors the strategic engine's resolution: keyed lists via the
    field-name registry with ``name`` as the universal fallback, the two
    upstream ``listType=set`` primitive fields as sets, everything else
    atomic (owned and replaced wholesale) — upstream's default for
    untagged/CRD lists.
    """
    merge_keys, primitive_fields = _registries()
    if field in primitive_fields and all(_scalar(i) for i in items):
        return ("set", None)
    if items and all(isinstance(i, Mapping) for i in items):
        for key in merge_keys.get(field, ()) + ("name",):
            if all(key in i for i in items):
                return ("map", key)
    return ("atomic", None)


# ---------------------------------------------------------------------------
# Field-set extraction and the FieldsV1 wire format


#: Identity and server-owned metadata never enters a field set (upstream
#: fieldsets carry a manager's intent — labels, annotations, finalizers,
#: ownerReferences — never the object's coordinates or server bookkeeping).
_SERVER_OWNED_META = frozenset(
    {
        "name",
        "namespace",
        "uid",
        "resourceVersion",
        "creationTimestamp",
        "generation",
        "selfLink",
        "deletionTimestamp",
        "deletionGracePeriodSeconds",
        "managedFields",
    }
)

_META_PREFIX: Path = ((_F, "metadata"),)


def extract_leaves(obj: Mapping[str, Any]) -> dict[Path, Any]:
    """Leaf path -> value for every managed field of ``obj``."""
    out: dict[Path, Any] = {}
    _extract_into(obj, (), out, top=True)
    return out


def _extract_into(
    obj: Mapping[str, Any], prefix: Path, out: dict[Path, Any], top: bool = False
) -> None:
    for field, value in obj.items():
        if top and field in ("apiVersion", "kind"):
            # Type identity, not managed state.
            continue
        if prefix == _META_PREFIX and field in _SERVER_OWNED_META:
            continue
        path = prefix + ((_F, field),)
        _extract_value(field, value, path, out)
    if not obj and prefix:
        out[prefix] = {}


def _extract_value(field: str, value: Any, path: Path, out: dict[Path, Any]) -> None:
    if isinstance(value, Mapping):
        if value:
            _extract_into(value, path, out)
        else:
            out[path] = {}
    elif isinstance(value, list):
        mode, key = _list_mode(field, value)
        if mode == "map":
            for item in value:
                kpath = path + ((_K, _canon({key: item[key]})),)
                if len(item) > 1:
                    _extract_into(item, kpath, out)
                else:
                    out[kpath] = copy.deepcopy(item)
        elif mode == "set":
            for item in value:
                out[path + ((_V, _canon(item)),)] = item
        else:
            out[path] = copy.deepcopy(value)
    else:
        out[path] = copy.deepcopy(value)


def leaves_to_fields_v1(paths: Iterable[Path]) -> dict[str, Any]:
    """Render an internal leaf set in upstream's FieldsV1 wire shape."""
    root: dict[str, Any] = {}
    for path in sorted(paths):
        node = root
        for kind, token in path:
            node = node.setdefault(f"{kind}:{token}", {})
        # A leaf that is also a container for deeper-owned leaves gets the
        # upstream "." self-marker; pure leaves stay {}.
        if node:
            node["."] = {}
    return root


def fields_v1_to_leaves(fv1: Mapping[str, Any]) -> set[Path]:
    out: set[Path] = set()
    _parse_fv1(fv1, (), out)
    return out


def _parse_fv1(node: Mapping[str, Any], prefix: Path, out: set[Path]) -> None:
    children = False
    for key, sub in node.items():
        if key == ".":
            out.add(prefix)
            continue
        kind, _, token = key.partition(":")
        children = True
        _parse_fv1(sub, prefix + ((kind, token),), out)
    if not children and prefix:
        out.add(prefix)


# ---------------------------------------------------------------------------
# Navigation / mutation by path


def value_at(obj: Any, path: Path) -> tuple[bool, Any]:
    cur = obj
    for kind, token in path:
        if kind == _F:
            if not isinstance(cur, Mapping) or token not in cur:
                return (False, None)
            cur = cur[token]
        elif kind == _K:
            if not isinstance(cur, list):
                return (False, None)
            keyd = json.loads(token)
            cur = next(
                (
                    i
                    for i in cur
                    if isinstance(i, Mapping)
                    and all(i.get(k) == v for k, v in keyd.items())
                ),
                None,
            )
            if cur is None:
                return (False, None)
        else:  # _V
            if not isinstance(cur, list):
                return (False, None)
            want = json.loads(token)
            if not any(_json_equal(i, want) for i in cur):
                return (False, None)
            cur = want
    return (True, cur)


def remove_leaf(obj: dict[str, Any], path: Path) -> None:
    """Remove the value at ``path`` (missing = no-op), pruning containers
    left empty along the way — the applier created them, nobody declares
    them anymore."""
    _remove_leaf(obj, path)


def _remove_leaf(cur: Any, path: Path) -> bool:
    """Returns True when ``cur`` became empty and should be pruned."""
    if not path:
        return False
    (kind, token), rest = path[0], path[1:]
    if kind == _F:
        if not isinstance(cur, Mapping) or token not in cur:
            return False
        if rest:
            if _remove_leaf(cur[token], rest):
                del cur[token]
        else:
            del cur[token]
    elif kind == _K:
        if not isinstance(cur, list):
            return False
        keyd = json.loads(token)
        if (
            len(rest) == 1
            and rest[0][0] == _F
            and rest[0][1] in keyd
        ):
            # The merge key is structural: it leaves only WITH the element
            # (the key-only collapse below), never alone — deleting it
            # first would strand a keyless ghost that declassifies the
            # whole list to atomic.
            return False
        for i, item in enumerate(cur):
            if isinstance(item, Mapping) and all(
                item.get(k) == v for k, v in keyd.items()
            ):
                if rest:
                    if _remove_leaf(item, rest) or set(item) == set(keyd):
                        cur.pop(i)
                else:
                    cur.pop(i)
                break
    else:  # _V
        if not isinstance(cur, list):
            return False
        want = json.loads(token)
        cur[:] = [i for i in cur if not _json_equal(i, want)]
    return (isinstance(cur, (Mapping, list)) and not cur)


# ---------------------------------------------------------------------------
# Structural merge of an applied config into the live object


def merge_applied(live: dict[str, Any], applied: Mapping[str, Any]) -> None:
    for field, value in applied.items():
        if value is None:
            # Apply declares intent; null is "not my field" (removal
            # happens via omission + ownership pruning).
            continue
        if isinstance(value, Mapping):
            cur = live.get(field)
            if isinstance(cur, dict):
                merge_applied(cur, value)
            else:
                live[field] = copy.deepcopy(value)
        elif isinstance(value, list):
            live[field] = _merge_list(field, live.get(field), value)
        else:
            live[field] = copy.deepcopy(value)


def _merge_list(field: str, live: Any, applied: list[Any]) -> list[Any]:
    # An empty applied list cannot be classified from its own items —
    # fall back to the live list's shape, so declaring "none of mine"
    # on a keyed list keeps other managers' elements (their removal is
    # ownership pruning's job, never the merge's).
    mode, key = _list_mode(
        field, applied or (live if isinstance(live, list) else [])
    )
    if not isinstance(live, list) or mode == "atomic":
        return copy.deepcopy(applied)
    if mode == "set":
        merged = list(live)
        merged.extend(
            item
            for item in applied
            if not any(_json_equal(item, m) for m in merged)
        )
        return merged
    # keyed: merge by element key, live order first, new elements appended
    merged = copy.deepcopy(live)
    index = {
        item.get(key): i
        for i, item in enumerate(merged)
        if isinstance(item, Mapping)
    }
    for item in applied:
        kval = item.get(key)
        if kval in index:
            target = merged[index[kval]]
            if isinstance(target, Mapping):
                merge_applied(target, item)
            else:
                merged[index[kval]] = copy.deepcopy(item)
        else:
            merged.append(copy.deepcopy(item))
            index[kval] = len(merged) - 1
    return merged


# ---------------------------------------------------------------------------
# managedFields entries (wire shape) <-> internal


class ApplyConflictError(ConflictError):
    """409 carrying the per-field conflict list, upstream-style."""

    def __init__(self, conflicts: list[tuple[str, str]]) -> None:
        self.conflicts = conflicts
        detail = ", ".join(
            f'conflict with "{mgr}": {field}' for mgr, field in conflicts
        )
        n = len(conflicts)
        super().__init__(
            f"Apply failed with {n} conflict{'s' if n != 1 else ''}: {detail}"
        )


def dotted_path(path: Path) -> str:
    """Render a path the way upstream conflict messages do:
    ``.spec.containers[name="a"].image``."""
    out = []
    for kind, token in path:
        if kind == _F:
            out.append(f".{token}")
        elif kind == _K:
            keyd = json.loads(token)
            inner = ",".join(f'{k}="{v}"' for k, v in sorted(keyd.items()))
            out.append(f"[{inner}]")
        else:
            out.append(f"[v={token}]")
    return "".join(out)


def _entry_leaves(entry: Mapping[str, Any]) -> set[Path]:
    return fields_v1_to_leaves(entry.get("fieldsV1") or {})


def _make_entry(
    manager: str,
    operation: str,
    api_version: str,
    leaves: Iterable[Path],
    now_iso: str,
    subresource: str = "",
) -> dict[str, Any]:
    entry: dict[str, Any] = {
        "manager": manager,
        "operation": operation,
        "apiVersion": api_version,
        "time": now_iso,
        "fieldsType": "FieldsV1",
        "fieldsV1": leaves_to_fields_v1(leaves),
    }
    if subresource:
        entry["subresource"] = subresource
    return entry


def server_side_apply(
    live: dict[str, Any],
    applied: Mapping[str, Any],
    manager: str,
    force: bool,
    now_iso: str,
) -> None:
    """Apply ``applied`` into ``live`` in place under ``manager``'s name.

    Implements the upstream contract: fields the manager declared last
    time but omits now are removed (unless co-owned); fields owned by
    another manager with a *different* value raise ApplyConflictError
    unless ``force`` (same value = shared ownership, no conflict —
    upstream: "multiple appliers can set the same value").
    """
    if not manager:
        raise BadRequestError("fieldManager is required for apply requests")
    if (applied.get("metadata") or {}).get("managedFields"):
        raise InvalidError(
            "metadata.managedFields must not be set in an apply request"
        )
    entries = (live.get("metadata") or {}).get("managedFields") or []
    api_version = str(
        applied.get("apiVersion") or live.get("apiVersion") or ""
    )
    applied_leaves = extract_leaves(applied)
    new_set = set(applied_leaves)

    old_self: set[Path] = set()
    others: list[tuple[dict[str, Any], set[Path]]] = []
    kept_entries: list[dict[str, Any]] = []
    for entry in entries:
        if (
            entry.get("manager") == manager
            and entry.get("operation") == "Apply"
            and not entry.get("subresource")
        ):
            old_self |= _entry_leaves(entry)
        else:
            others.append((entry, _entry_leaves(entry)))
            kept_entries.append(entry)

    # Conflicts: a leaf we declare, another manager owns, and the value
    # we want differs from what is live.
    conflicts: list[tuple[str, str]] = []
    conflicted: set[Path] = set()
    for path in sorted(new_set):
        want = applied_leaves[path]
        if path[-1][0] == _K and isinstance(want, Mapping):
            keyd = json.loads(path[-1][1])
            if set(want) <= set(keyd):
                # A key-only element ({"name": "a"}) declares the
                # element's presence, not its contents — shared element
                # ownership, never a value conflict (the live item
                # legitimately carries other managers' fields).
                continue
        found, have = value_at(live, path)
        if not found or _json_equal(want, have):
            continue
        for entry, leaves in others:
            if path in leaves:
                conflicts.append(
                    (str(entry.get("manager", "")), dotted_path(path))
                )
                conflicted.add(path)
    if conflicts and not force:
        raise ApplyConflictError(conflicts)

    # Removal: leaves we owned, no longer declare, and nobody else owns.
    foreign: set[Path] = set()
    for _, leaves in others:
        foreign |= leaves
    # Deepest-first and fully deterministic (never set-iteration order —
    # removal order within an element matters for the key-only collapse).
    for path in sorted(
        old_self - new_set - foreign, key=lambda p: (len(p), p), reverse=True
    ):
        remove_leaf(live, path)

    merge_applied(live, applied)

    # Forced takeover strips the conflicted leaves from their old owners.
    if conflicted and force:
        for entry, leaves in others:
            remaining = leaves - conflicted
            if remaining != leaves:
                entry["fieldsV1"] = leaves_to_fields_v1(remaining)
        kept_entries = [
            e for e in kept_entries if fields_v1_to_leaves(e.get("fieldsV1") or {})
        ]

    kept_entries.append(
        _make_entry(manager, "Apply", api_version, new_set, now_iso)
    )
    live.setdefault("metadata", {})["managedFields"] = kept_entries


def reassign_on_write(
    old: Mapping[str, Any],
    new: dict[str, Any],
    manager: str,
    now_iso: str,
    subresource: str = "",
) -> None:
    """After a non-apply write (update / merge / strategic / json patch):
    every changed or removed field leaves its previous owners' sets, and
    changed fields are recorded under the writer's Update entry — so the
    next apply by a displaced manager sees an honest conflict (the
    kubectl-scale-then-apply story).

    No-ops (leaving the object untracked) when the object has no
    managedFields and the writer declared no manager — the activation
    rule that keeps unmanaged clusters byte-identical to their behavior
    before apply existed.
    """
    entries = (old.get("metadata") or {}).get("managedFields")
    if not entries and not manager:
        new.get("metadata", {}).pop("managedFields", None)
        return
    manager = manager or UNKNOWN_MANAGER
    entries = copy.deepcopy(entries or [])
    old_leaves = extract_leaves(old)
    new_leaves = extract_leaves(new)
    changed = {
        p
        for p, v in new_leaves.items()
        if p not in old_leaves or not _json_equal(old_leaves[p], v)
    }
    removed = set(old_leaves) - set(new_leaves)
    touched = changed | removed
    api_version = str(new.get("apiVersion") or old.get("apiVersion") or "")

    kept: list[dict[str, Any]] = []
    writer_leaves: set[Path] = set()
    for entry in entries:
        if (
            entry.get("manager") == manager
            and entry.get("operation") == "Update"
            and entry.get("subresource", "") == subresource
        ):
            writer_leaves |= _entry_leaves(entry)
            continue
        remaining = _entry_leaves(entry) - touched
        if remaining:
            if remaining != _entry_leaves(entry):
                entry["fieldsV1"] = leaves_to_fields_v1(remaining)
                entry["time"] = entry.get("time") or now_iso
            kept.append(entry)
    writer_leaves = (writer_leaves - removed) | changed
    if writer_leaves:
        kept.append(
            _make_entry(
                manager, "Update", api_version, writer_leaves, now_iso,
                subresource=subresource,
            )
        )
    meta = new.setdefault("metadata", {})
    if kept:
        meta["managedFields"] = kept
    else:
        meta.pop("managedFields", None)
