"""Apply or delete CustomResourceDefinitions from YAML files and
directories.

The JAX package's ``crdutil/crdutil.py`` (the reference's
``pkg/crdutil``): directories are walked recursively for ``.yaml`` and
``.yml`` files; a file may hold many documents, and those that are not
CRDs are skipped; an existing CRD is updated under ``retry_on_conflict``
with a fresh ``resourceVersion`` on each attempt; a delete tolerates a CRD
already gone. After an apply the wait polls API **discovery**, one GET a
group/version a round, until every served version of every CRD lists its
plural: an Established condition flips before the version can be routed.
A client without discovery is waited on through each CRD's status
instead. Helm upgrades no CRD on a chart upgrade, which is why an operator
applies its own.
"""

from __future__ import annotations

import enum
import os
import time
from typing import Iterable, Sequence

from ..kube.client import Client, NotFoundError, get_or_none, has_reason, retry_on_conflict
from ..kube.objects import CustomResourceDefinition
from ..utils.log import get_logger

log = get_logger("crdutil")

#: Seconds between two rounds of the wait.
ESTABLISH_POLL_INTERVAL_SECONDS = 0.1
#: The wait's limit; read when the wait starts, so a caller may set it.
ESTABLISH_TIMEOUT_SECONDS = 10.0

CRD_KIND = "CustomResourceDefinition"
_YAML_EXTENSIONS = (".yaml", ".yml")


class CRDOperation(enum.StrEnum):
    APPLY = "apply"
    DELETE = "delete"


class CRDProcessingError(Exception):
    pass


def walk_crd_paths(paths: Iterable[str]) -> list[str]:
    """Files and directories as the YAML files they hold, subdirectories
    included, in sorted order. A path that does not exist is an error."""
    out: list[str] = []
    for path in paths:
        if not os.path.exists(path):
            raise CRDProcessingError(f"CRD path does not exist: {path}")
        if os.path.isfile(path):
            out.append(path)
            continue
        for dirpath, _, filenames in sorted(os.walk(path)):
            for fname in sorted(filenames):
                if fname.lower().endswith(_YAML_EXTENSIONS):
                    out.append(os.path.join(dirpath, fname))
    return out


def parse_crds_from_file(path: str) -> list[CustomResourceDefinition]:
    """The CRD documents of one YAML file; other and empty documents are
    skipped."""
    import yaml

    crds: list[CustomResourceDefinition] = []
    with open(path, "r", encoding="utf-8") as fh:
        try:
            docs = list(yaml.safe_load_all(fh))
        except yaml.YAMLError as e:
            raise CRDProcessingError(f"invalid YAML in {path}: {e}") from e
    for doc in docs:
        if not isinstance(doc, dict) or doc.get("kind") != CRD_KIND:
            continue
        if not (doc.get("metadata") or {}).get("name"):
            raise CRDProcessingError(f"CRD document without metadata.name in {path}")
        crds.append(CustomResourceDefinition(doc))
    return crds


def parse_crds_from_paths(paths: Iterable[str]) -> list[CustomResourceDefinition]:
    crds: list[CustomResourceDefinition] = []
    for f in walk_crd_paths(paths):
        crds.extend(parse_crds_from_file(f))
    return crds


def apply_crds(
    client: Client,
    crds: Sequence[CustomResourceDefinition],
    wait: bool = True,
    timeout_seconds: float | None = None,
) -> None:
    """Create each CRD, or update it where it exists (a fresh
    ``resourceVersion`` each attempt, again on a conflict); then, with
    ``wait``, wait until every one can be routed."""
    for crd in crds:
        if get_or_none(client, CRD_KIND, crd.name) is None:
            log.info("creating CRD %s", crd.name)
            client.create(crd.deep_copy())
        else:
            log.info("updating CRD %s", crd.name)

            def attempt(crd=crd):
                fresh = client.get(CRD_KIND, crd.name)
                desired = crd.deep_copy()
                desired.metadata["resourceVersion"] = fresh.raw["metadata"]["resourceVersion"]
                client.update(desired)

            retry_on_conflict(attempt)
    if wait:
        wait_for_crds(client, crds, timeout_seconds=timeout_seconds)


def _discover(client, group: str, version: str) -> list:
    discover = getattr(client, "discover", None)
    if not callable(discover):
        raise NotImplementedError(f"{type(client).__name__} does not support discovery")
    return discover(group, version)


def wait_for_crds(
    client: Client,
    crds: Sequence[CustomResourceDefinition],
    timeout_seconds: float | None = None,
) -> None:
    """Poll discovery until each served version of each CRD lists its
    plural, one GET a distinct group/version a round; past the limit
    (``ESTABLISH_TIMEOUT_SECONDS`` when None) raise, naming what is
    missing. A client without discovery falls back to the CRDs' status:
    Established, with the wanted versions served."""
    if timeout_seconds is None:
        timeout_seconds = ESTABLISH_TIMEOUT_SECONDS
    deadline = time.monotonic() + timeout_seconds
    #: (crd name, group, version, plural) still awaited.
    pending: set[tuple[str, str, str, str]] = {
        (crd.name, crd.group, version, crd.plural)
        for crd in crds
        for version in crd.served_versions
    }
    try:
        _discover(client, "", "v1")
    except NotImplementedError:
        log.warning(
            "%s has no discovery support; falling back to status-based "
            "establishment polling (weaker: cannot see the Established-"
            "but-undiscoverable window)", type(client).__name__,
        )
        return _wait_for_crds_via_status(client, crds, deadline)
    except Exception as e:  # noqa: BLE001 - the poll below decides
        log.debug("discovery probe failed (%s); proceeding to poll", e)
    while pending:
        by_gv: dict[tuple[str, str], list[tuple[str, str, str, str]]] = {}
        for entry in pending:
            by_gv.setdefault((entry[1], entry[2]), []).append(entry)
        for (group, version), entries in sorted(by_gv.items()):
            try:
                resources = _discover(client, group, version)
            except Exception as e:  # noqa: BLE001 - the client's own classes
                if has_reason(e, NotFoundError):
                    continue  # not discoverable yet
                raise
            served = {r.get("name") for r in resources}
            for entry in entries:
                if entry[3] in served:
                    pending.discard(entry)
        if not pending:
            return
        if time.monotonic() > deadline:
            names = sorted({f"{e[0]} ({e[2]})" for e in pending})
            raise CRDProcessingError(
                f"timed out waiting for CRD versions to become discoverable: {names}"
            )
        time.sleep(ESTABLISH_POLL_INTERVAL_SECONDS)


def _wait_for_crds_via_status(
    client: Client,
    crds: Sequence[CustomResourceDefinition],
    deadline: float,
) -> None:
    """The wait for a client without discovery: each CRD Established with
    the wanted versions served."""
    pending = {crd.name: crd for crd in crds}
    while pending:
        for name in list(pending):
            current = get_or_none(client, CRD_KIND, name)
            if current is None:
                continue
            cur = CustomResourceDefinition(current.raw)
            wanted = set(pending[name].served_versions)
            if cur.is_established() and wanted.issubset(set(cur.served_versions)):
                del pending[name]
        if not pending:
            return
        if time.monotonic() > deadline:
            raise CRDProcessingError(
                f"timed out waiting for CRDs to become established: {sorted(pending)}"
            )
        time.sleep(ESTABLISH_POLL_INTERVAL_SECONDS)


def delete_crds(client: Client, crds: Sequence[CustomResourceDefinition]) -> None:
    """Delete each CRD; one already gone is passed over."""
    for crd in crds:
        try:
            client.delete(CRD_KIND, crd.name)
            log.info("deleted CRD %s", crd.name)
        except Exception as e:  # noqa: BLE001 - the client's own classes
            if not has_reason(e, NotFoundError):
                raise
            log.info("CRD %s already absent", crd.name)


def process_crds(
    client: Client,
    paths: Iterable[str],
    operation: CRDOperation | str,
    wait: bool = True,
    timeout_seconds: float | None = None,
) -> int:
    """Apply or delete the CRDs found under ``paths``; how many there were."""
    op = CRDOperation(operation)
    crds = parse_crds_from_paths(paths)
    if op is CRDOperation.APPLY:
        apply_crds(client, crds, wait=wait, timeout_seconds=timeout_seconds)
    else:
        delete_crds(client, crds)
    return len(crds)
