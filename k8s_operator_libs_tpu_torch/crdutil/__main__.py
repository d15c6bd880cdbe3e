"""apply-crds: apply or delete CRDs from YAML files and directories.

    python -m k8s_operator_libs_tpu_torch.crdutil --crds-path DIR [--crds-path F ...]
        [--operation apply|delete] [--no-wait] [--demo]

The flags of the JAX package's ``examples/apply_crds.py`` (the
reference's ``examples/apply-crds``), which is an example script and so
has no module path for this one to mirror. The client is
``RestClient.from_environment()``: the in-cluster service account, else
``$KUBECONFIG``; with ``--demo`` it is the port's in-memory cluster
(``kube/fake.py``), which establishes each CRD 0.05 s after its write, as
the JAX example's does, and is closed on the way out. Prints
``<operation>: processed N CRD(s)``; exits 1 with the error on stderr when
a path or document is bad or the wait times out.
"""

from __future__ import annotations

import argparse
import logging
import sys

from .crdutil import CRDOperation, CRDProcessingError, process_crds


def build_client(args: argparse.Namespace):
    if args.demo:
        from ..kube.fake import FakeCluster

        return FakeCluster(crd_establish_delay=0.05)
    from ..kube.rest import RestClient, RestConfigError

    try:
        return RestClient.from_environment()
    except RestConfigError as e:
        raise SystemExit(f"no cluster access configured ({e})") from None


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(prog="apply-crds", description=__doc__)
    parser.add_argument(
        "--crds-path", action="append", required=True,
        help="file or directory with CRD YAML (repeatable, recursed)",
    )
    parser.add_argument(
        "--operation", choices=[op.value for op in CRDOperation],
        default=CRDOperation.APPLY.value,
    )
    parser.add_argument(
        "--no-wait", action="store_true",
        help="do not wait for CRDs to become discoverable",
    )
    parser.add_argument(
        "--demo", action="store_true",
        help="run against the in-memory cluster, no cluster needed",
    )
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(levelname)s %(message)s")
    client = build_client(args)
    try:
        count = process_crds(client, args.crds_path, args.operation, wait=not args.no_wait)
    except CRDProcessingError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    finally:
        close = getattr(client, "close", None)
        if callable(close):
            close()
    print(f"{args.operation}: processed {count} CRD(s)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
