"""Apply and delete CustomResourceDefinitions (the JAX package's
``crdutil``). ``python -m k8s_operator_libs_tpu_torch.crdutil`` is its
command line."""

from .crdutil import (
    CRDOperation,
    CRDProcessingError,
    apply_crds,
    delete_crds,
    parse_crds_from_file,
    parse_crds_from_paths,
    process_crds,
    wait_for_crds,
    walk_crd_paths,
)

__all__ = [
    "CRDOperation",
    "CRDProcessingError",
    "apply_crds",
    "delete_crds",
    "parse_crds_from_file",
    "parse_crds_from_paths",
    "process_crds",
    "wait_for_crds",
    "walk_crd_paths",
]
