"""Burn-in workloads used by the health gate: the transformer of
``burnin`` and its GPipe schedule in ``pipeline``."""

from .burnin import (
    BurninConfig,
    batch_spec,
    forward,
    init_params,
    loss_fn,
    make_sharded_train_step,
    param_specs,
    synthetic_batch,
    train_step,
)
from .pipeline import make_pipeline_train_step, stack_layers

__all__ = [
    "BurninConfig",
    "batch_spec",
    "forward",
    "init_params",
    "loss_fn",
    "make_pipeline_train_step",
    "make_sharded_train_step",
    "param_specs",
    "stack_layers",
    "synthetic_batch",
    "train_step",
]
