"""Logging helper: one logger namespace for the port."""

from __future__ import annotations

import logging


def get_logger(name: str) -> logging.Logger:
    return logging.getLogger(f"k8s_operator_libs_tpu_torch.{name}")
