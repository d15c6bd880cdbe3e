"""Burn-in workloads used by the health gate."""
