"""Worlds of rank processes and the process groups the probes run over."""
