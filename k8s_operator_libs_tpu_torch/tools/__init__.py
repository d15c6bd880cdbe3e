"""Measurement scripts for the port's kernels (run on a card), and the
reader of a trace export (``trace_view``)."""
