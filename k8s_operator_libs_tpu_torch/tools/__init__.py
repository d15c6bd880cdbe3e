"""Measurement scripts for the port's kernels (run on a card), the
reader of a trace export (``trace_view``), and the chaos corpus runner
(``chaos_run``)."""
