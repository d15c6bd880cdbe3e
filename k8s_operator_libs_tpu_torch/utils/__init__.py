"""Logging and device helpers, the int-or-percent type, per-node locks and
the wall clock the durable deadlines read."""
