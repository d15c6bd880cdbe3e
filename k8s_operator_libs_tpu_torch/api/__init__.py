"""Telemetry metric keys shared with the control plane."""
