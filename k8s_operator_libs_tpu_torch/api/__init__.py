"""The API types the port reads and writes: the driver upgrade policy and
the NodeHealthReport telemetry contract."""
