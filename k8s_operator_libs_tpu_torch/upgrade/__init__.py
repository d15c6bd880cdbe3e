"""The device class, its upgrade keys and states, and the monitor's metrics
endpoint (a subset of the JAX package's ``upgrade`` package: the state
machine itself stays in the operator)."""
