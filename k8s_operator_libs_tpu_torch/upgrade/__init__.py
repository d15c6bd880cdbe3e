"""The device class and its upgrade keys (a subset of the JAX package's
``upgrade`` package: the state machine itself stays in the operator)."""
