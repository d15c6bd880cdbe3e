"""Mean seconds of the burn-in in a battery (``models.burnin`` through
``World.run``): the benchmark's span around the gate's ``_burnin``, closed
after the card has finished."""


def read(run):
    return run.span_mean_s("probe.burnin")
