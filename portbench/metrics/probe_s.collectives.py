"""Mean seconds of the collective battery in a battery
(``ops.collectives``): the benchmark's span around ``run_ici_probes`` where
``tpu.health`` calls it, closed after the card has finished."""


def read(run):
    return run.span_mean_s("probe.collectives")
