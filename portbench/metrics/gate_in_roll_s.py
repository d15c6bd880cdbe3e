"""Mean seconds of the gate inside the roll: the benchmark's span around
the validation hook it hands to ``with_validation_enabled``."""


def read(run):
    return run.span_mean_s("gate")
