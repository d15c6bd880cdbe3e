"""Mean seconds of the matmul probe in a battery (``ops.matmul``): the
benchmark's span around ``mxu_probe`` where ``tpu.health`` calls it,
closed after the card has finished."""


def read(run):
    return run.span_mean_s("probe.mxu")
