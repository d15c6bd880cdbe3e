"""Mean seconds of the flash probe in a battery (``ops.flash_attention``):
the benchmark's span around ``flash_attention_probe`` where ``tpu.health``
calls it, closed after the card has finished."""


def read(run):
    return run.span_mean_s("probe.flash")
