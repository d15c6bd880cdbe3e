"""The flash probe's share of its roofline, in percent: the bound of the
work the probe asks for (``roofline.flash_probe_work``: its causal
attentions, q, k and v read once and the output written once), over the
device time of the kernels that ran inside the probe's spans."""

from portbench import roofline


def read(run):
    if run.device is None or "flash" not in run.work:
        return None
    seconds = run.device.kernel_s_in("probe.flash")
    if not seconds:
        return None
    calls = len(run.device.ranges["probe.flash"])
    flops, nbytes = run.work["flash"]
    return roofline.share_percent((flops * calls, nbytes * calls), seconds)
