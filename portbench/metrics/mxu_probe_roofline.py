"""The matmul probe's share of its roofline, in percent: the bound of the
work the probe asks for (``roofline.mxu_probe_work``: its products at its
size, each operand read once and each result written once), over the
device time of the kernels that ran inside the probe's spans."""

from portbench import roofline


def read(run):
    if run.device is None or "mxu" not in run.work:
        return None
    seconds = run.device.kernel_s_in("probe.mxu")
    if not seconds:
        return None
    calls = len(run.device.ranges["probe.mxu"])
    flops, nbytes = run.work["mxu"]
    return roofline.share_percent((flops * calls, nbytes * calls), seconds)
