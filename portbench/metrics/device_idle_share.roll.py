"""The share of the roll cell's window in which no operation ran on the
card, in percent, from the device trace of this process and the world's
rank processes."""


def read(run):
    if run.device is None:
        return None
    share = run.device.idle_share()
    return None if share is None else 100.0 * share
