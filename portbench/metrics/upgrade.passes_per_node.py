"""Passes of the state machine in the window over the node-rolls that
ended in it."""


def read(run):
    passes = run.counters.get("window.passes")
    rolls = run.counters.get("window.node_rolls")
    if not passes or not rolls or not rolls[0]:
        return None
    return passes[0] / rolls[0]
