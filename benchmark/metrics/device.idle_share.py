"""The share of the window in which no operation ran on the card, in %:
one less the union of the device activity in the profiler's trace over
the window's length."""


def read(run):
    if run.device is None:
        return None
    return 100 * (1 - run.device.busy_s(run.start, run.end) / run.seconds)
