"""The share of the window in which the host process's garbage
collector held the interpreter, in %: the window's change of the
program's ``headlamp_tpu_torch_gc_pause_seconds_total``, every
generation together, over the window's seconds. None where the program
has no such counter."""

NAME = "headlamp_tpu_torch_gc_pause_seconds_total"


def read(run):
    if not any(name == NAME for name, _ in run.metricsz_before):
        return None
    return 100 * run.metric_delta(NAME) / run.seconds
