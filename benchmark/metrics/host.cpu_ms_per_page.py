"""CPU of the host process per completed page, in ms: the window's
change of the program's ``headlamp_tpu_torch_process_cpu_seconds_total``
(user and system, every thread) over the pages completed in the window.
None where the program has no such counter."""

NAME = "headlamp_tpu_torch_process_cpu_seconds_total"


def read(run):
    pages = len(run.completed())
    if not pages or not any(name == NAME for name, _ in run.metricsz_before):
        return None
    return run.metric_delta(NAME) * 1000 / pages
