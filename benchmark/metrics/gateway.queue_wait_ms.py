"""Mean time a request waited in the request gateway's queue before a
render worker took it, in ms: the window's change of the gateway's
``headlamp_tpu_torch_gateway_queue_wait_seconds`` sum over its change of
count, every priority class together."""

NAME = "headlamp_tpu_torch_gateway_queue_wait_seconds"


def read(run):
    count = run.metric_delta(NAME + "_count")
    if count <= 0:
        return None
    return run.metric_delta(NAME + "_sum") / count * 1000
