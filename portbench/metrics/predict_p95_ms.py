"""predict_p95_ms: the 95th percentile (nearest rank) over all requests of
the window of a request's time, from its dispatch to its boxes on the host
as numpy."""

from portbench import harness


def read(ctx):
    return 1e3 * harness.percentile(ctx["record"]["latencies_s"], 95)
