"""serve_p95_ms: the 95th percentile of every request's latency in the
window, from its start to its outputs on the device after a synchronize
(host clock; Python's inclusive quantiles)."""
import statistics


def read(ctx):
    if len(ctx["latencies"]) < 2:
        return None
    q = statistics.quantiles(ctx["latencies"], n=100, method="inclusive")
    return 1e3 * q[94]
