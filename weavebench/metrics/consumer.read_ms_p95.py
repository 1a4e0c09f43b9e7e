"""95th percentile of every reader's ``next_batch`` latency in the window
(``ConsumerStats.read_latencies``: entry to data, prefetch hits included),
in milliseconds."""
import statistics


def read(run):
    xs = run.read_latencies
    if len(xs) < 20:
        return None
    return statistics.quantiles(xs, n=20, method="inclusive")[18] * 1e3
