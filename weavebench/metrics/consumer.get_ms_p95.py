"""95th percentile of the latency of every object-store GET the readers'
consumers issued (``consumer.<instance>.get_latencies`` in the process
registry: footer, slice and vectored reads, direct and prefetch, timed at
the consumer's call into the store, so a resilient store's retries, hedges
and governor waits are inside), in milliseconds. The set-up's few GETs
(the checked steps' and the first prefetches) are included; each
histogram keeps its last 1024 samples."""
import statistics


def read(run):
    if run.trace is None:
        return None
    from repro_torch.obs.registry import default_registry
    tails = getattr(default_registry(), "histograms", lambda prefix: {})("consumer.")
    xs = [x for name, h in tails.items() if name.endswith(".get_latencies") for x in h]
    if len(xs) < 20:
        return None
    return statistics.quantiles(xs, n=20, method="inclusive")[18] * 1e3
