"""The one generator of the benchmark's traffic: a training job's token
stream written into the data plane, as a traffic file describes it.

Every store setting is read from the file and handed to the program's
constructors explicitly, so no default of the program decides what a cell
offers; the latency jitter, the injected faults and the resilient client's
backoff are seeded from the run's seed. Two shapes of feed:

* a backlog: ``backlog_steps`` global batches committed by one writer
  (``session.writer().write_tokens``) on a thread that set-up starts first
  and joins before the window;
* a live stream (``producer`` in the file): ``committed_before`` batches
  committed at set-up, then one producer thread (``run_producer_loop``)
  writes the rest while the trainer reads.

The grid of step i is tokens [i * GB * S, (i + 1) * GB * S) of the stream,
row-major: the data-plane check compares every consumed grid with it.
"""
from __future__ import annotations

import random
import threading
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from wb.weights import sub_seed, token_stream


@dataclass
class Feed:
    """What the harness needs of the running data plane."""

    topology: object
    session: object
    tokens: np.ndarray
    steps: int                   # global batches the stream holds in all
    grid_shape: tuple
    store: object = None         # the faulty store, where there is one
    threads: List[threading.Thread] = field(default_factory=list)
    stop: threading.Event = field(default_factory=threading.Event)
    errors: List[BaseException] = field(default_factory=list)
    brownout: Optional[list] = None

    def expected_grid(self, step: int) -> np.ndarray:
        n = self.grid_shape[0] * self.grid_shape[1]
        return self.tokens[step * n:(step + 1) * n].reshape(self.grid_shape)

    def join_backlog(self) -> None:
        """Wait for the backlog writer (a live producer keeps running)."""
        for t in self.threads:
            if t.name == "weavebench-backlog":
                t.join()
        if self.errors:
            raise RuntimeError(f"the traffic writer failed: {self.errors[0]!r}")

    def arm(self, seconds: float) -> None:
        """Start the brownout schedule, relative to now, over a window of
        ``seconds``."""
        if not self.brownout:
            return
        from repro_torch.core import BrownoutPhase
        phases = []
        for ph in self.brownout:
            ph = dict(ph)
            start, end = ph.pop("start_frac") * seconds, ph.pop("end_frac") * seconds
            phases.append(BrownoutPhase(start, end, **ph))
        self.store.script_brownout(phases)

    def close(self) -> None:
        self.stop.set()
        if self.store is not None and self.brownout:
            self.store.clear_brownout()
        for t in self.threads:
            t.join(timeout=120.0)
        self.session.close()
        if self.errors:
            raise RuntimeError(f"the traffic writer failed: {self.errors[0]!r}")


def _guarded(feed: Feed, fn, **kw):
    def body():
        try:
            fn(**kw)
        except BaseException as e:  # reported by join_backlog / close
            feed.errors.append(e)
    return body


def open_feed(traffic: dict, vocab: int, seed: int, namespace: str = "runs/weavebench") -> Feed:
    """Build the store and the data-plane session of ``traffic``, draw the
    token stream from ``seed`` and start writing it."""
    from repro_torch.core import (FaultPolicy, FaultyObjectStore, HedgePolicy,
                                  LatencyModel, MemoryObjectStore, ResilienceConfig,
                                  run_producer_loop)
    from repro_torch.data.packing import GlobalBatchPacker
    from repro_torch.dataplane import Topology, open_dataplane

    GB, S = traffic["global_batch"], traffic["seq_len"]
    topo = Topology(dp=traffic["dp"], cp=traffic["cp"], global_batch=GB, seq_len=S)
    steps = traffic["backlog_steps"]
    tokens = token_stream(seed, steps, GB * S, vocab)
    lat = dict(traffic["store"]["latency"])
    latency = LatencyModel(**lat, _rng=random.Random(sub_seed(seed, 4)))
    store = inner = MemoryObjectStore(latency=latency)
    faults = traffic.get("faults")
    if faults is not None:
        policy = {k: v for k, v in faults.items() if k != "seed_from_run_seed"}
        store = FaultyObjectStore(inner, FaultPolicy(seed=sub_seed(seed, 5), **policy))
    opts = {}
    res = traffic.get("resilience")
    if res is not None:
        res = {k: v for k, v in res.items() if k != "seed_from_run_seed"}
        res["retry_budgets"] = {k: tuple(v) for k, v in res["retry_budgets"].items()}
        res["hedge"] = HedgePolicy(**res["hedge"])
        opts["resilience"] = ResilienceConfig(seed=sub_seed(seed, 6), **res)
    session = open_dataplane(store, topo, namespace=namespace, **opts)
    feed = Feed(topo, session, tokens, steps, (GB, S),
                store=store if faults is not None else None,
                brownout=traffic.get("brownout"))
    prod = traffic.get("producer")
    if prod is None:
        def backlog():
            with session.writer("w0") as w:
                w.write_tokens(tokens)
        t = threading.Thread(target=_guarded(feed, backlog), name="weavebench-backlog")
    else:
        slices = [b.slices for b in GlobalBatchPacker(GB, S, topo.dp, topo.cp).add_tokens(tokens)]
        writer = session.writer("w0", spill_limit=prod["spill_limit"]).__enter__()
        for offset in range(prod["committed_before"]):
            writer.write(slices[offset])
        writer.flush()
        t = threading.Thread(target=_guarded(
            feed, run_producer_loop, producer=writer.producer,
            n_tgbs=steps - prod["committed_before"], slice_bytes=0, stop=feed.stop,
            produce_delay_s=prod["produce_delay_s"], payload_fn=slices.__getitem__),
            name="weavebench-producer")
    feed.threads.append(t)
    t.start()
    return feed


def fan_in(feed: Feed, traffic: dict):
    """One reader per (dp, cp) position, fanned in by the program's
    ``ReaderFanInSource``."""
    from repro_torch.train.pipeline import ReaderFanInSource

    topo = feed.topology
    return ReaderFanInSource([feed.session.reader(dp_rank=d, cp_rank=c,
                                                  prefetch_depth=traffic["prefetch_depth"])
                              for d in range(topo.dp) for c in range(topo.cp)], topo)
