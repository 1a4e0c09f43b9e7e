"""Colocated dataloader baseline (paper §2.2, §7.1 'Local'); port of
``repro.data.colocated``, copied as it is but for its imports.

Expert-tuned in-rank pipeline: N worker threads do sample-level preprocessing on
the trainer node, feed a bounded queue into a collator, which feeds the training
step. Its two structural limits — the ones BatchWeave removes — are modeled
explicitly:

  * **resource contention**: preprocessing threads share CPU cycles/memory
    bandwidth with the training process on the same node. We model a node with
    ``node_cpu`` cores: the training step itself needs ``train_cpu`` cores'
    worth of host work; preprocessing demand beyond the remaining cores slows
    *both* sides by the oversubscription factor.
  * **no failure isolation**: a preprocessing crash stalls the trainer (the
    queue empties and the step blocks), and the two cannot scale independently.

The simulation advances a shared Clock, producing the same steps/s and P50/P95
metrics as the BatchWeave/Kafka paths in fig5.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass, field
from queue import Empty, Full, Queue
from typing import Callable, List, Optional

from repro_torch.core.clock import Clock, SystemClock
from repro_torch.core.consumer import ConsumerStats
from repro_torch.core.errors import BatchTimeout
from repro_torch.core.stats import percentile as _percentile


@dataclass
class ColocatedConfig:
    workers: int = 12            # paper: 12 local worker threads per rank
    queue_depth: int = 8
    node_cpu: float = 64.0       # cores per node (paper infra)
    train_cpu: float = 16.0      # host-side cores the training step consumes
    trainer_ranks_per_node: int = 8


@dataclass
class StepTrace:
    latencies: List[float] = field(default_factory=list)
    stalls: int = 0

    def percentile(self, p: float) -> float:
        return _percentile(self.latencies, p)


class ColocatedPipeline:
    """Threaded colocated pipeline with an explicit contention model."""

    def __init__(self, cfg: ColocatedConfig,
                 preprocess_cost_s: Callable[[int], float],
                 batch_cpu_items: int,
                 clock: Optional[Clock] = None):
        """``preprocess_cost_s(i)`` is the nominal CPU-seconds for sample i on an
        idle core; ``batch_cpu_items`` samples form one global-batch equivalent."""
        self.cfg = cfg
        self.clock = clock or SystemClock()
        self.preprocess_cost_s = preprocess_cost_s
        self.batch_cpu_items = batch_cpu_items
        self.queue: Queue = Queue(maxsize=cfg.queue_depth)
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []
        self._sample_idx = 0
        self._idx_lock = threading.Lock()
        self.crashed = threading.Event()
        self._partial: List[int] = []  # items drawn for a not-yet-complete batch
        # the same registry-backed surface the tgb consumer exposes, so
        # fig5/fig10 baseline comparisons report identical fields; byte
        # counters use the facade's int32-index payload convention, and
        # fetched == consumed (in-process queue: no transport amplification)
        self.stats = ConsumerStats("colocated")

    # -- contention model -------------------------------------------------------
    def _slowdown(self) -> float:
        """Oversubscription factor: demand / capacity when demand exceeds the
        node's cores. Preprocessing demand = workers (each wants a core);
        training demand = train_cpu per node."""
        c = self.cfg
        demand = c.workers * c.trainer_ranks_per_node + c.train_cpu
        return max(1.0, demand / c.node_cpu)

    # -- producer side ------------------------------------------------------------
    def _worker(self):
        while not self._stop.is_set() and not self.crashed.is_set():
            with self._idx_lock:
                i = self._sample_idx
                self._sample_idx += 1
            cost = self.preprocess_cost_s(i) * self._slowdown()
            self.clock.sleep(cost)
            item = i
            while not self._stop.is_set():
                try:
                    self.queue.put(item, timeout=0.05)
                    break
                except Full:
                    continue

    def start(self):
        self._stop.clear()  # support stop/start cycles (writer re-entry)
        for w in range(self.cfg.workers):
            t = threading.Thread(target=self._worker, daemon=True,
                                 name=f"coloc-worker-{w}")
            t.start()
            self._threads.append(t)

    def stop(self):
        self._stop.set()
        for t in self._threads:
            t.join(timeout=2)
        self._threads.clear()

    def inject_crash(self):
        """Preprocessing failure: all workers die; the trainer stalls (no
        failure isolation)."""
        self.crashed.set()

    # -- trainer side ---------------------------------------------------------------
    def next_batch(self, timeout_s: Optional[float] = None) -> List[int]:
        """Assemble one global batch's worth of preprocessed sample indices.

        Same contract as ``repro_torch.core.Consumer.next_batch``: raises
        ``BatchTimeout`` if the batch cannot be assembled within ``timeout_s``
        (including the permanent stall after a preprocessing crash). Items
        already drawn from the queue survive a timeout and count toward the
        next attempt.
        """
        t0 = self.clock.now()
        while len(self._partial) < self.batch_cpu_items:
            if self.crashed.is_set() and self.queue.empty():
                raise BatchTimeout("preprocessing crashed; trainer stalled")
            if timeout_s is not None and self.clock.now() - t0 > timeout_s:
                raise BatchTimeout(
                    f"global batch not assembled after {timeout_s}s "
                    f"({len(self._partial)}/{self.batch_cpu_items} items)")
            try:
                self._partial.append(self.queue.get(timeout=0.05))
            except Empty:
                continue
        items, self._partial = self._partial, []
        nbytes = 4 * len(items)  # int32 sample indices
        self.stats.steps_consumed += 1
        self.stats.bytes_fetched += nbytes
        self.stats.bytes_consumed += nbytes
        self.stats.read_latencies.append(self.clock.now() - t0)
        return items

    def run_training(self, steps: int, gpu_step_s: float,
                     stall_timeout_s: float = 30.0) -> StepTrace:
        trace = StepTrace()
        slowdown = self._slowdown()
        for _ in range(steps):
            t0 = self.clock.now()  # stall time counts toward step latency
            while True:
                try:
                    self.next_batch(timeout_s=stall_timeout_s)
                    break
                except BatchTimeout:
                    trace.stalls += 1
                    if self.crashed.is_set():
                        return trace  # job stalls permanently
            # the GPU step also pays the host-side contention tax
            self.clock.sleep(gpu_step_s * slowdown)
            trace.latencies.append(self.clock.now() - t0)
        return trace
