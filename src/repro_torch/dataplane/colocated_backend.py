"""`colocated` backend: the in-rank 'Local' baseline behind the facade (port
of ``repro.dataplane.colocated_backend``, copied as it is but for its
imports).

Preprocessing happens on the trainer node, so there is no transport: the
"writer" is the worker-pool lifecycle (``__enter__`` starts the threads,
``__exit__`` stops them; ``inject_crash`` models the paper's no-failure-
isolation property), and the reader assembles one global batch's worth of
preprocessed sample indices from the shared bounded queue.

Batches carry the preprocessed sample indices as an int32 payload; ``version``
is always -1 (there is no durable control plane — which is precisely the
baseline's limitation). ``Checkpoint("colocated", -1, step)`` records the step
counter only: the queue is volatile, so restore repositions the counter but
cannot replay data (the facade makes the consistency gap explicit rather than
papering over it).
"""
from __future__ import annotations

from typing import Callable, List, Optional

import numpy as np

from repro_torch.data.colocated import ColocatedConfig, ColocatedPipeline
from repro_torch.dataplane._base import SessionBase
from repro_torch.dataplane.types import (Batch, Checkpoint, Topology,
                                         UnsupportedOperation)


class ColocatedWriter:
    """Worker-pool lifecycle handle (no per-batch writes: samples are produced
    by the in-process preprocessing threads)."""

    def __init__(self, pipeline: ColocatedPipeline):
        self.pipeline = pipeline
        self.recovered_offset = 0

    def __enter__(self) -> "ColocatedWriter":
        self.pipeline.start()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        self.pipeline.stop()
        return False

    def write(self, slices=None, *, uniform_slice_bytes=None,
              num_samples: int = 0, token_count: int = 0) -> Optional[int]:
        raise UnsupportedOperation(
            "colocated preprocessing is push-based (in-process worker "
            "threads); there is no explicit batch write")

    def write_tokens(self, tokens) -> List[int]:
        raise UnsupportedOperation(
            "colocated preprocessing is push-based; there is no explicit "
            "token feed")

    def flush(self) -> bool:
        return True

    def inject_crash(self) -> None:
        """Kill the worker pool: readers stall (no failure isolation)."""
        self.pipeline.inject_crash()


class ColocatedBatchReader:
    """Trainer-side reader: one global batch's worth of queue items."""

    def __init__(self, pipeline: ColocatedPipeline, topology: Topology):
        self.pipeline = pipeline
        self.topology = topology
        self.step = 0

    def next_batch(self, timeout_s: Optional[float] = None) -> Batch:
        items = self.pipeline.next_batch(timeout_s=timeout_s)
        step = self.step
        self.step += 1
        payload = np.asarray(items, dtype=np.int32).tobytes()
        return Batch(payload=payload, step=step, version=-1, dp_rank=0,
                     cp_rank=0,
                     array=np.asarray(items, dtype=np.int32)[None, :])

    def checkpoint(self) -> Checkpoint:
        return Checkpoint("colocated", version=-1, step=self.step,
                          topology=(self.topology.dp, self.topology.cp))

    def restore(self, ckpt: "Checkpoint | str") -> None:
        ckpt = Checkpoint.coerce(ckpt)
        if ckpt.backend != "colocated":
            raise ValueError(f"cannot restore a {ckpt.backend!r} checkpoint "
                             f"on a colocated reader")
        here = (self.topology.dp, self.topology.cp)
        if ckpt.topology is not None and tuple(ckpt.topology) != here:
            # the queue is per-node and volatile: a step counter from a
            # different mesh shape has no meaning here, so refuse loudly
            raise UnsupportedOperation(
                f"colocated backend cannot restore a checkpoint captured at "
                f"dp={ckpt.topology[0]} cp={ckpt.topology[1]} onto a "
                f"dp={here[0]} cp={here[1]} reader: the in-rank pipeline has "
                f"no topology remap. Factor DP resize is supported only by "
                f"the tgb backend's elastic restore path "
                f"(TGBBatchReader.restore / TrainSession.resume)")
        # volatile queue: the counter moves but past batches are gone — the
        # baseline cannot replay (the paper's consistency argument)
        self.step = ckpt.step

    def close(self) -> None:
        pass

    @property
    def stats(self):
        return self.pipeline.stats


class ColocatedSession(SessionBase):
    backend = "colocated"

    def __init__(self, target, topology: Topology, *,
                 namespace: str = "runs/dataplane",
                 resume: "Checkpoint | str | None" = None,
                 config: Optional[ColocatedConfig] = None,
                 preprocess_cost_s: Optional[Callable[[int], float]] = None,
                 batch_cpu_items: Optional[int] = None, clock=None):
        """``target`` may be an existing ``ColocatedPipeline``, a Clock, or
        None (a pipeline is built from ``config``/``preprocess_cost_s``)."""
        self.topology = topology
        self.namespace = namespace
        if isinstance(target, ColocatedPipeline):
            self.pipeline = target
        else:
            self.pipeline = ColocatedPipeline(
                config or ColocatedConfig(),
                preprocess_cost_s or (lambda i: 0.0),
                batch_cpu_items or topology.global_batch or topology.dp,
                clock=clock if clock is not None else target)
        self._resume = Checkpoint.coerce(resume)

    @property
    def slowdown(self) -> float:
        """The node's oversubscription factor (the contention tax every
        host-side operation — including the GPU step's host work — pays)."""
        return self.pipeline._slowdown()

    def writer(self, writer_id: str = "local-workers",
               **_opts) -> ColocatedWriter:
        return ColocatedWriter(self.pipeline)

    def reader(self, dp_rank: int = 0, cp_rank: int = 0,
               **_opts) -> ColocatedBatchReader:
        # every rank on the node shares the one queue; the facade models the
        # node-level pipeline, so readers are fungible
        r = ColocatedBatchReader(self.pipeline, self.topology)
        if self._resume is not None:
            r.restore(self._resume)
        return r

    def close(self) -> None:
        self.pipeline.stop()


def _factory(target, topology, **opts) -> ColocatedSession:
    return ColocatedSession(target, topology, **opts)
