"""Unified DataPlane session API (port of ``repro.dataplane``), tgb backend.

The same facade as the reference::

    from repro_torch.dataplane import Topology, open_dataplane

    session = open_dataplane(store, Topology(dp=2, cp=2), backend="tgb",
                             namespace="runs/myjob")
    with session.writer("worker0") as w:        # recover() on enter
        w.write(slice_payloads)                  # -> stream offset
    reader = session.reader(dp_rank=0, cp_rank=0)
    batch = reader.next_batch(timeout_s=5)       # -> Batch (raises BatchTimeout)
    token = reader.checkpoint().encode()         # opaque exactly-once cursor
    session2 = open_dataplane(store, topo, backend="tgb", resume=token)

Stores, TGBs, manifests and Checkpoint tokens are byte-compatible with the
reference's (``repro_torch.core._msgpack`` writes msgpack's bytes), so a
store written by either package reads back in the other. Only the
object-store-native ``tgb`` backend is registered; ``mq`` and ``colocated``
raise ``UnsupportedOperation`` until they are ported.
"""
from repro_torch.core.errors import BatchTimeout
from repro_torch.dataplane.registry import (available_backends,
                                            backend_factory, register_backend)
from repro_torch.dataplane.session import open_dataplane
from repro_torch.dataplane.tgb_backend import (TGBBatchReader, TGBSession,
                                               TGBWriter)
from repro_torch.dataplane.tgb_backend import _factory as _tgb_factory
from repro_torch.dataplane.types import (Batch, BatchReader, BatchWriter,
                                         Checkpoint, DataPlaneSession,
                                         Topology, UnsupportedOperation)

register_backend("tgb", _tgb_factory, overwrite=True)

__all__ = [
    "Batch", "BatchReader", "BatchTimeout", "BatchWriter", "Checkpoint",
    "DataPlaneSession", "TGBBatchReader", "TGBSession", "TGBWriter",
    "Topology", "UnsupportedOperation", "available_backends",
    "backend_factory", "register_backend", "open_dataplane",
]
