"""Unified DataPlane session API (port of ``repro.dataplane``) with the
reference's three backends.

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
store written by either package reads back in the other. ``backend="tgb"``
is the object-store-native data plane (the paper's system); ``"mq"`` the
strict-TGB Kafka baseline (§7.1); ``"colocated"`` the in-rank Local
baseline (§2.2). New transports plug in via ``register_backend``.
"""
from repro_torch.core.errors import BatchTimeout
from repro_torch.dataplane.colocated_backend import (ColocatedBatchReader,
                                                     ColocatedSession,
                                                     ColocatedWriter)
from repro_torch.dataplane.colocated_backend import \
    _factory as _colocated_factory
from repro_torch.dataplane.mq_backend import (MQBatchReader, MQSession,
                                              MQWriter)
from repro_torch.dataplane.mq_backend import _factory as _mq_factory
from repro_torch.dataplane.registry import (available_backends,
                                            backend_factory, register_backend)
from repro_torch.dataplane.session import open_dataplane
from repro_torch.dataplane.tgb_backend import (TGBBatchReader, TGBSession,
                                               TGBWriter)
from repro_torch.dataplane.tgb_backend import _factory as _tgb_factory
from repro_torch.dataplane.types import (Batch, BatchReader, BatchWriter,
                                         Checkpoint, DataPlaneSession,
                                         Topology, UnsupportedOperation)

for _name, _f in (("tgb", _tgb_factory), ("mq", _mq_factory),
                  ("colocated", _colocated_factory)):
    register_backend(_name, _f, overwrite=True)

__all__ = [
    "Batch", "BatchReader", "BatchTimeout", "BatchWriter", "Checkpoint",
    "ColocatedBatchReader", "ColocatedSession", "ColocatedWriter",
    "DataPlaneSession", "MQBatchReader", "MQSession", "MQWriter",
    "TGBBatchReader", "TGBSession", "TGBWriter", "Topology",
    "UnsupportedOperation", "available_backends", "backend_factory",
    "open_dataplane", "register_backend",
]
