"""``open_dataplane`` — the single entry point to every data-plane backend."""
from __future__ import annotations

from typing import Mapping, Optional

from repro_torch.dataplane.registry import backend_factory
from repro_torch.dataplane.types import (Checkpoint, DataPlaneSession,
                                         Topology, UnsupportedOperation)


def open_dataplane(target, topology: Topology, backend: str = "tgb", *,
                   namespace: str = "runs/dataplane",
                   resume: "Checkpoint | str | None" = None,
                   streams: Optional[Mapping[str, float]] = None,
                   mix_seed: int = 0,
                   **backend_opts) -> DataPlaneSession:
    """Open a data-plane session over an interchangeable backend.

    Args:
      target: the transport substrate — an ``ObjectStore`` for ``tgb``, a
        ``KafkaSimBroker`` (or None to build one) for ``mq``, a
        ``ColocatedPipeline``/Clock/None for ``colocated``. Custom backends
        define their own target type.
      topology: the consuming mesh's ``Topology`` (DP x CP, optionally the
        global-batch token grid so readers decode arrays).
      backend: registered backend name (see ``available_backends()``).
      namespace: run prefix on the substrate (a fresh namespace is all a new
        job needs).
      resume: a ``Checkpoint`` (or its encoded token) to restore every reader
        vended by this session — the exactly-once cursor restore flow. With
        ``streams`` this must be a composite token (a MixedReader
        checkpoint).
      streams: optional ``{name: weight}`` map of named TGB streams. When
        given (tgb backend only) the session is multi-stream: ``writer(...,
        stream=<name>)`` vends per-stream producers and ``reader(...)``
        returns one MixedReader whose step sequence deterministically
        interleaves the streams by weight.
      mix_seed: seed of the deterministic mixing schedule (only meaningful
        with ``streams``; the schedule is a pure function of
        ``(weights, mix_seed, step)``).
      **backend_opts: forwarded to the backend session factory.

    Returns a session vending ``writer()`` / ``reader()`` handles that conform
    to the shared ``BatchWriter`` / ``BatchReader`` protocols.

    Raises:
      TypeError: ``topology`` is not a ``Topology`` (or ``target`` does not
        match the backend's substrate type).
      ValueError: ``resume`` token was captured on a different backend
        (cursors are not portable across transports) or is malformed, or
        ``backend`` is not a registered backend name.
      UnsupportedOperation: ``streams`` given with a non-tgb backend.

    Example::

        from repro_torch.core import MemoryObjectStore
        from repro_torch.dataplane import Topology, open_dataplane

        store = MemoryObjectStore()
        topo = Topology(dp=2, cp=1, global_batch=4, seq_len=16)
        session = open_dataplane(store, topo, namespace="runs/job")
        with session.writer("w0") as w:       # recover() on enter
            w.write(uniform_slice_bytes=256)  # -> stream offset 0
        batch = session.reader(dp_rank=0).next_batch(timeout_s=5)
        token = session.reader(dp_rank=1).checkpoint().encode()
        # later / elsewhere: resume every reader from the saved cursor
        session2 = open_dataplane(store, topo, namespace="runs/job",
                                  resume=token)
    """
    if not isinstance(topology, Topology):
        raise TypeError(f"topology must be a dataplane Topology, got "
                        f"{type(topology).__name__}")
    ckpt = Checkpoint.coerce(resume)
    if ckpt is not None and ckpt.backend != backend:
        raise ValueError(
            f"resume token was captured on backend {ckpt.backend!r} but this "
            f"session uses {backend!r}; cursors are not portable across "
            f"transports")
    if streams is not None:
        if backend != "tgb":
            raise UnsupportedOperation(
                f"multi-stream sessions need the object-store-native 'tgb' "
                f"backend (per-stream namespace prefixes); got {backend!r}")
        from repro_torch.streams import MultiStreamSession

        return MultiStreamSession(target, topology, streams=streams,
                                  mix_seed=mix_seed, namespace=namespace,
                                  resume=ckpt, **backend_opts)
    factory = backend_factory(backend)
    return factory(target, topology, namespace=namespace, resume=ckpt,
                   **backend_opts)
