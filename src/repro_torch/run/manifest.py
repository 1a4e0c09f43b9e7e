"""RunManifest: the per-run record that makes model+data recovery atomic.

A RunManifest entry is a small, versioned, conditionally-written object that
binds, in **one object-store commit**:

  * the model checkpoint pointer (the step's ``MANIFEST.ckpt`` key),
  * the data-plane cursor (an encoded facade ``Checkpoint`` token — composite
    on multi-stream runs, so it carries every stream's ``<V, S>`` plus the
    mix position),
  * the capture topology (DP x CP and the token grid), and
  * the materialized TGB layout's DP degree (the invariant unit elastic
    restores convert through).

Commit protocol mirrors the data plane's manifests: entries live at
``<run>/runmanifest/<seq>.rm`` with a strictly monotone sequence number
claimed by conditional put (If-None-Match: *). Model state is uploaded
*first*, then the entry naming it is committed — a crash between the two
leaves the previous entry authoritative, so recovery is exactly-once by
construction and the half-uploaded model state surfaces as a safe orphan in
``batchweave fsck``.

The wire format carries a schema tag; unknown schemas fail loudly instead of
key-erroring mid-restore.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Callable, List, Optional, Tuple

from repro_torch.core import _msgpack as msgpack

from repro_torch.core.consumer import floor_to_data_step
from repro_torch.core.lifecycle import Watermark
from repro_torch.core.objectstore import Namespace, NoSuchKey
from repro_torch.dataplane.types import Checkpoint

__all__ = ["RUN_SCHEMA", "RUNMANIFEST_DIR", "RunManifest",
           "RunManifestError", "RunManifestStore"]

#: wire-format schema tag; bump on incompatible changes
RUN_SCHEMA = 1
#: directory component under the run namespace holding the entries
RUNMANIFEST_DIR = "runmanifest"


class RunManifestError(ValueError):
    """A RunManifest entry is missing, malformed, or from an unknown schema."""


@dataclass(frozen=True)
class RunManifest:
    """One committed aligned-checkpoint record."""

    seq: int                      # monotone commit sequence (the object key)
    step: int                     # trainer logical step at capture topology
    model_key: str                # model checkpoint MANIFEST key ("" = none)
    data_token: str               # encoded dataplane Checkpoint (see types)
    topology: Tuple[int, int]     # (dp, cp) of the capturing mesh
    data_dp: int                  # materialized TGB layout DP degree
    global_batch: Optional[int] = None   # token grid at capture (optional)
    seq_len: Optional[int] = None
    streams: Optional[dict] = None       # {name: weight} on multi-stream runs
    mix_seed: int = 0

    def pack(self) -> bytes:
        return msgpack.packb({
            "schema": RUN_SCHEMA,
            "seq": self.seq,
            "step": self.step,
            "model": self.model_key,
            "data": self.data_token,
            "tp": list(self.topology),
            "dd": self.data_dp,
            "gb": self.global_batch,
            "sl": self.seq_len,
            "streams": self.streams,
            "mix_seed": self.mix_seed,
        }, use_bin_type=True)

    @staticmethod
    def unpack(raw: bytes) -> "RunManifest":
        try:
            d = msgpack.unpackb(raw, raw=False)
        except Exception as e:
            raise RunManifestError(
                f"undecodable RunManifest entry: {type(e).__name__}: {e}") from e
        if not isinstance(d, dict) or "schema" not in d:
            raise RunManifestError("RunManifest entry carries no schema tag")
        if d["schema"] != RUN_SCHEMA:
            raise RunManifestError(
                f"RunManifest schema {d['schema']!r} is not supported by this "
                f"build (expected {RUN_SCHEMA}); upgrade the tooling or "
                f"re-checkpoint the run")
        try:
            return RunManifest(
                seq=d["seq"], step=d["step"], model_key=d["model"],
                data_token=d["data"], topology=tuple(d["tp"]),
                data_dp=d["dd"], global_batch=d.get("gb"),
                seq_len=d.get("sl"), streams=d.get("streams"),
                mix_seed=d.get("mix_seed", 0))
        except KeyError as e:
            raise RunManifestError(f"RunManifest entry missing field {e}") from e

    # -- derived views --------------------------------------------------------
    def data_checkpoint(self) -> Checkpoint:
        """The bound data-plane cursor, decoded."""
        return Checkpoint.decode(self.data_token)

    def aligned_data_step(self) -> int:
        """The cursor position in *materialized* (TGB-layout) units — the
        unit trim markers and per-TGB retention decisions use. Floored, so a
        mid-boundary cursor can only under-trim."""
        ck = self.data_checkpoint()
        if ck.mix_pos is not None:
            return ck.mix_pos
        return floor_to_data_step(ck.step, self.topology[0], self.data_dp)

    def watermark(self, stream: Optional[str] = None) -> Watermark:
        """The reclamation boundary this aligned checkpoint defines.

        ``stream=None`` on a single-stream run yields the run's
        ``(version, tgb_step)``; naming a stream of a multi-stream run yields
        that stream's ``(version, stream_step)`` from the composite token.
        """
        ck = self.data_checkpoint()
        if stream is None:
            if ck.composite:
                raise RunManifestError(
                    "multi-stream RunManifest needs a stream name to derive "
                    "a per-stream watermark")
            return Watermark(version=ck.version, step=self.aligned_data_step())
        v, s = ck.stream_cursor(stream)
        return Watermark(version=v, step=s)


class RunManifestStore:
    """Reads and conditionally commits RunManifest entries of one run."""

    def __init__(self, ns: Namespace):
        self.ns = ns
        self.store = ns.store

    def key(self, seq: int) -> str:
        return self.ns.key(RUNMANIFEST_DIR, f"{seq:08d}.rm")

    def seqs(self) -> List[int]:
        out = []
        for key in self.store.list(self.ns.key(RUNMANIFEST_DIR)):
            try:
                out.append(int(key.rsplit("/", 1)[-1].split(".")[0]))
            except ValueError:
                pass
        return sorted(out)

    def read(self, seq: int) -> RunManifest:
        try:
            raw = self.store.get(self.key(seq))
        except (KeyError, NoSuchKey) as e:
            raise RunManifestError(f"no RunManifest entry seq={seq}") from e
        return RunManifest.unpack(raw)

    def latest(self) -> Optional[RunManifest]:
        seqs = self.seqs()
        if not seqs:
            return None
        return self.read(seqs[-1])

    def commit(self, rm: RunManifest) -> bool:
        """Claim ``rm.seq`` with a conditional put. False = another trainer
        incarnation won that sequence number."""
        return self.store.put_if_absent(self.key(rm.seq), rm.pack())

    def append(self, *, step: int, model_key: str, data_token: str,
               topology: Tuple[int, int], data_dp: int,
               global_batch: Optional[int] = None,
               seq_len: Optional[int] = None,
               streams: Optional[dict] = None, mix_seed: int = 0,
               max_attempts: int = 16) -> RunManifest:
        """Commit the next entry. Retries the (rare) sequence race — two
        trainer incarnations can only contend during a failover overlap, and
        the conditional put makes exactly one of them win each number.

        Regression fencing: an entry whose cursor sits *behind* the current
        latest entry's (compared in materialized units, which survive
        elastic resizes) is refused — a zombie incarnation resurfacing
        after a replacement has advanced the run must not roll ``latest()``
        backward and cause the replayed window to be trained twice.
        """
        candidate = RunManifest(seq=0, step=step, model_key=model_key,
                                data_token=data_token,
                                topology=tuple(topology), data_dp=data_dp,
                                global_batch=global_batch, seq_len=seq_len,
                                streams=streams, mix_seed=mix_seed)
        for _ in range(max_attempts):
            seqs = self.seqs()
            seq = (seqs[-1] + 1) if seqs else 0
            if seqs:
                head = self.read(seqs[-1])
                if candidate.aligned_data_step() < head.aligned_data_step():
                    raise RunManifestError(
                        f"refusing to commit a regressive RunManifest entry: "
                        f"candidate data step "
                        f"{candidate.aligned_data_step()} < committed "
                        f"{head.aligned_data_step()} (seq {head.seq}) — is a "
                        f"replaced trainer incarnation still running?")
            rm = replace(candidate, seq=seq)
            if self.commit(rm):
                return rm
        raise RunManifestError(
            f"could not claim a RunManifest sequence number after "
            f"{max_attempts} attempts (is another trainer committing?)")

    def watermark_source(self, stream: Optional[str] = None
                         ) -> Callable[[], Optional[Watermark]]:
        """A Reclaimer ``watermark_source``: the boundary of the last
        *committed* aligned checkpoint (None until one exists)."""
        def source() -> Optional[Watermark]:
            rm = self.latest()
            if rm is None:
                return None
            return rm.watermark(stream)
        return source
