"""Fault-tolerance demo through the checkpoint-aligned run facade: producer
crash + exactly-once takeover, a trainer killed *between* model upload and
RunManifest commit (the window that breaks naive two-file checkpointing),
aligned rollback via TrainSession.resume, and reclamation bounded by the last
aligned checkpoint — the paper's §5.3 end to end.

The twin of ``examples/failover.py`` on the PyTorch/CUDA port
(``repro_torch``): the same story through the same calls, host code
only (no tensor, no kernel).

Run:  PYTHONPATH=src python examples/failover_torch.py
"""
import numpy as np

from repro_torch.core import FaultInjector, InjectedCrash, MemoryObjectStore
from repro_torch.dataplane import Topology
from repro_torch.run import TrainSession

store = MemoryObjectStore(faults=FaultInjector())
topo = Topology(dp=1, cp=1, global_batch=2, seq_len=32)
session = TrainSession(store, topo, namespace="runs/failover")


def token_stream(seed: int, n_batches: int) -> np.ndarray:
    """Deterministic preprocessing output: crash/replay yields identical TGBs."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, 997, n_batches * topo.global_batch * topo.seq_len)


# -- 1. producer crashes mid-commit ------------------------------------------
store.faults.crash_on("cput", key_substr=".manifest", nth=4)
crashed_at = 0
try:
    with session.writer("W") as w:
        for chunk in np.split(token_stream(seed=42, n_batches=10), 10):
            w.write_tokens(chunk)
            crashed_at = w.producer.next_offset  # offset the crash interrupts
            w.flush()
except InjectedCrash:
    print(f"producer W crashed mid-commit at stream offset {crashed_at}")
store.faults = FaultInjector()

# -- 2. replacement takes over exactly-once ------------------------------------
view = session.manifest_view()
print(f"durable state says W committed through offset "
      f"{view.producer_offset('W')} ({view.total_steps} steps visible)")
with session.writer("W") as w2:
    resume = w2.recovered_offset
    w2.seek(0)  # deterministic replay from the stream start
    w2.write_tokens(token_stream(seed=42, n_batches=10))
    # exit: finalize — exactly-once dedup drops offsets < resume
view = session.manifest_view()
seqs = [t.producer_seq for t in view.tgbs]
assert seqs == sorted(set(seqs)), "duplicate or reordered offsets!"
print(f"replacement resumed at offset {resume}; stream is dense: "
      f"{seqs[:4]}...{seqs[-2:]} (no dups, no gaps)")

# -- 3. trainer killed between model upload and RunManifest commit -------------
reader = session.reader()
first = [reader.next_batch(timeout_s=5) for _ in range(4)]
model = {"w": np.arange(4, dtype=np.float32)}
entry = session.checkpoint(model)  # ONE commit binds model + cursor @ step 4
print(f"aligned checkpoint committed: RunManifest seq {entry.seq} "
      f"@ step {entry.step}")
lost = [reader.next_batch(timeout_s=5) for _ in range(2)]   # steps 4, 5
store.faults.crash_on("cput", key_substr=".rm", nth=1)      # the fatal window
try:
    session.checkpoint({"w": model["w"] * -1.0})
    raise AssertionError("injected crash never fired")
except InjectedCrash:
    print("trainer crashed AFTER model upload, BEFORE RunManifest commit")
store.faults = None

# -- 4. aligned resume: old model + old cursor, together, exactly-once ---------
resumed = TrainSession.resume(store, "runs/failover")
state = resumed.restore_model({"w": np.zeros(4, np.float32)})
assert np.array_equal(np.asarray(state["w"]), model["w"]), \
    "resume must yield the ALIGNED model, not the half-committed one"
replayer = resumed.reader()
replay = [replayer.next_batch(timeout_s=5) for _ in range(2)]
assert [b.payload for b in replay] == [b.payload for b in lost]
print(f"resumed at step {resumed.resume_step}: aligned model restored and "
      f"the lost window replayed byte-identically")

# -- 5. reclamation below the last aligned checkpoint --------------------------
deleted = resumed.reclaim()
print(f"reclaimer deleted {deleted} TGBs below the aligned checkpoint; "
      f"store now {store.total_bytes()} bytes")
print("OK: exactly-once + aligned model/data recovery + reclamation all hold")
