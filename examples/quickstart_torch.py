"""BatchWeave quickstart: the full data-plane story through the unified
facade, in ~50 lines.

Two producers materialize TGBs and race manifest commits (DAC-gated); four
training ranks (DP=2 x CP=2) each read only their (d, c) slice as decoded
token arrays; checkpoint tokens drive watermarks; the reclaimer trims
everything below W_global; a replacement writer resumes exactly-once.

The twin of ``examples/quickstart.py`` on the PyTorch/CUDA port
(``repro_torch``): the same story through the same calls, host code
only (no tensor, no kernel).

Run:  PYTHONPATH=src python examples/quickstart_torch.py
"""
import numpy as np

from repro_torch.core import MemoryObjectStore
from repro_torch.dataplane import Topology, open_dataplane

store = MemoryObjectStore()
topo = Topology(dp=2, cp=2, global_batch=4, seq_len=16)
session = open_dataplane(store, topo, backend="tgb",
                         namespace="runs/quickstart")

# -- produce: two uncoordinated preprocessing workers -------------------------
rng = np.random.default_rng(0)
for i in range(2):
    with session.writer(f"worker{i}") as w:          # enter: recover offset
        for _ in range(3):
            # stage 1 (immutable TGB write) + stage 2 (DAC-gated conditional
            # manifest put) behind one call; exit: finalize drains pending
            w.write_tokens(rng.integers(0, 997, topo.global_batch * topo.seq_len))

view = session.manifest_view()
offsets = {k: v.committed_offset for k, v in view.producers.items()}
print(f"manifest v{view.version}: {view.total_steps} global batches, "
      f"producer offsets={offsets}")

# -- consume: 4 data-relevant mesh positions (TP/PP ranks would reuse these) --
readers = {(d, c): session.reader(dp_rank=d, cp_rank=c)
           for d in range(2) for c in range(2)}
for s in range(6):
    shards = {dc: r.next_batch(timeout_s=5) for dc, r in readers.items()}
    assert all(b.tokens.shape == (2, 8) and b.step == s
               for b in shards.values())
r00 = readers[(0, 0)]
print(f"consumed 6 steps; rank(0,0) cursor={r00.checkpoint().as_tuple()}, "
      f"read amplification={r00.stats.read_amplification:.2f}x")

# -- checkpoint + lifecycle ----------------------------------------------------
for rank, reader in enumerate(readers.values()):
    session.save_watermark(rank, reader.checkpoint())
deleted = session.reclaim()
print(f"reclaimed {deleted} TGBs "
      f"({session.reclaim_stats.bytes_reclaimed} bytes) below W_global")

# -- failover: a replacement worker resumes exactly-once -----------------------
with session.writer("worker0") as replacement:
    print(f"worker0 replacement resumes at stream offset "
          f"{replacement.recovered_offset}")
