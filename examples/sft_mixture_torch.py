"""Multi-stream mixture: multimodal-style pre-training/SFT data plane in ~60
lines.

Three named TGB streams (web 60%, code 30%, math-sft 10%), each an
independent manifest chain with its own producer, are deterministically
interleaved by one mixed reader. The composite checkpoint token carries every
stream's <V, S> cursor plus the mix position, so one string restores the
whole mixture exactly-once; per-stream watermarks make reclamation mix-aware.

The twin of ``examples/sft_mixture.py`` on the PyTorch/CUDA port
(``repro_torch``): the same story through the same calls, host code
only (no tensor, no kernel).

Run:  PYTHONPATH=src python examples/sft_mixture_torch.py
"""
import numpy as np

from repro_torch.core import MemoryObjectStore
from repro_torch.dataplane import Topology, open_dataplane

store = MemoryObjectStore()
topo = Topology(dp=2, cp=1, global_batch=4, seq_len=16)
MIX = {"web": 0.6, "code": 0.3, "math-sft": 0.1}
session = open_dataplane(store, topo, backend="tgb", streams=MIX,
                         mix_seed=42, namespace="runs/sft-mix")

# -- produce: one uncoordinated worker per source corpus ----------------------
TOTAL_STEPS = 20
need = session.plan.stream_counts(TOTAL_STEPS)   # what the schedule will pull
rng = np.random.default_rng(0)
for name in session.stream_names:
    with session.writer("w0", stream=name) as w:  # enter: recover offset
        for _ in range(need[name]):
            w.write_tokens(rng.integers(0, 997, topo.global_batch * topo.seq_len))
print("published per stream:",
      {n: session.manifest_view(n).total_steps for n in session.stream_names})

# -- consume: the mixed reader follows the deterministic weighted schedule ----
reader = session.reader(dp_rank=0, cp_rank=0)
tally = {n: 0 for n in session.stream_names}
for _ in range(12):
    b = reader.next_batch(timeout_s=5)
    tally[b.stream] += 1
    assert b.tokens.shape == (2, 16)
print(f"12 mixed steps consumed: {tally} "
      f"(weights {MIX}, seed 42 — same every run)")

# -- one composite token checkpoints the whole mixture ------------------------
token = reader.checkpoint().encode()
print(f"composite cursor: step={reader.checkpoint().step}, "
      f"streams={reader.checkpoint().streams}")

# -- mix-aware lifecycle: each stream trims below ITS low-watermark ----------
for rank in range(topo.world):
    session.save_watermark(rank, reader.checkpoint())
deleted = session.reclaim()
print(f"reclaimed {deleted} TGBs across streams (mix-aware watermarks)")

# -- kill-and-restore: one string resumes all streams exactly-once ------------
resumed = open_dataplane(store, topo, backend="tgb", streams=MIX,
                         mix_seed=42, namespace="runs/sft-mix", resume=token)
r2 = resumed.reader(dp_rank=0, cp_rank=0)
for _ in range(TOTAL_STEPS - 12):
    b = r2.next_batch(timeout_s=5)
print(f"resumed and drained to global step {r2.checkpoint().step} "
      f"with zero duplicated and zero skipped steps")
