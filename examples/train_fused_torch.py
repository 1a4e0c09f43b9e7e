"""Training example on the PyTorch/CUDA port: a decoder LM trained straight
off the tgb data plane through ``FusedTrainLoop``.

A writer packs a deterministic token stream into TGBs and commits them
through the manifest protocol into an in-memory object store with the
S3-class latency model; one reader per (d, c) position of a dp 2 x cp 2
mesh range-reads its slice, and the loop's staging thread fans the
slices into ``(GB, S)`` grids and stages them on the device (pinned slots
and a side-stream copy on the card) while the step runs. On the card every
RMSNorm and attention forward runs its hand-written Hopper kernel;
``--device cpu`` runs their plain PyTorch versions. Prints each step's loss,
then tokens/s and the data_wait / h2d / compute / other split. Nothing is
written to disk.

Run:  PYTHONPATH=src python examples/train_fused_torch.py [--steps 12]
      PYTHONPATH=src python examples/train_fused_torch.py --device cpu
"""
import argparse

import numpy as np

from repro_torch.core import LatencyModel, MemoryObjectStore
from repro_torch.dataplane import Topology, open_dataplane
from repro_torch.kernels import common as kcommon
from repro_torch.models import ModelConfig, init_params, param_specs
from repro_torch.models.common import resolve_device
from repro_torch.train import (OptimizerConfig, StepConfig, init_opt_state,
                               make_train_step)
from repro_torch.train.pipeline import FusedTrainLoop, ReaderFanInSource


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=12)
    ap.add_argument("--depth", type=int, default=2,
                    help="staging-ring depth (0: synchronous fetch + h2d)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default: the Hopper kernels) or cpu")
    args = ap.parse_args()
    dev = resolve_device(args.device)

    # head_dim 64: inside the flash-attention kernel's range on the card
    cfg = ModelConfig(name="fused-demo", family="dense", num_layers=4,
                      d_model=256, num_heads=4, num_kv_heads=2, d_ff=1024,
                      vocab_size=4096)
    topo = Topology(dp=2, cp=2, global_batch=4, seq_len=256)
    session = open_dataplane(MemoryObjectStore(latency=LatencyModel()), topo,
                             namespace="runs/fused_demo")

    # -- produce: pack the stream into TGBs, commit them through the manifest
    n = (args.steps + 1) * topo.global_batch * topo.seq_len
    stream = ((np.arange(n) * 7 + 3) % cfg.vocab_size).astype(np.int32)
    with session.writer("w0") as w:
        offsets = w.write_tokens(stream)
    print(f"produced {len(offsets)} TGBs of {topo.global_batch} x "
          f"{topo.seq_len} tokens (dp={topo.dp}, cp={topo.cp})")

    # -- consume: one reader per mesh position, fanned in by the loop
    readers = [session.reader(dp_rank=d, cp_rank=c)
               for d in range(topo.dp) for c in range(topo.cp)]
    params = init_params(param_specs(cfg), seed=0, device=dev)
    step_fn = make_train_step(
        cfg, OptimizerConfig(learning_rate=3e-3, warmup_steps=2,
                             total_steps=args.steps), StepConfig())
    kcommon.reset_launches()
    with FusedTrainLoop(ReaderFanInSource(readers, topo), step_fn, params,
                        init_opt_state(params), topology=topo,
                        depth=args.depth, device=dev) as loop:
        report = loop.run(args.steps)
    session.close()

    for t in report.timings:
        print(f"step {t.step:3d}  loss {t.loss:.4f}  "
              f"{t.wall_s * 1e3:8.1f} ms")
    split = report.stall_fractions()
    print(f"{report.tokens_per_s:.1f} tokens/s on {dev}; split "
          + ", ".join(f"{k} {v:.3f}" for k, v in split.items()))
    print(f"kernel launches: {kcommon.launches}")


if __name__ == "__main__":
    main()
