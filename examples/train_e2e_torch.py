"""End-to-end example on the PyTorch/CUDA port: train a decoder LM fed through
the checkpoint-aligned ``TrainSession`` — model state and data cursors are
bound atomically in one RunManifest commit, reclamation trims only below the
last aligned checkpoint, and a mid-run restart (optionally at a resized DP
degree) resumes the exact batch sequence. The twin of
``examples/train_e2e.py``: the same profiles, flags and producers (two
threads through ``PreprocessWorker``), on the CUDA card unless ``--device
cpu``; on the card every RMSNorm and attention forward runs its
hand-written Hopper kernel.

Run:  PYTHONPATH=src python examples/train_e2e_torch.py [--steps 60]
      [--profile small] [--restart-at 30 [--restart-dp 4]] [--device cpu]
"""
import argparse
import threading
import time

import numpy as np
import torch

from repro_torch.core import MemoryObjectStore
from repro_torch.core.dac import DACPolicy
from repro_torch.data import (PipelineConfig, PreprocessConfig,
                              PreprocessWorker)
from repro_torch.dataplane import Topology
from repro_torch.models import ModelConfig, init_params, param_specs
from repro_torch.models.common import resolve_device
from repro_torch.run import TrainSession
from repro_torch.train import (OptimizerConfig, StepConfig, init_opt_state,
                               make_train_step)

PROFILES = {
    "small": dict(num_layers=4, d_model=256, num_heads=4, num_kv_heads=2,
                  d_ff=1024, vocab_size=4096, gb=4, seq=128),
    "100m": dict(num_layers=10, d_model=640, num_heads=10, num_kv_heads=5,
                 d_ff=2560, vocab_size=32000, gb=8, seq=512),
}

NAMESPACE = "runs/train_e2e"


class Backlog:
    """How far the producers run ahead of the trainer, in TGBs. The port's
    eager step dispatches every op from Python, so producer threads left to
    run free (as the JAX example's, beside its one jitted call) would hold
    the GIL against it; here they park once ``lead`` TGBs are unconsumed."""

    def __init__(self, lead: int = 16):
        self.lead = lead
        self.produced = 0
        self.consumed = 0.0   # TGBs, in the run's materialized layout
        self.lock = threading.Lock()

    def wait_for_room(self, stop: threading.Event) -> None:
        while not stop.is_set():
            with self.lock:
                if self.produced - self.consumed < self.lead:
                    return
            stop.wait(0.01)


def start_producers(session: TrainSession, pc: PipelineConfig,
                    stop: threading.Event, backlog: Backlog):
    """Disaggregated preprocessing workers (background threads). Writers are
    vended by the session, so after an elastic restart they keep
    materializing at the run's original layout."""
    def producer_thread(pid: int):
        with session.writer(f"w{pid}", policy=DACPolicy(), max_lag=64) as w:
            worker = PreprocessWorker(pc, PreprocessConfig(), w.producer,
                                      sample_stride=2, sample_offset=pid)
            while not stop.is_set():
                backlog.wait_for_room(stop)
                made = worker.produce_n_tgbs(4, stop=stop)
                w.flush()
                with backlog.lock:
                    backlog.produced += made

    threads = [threading.Thread(target=producer_thread, args=(i,), daemon=True)
               for i in range(2)]
    for t in threads:
        t.start()
    return threads


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--profile", default="small", choices=list(PROFILES))
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--restart-at", type=int, default=None,
                    help="simulate a crash+aligned-restore at this step")
    ap.add_argument("--restart-dp", type=int, default=None,
                    help="resume on this DP degree (elastic factor resize; "
                         "default: same topology)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default: the Hopper kernels) or cpu")
    args = ap.parse_args()
    dev = resolve_device(args.device)
    prof = PROFILES[args.profile]
    dp = 2

    cfg = ModelConfig(name=f"e2e-{args.profile}", family="dense",
                      num_layers=prof["num_layers"], d_model=prof["d_model"],
                      num_heads=prof["num_heads"],
                      num_kv_heads=prof["num_kv_heads"], d_ff=prof["d_ff"],
                      vocab_size=prof["vocab_size"])
    n_params = cfg.param_count()
    print(f"model: {n_params / 1e6:.1f}M params | global_batch={prof['gb']} "
          f"seq={prof['seq']} dp={dp} | device {dev}")

    store = MemoryObjectStore()
    topo = Topology(dp=dp, cp=1, global_batch=prof["gb"], seq_len=prof["seq"])
    session = TrainSession(store, topo, namespace=NAMESPACE)
    pc = PipelineConfig(global_batch=prof["gb"], seq_len=prof["seq"], dp=dp,
                        cp=1, vocab_size=cfg.vocab_size, seed=17)
    stop = threading.Event()
    backlog = Backlog()
    threads = start_producers(session, pc, stop, backlog)

    # -- trainer ----------------------------------------------------------------
    params = init_params(param_specs(cfg), seed=0, device=dev)
    opt = init_opt_state(params)
    step_fn = make_train_step(
        cfg, OptimizerConfig(learning_rate=3e-3, warmup_steps=10,
                             total_steps=max(100, args.steps)),
        StepConfig(microbatches=1))
    readers = [session.reader(dp_rank=d, prefetch_depth=4) for d in range(dp)]

    def one_step(params, opt):
        shards = [r.next_batch(timeout_s=120).tokens for r in readers]
        tokens = torch.from_numpy(np.concatenate(shards, axis=0)).to(dev)
        return step_fn(params, opt, {"tokens": tokens})

    t0 = time.time()
    losses = []
    s = 0
    cur_dp = dp
    while s < args.steps:
        params, opt, metrics = one_step(params, opt)
        losses.append(float(metrics["loss"]))
        s += 1
        with backlog.lock:
            backlog.consumed = s * cur_dp / dp
        if s % args.ckpt_every == 0:
            # ONE commit binds model state + every rank's data cursor
            entry = session.checkpoint({"params": params, "opt": opt})
            reclaimed = session.reclaim()
            print(f"step {s:4d} loss={losses[-1]:.3f} "
                  f"lr={float(metrics['lr']):.2e} "
                  f"aligned@{entry.step} (seq {entry.seq}) "
                  f"store={store.total_bytes() / 2**20:.1f}MiB "
                  f"reclaimed={reclaimed} tgbs "
                  f"({(time.time() - t0) / s:.2f}s/step)")
        if args.restart_at is not None and s == args.restart_at:
            new_dp = args.restart_dp or dp
            print(f"--- simulating trainer crash at step {s}; aligned "
                  f"restore at dp={new_dp} ---")
            new_topo = None
            if new_dp != dp:
                new_topo = Topology(dp=new_dp, cp=1,
                                    global_batch=prof["gb"] * new_dp // dp,
                                    seq_len=prof["seq"])
            session.close()
            t_restore = time.time()
            session = TrainSession.resume(store, NAMESPACE,
                                          topology=new_topo)
            state = session.restore_model({"params": params, "opt": opt})
            params, opt = state["params"], state["opt"]
            readers = [session.reader(dp_rank=d, prefetch_depth=4)
                       for d in range(new_dp)]
            s, cur_dp = session.resume_step, new_dp
            print(f"resumed at logical step {s} "
                  f"(RunManifest seq {session.last_entry.seq}) in "
                  f"{time.time() - t_restore:.3f}s")
            args.restart_at = None

    stop.set()
    for t in threads:
        t.join(timeout=10)
    session.close()
    print(f"first-10 mean loss {np.mean(losses[:10]):.3f} -> "
          f"last-10 mean {np.mean(losses[-10:]):.3f} "
          f"({'improved' if np.mean(losses[-10:]) < np.mean(losses[:10]) else 'no improvement'})")
    final = readers[0].checkpoint()
    print(f"consumed {final.step} global batches; "
          f"read amplification {readers[0].stats.read_amplification:.2f}x")


if __name__ == "__main__":
    main()
