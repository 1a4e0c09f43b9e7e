"""Twin of ``tests/test_system.py`` on the port: BatchWeave feeding the
port's train step, with checkpoint/rollback, producer failover and
lifecycle reclamation — the paper's full story on one CPU. The reference's
``jax.jit(make_train_step(...))`` is ``repro_torch.train.make_train_step``
on ``device="cpu"`` (eager; the port has no jit), its ``jnp`` leaves are
torch tensors, and ``train/checkpoint.py`` is the port's. Imports neither
jax nor msgpack.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.registry import get_smoke_config  # noqa: E402
from repro_torch.core import (Consumer, ManifestStore,  # noqa: E402
                              MemoryObjectStore, MeshPosition, Namespace,
                              Producer, Reclaimer)
from repro_torch.data import (PipelineConfig, PreprocessConfig,  # noqa: E402
                              PreprocessWorker)
from repro_torch.data.packing import decode_slice  # noqa: E402
from repro_torch.models import init_params, param_specs  # noqa: E402
from repro_torch.train.checkpoint import (restore_checkpoint,  # noqa: E402
                                          save_checkpoint)
from repro_torch.train.optimizer import (OptimizerConfig,  # noqa: E402
                                         init_opt_state)
from repro_torch.train.step import StepConfig, make_train_step  # noqa: E402


def _setup(n_tgbs=8, dp=2, gb=4, seq=32, vocab=257, seed=11):
    store = MemoryObjectStore()
    ns = Namespace(store, "runs/e2e")
    prod = Producer(ns, "w0", dp=dp, cp=1, manifests=ManifestStore(ns))
    pc = PipelineConfig(global_batch=gb, seq_len=seq, dp=dp, cp=1,
                        vocab_size=vocab, seed=seed)
    worker = PreprocessWorker(pc, PreprocessConfig(), prod)
    worker.produce_n_tgbs(n_tgbs)
    prod.finalize()
    return ns, pc


def test_train_loop_consumes_batchweave_batches():
    cfg = get_smoke_config("granite_8b")
    ns, pc = _setup(n_tgbs=6, vocab=cfg.vocab_size)
    params = init_params(param_specs(cfg), seed=0, device="cpu")
    opt = init_opt_state(params)
    step = make_train_step(
        cfg, OptimizerConfig(learning_rate=1e-3, warmup_steps=2,
                             total_steps=50), StepConfig(microbatches=1))
    consumers = [Consumer(ns, MeshPosition(d, 0, 2, 1)) for d in range(2)]
    losses = []
    for s in range(6):
        shards = [decode_slice(c.next_batch(2.0), pc.global_batch // 2,
                               pc.seq_len) for c in consumers]
        tokens = torch.from_numpy(np.concatenate(shards, axis=0))
        params, opt, m = step(params, opt, {"tokens": tokens})
        losses.append(float(m["loss"]))
    assert all(np.isfinite(losses))
    assert consumers[0].cursor == consumers[1].cursor == \
        (consumers[0].view.version, 6)


def test_checkpoint_rollback_replays_same_batches():
    cfg = get_smoke_config("granite_8b")
    ns, pc = _setup(n_tgbs=8, vocab=cfg.vocab_size)
    cons = Consumer(ns, MeshPosition(0, 0, 2, 1))
    seen = [cons.next_batch(2.0) for _ in range(4)]  # noqa: F841
    # checkpoint at step 4
    save_checkpoint(ns, step=4, state={"dummy": torch.zeros(2)},
                    cursor=cons.cursor, consumer_ranks=[0, 1])
    after = [cons.next_batch(2.0) for _ in range(4)]
    # crash + restore
    _state, cursor, _ = restore_checkpoint(ns, {"dummy": torch.zeros(2)})
    cons2 = Consumer(ns, MeshPosition(0, 0, 2, 1))
    cons2.restore_cursor(*cursor)
    replay = [cons2.next_batch(2.0) for _ in range(4)]
    assert replay == after


def test_producer_failover_mid_run_data_identical():
    """Kill the producer mid-stream; a replacement resumes and the consumed
    token stream equals an uninterrupted run (deterministic sources)."""
    def run(crash_after):
        store = MemoryObjectStore()
        ns = Namespace(store, "runs/f")
        pc = PipelineConfig(global_batch=2, seq_len=16, dp=1, cp=1,
                            vocab_size=97, seed=5)
        prod = Producer(ns, "W", dp=1, cp=1, manifests=ManifestStore(ns))
        w = PreprocessWorker(pc, PreprocessConfig(), prod)
        if crash_after is None:
            w.produce_n_tgbs(6)
            prod.finalize()
        else:
            w.produce_n_tgbs(crash_after)
            prod.finalize()
            # replacement process: same producer_id, fresh state
            prod2 = Producer(ns, "W", dp=1, cp=1,
                             manifests=ManifestStore(ns))
            resume_offset = prod2.recover()
            assert resume_offset >= 0
            # deterministic replay: regenerate the stream from offset 0 —
            # the commit protocol's producer-state dedup drops the TGBs the
            # manifest already made visible (exactly-once), so re-produced
            # offsets < resume_offset never land twice.
            prod2.next_offset = 0
            w2 = PreprocessWorker(pc, PreprocessConfig(), prod2)
            w2.produce_n_tgbs(6)
            prod2.finalize()
        cons = Consumer(ns, MeshPosition(0, 0, 1, 1))
        return [cons.next_batch(2.0) for _ in range(6)]

    uninterrupted = run(None)
    failover = run(3)
    assert uninterrupted == failover


def test_reclamation_during_training():
    cfg = get_smoke_config("granite_8b")
    ns, pc = _setup(n_tgbs=10, vocab=cfg.vocab_size)
    cons = Consumer(ns, MeshPosition(0, 0, 2, 1))
    cons1 = Consumer(ns, MeshPosition(1, 0, 2, 1))
    rec = Reclaimer(ns, expected_ranks=2)
    for s in range(1, 9):
        cons.next_batch(2.0)
        cons1.next_batch(2.0)
        if s % 4 == 0:
            save_checkpoint(ns, step=s, state={"x": torch.zeros(1)},
                            cursor=cons.cursor, consumer_ranks=[0, 1])
            rec.run_cycle()
    assert rec.stats.tgbs_deleted > 0
    # remaining steps (>= last checkpoint) still readable
    cons.next_batch(2.0)
