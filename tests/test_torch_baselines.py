"""The port's two baselines (``repro_torch.data.{mq,colocated}`` and their
facade backends) and its roofline, against the JAX package.

Twins of ``tests/test_data_pipeline.py:62-113`` and of the mq and colocated
cases of ``tests/test_dataplane.py`` run on the port; the cross-package
cases hold the broker's messages, the Checkpoint tokens and the fused loop's
grids byte for byte, and the loop's losses within the whole-model fp32
tolerance of ``tests/test_torch_fused_train.py`` (1e-4).
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")
pytest.importorskip("msgpack")

import repro.data as jdata  # noqa: E402
import repro.dataplane as jdp  # noqa: E402
import repro_torch.data as tdata  # noqa: E402
import repro_torch.dataplane as tdp  # noqa: E402
from repro_torch.core import (BatchTimeout, FaultInjector,  # noqa: E402
                              InjectedCrash, MemoryObjectStore)
from repro_torch.core.tgb import build_uniform_tgb  # noqa: E402
from repro_torch.data import (BrokerConfig, ColocatedConfig,  # noqa: E402
                              ColocatedPipeline, KafkaSimBroker,
                              KafkaTGBConsumer, KafkaTGBProducer)
from repro_torch.data.packing import GlobalBatchPacker, assemble_grid  # noqa: E402
from repro_torch.dataplane import (BatchReader, BatchWriter,  # noqa: E402
                                   Checkpoint, Topology, UnsupportedOperation,
                                   available_backends, open_dataplane)

TOPO = Topology(dp=2, cp=2, global_batch=4, seq_len=16)
BACKENDS = ("tgb", "mq", "colocated")


def _token_stream(n_batches: int, seed: int = 7) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.integers(0, 31_000, n_batches * TOPO.global_batch * TOPO.seq_len
                        ).astype(np.int32)


def _fill(session, n_batches: int, writer_id: str = "w0") -> None:
    with session.writer(writer_id) as w:
        w.write_tokens(_token_stream(n_batches))
        w.flush()


def _drain(session, n_batches: int):
    out = {}
    for d in range(TOPO.dp):
        for c in range(TOPO.cp):
            r = session.reader(dp_rank=d, cp_rank=c)
            out[(d, c)] = [r.next_batch(timeout_s=5) for _ in range(n_batches)]
    return out


def _target(backend: str):
    return {"tgb": MemoryObjectStore, "mq": KafkaSimBroker}.get(
        backend, lambda: None)()


# ---------------------------------------------------------------------------
# twins of tests/test_data_pipeline.py:62-113
# ---------------------------------------------------------------------------

def test_kafka_strict_tgb_size_limit():
    br = KafkaSimBroker(BrokerConfig(max_message_bytes=10_000))
    p = KafkaTGBProducer(br)
    assert p.publish_tgb(build_uniform_tgb("a", 2, 1, "p", 0, 1000)) is not None
    assert p.publish_tgb(build_uniform_tgb("b", 2, 1, "p", 1, 100_000)) is None
    assert br.stats.append_failures_size == 1


def test_kafka_consumer_read_amplification_is_world_size():
    br = KafkaSimBroker()
    p = KafkaTGBProducer(br)
    for i in range(3):
        p.publish_tgb(build_uniform_tgb(f"t{i}", 4, 1, "p", i, 50_000))
    c = KafkaTGBConsumer(br, d=0, c=0, dp=4, cp=1)
    for _ in range(3):
        c.next_batch(1.0)
    assert c.read_amplification > 3.5  # ~D = 4


def test_kafka_ordering_is_total():
    br = KafkaSimBroker()
    p = KafkaTGBProducer(br)
    blobs = [build_uniform_tgb(f"t{i}", 1, 1, "p", i, 100) for i in range(5)]
    for b in blobs:
        p.publish_tgb(b)
    assert [br.fetch(i) for i in range(5)] == blobs


def test_colocated_crash_stalls_training():
    cp = ColocatedPipeline(
        ColocatedConfig(workers=2, node_cpu=8, train_cpu=2,
                        trainer_ranks_per_node=1, queue_depth=2),
        preprocess_cost_s=lambda i: 0.001, batch_cpu_items=2)
    cp.start()
    tr1 = cp.run_training(steps=3, gpu_step_s=0.001)
    assert len(tr1.latencies) == 3
    cp.inject_crash()
    tr2 = cp.run_training(steps=3, gpu_step_s=0.001, stall_timeout_s=0.2)
    cp.stop()
    assert len(tr2.latencies) < 3  # the job stalled: no failure isolation


def test_colocated_contention_slows_steps():
    fast = ColocatedPipeline(
        ColocatedConfig(workers=1, node_cpu=64, train_cpu=1,
                        trainer_ranks_per_node=1),
        preprocess_cost_s=lambda i: 0.0005, batch_cpu_items=1)
    slow = ColocatedPipeline(
        ColocatedConfig(workers=12, node_cpu=8, train_cpu=4,
                        trainer_ranks_per_node=8),
        preprocess_cost_s=lambda i: 0.0005, batch_cpu_items=1)
    assert slow._slowdown() > fast._slowdown() >= 1.0


def test_contention_model_and_defaults_equal_the_reference():
    """The 64-core node of the paper: 12 workers a rank, 8 ranks, 16 cores
    of training host work -> a 1.75x tax, in both packages."""
    assert ColocatedConfig() == ColocatedConfig(**vars(jdata.ColocatedConfig()))
    assert BrokerConfig() == BrokerConfig(**vars(jdata.BrokerConfig()))
    for cfg in (ColocatedConfig(), ColocatedConfig(workers=3, node_cpu=8)):
        t = ColocatedPipeline(cfg, lambda i: 0.0, 1)
        j = jdata.ColocatedPipeline(jdata.ColocatedConfig(**vars(cfg)),
                                    lambda i: 0.0, 1)
        assert t._slowdown() == j._slowdown()
    assert ColocatedPipeline(ColocatedConfig(), lambda i: 0.0,
                             1)._slowdown() == 1.75


# ---------------------------------------------------------------------------
# twins of the mq and colocated cases of tests/test_dataplane.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["tgb", "mq"])
def test_backend_parity_with_the_host_packer(backend):
    """Twin of ``test_backend_parity_tgb_vs_mq``: each writing backend
    yields every (d, c) quadrant of the packer's grids, in order."""
    n = 4
    session = open_dataplane(_target(backend), TOPO, backend=backend,
                             namespace="runs/parity")
    _fill(session, n)
    got = _drain(session, n)
    packer = GlobalBatchPacker(TOPO.global_batch, TOPO.seq_len, TOPO.dp,
                               TOPO.cp)
    want = list(packer.add_tokens(_token_stream(n)))
    for dc, batches in got.items():
        assert [b.payload for b in batches] == [w.slices[dc] for w in want]
        assert [b.step for b in batches] == list(range(n))
        for b in batches:
            assert b.tokens.shape == (TOPO.samples_per_slice,
                                      TOPO.seq_per_rank)
    step0 = [got[dc][0].payload for dc in sorted(got)]
    assert len(set(step0)) == len(step0)


@pytest.mark.parametrize("backend", BACKENDS)
def test_readers_conform_to_protocols(backend):
    topo = TOPO if backend != "colocated" else Topology(dp=1)
    opts = {"batch_cpu_items": 1} if backend == "colocated" else {}
    s = open_dataplane(_target(backend), topo, backend=backend, **opts)
    assert isinstance(s.reader(), BatchReader)
    assert isinstance(s.writer("wp"), BatchWriter)


@pytest.mark.parametrize("backend", BACKENDS)
def test_checkpoint_resume(backend):
    """Twin of ``test_checkpoint_resume_replays_identical_batches``: tgb and
    mq replay the same batches from an encoded token; colocated's volatile
    queue only repositions the step counter (the reference's documented
    consistency gap)."""
    if backend == "colocated":
        session = open_dataplane(
            None, Topology(dp=2), backend="colocated",
            config=ColocatedConfig(workers=1, queue_depth=4),
            batch_cpu_items=2)
        with session.writer():
            r = session.reader()
            [r.next_batch(timeout_s=5) for _ in range(2)]
            ck = r.checkpoint()
            assert (ck.backend, ck.version, ck.step) == ("colocated", -1, 2)
            resumed = open_dataplane(None, Topology(dp=2),
                                     backend="colocated", resume=ck.encode(),
                                     batch_cpu_items=2)
            assert resumed.reader().step == 2
        session.close()
        return
    target = _target(backend)
    session = open_dataplane(target, TOPO, backend=backend,
                             namespace="runs/resume")
    _fill(session, 6)
    r = session.reader(dp_rank=1, cp_rank=0)
    first = [r.next_batch(timeout_s=5) for _ in range(4)]
    r2 = session.reader(dp_rank=1, cp_rank=0)
    for _ in range(2):
        r2.next_batch(timeout_s=5)
    ck = r2.checkpoint()
    assert ck.step == 2
    resumed = open_dataplane(target, TOPO, backend=backend,
                             namespace="runs/resume", resume=ck.encode())
    r3 = resumed.reader(dp_rank=1, cp_rank=0)
    replay = [r3.next_batch(timeout_s=5) for _ in range(2)]
    assert [b.payload for b in replay] == [b.payload for b in first[2:4]]


@pytest.mark.parametrize("backend", ["mq", "colocated"])
def test_baseline_restore_refuses_another_topology(backend):
    here = TOPO if backend == "mq" else Topology(dp=2)
    opts = {"batch_cpu_items": 2} if backend == "colocated" else {}
    r = open_dataplane(None, here, backend=backend, **opts).reader()
    with pytest.raises(UnsupportedOperation, match="no topology remap"):
        r.restore(Checkpoint(backend, -1, 3, topology=(4, 1)))
    with pytest.raises(ValueError, match="cannot restore"):
        r.restore(Checkpoint("tgb", 0, 3))


def test_batch_timeout_contract_all_backends():
    tgb = open_dataplane(MemoryObjectStore(), TOPO, backend="tgb")
    with pytest.raises(BatchTimeout):
        tgb.reader().next_batch(timeout_s=0.05)

    mq = open_dataplane(
        None, TOPO, backend="mq",
        broker_config=BrokerConfig(request_timeout_s=0.05))
    with pytest.raises(BatchTimeout):
        mq.reader().next_batch(timeout_s=0.05)

    coloc = open_dataplane(
        None, Topology(dp=2), backend="colocated",
        config=ColocatedConfig(workers=1, queue_depth=2),
        preprocess_cost_s=lambda i: 10.0, batch_cpu_items=2)
    with coloc.writer():
        with pytest.raises(BatchTimeout):
            coloc.reader().next_batch(timeout_s=0.1)
    assert issubclass(BatchTimeout, TimeoutError)


def test_colocated_crash_stalls_reader():
    session = open_dataplane(
        None, Topology(dp=2), backend="colocated",
        config=ColocatedConfig(workers=2, queue_depth=4),
        preprocess_cost_s=lambda i: 0.0, batch_cpu_items=2)
    with session.writer() as w:
        r = session.reader()
        b = r.next_batch(timeout_s=5)
        assert b.step == 0 and len(b.payload) == 2 * 4  # 2 int32 indices
        w.inject_crash()  # no failure isolation: the trainer stalls
        with pytest.raises(BatchTimeout):
            for _ in range(64):
                r.next_batch(timeout_s=0.5)
    session.close()


def test_colocated_writer_context_is_reenterable():
    session = open_dataplane(
        None, Topology(dp=2), backend="colocated",
        config=ColocatedConfig(workers=2, queue_depth=2),
        preprocess_cost_s=lambda i: 0.0, batch_cpu_items=2)
    r = session.reader()
    with session.writer():
        r.next_batch(timeout_s=5)
    try:
        while True:
            r.next_batch(timeout_s=0.2)
    except BatchTimeout:
        pass
    with session.writer():
        assert r.next_batch(timeout_s=5) is not None
    session.close()


def test_mq_writer_replay_is_exactly_once():
    session = open_dataplane(None, TOPO, backend="mq")
    stream = _token_stream(4, seed=11)
    with session.writer("w0") as w:
        assert w.write_tokens(stream) == [0, 1, 2, 3]
    with session.writer("w0") as w2:
        assert w2.recovered_offset == 4
        assert w2.write_tokens(stream) == []  # all dedup'd
        assert w2.write_tokens(_token_stream(1, seed=12)) == [4]
    r = session.reader(dp_rank=0, cp_rank=0)
    steps = [r.next_batch(timeout_s=5).step for _ in range(5)]
    assert steps == list(range(5))
    with pytest.raises(BatchTimeout):
        r.next_batch(timeout_s=0.1)


def test_colocated_writer_rejects_explicit_writes():
    session = open_dataplane(None, Topology(dp=1), backend="colocated",
                             batch_cpu_items=1)
    with pytest.raises(UnsupportedOperation):
        session.writer().write(uniform_slice_bytes=8)
    with pytest.raises(UnsupportedOperation):
        session.writer().write_tokens(np.zeros(4, np.int32))
    with pytest.raises(UnsupportedOperation):
        session.reclaim()


def test_unknown_backend_lists_available():
    with pytest.raises(ValueError, match="colocated, mq, tgb"):
        open_dataplane(MemoryObjectStore(), TOPO, backend="nope")
    assert set(available_backends()) >= {"tgb", "mq", "colocated"}


def test_writer_crash_recovery_then_mq_replay_matches_tgb():
    """The tgb writer's kill-and-recover path and mq's offset recovery give
    the same dense stream."""
    store = MemoryObjectStore(faults=FaultInjector())
    tgb = open_dataplane(store, TOPO, backend="tgb", namespace="runs/cr")
    mq = open_dataplane(None, TOPO, backend="mq")
    stream = _token_stream(6, seed=3)
    store.faults.crash_on("cput", key_substr=".manifest", nth=3)
    with pytest.raises(InjectedCrash):
        with tgb.writer("W") as w:
            for chunk in np.split(stream, 6):
                w.write_tokens(chunk)
                w.flush()
    store.faults = None
    with tgb.writer("W") as w2:
        w2.seek(0)
        w2.write_tokens(stream)
    with mq.writer("W") as w:
        w.write_tokens(stream[:3 * TOPO.global_batch * TOPO.seq_len])
    with mq.writer("W") as w:
        w.seek(0)
        w.write_tokens(stream)
    a, b = _drain(tgb, 6), _drain(mq, 6)
    for dc in a:
        assert [x.payload for x in a[dc]] == [y.payload for y in b[dc]]


# ---------------------------------------------------------------------------
# across packages
# ---------------------------------------------------------------------------

def _mq_pair(n_batches: int):
    """The same stream written by each package's mq writer into its own
    broker: (port broker, JAX broker)."""
    stream = _token_stream(n_batches)
    tb, jb = KafkaSimBroker(), jdata.KafkaSimBroker()
    with tdp.open_dataplane(tb, TOPO, backend="mq").writer("w0") as w:
        w.write_tokens(stream)
    jtopo = jdp.Topology(dp=TOPO.dp, cp=TOPO.cp,
                         global_batch=TOPO.global_batch, seq_len=TOPO.seq_len)
    with jdp.open_dataplane(jb, jtopo, backend="mq").writer("w0") as w:
        w.write_tokens(stream)
    return tb, jb, jtopo


def test_mq_messages_batches_and_tokens_equal_the_reference():
    tb, jb, jtopo = _mq_pair(4)
    assert tb._log == jb._log          # byte-identical TGB messages
    tsess = tdp.open_dataplane(tb, TOPO, backend="mq")
    jsess = jdp.open_dataplane(jb, jtopo, backend="mq")
    for d in range(TOPO.dp):
        for c in range(TOPO.cp):
            tr, jr = tsess.reader(d, c), jsess.reader(d, c)
            for _ in range(4):
                a, b = tr.next_batch(timeout_s=5), jr.next_batch(timeout_s=5)
                assert (a.step, a.version, a.payload) == \
                    (b.step, b.version, b.payload)
                assert tr.checkpoint().encode() == jr.checkpoint().encode()
            assert tr.stats.read_amplification == \
                jr.stats.read_amplification > TOPO.world


@pytest.mark.parametrize("direction", ["repro->repro_torch",
                                       "repro_torch->repro"])
def test_mq_checkpoint_token_restores_across_packages(direction):
    tb, jb, jtopo = _mq_pair(5)
    tsess = tdp.open_dataplane(tb, TOPO, backend="mq")
    jsess = jdp.open_dataplane(jb, jtopo, backend="mq")
    src, dst = (jsess, tsess) if direction == "repro->repro_torch" \
        else (tsess, jsess)
    r = src.reader(dp_rank=1, cp_rank=1)
    [r.next_batch(timeout_s=5) for _ in range(3)]
    token = r.checkpoint().encode()
    restored = dst.reader(dp_rank=1, cp_rank=1, resume=token)
    assert restored.checkpoint().encode() == token
    assert restored.next_batch(timeout_s=5).payload == \
        r.next_batch(timeout_s=5).payload


def test_colocated_batches_equal_the_reference():
    """One worker, so the indices come in order in both packages: equal
    payloads, arrays and tokens."""
    def run(pkg, data):
        sess = pkg.open_dataplane(None, pkg.Topology(dp=2), backend="colocated",
                                  config=data.ColocatedConfig(workers=1),
                                  batch_cpu_items=3)
        with sess.writer():
            r = sess.reader()
            out = [r.next_batch(timeout_s=5) for _ in range(3)]
            tok = r.checkpoint().encode()
        sess.close()
        return [(b.step, b.version, b.payload, b.array.tobytes())
                for b in out], tok
    assert run(tdp, tdata) == run(jdp, jdata)


# ---------------------------------------------------------------------------
# the fused loop over the baselines
# ---------------------------------------------------------------------------

FUSED_TOPO = Topology(dp=2, cp=1, global_batch=4, seq_len=32)


def _fused_stream(n_batches: int, vocab: int) -> np.ndarray:
    n = n_batches * FUSED_TOPO.global_batch * FUSED_TOPO.seq_len
    return ((np.arange(n) * 7 + 3) % vocab).astype(np.int32)


def _packer_grids(tokens: np.ndarray) -> list:
    t = FUSED_TOPO
    packer = GlobalBatchPacker(t.global_batch, t.seq_len, t.dp, t.cp)
    return [assemble_grid(b.slices, t.global_batch, t.seq_len, t.dp,
                          t.cp).tobytes() for b in packer.add_tokens(tokens)]


@pytest.fixture(scope="module")
def jax_mq_slice():
    """An mq broker written by the JAX writer, the JAX step (jitted) and the
    weights both packages start from (fp32 compute), as in
    ``tests/test_torch_fused_train.py``'s tgb twin."""
    jax = pytest.importorskip("jax")
    from repro.configs.registry import get_smoke_config as jax_smoke
    from repro.models import init_params as jax_init
    from repro.models import param_specs as jax_specs
    from repro.train.optimizer import OptimizerConfig as JaxOpt
    from repro.train.step import StepConfig as JaxStepCfg
    from repro.train.step import make_train_step as jax_make_step
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.train import OptimizerConfig, StepConfig, make_train_step

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    jcfg = jax_smoke("granite_8b").replace(compute_dtype="float32")
    tcfg = get_smoke_config("granite_8b").replace(compute_dtype="float32")
    jtopo = jdp.Topology(dp=FUSED_TOPO.dp, cp=FUSED_TOPO.cp,
                         global_batch=FUSED_TOPO.global_batch,
                         seq_len=FUSED_TOPO.seq_len)
    broker = jdata.KafkaSimBroker()
    with jdp.open_dataplane(broker, jtopo, backend="mq").writer("w0") as w:
        w.write_tokens(_fused_stream(10, jcfg.vocab_size))
    jparams = jax_init(jax_specs(jcfg), seed=3)
    np_params = jax.tree_util.tree_map(np.asarray, jparams)
    jstep = jax.jit(jax_make_step(jcfg, JaxOpt(), JaxStepCfg()))
    tstep = make_train_step(tcfg, OptimizerConfig(), StepConfig())
    yield broker, jtopo, jparams, np_params, jstep, tstep, tcfg
    torch.set_num_threads(threads)


@pytest.mark.parametrize("depth", [0, 2])
def test_fused_loop_over_mq_matches_the_jax_loop(jax_mq_slice, depth):
    from repro.train.optimizer import init_opt_state as jax_init_opt
    from repro.train.pipeline import FusedTrainLoop as JaxLoop
    from repro.train.pipeline import ReaderFanInSource as JaxFanIn
    from repro_torch import convert
    from repro_torch.train import init_opt_state
    from repro_torch.train.pipeline import FusedTrainLoop, ReaderFanInSource
    broker, jtopo, jparams, np_params, jstep, tstep, tcfg = jax_mq_slice

    jsess = jdp.open_dataplane(broker, jtopo, backend="mq")
    jsrc = JaxFanIn([jsess.reader(dp_rank=d) for d in range(jtopo.dp)],
                    jtopo)
    jgrids = []
    with JaxLoop(jsrc, jstep, jparams, jax_init_opt(jparams), topology=jtopo,
                 depth=depth, timeout_s=30.0) as jloop:
        jrep = jloop.run(4, on_batch=lambda s, t: jgrids.append(t.tobytes()))

    # the port's broker over the JAX broker's log (one totally ordered log)
    tbroker = KafkaSimBroker()
    tbroker._log = broker._log
    tsess = tdp.open_dataplane(tbroker, FUSED_TOPO, backend="mq")
    tsrc = ReaderFanInSource([tsess.reader(dp_rank=d)
                              for d in range(FUSED_TOPO.dp)], FUSED_TOPO)
    params = convert.params_from_numpy(np_params, device="cpu")
    tgrids = []
    with FusedTrainLoop(tsrc, tstep, params, init_opt_state(params),
                        topology=FUSED_TOPO, depth=depth, timeout_s=30.0,
                        device="cpu") as tloop:
        trep = tloop.run(4, on_batch=lambda s, t: tgrids.append(t.tobytes()))

    assert tgrids == jgrids == \
        _packer_grids(_fused_stream(10, tcfg.vocab_size))[:4]
    np.testing.assert_allclose(trep.losses, jrep.losses, rtol=1e-4)
    # whole-message fetch: each of the D x C readers downloads the TGB
    amp = [r.stats.read_amplification for r in tsrc.readers]
    assert all(a > FUSED_TOPO.world for a in amp)


def test_colocated_arm_grids_are_the_packer_grids_of_their_indices(
        jax_mq_slice):
    """fig17's colocated arm: the worker pool's sample indices, each mapped
    to its seq_len-token slice of the stream, packed on the staging thread.
    Workers may reorder indices; every grid is the packer's grid over the
    slices its delivered indices name."""
    from repro_torch.train import init_opt_state
    from repro_torch.train.pipeline import FusedTrainLoop, PackingTokenSource
    *_, np_params, _jstep, tstep, tcfg = jax_mq_slice
    from repro_torch import convert
    t = FUSED_TOPO

    def sample_tokens(indices):
        offs = indices.astype(np.int64)[:, None] * t.seq_len \
            + np.arange(t.seq_len)[None, :]
        return ((offs.ravel() * 7 + 3) % tcfg.vocab_size).astype(np.int32)

    sess = open_dataplane(None, t, backend="colocated",
                          config=ColocatedConfig(workers=4),
                          preprocess_cost_s=lambda i: 0.0002,
                          batch_cpu_items=t.global_batch)
    reader, pulled = sess.reader(), []

    def pull(timeout_s):
        indices = np.frombuffer(reader.next_batch(timeout_s=timeout_s).payload,
                                dtype=np.int32)
        pulled.append(indices.copy())
        return sample_tokens(indices)

    params = convert.params_from_numpy(np_params, device="cpu")
    grids = []
    with sess.writer():
        with FusedTrainLoop(PackingTokenSource(pull, t), tstep, params,
                            init_opt_state(params), topology=t, depth=2,
                            timeout_s=30.0, device="cpu") as loop:
            rep = loop.run(4, on_batch=lambda s, g: grids.append(g.tobytes()))
    sess.close()
    assert len(grids) == 4 and np.isfinite(rep.losses).all()
    for grid, indices in zip(grids, pulled):
        assert grid == _packer_grids(sample_tokens(indices))[0]
    # every index is drawn once: no sample is delivered twice
    seen = np.concatenate(pulled)
    assert len(set(seen.tolist())) == len(seen)


# ---------------------------------------------------------------------------
# roofline
# ---------------------------------------------------------------------------

RECORDS = [
    dict(kind="train", family="dense", params=8.255e9, global_batch=4,
         seq_len=1024, mesh="16x16"),
    dict(kind="decode", family="moe", params=16e9, active_params=2.8e9,
         global_batch=64, seq_len=32768, mesh="2x16x16"),
    dict(kind="prefill", family="dense", params=3.1e9, global_batch=8,
         seq_len=1000, mesh="16x16"),
]


@pytest.mark.parametrize("rec", RECORDS, ids=lambda r: r["kind"])
def test_roofline_formulas_equal_the_reference(rec):
    from repro.launch import roofline as jroof
    from repro_torch.launch import roofline as troof
    assert troof.tokens_per_step(rec) == jroof.tokens_per_step(rec)
    assert troof.model_flops(rec) == jroof.model_flops(rec)
    assert troof.chips(rec) == jroof.chips(rec)
    for kind in ("train", "decode"):
        args = (rec["params"], troof.tokens_per_step(rec), kind,
                troof.chips(rec))
        assert troof.ideal_step_s(*args, peak_flops=197e12) == \
            jroof.ideal_step_s(*args, peak_flops=197e12)


def test_roofline_constants_are_the_h100s():
    from repro_torch.launch import roofline as troof
    assert (troof.PEAK_FLOPS, troof.HBM_BW, troof.NVLINK_BW) == \
        (989e12, 3.35e12, 450e9)
    # granite-8b cut to 8 layers, 4 x 1024 tokens: 6 N D / 989 TFLOP/s
    assert troof.ideal_step_s(2.148e9, 4096) == \
        pytest.approx(6 * 2.148e9 * 4096 / 989e12)
    # the dry-run readers, refused until the port had a dry run, read its
    # records with these constants (the cases: tests/test_torch_dryrun.py)
    assert (troof.LINK_BW, troof.HBM_PER_CHIP) == (50e9, 80 * 2**30)
    row = troof.analyze_record({
        "arch": "a", "shape": "s", "mesh": "16x16", "status": "ok",
        "kind": "train", "family": "dense", "params": 1e9,
        "global_batch": 256, "seq_len": 4096,
        "hlo": {"flops": 989e12, "bytes_accessed": 3.35e12,
                "total_collective_bytes": 25e9},
        "memory": {"peak_per_device_bytes": 2**30}})
    assert (row.compute_s, row.memory_s, row.collective_s) == (1.0, 1.0, 0.5)
