"""The port's fused train loop (``repro_torch.train.pipeline``) on the CPU.

Twins of ``tests/test_fused_train.py`` on the port's own step and tgb data
plane (the granite-8b smoke config), then the slice as a whole against the
JAX package: one store written by ``repro``'s writer, a JAX
``FusedTrainLoop`` over its jitted ``make_train_step`` and the port's loop
over the same weights (``repro_torch.convert``), at depth 0 and 2, must
consume the same grids and reach the same losses within the whole-model fp32
tolerance, 1e-4 (``tests/test_models_smoke.py:85-97``); the same over a
weighted mix of two streams read through ``MixedReader``s.
"""
from __future__ import annotations

import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.registry import get_smoke_config  # noqa: E402
from repro_torch.core import (BatchTimeout, FaultPolicy,  # noqa: E402
                              FaultyObjectStore, MemoryObjectStore)
from repro_torch.data.packing import GlobalBatchPacker, assemble_grid  # noqa: E402
from repro_torch.dataplane import Topology, open_dataplane  # noqa: E402
from repro_torch.dataplane.types import Batch, UnsupportedOperation  # noqa: E402
from repro_torch.models import init_params, param_specs  # noqa: E402
from repro_torch.models.common import tree_leaves  # noqa: E402
from repro_torch.obs.tracer import disable_tracing, enable_tracing  # noqa: E402
from repro_torch.run import TrainSession  # noqa: E402
from repro_torch.train import (OptimizerConfig, StepConfig,  # noqa: E402
                               init_opt_state, make_train_step)
from repro_torch.train.pipeline import (FusedTrainLoop,  # noqa: E402
                                        PackingTokenSource, ReaderFanInSource)

TOPO = Topology(dp=2, cp=1, global_batch=4, seq_len=32)


@pytest.fixture(scope="module")
def tiny_step():
    """The port's smoke-size train step; ``fresh()`` gives new weights and
    optimizer state (the step updates both in place).

    The split tests assume, as the reference's jitted step gives them, a
    step that is cheap next to the throttled store's GET penalty. So the
    step computes in fp32, where the reference's twin keeps the smoke
    config's bf16 (eager bf16 matmuls on the CPU are several times slower),
    and on one intra-op thread while this module runs: with
    the suite's parallel workers each torch process would otherwise start a
    thread per core, and the oversubscribed step grew long enough to hide
    the throttle behind the prefetch entirely."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    cfg = get_smoke_config("granite_8b").replace(compute_dtype="float32")
    step_fn = make_train_step(cfg, OptimizerConfig(), StepConfig())

    def fresh():
        params = init_params(param_specs(cfg), seed=0, device="cpu")
        return params, init_opt_state(params)
    yield cfg, step_fn, fresh
    torch.set_num_threads(threads)


def _token_stream(n_batches: int, vocab: int) -> np.ndarray:
    n = n_batches * TOPO.global_batch * TOPO.seq_len
    return ((np.arange(n) * 7 + 3) % vocab).astype(np.int32)


def _host_grids(stream: np.ndarray) -> list:
    """The grids' bytes as the port's packer makes them from ``stream`` on
    the host, without a store."""
    packer = GlobalBatchPacker(TOPO.global_batch, TOPO.seq_len, TOPO.dp,
                               TOPO.cp)
    return [assemble_grid(b.slices, TOPO.global_batch, TOPO.seq_len,
                          TOPO.dp, TOPO.cp).tobytes()
            for b in packer.add_tokens(stream)]


def _produce(session, n_batches: int, vocab: int) -> None:
    with session.writer("w0") as w:
        w.write_tokens(_token_stream(n_batches, vocab))


def _fan_in(session, **reader_opts) -> ReaderFanInSource:
    readers = [session.reader(dp_rank=d, **reader_opts)
               for d in range(TOPO.dp)]
    return ReaderFanInSource(readers, TOPO)


def _loop(src, step_fn, params, opt, **kw) -> FusedTrainLoop:
    kw.setdefault("depth", 2)
    return FusedTrainLoop(src, step_fn, params, opt, topology=TOPO,
                          timeout_s=30.0, device="cpu", **kw)


# ---------------------------------------------------------------------------
# exactly-once kill-and-resume
# ---------------------------------------------------------------------------

def test_kill_and_resume_replays_identical_batches_and_losses(tiny_step):
    cfg, step_fn, fresh = tiny_step
    ns = "runs/fused_resume"

    # golden: 10 uninterrupted steps
    store_a = MemoryObjectStore()
    sess_a = TrainSession(store_a, TOPO, namespace=ns)
    _produce(sess_a, 12, cfg.vocab_size)
    golden_batches = []
    params, opt = fresh()
    with _loop(_fan_in(sess_a), step_fn, params, opt) as loop:
        rep = loop.run(10, on_batch=lambda s, t: golden_batches.append(
            t.tobytes()))
    golden_losses = rep.losses
    sess_a.close()

    # run B: 4 steps, aligned checkpoint, then die with the ring staged ahead
    store_b = MemoryObjectStore()
    sess_b = TrainSession(store_b, TOPO, namespace=ns)
    _produce(sess_b, 12, cfg.vocab_size)
    b_batches = []
    params, opt = fresh()
    loop_b = _loop(_fan_in(sess_b), step_fn, params, opt)
    with loop_b:
        rep_b = loop_b.run(4, on_batch=lambda s, t: b_batches.append(
            t.tobytes()))
        entry = loop_b.aligned_checkpoint(
            sess_b, {"params": loop_b.params, "opt": loop_b.opt_state})
    assert entry.step == 4      # bound at the consumed frontier, not the ring
    sess_b.close()              # crash: staged-but-unconsumed batches lost

    # resume: same namespace, fresh process state
    sess_c = TrainSession.resume(store_b, ns)
    assert sess_c.resume_step == 4
    params, opt = fresh()
    state = sess_c.restore_model({"params": params, "opt": opt})
    loop_c = _loop(_fan_in(sess_c), step_fn, state["params"], state["opt"])
    with loop_c:
        rep_c = loop_c.run(6, on_batch=lambda s, t: b_batches.append(
            t.tobytes()))
    sess_c.close()

    # byte-identical packed batches across the kill: exactly-once at the
    # token level, not just the TGB level
    assert b_batches == golden_batches
    np.testing.assert_allclose(rep_b.losses + rep_c.losses, golden_losses,
                               rtol=1e-6)


def test_fused_loop_over_mixed_streams_aligns_composite_cursors(tiny_step):
    """MixedReader under the ring: align/rewind must round-trip the
    composite (per-stream <V, S> + mix position) cursor."""
    cfg, step_fn, fresh = tiny_step
    ns = "runs/fused_mixed"
    streams = {"web": 0.5, "code": 0.5}

    store = MemoryObjectStore()
    sess = TrainSession(store, TOPO, namespace=ns, streams=streams)
    for name in streams:
        with sess.writer("w0", stream=name) as w:
            w.write_tokens(_token_stream(8, cfg.vocab_size))

    batches = []
    params, opt = fresh()
    with _loop(_fan_in(sess), step_fn, params, opt) as loop:
        loop.run(3, on_batch=lambda s, t: batches.append(t.tobytes()))
        entry = loop.aligned_checkpoint(
            sess, {"params": loop.params, "opt": loop.opt_state})
        loop.run(3, on_batch=lambda s, t: batches.append(t.tobytes()))
    assert entry.step == 3
    sess.close()

    resumed = TrainSession.resume(store, ns)
    assert resumed.resume_step == 3
    template_p, template_o = fresh()
    state = resumed.restore_model({"params": template_p, "opt": template_o})
    replay = []
    with _loop(_fan_in(resumed), step_fn, state["params"],
               state["opt"]) as loop2:
        loop2.run(3, on_batch=lambda s, t: replay.append(t.tobytes()))
    resumed.close()
    assert replay == batches[3:]   # the mixed stream replays byte-identically


def test_packing_source_cannot_align_a_staged_ring():
    src = PackingTokenSource(lambda t: None, TOPO)
    with pytest.raises(UnsupportedOperation):
        src.restore(())


# ---------------------------------------------------------------------------
# stall attribution
# ---------------------------------------------------------------------------

def test_stall_spans_sum_to_wall_clock(tiny_step):
    cfg, step_fn, fresh = tiny_step
    params, opt = fresh()
    sess = open_dataplane(MemoryObjectStore(), TOPO,
                          namespace="runs/fused_spans")
    _produce(sess, 10, cfg.vocab_size)
    with _loop(_fan_in(sess), step_fn, params, opt) as loop:
        loop.run(1)                    # first step outside the window
        tracer = enable_tracing()
        try:
            rep = loop.run(6)
        finally:
            disable_tracing()
    sess.close()

    critical = {"pipeline.data_wait", "pipeline.h2d", "pipeline.compute"}
    span_total = sum(s.dur for s in tracer.spans() if s.name in critical)
    wall_total = rep.totals()["wall_s"]
    assert span_total == pytest.approx(wall_total, rel=0.15)
    t = rep.totals()
    attributed = t["data_wait_s"] + t["h2d_s"] + t["compute_s"] + t["other_s"]
    assert attributed == pytest.approx(wall_total, rel=1e-6)
    fr = rep.stall_fractions()
    assert sum(fr.values()) == pytest.approx(1.0, abs=1e-6)


def test_throttled_store_shifts_split_toward_data_wait(tiny_step):
    """The reference's check and bounds; its throttle is 30 ms a TGB GET
    against a jitted step of a few ms. The port's eager step is several
    times longer, and longer still under the suite's parallel load (the
    data plane's threads contend with it for the GIL and the cores): at
    30 ms the prefetch hid the throttle and the throttled share stayed
    under the 0.4 bound in such runs. 100 ms a GET restores the
    reference's ratio of fetch to step."""
    cfg, step_fn, fresh = tiny_step

    def run_arm(store) -> float:
        params, opt = fresh()
        sess = open_dataplane(store, TOPO, backend="tgb",
                              namespace="runs/fused_throttle")
        with sess.writer("w0") as w:
            w.write_tokens(_token_stream(10, cfg.vocab_size))
        src = ReaderFanInSource(
            [sess.reader(dp_rank=d, prefetch_depth=1) for d in range(2)],
            TOPO)
        with _loop(src, step_fn, params, opt) as loop:
            loop.run(1)                # ring warm
            rep = loop.run(6)
        sess.close()
        return rep.data_wait_frac

    healthy = run_arm(MemoryObjectStore())
    # brownout-style throttle: every TGB GET eats a 100ms slow-path penalty
    throttled = run_arm(FaultyObjectStore(MemoryObjectStore(), FaultPolicy(
        seed=0, slow_get_rate=1.0, slow_get_s=0.1, key_filter="/tgb/")))

    assert throttled > healthy + 0.2, (healthy, throttled)
    assert throttled > 0.4, throttled


# ---------------------------------------------------------------------------
# fused packing source
# ---------------------------------------------------------------------------

def test_packing_token_source_matches_direct_packer():
    chunks = [np.arange(i * 50, i * 50 + 50, dtype=np.int32)
              for i in range(6)]
    feed = iter(chunks)

    def pull(timeout_s):
        return next(feed, None)

    src = PackingTokenSource(pull, TOPO, pad_token=0)
    grids = []
    while True:
        try:
            grids.append(src.next_tokens(timeout_s=1.0))
        except BatchTimeout:
            break
    total = sum(c.size for c in chunks)
    gb_tokens = TOPO.global_batch * TOPO.seq_len
    assert len(grids) == -(-total // gb_tokens)     # ceil: remainder flushed
    flat = np.concatenate([g.ravel() for g in grids])
    np.testing.assert_array_equal(flat[:total], np.concatenate(chunks))
    np.testing.assert_array_equal(flat[total:],
                                  np.zeros(flat.size - total, np.int32))
    assert src.last_batch.token_count == total - (len(grids) - 1) * gb_tokens


def test_packing_source_deadline_holds_when_pull_ignores_budget():
    src = PackingTokenSource(lambda t: np.empty(0, np.int32), TOPO)
    t0 = time.monotonic()
    with pytest.raises(BatchTimeout):
        src.next_tokens(timeout_s=0.3)
    assert time.monotonic() - t0 < 2.0


def test_packing_source_tolerates_pull_timeouts_and_counts_samples():
    half = TOPO.global_batch * TOPO.seq_len // 2
    events = [BatchTimeout("not yet"),
              (np.arange(half, dtype=np.int32), 3),
              np.empty(0, np.int32),
              (np.arange(half, dtype=np.int32), 2)]
    feed = iter(events)

    def pull(timeout_s):
        ev = next(feed)
        if isinstance(ev, BaseException):
            raise ev
        return ev

    src = PackingTokenSource(pull, TOPO)
    grid = src.next_tokens(timeout_s=5.0)
    assert grid.shape == (TOPO.global_batch, TOPO.seq_len)
    assert src.last_batch.num_samples == 5


# ---------------------------------------------------------------------------
# fan-in transactionality (torn-grid regression)
# ---------------------------------------------------------------------------

class _ScriptedReader:
    """Minimal BatchReader: deterministic grids, scriptable timeouts."""

    def __init__(self, dp_rank: int, fail_calls=()):
        self.dp_rank, self.cp_rank = dp_rank, 0
        self.step = 0
        self.calls = 0
        self.timeouts_seen = []
        self.fail_calls = set(fail_calls)

    def grid(self, step: int) -> np.ndarray:
        base = step * 1000 + self.dp_rank * 100
        n = TOPO.global_batch // TOPO.dp * TOPO.seq_len
        return np.arange(base, base + n, dtype=np.int32).reshape(
            TOPO.global_batch // TOPO.dp, TOPO.seq_len)

    def next_batch(self, timeout_s=None) -> Batch:
        self.calls += 1
        self.timeouts_seen.append(timeout_s)
        if self.calls in self.fail_calls:
            raise BatchTimeout("scripted timeout")
        b = Batch(payload=b"", step=self.step, version=0,
                  dp_rank=self.dp_rank, cp_rank=0, array=self.grid(self.step))
        self.step += 1
        return b

    def checkpoint(self) -> int:
        return self.step

    def restore(self, ck: int) -> None:
        self.step = ck


def test_fan_in_rewinds_advanced_readers_on_partial_timeout():
    r0, r1 = _ScriptedReader(0), _ScriptedReader(1, fail_calls={1})
    src = ReaderFanInSource([r0, r1], TOPO)
    with pytest.raises(BatchTimeout):
        src.next_tokens(timeout_s=0.1)
    assert r0.step == 0                      # rewound, not left at 1
    grid = src.next_tokens(timeout_s=1.0)    # retry: both rows from step 0
    np.testing.assert_array_equal(grid[:2], r0.grid(0))
    np.testing.assert_array_equal(grid[2:], r1.grid(0))


def test_fan_in_refuses_mixed_step_grids():
    r0, r1 = _ScriptedReader(0), _ScriptedReader(1)
    r0.step = 1                              # simulate diverged cursors
    src = ReaderFanInSource([r0, r1], TOPO)
    with pytest.raises(RuntimeError, match="mixed global steps"):
        src.next_tokens(timeout_s=1.0)
    assert (r0.step, r1.step) == (1, 0)      # entry snapshot restored


def test_fan_in_shares_one_timeout_budget():
    class _Slow(_ScriptedReader):
        def next_batch(self, timeout_s=None):
            time.sleep(0.05)
            return super().next_batch(timeout_s)

    r0, r1 = _Slow(0), _ScriptedReader(1)
    src = ReaderFanInSource([r0, r1], TOPO)
    src.next_tokens(timeout_s=0.25)
    assert r1.timeouts_seen[0] <= 0.22


# ---------------------------------------------------------------------------
# ring lifecycle vs exactly-once
# ---------------------------------------------------------------------------

def _wait_for_staged(loop, deadline_s: float = 10.0) -> None:
    deadline = time.monotonic() + deadline_s
    while True:
        with loop._cond:
            if loop._ring:
                return
        assert time.monotonic() < deadline, "staging ring never filled"
        time.sleep(0.01)


def test_stop_rewinds_cursors_to_consumed_frontier(tiny_step):
    """After stop() with staged-but-unconsumed entries the source names
    exactly the next unconsumed batch (the cursor half of the kill and
    resume above)."""
    cfg, step_fn, fresh = tiny_step
    params, opt = fresh()
    sess = open_dataplane(MemoryObjectStore(), TOPO,
                          namespace="runs/fused_stop")
    _produce(sess, 10, cfg.vocab_size)
    src = _fan_in(sess)
    loop = _loop(src, step_fn, params, opt)
    with loop:
        loop.run(3)
        _wait_for_staged(loop)    # the ring is ahead of the trainer
    for ck in src.cursors():
        assert ck.step == 3
    assert loop.consumed == 3
    sess.close()


def test_failed_alignment_does_not_wedge_the_loop(tiny_step):
    cfg, step_fn, fresh = tiny_step
    params, opt = fresh()
    chunks = iter(np.array_split(_token_stream(8, cfg.vocab_size), 16))
    src = PackingTokenSource(lambda t: next(chunks, None), TOPO)
    loop = _loop(src, step_fn, params, opt)
    with loop:
        loop.run(1)
        _wait_for_staged(loop)
        with pytest.raises(UnsupportedOperation):
            loop.aligned_checkpoint(object(), {})
        assert loop._pause is False          # staging resumed
        with loop._cond:
            assert loop._ring                # staged tokens not lost
        assert loop.run(2).steps == 2        # loop keeps training


# ---------------------------------------------------------------------------
# the port's own rules: device, int32 tokens, replay
# ---------------------------------------------------------------------------

def test_loop_refuses_params_on_another_device(tiny_step):
    cfg, step_fn, fresh = tiny_step
    params, opt = fresh()
    params["final_norm"] = params["final_norm"].to("meta")
    with pytest.raises(ValueError, match="parameter lies on meta"):
        _loop(PackingTokenSource(lambda t: None, TOPO), step_fn, params, opt)


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_cuda_loop_raises_without_a_card(tiny_step):
    _cfg, step_fn, fresh = tiny_step
    params, opt = fresh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FusedTrainLoop(PackingTokenSource(lambda t: None, TOPO), step_fn,
                       params, opt, topology=TOPO)


def test_int32_tokens_train_like_int64(tiny_step):
    """The loop hands the step int32 tokens (as the reference does): the
    forward, the loss and the embedding's gradient equal int64's."""
    from repro_torch.train.step import loss_and_grads
    cfg, _step_fn, fresh = tiny_step
    params, _opt = fresh()
    tokens = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (TOPO.global_batch, TOPO.seq_len))
    out = {dt: loss_and_grads(cfg, params, {"tokens": torch.from_numpy(
        tokens.astype(dt))}) for dt in (np.int32, np.int64)}
    assert torch.equal(out[np.int32][0], out[np.int64][0])
    for a, b in zip(tree_leaves(out[np.int32][2]),
                    tree_leaves(out[np.int64][2])):
        assert torch.equal(a, b)
    assert float(out[np.int32][2]["embed"].abs().sum()) > 0


def test_grids_equal_the_host_packer_and_replay_byte_identically(tiny_step):
    """Every consumed grid is the one the packer makes from the stream
    without the store; restoring a cursor snapshot replays the same bytes
    at depth 0 and depth 2."""
    cfg, step_fn, fresh = tiny_step
    stream = _token_stream(8, cfg.vocab_size)
    want = _host_grids(stream)
    sess = open_dataplane(MemoryObjectStore(), TOPO,
                          namespace="runs/fused_replay")
    with sess.writer("w0") as w:
        w.write_tokens(stream)
    src = _fan_in(sess)
    start = src.cursors()
    for depth in (0, 2):
        params, opt = fresh()
        src.restore(start)
        seen, snaps = [], {}
        loop = _loop(src, step_fn, params, opt, depth=depth)
        with loop:
            loop.run(2, on_batch=lambda s, t: seen.append(t.tobytes()))
            loop.align()
            snaps[2] = src.cursors()
            loop.resume_staging()
            loop.run(3, on_batch=lambda s, t: seen.append(t.tobytes()))
        assert seen == want[:5]
        assert all(ck.step == loop.consumed for ck in src.cursors())
        replay = []
        src.restore(snaps[2])
        params, opt = fresh()
        with _loop(src, step_fn, params, opt, depth=depth) as loop2:
            loop2.run(3, on_batch=lambda s, t: replay.append(t.tobytes()))
        assert replay == want[2:5]
    sess.close()


# ---------------------------------------------------------------------------
# the slice as a whole against the JAX package
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_slice():
    """One store written by the JAX writer, the JAX step (jitted) and the
    weights both packages start from (fp32 compute)."""
    jax = pytest.importorskip("jax")
    pytest.importorskip("msgpack")
    from repro.configs.registry import get_smoke_config as jax_smoke
    from repro.core import MemoryObjectStore as JaxStore
    from repro.dataplane import Topology as JaxTopology
    from repro.dataplane import open_dataplane as jax_open
    from repro.models import init_params as jax_init
    from repro.models import param_specs as jax_specs
    from repro.train.optimizer import OptimizerConfig as JaxOpt
    from repro.train.step import StepConfig as JaxStepCfg
    from repro.train.step import make_train_step as jax_make_step

    jcfg = jax_smoke("granite_8b").replace(compute_dtype="float32")
    tcfg = get_smoke_config("granite_8b").replace(compute_dtype="float32")
    store = JaxStore()
    jtopo = JaxTopology(dp=TOPO.dp, cp=TOPO.cp,
                        global_batch=TOPO.global_batch, seq_len=TOPO.seq_len)
    sess = jax_open(store, jtopo, namespace="runs/slice")
    with sess.writer("w0") as w:
        w.write_tokens(_token_stream(10, jcfg.vocab_size))
    sess.close()
    jparams = jax_init(jax_specs(jcfg), seed=3)
    np_params = jax.tree_util.tree_map(np.asarray, jparams)
    jstep = jax.jit(jax_make_step(jcfg, JaxOpt(), JaxStepCfg()))
    tstep = make_train_step(tcfg, OptimizerConfig(), StepConfig())
    return store, jtopo, jparams, np_params, jstep, tstep


def _port_store(jax_store):
    """The port's MemoryObjectStore over the JAX store's objects."""
    s = MemoryObjectStore()
    s._objects, s._lock = jax_store._objects, jax_store._lock
    return s


@pytest.mark.parametrize("depth", [0, 2])
def test_fused_loop_matches_the_jax_loop(jax_slice, depth):
    from repro.dataplane import open_dataplane as jax_open
    from repro.train.optimizer import init_opt_state as jax_init_opt
    from repro.train.pipeline import FusedTrainLoop as JaxLoop
    from repro.train.pipeline import ReaderFanInSource as JaxFanIn
    from repro_torch import convert
    store, jtopo, jparams, np_params, jstep, tstep = jax_slice

    jsess = jax_open(store, jtopo, namespace="runs/slice")
    jsrc = JaxFanIn([jsess.reader(dp_rank=d) for d in range(TOPO.dp)], jtopo)
    jgrids = []
    with JaxLoop(jsrc, jstep, jparams, jax_init_opt(jparams), topology=jtopo,
                 depth=depth, timeout_s=30.0) as jloop:
        jrep = jloop.run(4, on_batch=lambda s, t: jgrids.append(t.tobytes()))
    jsess.close()

    tsess = open_dataplane(_port_store(store), TOPO, namespace="runs/slice")
    params = convert.params_from_numpy(np_params, device="cpu")
    tgrids = []
    with _loop(_fan_in(tsess), tstep, params, init_opt_state(params),
               depth=depth) as tloop:
        trep = tloop.run(4, on_batch=lambda s, t: tgrids.append(t.tobytes()))
    tsess.close()

    assert tgrids == jgrids == _host_grids(_token_stream(10, 257))[:4]
    np.testing.assert_allclose(trep.losses, jrep.losses, rtol=1e-4)
    assert trep.tokens == jrep.tokens == 4 * TOPO.global_batch * TOPO.seq_len


def test_jax_cursor_snapshot_replays_in_the_port(jax_slice):
    """Cursors a JAX loop leaves at its consumed frontier, encoded as
    Checkpoint tokens, restore the port's readers to byte-identical grids."""
    from repro.dataplane import open_dataplane as jax_open
    from repro.train.optimizer import init_opt_state as jax_init_opt
    from repro.train.pipeline import FusedTrainLoop as JaxLoop
    from repro.train.pipeline import ReaderFanInSource as JaxFanIn
    from repro_torch import convert
    store, jtopo, jparams, np_params, jstep, tstep = jax_slice

    jsess = jax_open(store, jtopo, namespace="runs/slice")
    jsrc = JaxFanIn([jsess.reader(dp_rank=d) for d in range(TOPO.dp)], jtopo)
    jgrids = []
    with JaxLoop(jsrc, jstep, jparams, jax_init_opt(jparams), topology=jtopo,
                 depth=2, timeout_s=30.0) as jloop:
        jloop.run(5, on_batch=lambda s, t: jgrids.append(t.tobytes()))
        jloop.align()
        tokens = [ck.encode() for ck in jsrc.cursors()]
    jsess.close()
    # rewind to step 2 through a snapshot the JAX loop took at step 2
    jsess = jax_open(store, jtopo, namespace="runs/slice")
    readers = [jsess.reader(dp_rank=d) for d in range(TOPO.dp)]
    for r in readers:
        r.next_batch(timeout_s=5)
        r.next_batch(timeout_s=5)
    at2 = [r.checkpoint().encode() for r in readers]
    jsess.close()

    tsess = open_dataplane(_port_store(store), TOPO, namespace="runs/slice")
    src = _fan_in(tsess)
    src.restore(tuple(at2))
    params = convert.params_from_numpy(np_params, device="cpu")
    replay = []
    with _loop(src, tstep, params, init_opt_state(params)) as loop:
        loop.run(3, on_batch=lambda s, t: replay.append(t.tobytes()))
    assert replay == jgrids[2:5]
    # the JAX loop's frontier cursors, restored in the port, read step 5
    src.restore(tuple(tokens))
    assert src.next_tokens(timeout_s=5).tobytes() == \
        _host_grids(_token_stream(10, 257))[5]
    assert all(ck.step == 6 for ck in src.cursors())
    tsess.close()


@pytest.mark.parametrize("depth", [0, 2])
def test_fused_loop_over_a_mix_matches_the_jax_loop(jax_slice, depth):
    """A weighted mix of two streams written by the JAX writers: the JAX
    loop over its MixedReaders and the port's over its own consume the same
    grids (each the stream's packer grid the schedule names) and reach the
    same losses within 1e-4."""
    import repro.core as jcore
    from repro.dataplane import open_dataplane as jax_open
    from repro.train.optimizer import init_opt_state as jax_init_opt
    from repro.train.pipeline import FusedTrainLoop as JaxLoop
    from repro.train.pipeline import ReaderFanInSource as JaxFanIn
    from repro_torch import convert
    from repro_torch.streams import MixPlan
    _, jtopo, jparams, np_params, jstep, tstep = jax_slice

    weights, vocab = {"web": 0.7, "code": 0.3}, 257
    plan = MixPlan(weights, seed=5)
    need = plan.stream_counts(5)
    store = jcore.MemoryObjectStore()
    jsess = jax_open(store, jtopo, namespace="runs/mix", streams=weights,
                     mix_seed=5)
    streams = {name: (_token_stream(need[name] + 1, vocab) * (i + 3) + i)
               % vocab for i, name in enumerate(sorted(weights))}
    for name, toks in streams.items():
        with jsess.writer("w0", stream=name) as w:
            w.write_tokens(toks.astype(np.int32))
    jsrc = JaxFanIn([jsess.reader(dp_rank=d) for d in range(TOPO.dp)], jtopo)
    jgrids = []
    with JaxLoop(jsrc, jstep, jparams, jax_init_opt(jparams), topology=jtopo,
                 depth=depth, timeout_s=30.0) as jloop:
        jrep = jloop.run(5, on_batch=lambda s, t: jgrids.append(t.tobytes()))
    jsess.close()

    tstore = MemoryObjectStore()
    tstore._objects, tstore._lock = store._objects, store._lock
    tsess = open_dataplane(tstore, TOPO, namespace="runs/mix",
                           streams=weights, mix_seed=5)
    params = convert.params_from_numpy(np_params, device="cpu")
    tgrids = []
    with _loop(_fan_in(tsess), tstep, params, init_opt_state(params),
               depth=depth) as tloop:
        trep = tloop.run(5, on_batch=lambda s, t: tgrids.append(t.tobytes()))
    tsess.close()

    host = {name: _host_grids(toks.astype(np.int32))
            for name, toks in streams.items()}
    want = [host[name][k] for name, k in plan.schedule(5)]
    assert tgrids == jgrids == want
    assert {name for name, _ in plan.schedule(5)} == set(weights)
    np.testing.assert_allclose(trep.losses, jrep.losses, rtol=1e-4)
