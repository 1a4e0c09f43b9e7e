"""Model checkpoints and RunManifests across the two packages, on the CPU.

The JAX package's checkpoint format is the wire format: the same
smoke-config train state (fp32 parameters, bf16 Adam moments, the 0-d int32
step) uploaded by either package gives the same objects, byte for byte, and
so does a ``RunManifest`` of the same fields. A ``TrainSession`` checkpoint
written by one package resumes in the other with every leaf bit-identical
and the data cursor at the same batch, and one train step of each package
on that batch then agrees within the whole-model fp32 tolerance, 1e-4
(``tests/test_models_smoke.py:85-97``).

Each package's session refuses a store that is not its own ``ObjectStore``,
so "one store" is two ``MemoryObjectStore`` objects, one of each package,
over the same key -> bytes map and lock (``_view`` of
``tests/test_torch_dataplane.py``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
pytest.importorskip("msgpack")
pytest.importorskip("ml_dtypes")

import jax.numpy as jnp  # noqa: E402

import repro.core as jcore  # noqa: E402
import repro.dataplane as jdp  # noqa: E402
import repro.run as jrun  # noqa: E402
import repro.train.checkpoint as jckpt  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
import repro_torch.dataplane as tdp  # noqa: E402
import repro_torch.run as trun  # noqa: E402
import repro_torch.train.checkpoint as tckpt  # noqa: E402
from repro.configs.registry import get_smoke_config as jax_smoke  # noqa: E402
from repro.models import init_params as jax_init  # noqa: E402
from repro.models import param_specs as jax_specs  # noqa: E402
from repro.train.optimizer import OptimizerConfig as JaxOpt  # noqa: E402
from repro.train.optimizer import init_opt_state as jax_init_opt  # noqa: E402
from repro.train.step import StepConfig as JaxStepCfg  # noqa: E402
from repro.train.step import make_train_step as jax_make_step  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs.registry import get_smoke_config  # noqa: E402
from repro_torch.train import (OptimizerConfig, StepConfig,  # noqa: E402
                               make_train_step)
from test_torch_dataplane import _view  # noqa: E402

TOPO_ARGS = dict(dp=2, cp=1, global_batch=4, seq_len=32)
NS = "runs/xframe_ckpt"
N_BATCHES = 6
LOSS_RTOL = 1e-4
OPT = dict(state_dtype="bfloat16")


def _stream(vocab: int) -> np.ndarray:
    n = N_BATCHES * TOPO_ARGS["global_batch"] * TOPO_ARGS["seq_len"]
    return ((np.arange(n) * 7 + 3) % vocab).astype(np.int32)


@pytest.fixture(scope="module")
def smoke():
    """The granite-8b smoke config in fp32, JAX weights after one JAX step
    (so the bf16 moments and the step counter are not zero), the same state
    as numpy trees, both packages' train steps and their first batch."""
    jcfg = jax_smoke("granite_8b").replace(compute_dtype="float32")
    tcfg = get_smoke_config("granite_8b").replace(compute_dtype="float32")
    jstep = jax.jit(jax_make_step(jcfg, JaxOpt(**OPT), JaxStepCfg()))
    tstep = make_train_step(tcfg, OptimizerConfig(**OPT), StepConfig())
    params = jax_init(jax_specs(jcfg), seed=5)
    opt = jax_init_opt(params, jnp.bfloat16)
    tokens = _stream(jcfg.vocab_size)[:4 * 32].reshape(4, 32)
    params, opt, _ = jstep(params, opt, {"tokens": jnp.asarray(tokens)})
    state = {"params": params, "opt": opt}
    np_state = jax.tree_util.tree_map(np.asarray, state)
    return jcfg, jstep, tstep, state, np_state


def _torch_state(np_state):
    """The numpy state as the port holds it: tensors on the CPU."""
    return {"params": convert.params_from_numpy(np_state["params"], "cpu"),
            "opt": {"m": convert.params_from_numpy(np_state["opt"]["m"],
                                                   "cpu"),
                    "v": convert.params_from_numpy(np_state["opt"]["v"],
                                                   "cpu"),
                    "step": torch.tensor(int(np_state["opt"]["step"]),
                                         dtype=torch.int32)}}


def _zeros_like_torch(np_state):
    """A template of the port: the state's structure, fp32 zeros."""
    return jax.tree_util.tree_map(lambda a: torch.zeros(1), np_state)


def _leaf_bits(tree) -> dict:
    """{path: (dtype name, shape, raw bytes)} of a tree of either package."""
    out = {}
    for path, leaf in tckpt._flatten_py(tree):
        raw, shape, dtype = tckpt._leaf_bytes(leaf)
        out[path] = (dtype, tuple(shape), raw)
    return out


def test_same_state_writes_identical_objects(smoke):
    _jcfg, _jstep, _tstep, state, np_state = smoke
    dtypes = {str(np.asarray(x).dtype)
              for x in jax.tree_util.tree_leaves(np_state)}
    assert dtypes == {"float32", "bfloat16", "int32"}
    jstore, tstore = jcore.MemoryObjectStore(), tcore.MemoryObjectStore()
    jkey = jckpt.upload_model_state(jcore.Namespace(jstore, NS), 4, state,
                                    cursor=(3, 4), tag="r1")
    tkey = tckpt.upload_model_state(tcore.Namespace(tstore, NS), 4,
                                    _torch_state(np_state), cursor=(3, 4),
                                    tag="r1")
    assert jkey == tkey and jkey.endswith("0000000004-r1/MANIFEST.ckpt")
    assert sorted(jstore._objects) == sorted(tstore._objects)
    for key, raw in jstore._objects.items():
        assert tstore._objects[key] == raw, key


def test_runmanifest_packs_the_same_bytes():
    ck = jdp.Checkpoint("tgb", version=3, step=7, topology=(2, 1), data_dp=2)
    fields = dict(seq=2, step=7, model_key="runs/x/checkpoints/0000000007/"
                  "MANIFEST.ckpt", data_token=ck.encode(), topology=(2, 1),
                  data_dp=2, global_batch=8, seq_len=64)
    raw = jrun.RunManifest(**fields).pack()
    assert trun.RunManifest(**fields).pack() == raw
    assert trun.RunManifest.unpack(raw) == trun.RunManifest(**fields)
    assert trun.RunManifest.unpack(raw).data_checkpoint().encode() == \
        ck.encode()


def _next_grid(readers) -> np.ndarray:
    return np.block([[r.next_batch(timeout_s=10).tokens] for r in readers])


def _run_until_checkpoint(pkg, run_pkg, core, state, vocab):
    """A fresh run of ``pkg``: write the stream, consume 2 global batches,
    checkpoint ``state``; returns the store and the next 2 grids."""
    store = core.MemoryObjectStore()
    sess = run_pkg.TrainSession(store, pkg.Topology(**TOPO_ARGS),
                                namespace=NS)
    with sess.writer("w0") as w:
        w.write_tokens(_stream(vocab))
    readers = [sess.reader(dp_rank=d) for d in range(TOPO_ARGS["dp"])]
    for _ in range(2):
        _next_grid(readers)
    entry = sess.checkpoint(state)
    assert entry.step == 2
    tail = [_next_grid(readers) for _ in range(2)]
    sess.close()
    return store, tail


def _jax_step_loss(jstep, state, grid) -> float:
    _p, _o, m = jstep(state["params"], state["opt"],
                      {"tokens": jnp.asarray(grid)})
    return float(m["loss"])


def _port_step_loss(tstep, state, grid) -> float:
    _p, _o, m = tstep(state["params"], state["opt"],
                      {"tokens": torch.from_numpy(grid)})
    return float(m["loss"])


def test_jax_checkpoint_resumes_in_the_port(smoke):
    jcfg, jstep, tstep, state, np_state = smoke
    store, tail = _run_until_checkpoint(jdp, jrun, jcore, state,
                                        jcfg.vocab_size)

    resumed = trun.TrainSession.resume(_view(store, tdp), NS)
    assert resumed.resume_step == 2
    got = resumed.restore_model(_zeros_like_torch(np_state))
    assert _leaf_bits(got) == _leaf_bits(np_state)
    assert all(leaf.device.type == "cpu"
               for _, leaf in tckpt._flatten_py(got))
    readers = [resumed.reader(dp_rank=d) for d in range(TOPO_ARGS["dp"])]
    grid = _next_grid(readers)
    assert grid.tobytes() == tail[0].tobytes()
    # one step of each package from the restored state on that batch
    want = _jax_step_loss(jstep, state, grid)
    np.testing.assert_allclose(_port_step_loss(tstep, got, grid), want,
                               rtol=LOSS_RTOL)
    resumed.close()


def test_port_checkpoint_resumes_in_jax(smoke):
    jcfg, jstep, tstep, state, np_state = smoke
    store, tail = _run_until_checkpoint(tdp, trun, tcore,
                                        _torch_state(np_state),
                                        jcfg.vocab_size)

    resumed = jrun.TrainSession.resume(_view(store, jdp), NS)
    assert resumed.resume_step == 2
    template = jax.tree_util.tree_map(jnp.zeros_like, state)
    got = resumed.restore_model(template)
    assert _leaf_bits(jax.tree_util.tree_map(np.asarray, got)) == \
        _leaf_bits(np_state)
    readers = [resumed.reader(dp_rank=d) for d in range(TOPO_ARGS["dp"])]
    grid = _next_grid(readers)
    assert grid.tobytes() == tail[0].tobytes()
    want = _port_step_loss(tstep, _torch_state(np_state), grid)
    np.testing.assert_allclose(_jax_step_loss(jstep, got, grid), want,
                               rtol=LOSS_RTOL)
    resumed.close()


@pytest.mark.parametrize("writer", ["repro", "repro_torch"])
def test_fsck_of_either_package_reads_the_other_run(smoke, writer):
    """Both packages' fsck see the same issues in an aligned run with a
    torn upload (killed between upload and commit), whoever wrote it."""
    import repro.ops as jops
    import repro_torch.ops as tops

    jcfg, _jstep, _tstep, state, np_state = smoke
    pkg, run_pkg, core, st = ((jdp, jrun, jcore, state)
                              if writer == "repro" else
                              (tdp, trun, tcore, _torch_state(np_state)))
    store = core.MemoryObjectStore(faults=core.FaultInjector())
    sess = run_pkg.TrainSession(store, pkg.Topology(**TOPO_ARGS),
                                namespace=NS)
    with sess.writer("w0") as w:
        w.write_tokens(_stream(jcfg.vocab_size))
    readers = [sess.reader(dp_rank=d) for d in range(TOPO_ARGS["dp"])]
    _next_grid(readers)
    sess.checkpoint(st)
    _next_grid(readers)
    store.faults.crash_on("cput", key_substr=".rm", nth=1)
    with pytest.raises(core.InjectedCrash):
        sess.checkpoint(st)
    sess.close()

    reports = [jops.fsck(jcore.Namespace(_view(store, jdp), NS)),
               tops.fsck(tcore.Namespace(_view(store, tdp), NS))]
    rows = [sorted((i.severity, i.kind, i.key) for i in r.issues)
            for r in reports]
    assert rows[0] == rows[1]
    assert ("warn", "pending-model-checkpoint",
            f"{NS}/checkpoints/0000000002") in rows[0]
    assert not any(sev == "error" for sev, _, _ in rows[0])
