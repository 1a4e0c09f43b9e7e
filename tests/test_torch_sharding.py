"""The port's sharding rules (``repro_torch.sharding.specs``) on the CPU.

Twins of ``tests/test_sharding.py``: divisibility degradation and per-arch
spec validity on the production mesh geometry (16x16 / 2x16x16) without
256 devices — ``make_rules`` / ``spec`` read only axis names and sizes, so
the reference's ``StubMesh`` works. Then the port against the JAX package:
its ``spec`` equals JAX's ``PartitionSpec`` for every leaf of every arch on
both meshes; and placements on a ``DeviceMesh`` over the ``"fake"``
process group give each device the local shape the spec implies.
"""
import pytest

torch = pytest.importorskip("torch")

from jax.sharding import PartitionSpec as P  # noqa: E402

from repro.configs.registry import get_config as jax_config  # noqa: E402
from repro.models import param_specs as jax_param_specs  # noqa: E402
from repro.models.common import spec_tree_map  # noqa: E402
from repro.sharding.specs import make_rules as jax_make_rules  # noqa: E402
from repro_torch.configs.registry import ARCH_IDS, get_config  # noqa: E402
from repro_torch.models import param_specs  # noqa: E402
from repro_torch.models.common import tree_leaves, tree_map  # noqa: E402
from repro_torch.sharding.specs import (PartitionSpec,  # noqa: E402
                                        make_rules, param_shardings)


class StubMesh:
    def __init__(self, shape):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)


SINGLE = StubMesh({"data": 16, "model": 16})
MULTI = StubMesh({"pod": 2, "data": 16, "model": 16})


def test_batch_maps_to_all_data_axes():
    r = make_rules(MULTI, 32, 8)
    assert r.mapping["batch"] == ("pod", "data")
    r1 = make_rules(SINGLE, 32, 8)
    assert r1.mapping["batch"] == ("data",)


def test_heads_tp_only_when_divisible():
    assert make_rules(SINGLE, 128, 8).mapping["heads"] == ("model",)
    assert make_rules(SINGLE, 40, 40).mapping["heads"] is None   # qwen1.5
    assert make_rules(SINGLE, 24, 24).mapping["heads"] is None   # musicgen
    assert make_rules(SINGLE, 32, 32).mapping["kv"] == ("model",)
    assert make_rules(SINGLE, 64, 8).mapping["kv"] is None       # GQA kv=8


def test_seq_sp_fallback_for_odd_head_counts():
    assert make_rules(SINGLE, 40, 40).mapping["seq_sp"] == ("model",)
    assert make_rules(SINGLE, 128, 8).mapping["seq_sp"] is None


def test_spec_degrades_non_divisible_dims():
    r = make_rules(MULTI, 32, 8)
    # batch=1 (long_500k) cannot shard over (pod, data)=32
    assert r.spec(("batch", "vocab"), shape=(1, 65536)) == \
        PartitionSpec(None, "model")
    # divisible batch shards normally
    assert r.spec(("batch", "vocab"), shape=(256, 65536)) == \
        PartitionSpec(("pod", "data"), "model")


def test_duplicate_physical_axis_dedup():
    r = make_rules(SINGLE, 32, 8)
    spec = r.spec(("layers", "experts", "embed", "mlp"),
                  shape=(4, 64, 2048, 1408))
    names = []
    for s in spec:
        if s is None:
            continue
        names.extend(s if isinstance(s, tuple) else (s,))
    assert len(names) == len(set(names))
    # experts won the 'model' axis; mlp degraded
    assert spec[1] == "model"


@pytest.mark.parametrize("arch", ARCH_IDS)
@pytest.mark.parametrize("mesh", [SINGLE, MULTI], ids=["16x16", "2x16x16"])
def test_every_param_spec_resolves_on_production_mesh(arch, mesh):
    """spec() must produce a legal (divisible) PartitionSpec for every
    weight of every architecture."""
    cfg = get_config(arch)
    rules = make_rules(mesh, cfg.num_heads, cfg.num_kv_heads)

    def check(s):
        spec = rules.spec(s.logical_axes, s.shape)
        entries = list(spec) + [None] * (len(s.shape) - len(list(spec)))
        for dim, entry in zip(s.shape, entries):
            if entry is None:
                continue
            axes = entry if isinstance(entry, tuple) else (entry,)
            n = 1
            for a in axes:
                n *= mesh.shape[a]
            assert dim % n == 0, (arch, s.shape, spec)

    tree_map(check, param_specs(cfg))


@pytest.mark.parametrize("arch", ARCH_IDS)
@pytest.mark.parametrize("mesh", [SINGLE, MULTI], ids=["16x16", "2x16x16"])
def test_spec_equals_the_jax_partition_spec_for_every_leaf(arch, mesh):
    cfg, jcfg = get_config(arch), jax_config(arch)
    rules = make_rules(mesh, cfg.num_heads, cfg.num_kv_heads)
    jrules = jax_make_rules(mesh, jcfg.num_heads, jcfg.num_kv_heads)
    assert rules.mapping == jrules.mapping
    ours = [(s.shape, tuple(rules.spec(s.logical_axes, s.shape)))
            for s in tree_leaves(param_specs(cfg))]
    theirs = []
    spec_tree_map(lambda s: theirs.append(
        (tuple(s.shape), jrules.spec(s.logical_axes, s.shape))),
        jax_param_specs(jcfg))
    assert len(ours) == len(theirs)
    for (shape, spec), (jshape, jspec) in zip(ours, theirs):
        assert shape == jshape
        assert isinstance(jspec, P)
        assert spec == tuple(jspec), (arch, shape, spec, jspec)


@pytest.fixture
def fake_group():
    """The "fake" process group at the production world size, destroyed
    after the test."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=256)
    yield
    dist.destroy_process_group()


def test_distributed_shards_have_the_local_shapes_the_spec_implies(
        fake_group):
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.launch.mesh import make_production_mesh

    mesh = make_production_mesh(device="cpu")
    cfg = get_config("granite_8b").replace(num_layers=2)
    rules = make_rules(mesh, cfg.num_heads, cfg.num_kv_heads)
    specs = param_specs(cfg)
    placements = param_shardings(rules, specs)
    sizes = {"data": 16, "model": 16}
    with FakeTensorMode():
        for s, pl in zip(tree_leaves(specs), tree_leaves(placements)):
            t = distribute_tensor(torch.empty(s.shape, dtype=s.dtype), mesh,
                                  pl)
            spec = rules.spec(s.logical_axes, s.shape)
            want = list(s.shape)
            for dim, entry in enumerate(spec):
                for a in (entry if isinstance(entry, tuple) else
                          (entry,) if entry else ()):
                    want[dim] //= sizes[a]
            assert tuple(t.to_local().shape) == tuple(want), (s, spec, pl)
    # ("pod", "data") shards a dim on both mesh dims, in mesh order
    from repro_torch.sharding.specs import placements as to_placements
    stub = StubMesh({"pod": 2, "data": 16, "model": 16})
    pl = to_placements(stub, PartitionSpec(("pod", "data"), "model"))
    assert [p.dim for p in pl] == [0, 0, 1]


def test_production_mesh_never_shrinks_to_a_smaller_group():
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from repro_torch.launch.mesh import make_production_mesh
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
    try:
        with pytest.raises(ValueError, match="world size 256"):
            make_production_mesh(device="cpu")
    finally:
        dist.destroy_process_group()


def test_host_mesh_spans_the_groups_ranks():
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from repro_torch.launch.mesh import make_host_mesh
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
    try:
        mesh = make_host_mesh(model=2, device="cpu")
        assert tuple(mesh.shape) == (2, 2)
        assert mesh.mesh_dim_names == ("data", "model")
        with pytest.raises(ValueError, match="model=3"):
            make_host_mesh(model=3, device="cpu")
    finally:
        dist.destroy_process_group()
