"""The port's cost reader (``repro_torch.launch.hlo_analysis``) on the CPU.

Twins of the seven cases of ``tests/test_hlo_analysis.py``, as a reader of
the dispatched program means them: bytes by dtype; a collective's group
size read from the mesh dim it runs over; an 8-step loop of ``h @ w``
counting 8·2BD² whether traced whole or extrapolated from one and two
steps (the reference's trip-count multiplication); nested 3 x 4 loops;
slice reads charged as slices; einsum contraction FLOPs; an empty program
giving zeros. Then ``analyze_profile`` on a CPU-only trace, which holds no
device kernel.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.launch import hlo_analysis as H  # noqa: E402


def test_bytes_by_dtype():
    a = torch.ones(4, 8)
    b = torch.ones(10, dtype=torch.bfloat16)
    c = torch.ones(7, dtype=torch.bool)
    costs = H.analyze(lambda: (a + a, b * 2, ~c, a.sum()))
    # f32[4,8] twice in, once out; bf16[10] in and out; pred[7] in and out;
    # f32[4,8] in, f32[] out
    assert costs.bytes_accessed == 3 * 128 + 2 * 20 + 2 * 7 + 128 + 4
    assert costs.flops == 0 and costs.dot_count == 0


@pytest.fixture
def fake_group():
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=512)
    yield
    dist.destroy_process_group()


def test_collective_group_size_is_the_mesh_dims(fake_group):
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from repro_torch.launch.mesh import make_production_mesh
    mesh = make_production_mesh(multi_pod=True, device="cpu")
    with FakeTensorMode():
        x = distribute_tensor(torch.empty(64, 32), mesh,
                              (Replicate(), Shard(0), Shard(1)))

        def gather():
            x.redistribute(mesh, (Replicate(), Replicate(), Shard(1)))
            x.redistribute(mesh, (Replicate(), Shard(0), Replicate()))
        costs = H.analyze(gather)
    # over "data" (16): out f32[64, 2] -> 512 B x 15/16; over "model" (16):
    # out f32[4, 32] -> 512 B x 15/16
    assert costs.collective_count == {"all-gather": 2}
    assert costs.collective_bytes["all-gather"] == 2 * 512 * 15 / 16
    assert H.link_bytes("all-reduce", 100, 32) == 2 * 100 * 31 / 32
    assert H.link_bytes("reduce-scatter", 100, 4) == 300
    assert H.link_bytes("all-to-all", 100, 1) == 0


def _loop(h, ws):
    for w in ws:
        h = h @ w
    return h


def test_loop_flops_traced_whole_equal_the_extrapolation():
    L, B, D = 8, 32, 64
    h = torch.ones(B, D)
    ws = torch.ones(L, D, D).unbind(0)
    expected = L * 2 * B * D * D
    whole = H.analyze(_loop, h, ws)
    one, two = H.analyze(_loop, h, ws[:1]), H.analyze(_loop, h, ws[:2])
    extrapolated = H.combine(one, [(two, L - 1)], trips=L)
    assert whole.flops == extrapolated.flops == expected
    assert whole.dot_count == extrapolated.dot_count == L
    assert whole.bytes_accessed == extrapolated.bytes_accessed
    assert extrapolated.while_loops == [("layers", L)]


def test_nested_loops_multiply():
    h = torch.ones(8, 16)
    wss = torch.ones(3, 4, 16, 16)

    def outer(h, wss):
        for ws in wss.unbind(0):
            h = _loop(h, ws.unbind(0))
        return h
    expected = 3 * 4 * 2 * 8 * 16 * 16
    assert H.analyze(outer, h, wss).flops == expected
    inner1 = H.analyze(outer, h, wss[:1, :1])
    inner2 = H.analyze(outer, h, wss[:1, :2])
    per_outer = H.combine(inner1, [(inner2, 3)], loop="inner", trips=4)
    outer2 = H.analyze(outer, h, wss[:2])
    nested = H.combine(per_outer, [(outer2, 2)], loop="outer", trips=3)
    # the second trace runs two whole outer bodies; the first's inner loop
    # was extrapolated to the same four steps
    assert nested.flops == expected
    assert [n for n, _ in nested.while_loops] == ["inner", "outer"]


def test_bytes_slice_aware_for_a_loop():
    """A loop over the rows of a stacked buffer reads slices, not the whole
    buffer every step."""
    L, N = 64, 1024
    xs = torch.ones(L, N)

    def f(xs):
        c = torch.zeros(())
        for x in xs.unbind(0):
            c = c + x.sum()
        return c
    costs = H.analyze(f, xs)
    full_buffer_everytime = L * (L * N * 4)
    assert costs.bytes_accessed < full_buffer_everytime / 4
    assert costs.bytes_accessed >= L * N * 4


def test_dot_flops_contraction_dims():
    a, b = torch.ones(4, 8, 16), torch.ones(4, 16, 32)
    costs = H.analyze(lambda: torch.einsum("bij,bjk->bik", a, b))
    assert costs.flops == 2 * 4 * 8 * 16 * 32


def test_analyze_handles_an_empty_program():
    costs = H.analyze(lambda: None)
    assert costs.flops == 0 and costs.bytes_accessed == 0
    assert costs.total_collective_bytes == 0 and costs.peak_live_bytes == 0


def test_live_bytes_count_what_the_run_allocated_and_still_holds():
    x = torch.ones(256)                      # an argument: not counted

    def f(x):
        a = x * 2                            # 1 KiB
        b = a + 1                            # 2 KiB live
        del a
        return b * 3                         # b and the output: 2 KiB
    assert H.analyze(f, x).peak_live_bytes == 2 * 1024


def test_profile_reader_on_a_cpu_trace_finds_no_device_kernel():
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    p = H.analyze_profile(prof)
    assert p.kernels == {} and p.device_ms == 0 and p.busy == 0
    assert p.wall_ms > 0
