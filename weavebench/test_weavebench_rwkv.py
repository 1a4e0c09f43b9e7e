"""The RWKV family's plain reference (``wb/reference/rwkv.py``) against the
program and against itself, its FLOP count against a hand count, and the
readers of the metrics the rwkv6-3b cell adds, on the CPU."""
import json
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest

torch = pytest.importorskip("torch")

from wb.reference import rwkv as R  # noqa: E402
from wb.reference.common import stated  # noqa: E402
from wb.spec import Spec, metric_reader  # noqa: E402
from wb.weights import draw_leaf, nest  # noqa: E402

BENCH = Path(__file__).resolve().parent
SPEC = Spec()
CELL = "rwkv6-3b.pretrain-s1k"
CFG = SPEC.config(SPEC.cell(CELL))
OPT = SPEC.traffic(SPEC.cell(CELL))["optimizer"]


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(a, b):
    return float((a.double() - b.double()).norm() / b.double().norm().clamp_min(1e-30))


# ---------------------------------------------------------------------------
# the reference against the program
# ---------------------------------------------------------------------------

#: (loss, each leaf's gradient, each leaf's change after one AdamW step),
#: relative to the reference's, each a few times what these draws read
#: (fp32: 7.9e-8, 2.5e-6, 1.7e-4; bf16: 1.4e-4, 2.3e-2, 1.5e-3). fp32: both
#: sides compute one function, parted by summation order alone (the
#: reference's chunked WKV against the program's plain form), which AdamW's
#: first step, ~lr * sign(g), turns into a change gap where a tiny
#: gradient's sign differs. bf16: the program also rounds its elementwise
#: work (token shift, mixes, gating) to bf16 where the reference keeps fp32,
#: so a leaf's gradient moves by a few percent of its norm at these widths
TOLERANCES = {"fp32": (1e-6, 1e-4, 1e-3), "bf16": (1e-3, 0.06, 0.01)}


@pytest.mark.parametrize("numerics", ["fp32", "bf16"])
def test_the_reference_is_the_programs_loss_gradient_and_step(numerics):
    from repro_torch.models import model as M
    from repro_torch.models.config import ModelConfig
    from repro_torch.train import OptimizerConfig, init_opt_state, make_train_step

    m = dict(CFG["model"], **R.small(CFG["model"]),
             compute_dtype={"fp32": "float32", "bf16": "bfloat16"}[numerics])
    assert stated(m) == numerics
    lay = R.layout(m)
    seed = 2**31 + 35
    leaf = {spec[0]: draw_leaf(seed, i, spec, "cpu") for i, spec in enumerate(lay)}
    tokens = torch.randint(0, m["vocab_size"], (4, 48), generator=torch.Generator().manual_seed(3))
    cfg = ModelConfig(**m)

    ref = {k: v.clone().requires_grad_() for k, v in leaf.items()}
    ref_loss = R.loss_fn(m, ref, tokens, None, numerics)
    ref_grads = dict(zip(ref, torch.autograd.grad(ref_loss, list(ref.values()))))
    prog = {k: v.clone().requires_grad_() for k, v in leaf.items()}
    prog_loss, _ = M.loss_fn(cfg, nest(prog), {"tokens": tokens})
    prog_grads = dict(zip(prog, torch.autograd.grad(prog_loss, list(prog.values()))))

    ref_change = R.train_readings(m, OPT, lambda i: draw_leaf(seed, i, lay[i], "cpu"),
                                  [tokens])
    params = nest({k: v.clone() for k, v in leaf.items()})
    step = make_train_step(cfg, OptimizerConfig(**OPT))
    step(params, init_opt_state(params, OPT["state_dtype"]), {"tokens": tokens})
    flat = {k: v for k, v in zip(leaf, _leaves(params))}

    loss_tol, grad_tol, change_tol = TOLERANCES[numerics]
    assert abs(prog_loss.item() - ref_loss.item()) <= loss_tol * ref_loss.item()
    assert prog_loss.item() == pytest.approx(ref_change["losses"][0], rel=loss_tol)
    for k in leaf:
        assert _rel(prog_grads[k].float(), ref_grads[k]) <= grad_tol, k
        change = float((flat[k] - leaf[k]).norm())
        assert change == pytest.approx(ref_change["change"][k], rel=change_tol), k


def _leaves(tree):
    from repro_torch.models.common import tree_leaves
    return tree_leaves(tree)


@pytest.mark.parametrize("shape", [(2, 37, 3, 8), (1, 64, 2, 16)])
def test_the_chunked_wkv_is_the_per_token_recurrence(shape):
    """The form the loss runs, in blocks of 16 tokens (a ragged end too),
    against the recurrence one token at a time: y and the gradients of r,
    k, v, u and of the decay's exponent (w = exp(-exp(x)), as the model
    makes it, some decays near the clamp's 2e-24), all in fp32."""
    gen = torch.Generator().manual_seed(sum(shape))
    B, S, H, dh = shape
    r, k, v = (torch.randn(shape, generator=gen) for _ in range(3))
    x = torch.randn(shape, generator=gen) * 1.5
    u = torch.randn((H, dh), generator=gen)
    ct = torch.randn(shape, generator=gen)
    outs = []
    for form in (R.wkv_per_token, R.wkv):
        ins = [t.clone().requires_grad_() for t in (r, k, v, x, u)]
        w = torch.exp(-torch.exp(ins[3].clamp(R.DECAY_LOG_MIN, R.DECAY_LOG_MAX)))
        y = form(ins[0], ins[1], ins[2], w, ins[4])
        outs.append([y.detach()] + list(torch.autograd.grad(y, ins, ct)))
    for a, b in zip(*outs):
        assert float((b - a).abs().max() / a.abs().max()) < 2e-5


def test_the_reference_sets_tf32_off_inside_and_restores_it(monkeypatch):
    seen = []

    def readings(*a, **k):
        seen.append((torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32))
        return {}
    monkeypatch.setattr(R.common, "train_readings", readings)
    for flag in (True, False):
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = flag
        R.train_readings({}, OPT, None, [])
        assert (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32) == \
            (flag, flag)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True
    assert seen == [(False, False), (False, False)]


def test_importing_the_reference_loads_nothing_of_the_program():
    code = (f"import sys; sys.path[:0] = [{str(BENCH)!r}]\n"
            "import wb.reference.rwkv\n"
            "print(sorted({n.split('.')[0] for n in sys.modules}"
            " & {'repro_torch', 'repro', 'jax', 'jaxlib', 'flax'}))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "[]"


# ---------------------------------------------------------------------------
# the work a step is credited with
# ---------------------------------------------------------------------------

def test_step_model_flops_by_hand():
    tiny = dict(CFG["model"], **R.tiny(CFG["model"]))
    # a token of the 1-layer tiny model: r, k, v, g, o, cm_r 64 x 64, cm_k
    # and cm_v 64 x 160, the mix LoRA 64 x 40 and 40 x 64, the decay LoRA
    # 64 x 8 and 8 x 64, the WKV 4 heads of 4 x 16^2, the 64 x 257 head
    layer = 2 * (6 * 4096 + 2 * 10_240) + 2 * (2 * 2560) + 2 * (2 * 512) + 4 * 4 * 256
    assert layer == 106_496
    assert R.token_flops(tiny) == layer + 2 * 64 * 257 == 139_392
    assert R.step_model_flops(tiny, 4, 32) == 3 * 139_392 * 128
    # the cell: 32 layers at D 2560, F 8960, rank 64, head 64; V 65536;
    # 4 x 1024 tokens
    m = CFG["model"]
    per_layer = 2 * (6 * 2560**2 + 2 * 2560 * 8960) + 2 * (10 * 64 * 2560) \
        + 2 * (2 * 64 * 2560) + 4 * 2560 * 64
    assert per_layer == 174_981_120
    assert R.token_flops(m) == 32 * per_layer + 2 * 2560 * 65536 == 5_934_940_160
    assert R.step_model_flops(m, 4, 1024) == 72_928_544_686_080


def test_layout_holds_the_published_parameter_count():
    lay = R.layout(CFG["model"])
    assert len(lay) == 24
    assert sum(int(torch.Size(s[1]).numel()) for s in lay) == 3_125_824_000


# ---------------------------------------------------------------------------
# the readers of the metrics the cell adds
# ---------------------------------------------------------------------------

def test_wkv6_roofline_counts_k4s_bytes_by_hand():
    read = metric_reader("wkv6_roofline")
    work = read.__globals__["wkv6_op_work"]
    # the kernel table's serving shape: r, k, v, w, y bf16, u and the state fp32
    flops, nbytes = work((8, 1000, 40, 64), (40, 64), 2)
    assert nbytes == 5 * 2 * 8 * 1000 * 40 * 64 + 4 * (40 * 64 + 8 * 40 * 64 * 64) \
        == 210_053_120                                  # 210.05 MB
    assert flops == 4 * 8 * 1000 * 40 * 64 * 64
    flops, nbytes = work((4, 1024, 40, 64), (40, 64), 2)
    assert nbytes == 107_489_280                        # 0.0321 ms at 3.35 TB/s
    peaks = {"bf16_flops_per_s": 989e12, "hbm_bytes_per_s": 3.35e12}
    dims = [[4, 1024, 40, 64]] * 4 + [[40, 64], []]
    run = SimpleNamespace(peaks=peaks, model={"compute_dtype": "bfloat16"},
                          trace={"calls": {"repro_torch::wkv6_fwd": [(dims, 0.29e-3)] * 64
                                           + [(None, 0.1), (dims, 0.0)]}})
    assert read(run) == pytest.approx(100 * 107_489_280 / 3.35e12 / 0.29e-3)
    run.model = {"compute_dtype": "float32"}
    assert read(run) == pytest.approx(100 * (107_489_280 + 5 * 2 * 4 * 1024 * 40 * 64)
                                      / 3.35e12 / 0.29e-3)
    run.trace = {"calls": {"repro_torch::rmsnorm_fwd": [(dims, 1.0)]}}
    assert read(run) is None


def test_wkv6_backward_share_reads_planted_spans(monkeypatch):
    from repro_torch.obs.tracer import TRACER, Span
    read = metric_reader("wkv6.backward_share")
    spans = []

    def span(name, sid, parent, device_s):
        s = Span(name, "compute", 0.0, 1.0, 0, None, sid, parent)
        s.device_s = device_s
        spans.append(s)
    for k in (0, 100):   # two steps of 3.3 s; 2 layers
        span("train.step", k + 1, None, 3.3)
        span("train.forward", k + 2, k + 1, 0.4)
        span("train.backward", k + 3, k + 1, 2.8)
        for i in range(2):
            span("wkv6.forward", k + 10 + i, k + 2, 0.01)
            span("wkv6.forward", k + 20 + i, k + 3, 0.01)
            span("wkv6.backward", k + 30 + i, k + 3, 1.2)
    monkeypatch.setattr(TRACER, "spans", lambda: spans)
    run = SimpleNamespace(trace={"busy_s": 1.0})
    assert read(run) == pytest.approx(100 * 4.8 / 6.6)
    assert read(SimpleNamespace(trace=None)) is None
    # a program without the spans (the parent commit's)
    monkeypatch.setattr(TRACER, "spans", lambda: [s for s in spans if "wkv6" not in s.name])
    assert read(run) is None


def test_the_cell_lists_its_metrics():
    """The cell reports the metrics of the layers it runs, K4's two, and
    none of attention's or the MoE's; tokens/s and set-up, no step tail
    (~12 steps a window)."""
    mine = {p["name"] for p in SPEC.data["per_layer"] if CELL in p.get("workloads", [CELL])}
    assert {"pipeline.data_wait_share", "consumer.read_ms_p95", "consumer.get_ms_p95",
            "step.mfu", "device.idle_share", "rmsnorm_roofline", "train.optimizer_share",
            "train.backward_share", "train.host_syncs_per_step",
            "train.optimizer_kernel_share", "wkv6.backward_share", "wkv6_roofline"} <= mine
    assert not {n for n in mine if n.startswith("moe.") or n == "flash_attention_roofline"}
    e2e = {e["name"] for e in SPEC.data["end_to_end"] if CELL in e.get("workloads", [CELL])}
    assert e2e == {"tokens_per_s", "setup_s"}
    assert json.loads((BENCH / "configs" / "rwkv6-3b.json").read_text())["reduced"] == {}
