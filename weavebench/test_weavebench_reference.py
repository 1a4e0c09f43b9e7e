"""The plain reference against itself across a seed, its parameter layout
against the program's, and the controls of each cell's comparison at a
size a test run holds (at the cell's own size on a card)."""
import pytest

torch = pytest.importorskip("torch")

from wb import check  # noqa: E402
from wb.control import control_readings  # noqa: E402
from wb.spec import Spec, reference  # noqa: E402
from wb.weights import draw_leaf  # noqa: E402

SPEC = Spec()


@pytest.fixture(autouse=True)
def one_thread():
    """These models are small: one CPU thread runs them fastest, and keeps
    them fast beside other processes."""
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
CELLS = [w["name"] for w in SPEC.data["workloads"]]


def small(cell, spec=SPEC):
    """The controls' small size: the model as the cell's reference module
    sizes it for these tests (``small``), the traffic cut here."""
    cfg = spec.config(spec.cell(cell))
    traffic = spec.traffic(spec.cell(cell))
    tr = {"seq_len": min(traffic["seq_len"], 64 * (traffic["seq_len"] // 1024)),
          "backlog_steps": 4}
    if traffic["frontend_prefix"]:
        tr["frontend_prefix"] = 8
    return {"model": reference(cfg["reference"]).small(cfg["model"]), "traffic": tr}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


def test_the_reference_repeats_itself_and_follows_the_seed():
    # once for each family's reference, at its first cell's configuration
    firsts = {}
    for cell in CELLS:
        firsts.setdefault(SPEC.config(SPEC.cell(cell))["reference"], cell)
    for name, cell in sorted(firsts.items()):
        cfg = SPEC.config(SPEC.cell(cell))
        R = reference(name)
        m = dict(cfg["model"], **R.small(cfg["model"]))
        opt = SPEC.traffic(SPEC.cell(cell))["optimizer"]
        lay = R.layout(m)
        batches = [torch.randint(0, m["vocab_size"], (2, 16),
                                 generator=torch.Generator().manual_seed(i)) for i in range(2)]

        def read(seed):
            return R.train_readings(m, opt, lambda i: draw_leaf(seed, i, lay[i], "cpu"),
                                    batches)

        a, b, c = read(2**31 + 5), read(2**31 + 5), read(2**31 + 6)
        assert a == b, name
        assert a["grad1"] != c["grad1"] and a["change"] != c["change"], name
        assert all(x > 0 for x in a["change"].values()), name


@pytest.mark.parametrize("name", sorted({w["config"] for w in SPEC.data["workloads"]}))
def test_the_reference_layout_is_the_program_tree(name):
    import numpy as np

    from repro_torch.models import param_specs
    from repro_torch.models.common import tree_leaves
    from repro_torch.models.config import ModelConfig

    cell = next(w for w in SPEC.data["workloads"] if w["config"] == name)
    cfg = SPEC.config(cell)
    m = cfg["model"]
    shapes = [tuple(s.shape) for s in tree_leaves(param_specs(ModelConfig(**m)))]
    assert shapes == [tuple(spec[1]) for spec in reference(cfg["reference"]).layout(m)]
    assert sum(int(np.prod(s)) for s in shapes) == ModelConfig(**m).param_count()


@pytest.mark.parametrize("cell", CELLS)
def test_each_control_comes_out_not_correct(cell):
    limits = SPEC.limits(SPEC.cell(cell))
    out = control_readings(SPEC, cell, 2**31 + 77, "cpu", small(cell))
    controls = [c for c in ("fp8", "half_batch") if c in out]
    assert "fp8" in controls
    for c in controls:
        assert not check.judge(out[c], limits), (c, out[c])
    # a state left unchanged reads 1 on the change of every leaf
    assert not check.judge({"change_gap": 1.0}, limits)


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_each_control_comes_out_not_correct_at_the_cells_size(cell, cuda):
    limits = SPEC.limits(SPEC.cell(cell))
    out = control_readings(SPEC, cell, 2**31 + 78, cuda)
    for c in ("fp8", "half_batch"):
        if c in out:
            assert not check.judge(out[c], limits), (c, out[c])
