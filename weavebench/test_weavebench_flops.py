"""The work the benchmark credits, against numbers worked out by hand."""
import json
from pathlib import Path

import pytest

pytest.importorskip("torch")

from wb.flops import attention_op_work, least_seconds, rmsnorm_op_work  # noqa: E402
from wb.spec import reference  # noqa: E402

CONFIGS = Path(__file__).resolve().parent / "configs"
GRANITE_CFG = json.loads((CONFIGS / "granite-8b-l8.json").read_text())
QWEN_CFG = json.loads((CONFIGS / "qwen3-vl-30b-a3b-l4.json").read_text())
GRANITE, QWEN = GRANITE_CFG["model"], QWEN_CFG["model"]
# a step's model FLOPs are counted by the reference module the config names
GRANITE_REF, QWEN_REF = reference(GRANITE_CFG["reference"]), reference(QWEN_CFG["reference"])


def test_granite_8b_l8_model_flops_a_step():
    # a layer: wq 4096 x 4096, wk and wv 4096 x 1024, wo 4096 x 4096, the
    # SwiGLU 3 x 4096 x 14336; eight layers and the 4096 x 49152 head
    layer = 16_777_216 + 2 * 4_194_304 + 16_777_216 + 176_160_768
    assert layer == 218_103_808
    assert GRANITE_REF.matmul_params(GRANITE) == 8 * layer + 201_326_592 == 1_946_157_056
    # 6 x params x 4096 positions, and 3 x the causal products of 8 layers:
    # 4 x B 4 x H 32 x dh 128 x (1024 x 1025 / 2 = 524,800 pairs)
    attn = 4 * 4 * 32 * 128 * 524_800
    assert attn == 34_393_292_800
    assert GRANITE_REF.step_model_flops(GRANITE, 4, 1024) == \
        6 * 1_946_157_056 * 4096 + 3 * 8 * attn == 48_654_194_835_456
    # the same tokens as one 4096-token row: 4 x 32 x 128 x 8,390,656 pairs
    assert GRANITE_REF.step_model_flops(GRANITE, 1, 4096) == \
        6 * 1_946_157_056 * 4096 + 3 * 8 * 4 * 32 * 128 * 8_390_656


def test_qwen3_vl_l4_counts_the_router_and_top_8_experts_over_the_prefix():
    # attention 2 x 2048 x 4096 + 2 x 2048 x 512; eight experts of
    # 3 x 2048 x 768 and the 2048 x 128 router; four layers and the head
    layer = 2 * 8_388_608 + 2 * 1_048_576 + 8 * 4_718_592 + 262_144
    assert QWEN_REF.matmul_params(QWEN) == 4 * layer + 2048 * 151_936 == 538_705_920
    positions = 4 * (128 + 1024)
    attn = 4 * 4 * 32 * 128 * (1152 * 1153 // 2)
    assert QWEN_REF.step_model_flops(QWEN, 4, 1024, prefix=128) == \
        6 * 538_705_920 * positions + 3 * 4 * attn


def test_kernel_work_and_the_roofline_bound():
    flops, nbytes = attention_op_work((4, 1024, 32, 128), (4, 1024, 8, 128), True)
    assert flops == 4 * 4 * 32 * 128 * 524_800
    assert nbytes == 2 * (2 * 4 * 1024 * 32 * 128 + 2 * 4 * 1024 * 8 * 128) == 83_886_080
    full, _ = attention_op_work((1, 16, 2, 64), (1, 32, 1, 64), True)
    assert full == 4 * 2 * 64 * 16 * 32          # S != T: every pair
    flops, nbytes = rmsnorm_op_work((4, 1024, 4096), (4096,))
    assert (flops, nbytes) == (4 * 16_777_216, 4 * 16_777_216 + 4 * 4096)
    peaks = {"bf16_flops_per_s": 1e12, "hbm_bytes_per_s": 1e9}
    assert least_seconds(2e12, 1e9, peaks) == 2.0
    assert least_seconds(1e12, 3e9, peaks) == 3.0
