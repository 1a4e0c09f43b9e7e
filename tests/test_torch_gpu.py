"""The port's Hopper kernels on the card, each against its plain PyTorch
version, plus one small model run through the kernels.

Every test carries the ``gpu`` marker and skips where no CUDA card is
present. This file imports no JAX, so it also runs on a machine that has
only PyTorch:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py

Tolerances. A kernel against its plain version, as chip_smoke.py checks
it: each element must hold |kernel - plain| <= 2**-7 |plain| + c RMS, one
bf16 ulp of the value plus a share c of the RMS of its output vector (the
last axis): c = 1e-2 for RMSNorm and decode attention, which compute in
fp32 throughout, and 2e-2 for flash attention, which feeds P to the tensor
cores in bf16. A fixed 4e-2 would be as large as a decode-attention output
over 1000 keys. The
model on the card against the model on the CPU runs through different
weight products, so it keeps the end-to-end bf16 atol = rtol = 4e-2 of
tests/test_kernels.py.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import common as kcommon  # noqa: E402
from repro_torch.kernels.decode_attention.ops import decode_attention  # noqa: E402
from repro_torch.kernels.decode_attention.ref import decode_attention_ref  # noqa: E402
from repro_torch.kernels.flash_attention.ops import flash_attention  # noqa: E402
from repro_torch.kernels.flash_attention.ref import flash_attention_ref  # noqa: E402
from repro_torch.kernels.rmsnorm.ops import rmsnorm  # noqa: E402
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref  # noqa: E402
from repro_torch.models import (ModelConfig, decode_step, init_cache,  # noqa: E402
                                init_params, param_specs, prefill)
from repro_torch.serve.engine import serving_params  # noqa: E402

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    """The card, decided when the test runs (never at import: every xdist
    worker must collect the same tests)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _randn(gen, shape, dtype, device):
    return torch.randn(shape, generator=gen, device=device).to(dtype)


KERNEL_RTOL = 2.0 ** -7


def _assert_kernel_close(got, want, c):
    assert got.dtype == want.dtype and got.shape == want.shape
    g, w = got.float(), want.float()
    assert torch.isfinite(g).all()
    err = (g - w).abs()
    rms = w.pow(2).mean(dim=-1, keepdim=True).sqrt()
    limit = KERNEL_RTOL * w.abs() + c * rms
    worst = float((err / limit.clamp_min(1e-30)).max())
    assert worst <= 1.0, (f"max |err| {float(err.max()):.3e}, worst element "
                          f"at {worst:.2f}x its limit")


def _assert_close(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    torch.testing.assert_close(got.float(), want.float(), atol=4e-2, rtol=4e-2)


@pytest.mark.parametrize("shape", [(8000, 4096), (8, 4096), (1001, 4096),
                                   (3, 7, 256), (2, 64), (1, 8)])
def test_rmsnorm_kernel_matches_plain(cuda, shape):
    gen = torch.Generator(device=cuda).manual_seed(0)
    x = _randn(gen, shape, torch.bfloat16, cuda)
    w = _randn(gen, (shape[-1],), torch.float32, cuda)
    _assert_kernel_close(rmsnorm(x, w), rmsnorm_ref(x, w), c=1e-2)


@pytest.mark.parametrize("B,S,T,H,G,dh,causal", [
    (2, 1000, 1000, 32, 8, 128, True),
    (2, 45, 45, 4, 2, 128, True),
    (1, 45, 100, 6, 3, 64, False),
    (1, 1, 1, 2, 1, 64, True),
    (1, 130, 130, 8, 8, 64, True),
])
def test_flash_attention_kernel_matches_plain(cuda, B, S, T, H, G, dh, causal):
    gen = torch.Generator(device=cuda).manual_seed(1)
    q = _randn(gen, (B, S, H, dh), torch.bfloat16, cuda)
    k = _randn(gen, (B, T, G, dh), torch.bfloat16, cuda)
    v = _randn(gen, (B, T, G, dh), torch.bfloat16, cuda)
    _assert_kernel_close(flash_attention(q, k, v, causal),
                         flash_attention_ref(q, k, v, causal), c=2e-2)


@pytest.mark.parametrize("B,H,G,dh,T,cur", [
    (8, 32, 8, 128, 1032, 1015),
    (8, 32, 8, 128, 1032, 1031),
    (2, 8, 2, 64, 256, 0),
    (3, 6, 3, 64, 100, 70),
    (1, 8, 1, 128, 700, 699),
])
def test_decode_attention_kernel_matches_plain(cuda, B, H, G, dh, T, cur):
    gen = torch.Generator(device=cuda).manual_seed(2)
    q = _randn(gen, (B, H, dh), torch.bfloat16, cuda)
    kc = _randn(gen, (B, T, G, dh), torch.bfloat16, cuda)
    vc = _randn(gen, (B, T, G, dh), torch.bfloat16, cuda)
    _assert_kernel_close(decode_attention(q, kc, vc, cur),
                         decode_attention_ref(q, kc, vc, cur), c=1e-2)


def test_kernels_refuse_inputs_they_do_not_take(cuda):
    q = torch.zeros(1, 4, 2, 64, dtype=torch.float16, device=cuda)
    with pytest.raises(ValueError):
        flash_attention(q, q, q)           # fp16
    q = torch.zeros(1, 4, 2, 16, dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError):
        flash_attention(q, q, q)           # head_dim 16
    with pytest.raises(ValueError):        # fp32 x
        rmsnorm(torch.zeros(2, 8, device=cuda), torch.ones(8, device=cuda))
    with pytest.raises(ValueError):        # D not a multiple of 8
        rmsnorm(torch.zeros(2, 6, dtype=torch.bfloat16, device=cuda),
                torch.ones(6, device=cuda))


def test_model_on_the_card_launches_the_kernels_and_matches_the_cpu(cuda):
    cfg = ModelConfig(name="gpu-smoke", family="dense", num_layers=2,
                      d_model=256, num_heads=4, num_kv_heads=2, d_ff=512,
                      vocab_size=512)  # head_dim 64
    cpu_params = serving_params(cfg, init_params(param_specs(cfg), seed=0,
                                                 device="cpu"), torch.device("cpu"))
    gpu_params = serving_params(cfg, cpu_params, cuda)
    tokens = torch.arange(2 * 12).reshape(2, 12) * 7 % cfg.vocab_size
    kcommon.reset_launches()
    with torch.inference_mode():
        out = {}
        for dev, params in (("cpu", cpu_params), ("cuda", gpu_params)):
            cache = init_cache(cfg, 2, 16, device=dev)
            logits, cache = prefill(cfg, params, {"tokens": tokens.to(dev)},
                                    cache=cache)
            steps = [logits]
            for i in range(3):
                logits, cache = decode_step(cfg, params, cache,
                                            tokens[:, i].to(dev), 12 + i)
                steps.append(logits)
            out[dev] = steps
    L = cfg.num_layers
    assert kcommon.launches == {"rmsnorm": (2 * L + 1) * 4,
                                "flash_attention": L,
                                "decode_attention": 3 * L}
    for a, b in zip(out["cuda"], out["cpu"]):
        _assert_close(a.cpu(), b)
