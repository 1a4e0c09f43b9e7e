"""Serving example on the PyTorch/CUDA port: batched prefill + greedy decode
with the KV cache. On the card, prefill attention, decode attention and every
RMSNorm run on the port's hand-written Hopper kernels (always on: there is no
switch); ``--device cpu`` runs their plain PyTorch versions instead.

Run:  PYTHONPATH=src python examples/serve_torch.py [--batch 4] [--gen 24]
      PYTHONPATH=src python examples/serve_torch.py --device cpu
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.kernels import common as kcommon
from repro_torch.models import (ModelConfig, decode_step, init_decode_state,
                                init_params, param_specs, prefill)
from repro_torch.models.common import resolve_device
from repro_torch.serve.engine import serving_params


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=24)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default: the Hopper kernels) or cpu")
    args = ap.parse_args()
    dev = resolve_device(args.device)

    cfg = ModelConfig(name="serve-demo", family="dense", num_layers=4,
                      d_model=256, num_heads=4, num_kv_heads=2, d_ff=1024,
                      vocab_size=4096)
    params = serving_params(cfg, init_params(param_specs(cfg), seed=0,
                                             device=dev), dev)
    B, P, G = args.batch, args.prompt_len, args.gen
    max_seq = P + G

    rng = np.random.default_rng(0)
    prompts = torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (B, P)).astype(np.int64)).to(dev)

    with torch.inference_mode():
        # -- prefill: one pass fills the preallocated KV cache for the batch ----
        t0 = time.time()
        cache = init_decode_state(cfg, B, max_seq, device=dev)
        logits, cache = prefill(cfg, params, {"tokens": prompts}, cache=cache)
        _sync(dev)
        t_prefill = time.time() - t0
        print(f"prefill: {B} x {P} tokens in {t_prefill * 1e3:.1f} ms "
              f"(cache {tuple(cache['k'].shape)}, {dev})")

        # -- batched greedy decode -----------------------------------------------
        tok = torch.argmax(logits, dim=-1)
        generated = [tok.cpu().numpy()]
        t0 = time.time()
        for i in range(G - 1):
            logits, cache = decode_step(cfg, params, cache, tok, P + i)
            tok = torch.argmax(logits, dim=-1)
            generated.append(tok.cpu().numpy())
        _sync(dev)
        dt = time.time() - t0
    out = np.stack(generated, axis=1)
    print(f"decode: {B} x {G} tokens in {dt * 1e3:.1f} ms "
          f"({B * G / max(dt, 1e-9):.1f} tok/s batched)")
    for b in range(min(B, 2)):
        print(f"  seq{b}: prompt[-4:]={prompts[b, -4:].tolist()} "
              f"-> gen[:8]={out[b, :8].tolist()}")
    print(f"kernel launches: {kcommon.launches}")


if __name__ == "__main__":
    main()
