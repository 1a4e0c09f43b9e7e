"""Weights and other inputs drawn from the run's seed, on the device.

Each leaf of the reference's ``layout`` is drawn by one ``randn`` call from
a generator of its own, seeded from (run seed, leaf index), so any leaf can
be drawn again alone, bit for bit: the reference redraws the starting
weights instead of keeping a copy, and the program gets the same tensors
the reference starts from. Leaves are fp32, as the configurations store
them.
"""
from __future__ import annotations

import numpy as np
import torch


def sub_seed(seed: int, *path: int) -> int:
    """A 63-bit seed for the stream ``path`` of the run seed ``seed``."""
    state = np.random.SeedSequence([int(seed) & (2 ** 64 - 1), *path]).generate_state(2)
    return int(state[0]) & (2 ** 63 - 1)


def draw_leaf(seed: int, index: int, spec, device) -> torch.Tensor:
    """Leaf ``index`` of a layout (path, shape, init, std): ones, or one
    seeded normal draw scaled by its std."""
    _path, shape, init, std = spec
    if init == "ones":
        return torch.ones(shape, dtype=torch.float32, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(sub_seed(seed, 1, index))
    x = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return x.mul_(std)


def nest(flat: dict) -> dict:
    """{"a.b": t} -> {"a": {"b": t}}."""
    out: dict = {}
    for path, t in flat.items():
        node = out
        *head, last = path.split(".")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = t
    return out


def frame_embeddings(seed: int, shape, device) -> torch.Tensor:
    """The prefix of precomputed frame embeddings (fp32, std 0.02), one
    draw for the run."""
    gen = torch.Generator(device=device)
    gen.manual_seed(sub_seed(seed, 2))
    return torch.randn(shape, generator=gen, dtype=torch.float32, device=device).mul_(0.02)


def token_stream(seed: int, steps: int, tokens_per_step: int, vocab: int) -> np.ndarray:
    """``steps`` global batches of token ids, uniform over the vocabulary."""
    rng = np.random.default_rng(sub_seed(seed, 3))
    return rng.integers(0, vocab, steps * tokens_per_step, dtype=np.int32)
