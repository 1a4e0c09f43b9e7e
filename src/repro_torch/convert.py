"""Parameter trees between the JAX package and the port, through numpy.

The port cannot reproduce ``jax.random`` streams, so parity runs build the
weights once and hand them over: ``jax.tree_util.tree_map(np.asarray,
params)`` on the JAX side, ``params_from_numpy`` here. Leaf paths and the
leading "layers" axis are kept, so one tree format serves both packages.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.common import resolve_device, tree_map


def _to_tensor(a: np.ndarray, device: torch.device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        # torch.from_numpy rejects ml_dtypes.bfloat16: go through its bits
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.int16).copy())
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.ascontiguousarray(a).copy()).to(device)


def params_from_numpy(tree, device=None):
    """Nested dict of numpy arrays (bf16 as ``ml_dtypes.bfloat16``) ->
    the same nested dict of tensors on ``device`` (the CUDA card by default)."""
    dev = resolve_device(device)
    return tree_map(lambda a: _to_tensor(a, dev), tree)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes  # only needed to hand bf16 leaves back
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def params_to_numpy(params):
    """The reverse of ``params_from_numpy``: tensors -> host numpy arrays."""
    return tree_map(_to_numpy, params)
