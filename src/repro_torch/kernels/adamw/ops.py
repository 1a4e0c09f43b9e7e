"""K5 AdamW: one multi-tensor update of a list of CUDA leaves, in place,
through ``csrc/adamw.cu``. There is no operator and no plain version here:
the plain version is ``train/optimizer.py`` ``adamw_plain``, the loop that
CPU and fake tensors take, and this wrapper runs only on real CUDA
tensors (``adamw_update`` chooses by what it is given).

A step launches pass 1 (each launch's blocks write the sums of squares of
their gradient elements as fp64 partials), one block that sums every
partial of the step in order into the norm and the clip scale, then pass 2
(the update, which reads the scale, the learning rate and the bias
corrections through device pointers): ``2 ceil(L / MAX_LEAVES) + 1``
launches for ``L`` non-empty leaves of one dtype combination, and no host
sync. Each launch takes a table of up to ``MAX_LEAVES`` leaves by value;
``chunk_plan`` lays the launches out and ``chunk_span`` is the kernel's own
walk from a chunk to its elements.
"""
from __future__ import annotations

import bisect
import ctypes
import functools
from typing import List, Sequence, Tuple

import torch

from repro_torch.kernels.common import cdiv, launch, load, on_cpu, require

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_T = ctypes.POINTER(ctypes.c_int64)
_ARGTYPES = {"adamw_sumsq": [_T, _I, _I, _I, _P, _P],
             "adamw_scale": [_P, _I, _F, _P, _P],
             "adamw_fwd": [_T, _I, _I, _I, _I, _I, _P, _P, _P, _P,
                           _F, _F, _F, _F, _F, _F, _P]}
#: leaves a launch's table holds; must equal kMaxLeaves in csrc/adamw.cu
MAX_LEAVES = 48
#: elements of a leaf a block takes at a time; must equal kChunk there
CHUNK = 1 << 16
#: elements of a vector load; must equal kVec there
VEC = 4
#: blocks an SM of both passes' persistent grids (256 threads each)
BLOCKS_PER_SM = 4
#: parameter elements in the tables of every pass 2 launched (a step's
#: count is a difference, as with ``common.launches``)
counts = {"elems": 0}
#: the table's flags, as the kernel reads them
DECAY, ALIGNED = 1, 2
#: dtype codes of the kernel's templates
CODES = {torch.float32: 0, torch.bfloat16: 1}


def chunk_plan(numels: Sequence[int]) -> List[Tuple[List[int], List[int]]]:
    """The launches for leaves of ``numels`` elements: ``[(slots, first)]``,
    each launch's leaves (indices into ``numels``, empty leaves left out,
    order kept, at most ``MAX_LEAVES``) and ``first``, the first chunk of
    each of them followed by the launch's chunk count."""
    live = [i for i, n in enumerate(numels) if n > 0]
    plan = []
    for k in range(0, len(live), MAX_LEAVES):
        slots = live[k:k + MAX_LEAVES]
        first = [0]
        for i in slots:
            first.append(first[-1] + cdiv(numels[i], CHUNK))
        plan.append((slots, first))
    return plan


def chunk_span(first: Sequence[int], numels: Sequence[int],
               c: int) -> Tuple[int, int, int]:
    """The kernel's ``locate``: chunk ``c`` of a launch whose leaves hold
    ``numels`` elements, as (its leaf's slot, first element, end)."""
    slot = bisect.bisect_right(first, c) - 1
    start = (c - first[slot]) * CHUNK
    return slot, start, min(start + CHUNK, numels[slot])


def launch_count(numels_by_combination: Sequence[Sequence[int]]) -> int:
    """Launches of one step over leaves grouped by dtype combination."""
    return 2 * sum(len(chunk_plan(n)) for n in numels_by_combination) + 1


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _table(leaves, first):
    """The launcher's int64 layout: p, g, m, v pointers, element counts and
    flags, a leaf each, then ``first``."""
    cols = [[t.data_ptr() for t in col] for col in list(zip(*leaves))[:4]]
    flags = [(DECAY if decay else 0)
             | (ALIGNED if all(t.data_ptr() % (VEC * t.element_size()) == 0
                               for t in (p, g, m, v)) else 0)
             for p, g, m, v, decay in leaves]
    vals = [x for col in cols for x in col] + \
        [p.numel() for p, *_ in leaves] + flags + list(first)
    return (ctypes.c_int64 * len(vals))(*vals)


def adamw_fused(params, grads, ms, vs, decay, lr: torch.Tensor,
                bc1: torch.Tensor, bc2: torch.Tensor, *, b1: float, b2: float,
                eps: float, weight_decay: float, clip_norm: float
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """AdamW with global-norm clipping over the leaf lists ``params``,
    ``grads``, ``ms``, ``vs`` (one CUDA device, contiguous; each of p, g
    and the moments fp32 or bf16, m and v alike), ``decay`` a flag a leaf;
    ``lr``, ``bc1`` and ``bc2`` fp32 device scalars. Updates p, m and v in
    place and returns (grad_norm, scale) as fp32 0-d device tensors; the
    scale is 1 where ``clip_norm`` <= 0."""
    leaves = list(zip(params, grads, ms, vs, decay))
    scalars = (lr, bc1, bc2)
    require(not on_cpu(*(t for leaf in leaves for t in leaf[:4]), *scalars),
            "the adamw kernel takes CUDA tensors")
    for p, g, m, v, _ in leaves:
        require(p.shape == g.shape == m.shape == v.shape,
                f"adamw leaves differ in shape: p {tuple(p.shape)}, g "
                f"{tuple(g.shape)}, m {tuple(m.shape)}, v {tuple(v.shape)}")
        require(all(t.dtype in CODES for t in (p, g, m)) and m.dtype == v.dtype,
                f"adamw kernel takes float32 or bfloat16 p, g and moments "
                f"(m and v alike), got {p.dtype}, {g.dtype}, {m.dtype}, {v.dtype}")
        require(all(t.is_contiguous() for t in (p, g, m, v)),
                "adamw kernel updates contiguous leaves in place")
    require(all(s.dtype == torch.float32 and s.numel() == 1 for s in scalars),
            "adamw kernel reads lr, bc1 and bc2 as fp32 scalars")
    device = lr.device
    groups = {}
    for leaf in leaves:
        p, g, m = leaf[:3]
        groups.setdefault((CODES[p.dtype], CODES[g.dtype], CODES[m.dtype]),
                          []).append(leaf)
    launches = []
    for codes, group in groups.items():
        for slots, first in chunk_plan([leaf[0].numel() for leaf in group]):
            tabled = [group[s] for s in slots]
            launches.append((codes, _table(tabled, first), len(slots),
                             sum(leaf[0].numel() for leaf in tabled)))
    blocks = BLOCKS_PER_SM * _sm_count(device.index)
    partials = torch.empty(max(1, len(launches)) * blocks, dtype=torch.float64,
                           device=device)
    out = torch.empty(2, dtype=torch.float32, device=device)
    lib = load("adamw", _ARGTYPES)
    for j, ((_, g_code, _), table, n, _e) in enumerate(launches):
        launch("adamw", lib.adamw_sumsq, device, table, n, g_code, blocks,
               partials.data_ptr() + 8 * j * blocks)
    launch("adamw", lib.adamw_scale, device, partials.data_ptr(),
           len(launches) * blocks, float(clip_norm), out.data_ptr())
    hyper = (b1, 1 - b1, b2, 1 - b2, eps, weight_decay)
    for codes, table, n, elems in launches:
        launch("adamw", lib.adamw_fwd, device, table, n, *codes, blocks,
               out.data_ptr() + 4, lr.data_ptr(), bc1.data_ptr(),
               bc2.data_ptr(), *hyper)
        counts["elems"] += elems
    return out[0], out[1]
