"""The comparison that decides ``correct``.

The numbers, each compared against a limit of its own where the cell's
limits file names it:

* ``grids_wrong``: steps whose grid, as the loop consumed it, is not the
  grid the benchmark wrote for that step (the data plane; limit 0);
* ``tokens_wrong``: steps whose device tokens, as the step read them, are
  not the host grid (the pipeline's copy to the card; limit 0);
* ``loss_gap``: the largest relative gap of a checked step's loss from the
  reference's;
* ``grad_gap``: over the leaves, the largest gap between the program's and
  the reference's norm of the first step's clipped gradient (the program's
  read from its first moment, m = (1 - b1) g after one step), over the
  reference's norm of that leaf or of the median leaf, whichever is larger;
* ``change_gap``: the same for the norm of each leaf's change over the
  checked steps, over the leaves whose reference gradient is at least a
  thousandth of the median leaf's (a leaf below that moves by round-off).
* ``route_margin`` (MoE): the reference follows the program's routing
  choices (``reference.Routes``) and checks each that is not its own: the
  largest relative margin by which the reference prefers a left-out expert.
"""
from __future__ import annotations

import math
import statistics
from typing import Dict

COUNTED_GRAD_SHARE = 1e-3


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float], leaves=None) -> list:
    floor = statistics.median(ref.values())
    keys = ref.keys() if leaves is None else leaves
    return [abs(prog[k] - ref[k]) / max(ref[k], floor) for k in keys]


def counted_leaves(ref_grad1: Dict[str, float]):
    floor = COUNTED_GRAD_SHARE * statistics.median(ref_grad1.values())
    return [k for k, v in ref_grad1.items() if v >= floor]


def readings(prog: dict, ref: dict, routes=None) -> Dict[str, float]:
    """The training gaps of the program's readings against the reference's
    (each a dict of ``losses``, ``grad1``, ``change``), and the routing
    margin where the reference followed given ``routes``."""
    pl, rl = prog["losses"], ref["losses"]
    if len(pl) != len(rl) or not all(map(math.isfinite, pl)):
        loss_gap = math.inf
    else:
        loss_gap = max(abs(a - b) / abs(b) for a, b in zip(pl, rl))
    change = leaf_gaps(prog["change"], ref["change"], counted_leaves(ref["grad1"])) or [math.inf]
    out = {"loss_gap": loss_gap, "grad_gap": max(leaf_gaps(prog["grad1"], ref["grad1"])),
           "change_gap": max(change)}
    if routes is not None:
        out["route_margin"] = routes.margin
    return out


NUMBERS = ("grids_wrong", "tokens_wrong", "loss_gap", "grad_gap", "change_gap",
           "route_margin")


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every number of ``numbers`` that the limits name at or under its
    limit (NaN fails)."""
    return all(numbers[k] <= v for k, v in limits.items() if k in numbers)
