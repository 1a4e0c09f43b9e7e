"""Distributed model-state checkpointing to the object store (port of
``repro.train.checkpoint``).

This module owns the *model* half of the recovery story: uploading a tree
of tensors as immutable leaf objects plus a ``MANIFEST.ckpt`` index
(manifest-last ordering gives atomic visibility, exactly like the data
plane's TGBs), and reading it back into a template tree.

The *binding* half — coupling a model checkpoint to the data-plane cursor so
a crash between the two saves cannot break exactly-once — lives in the
RunManifest (``repro_torch.run``): ``TrainSession.checkpoint`` calls
:func:`upload_model_state` and then commits a RunManifest entry naming the
upload. A model upload whose RunManifest commit never landed is invisible to
recovery and is reported by ``repro_torch.ops.fsck`` as a safe orphan.

``save_checkpoint`` / ``restore_checkpoint`` keep the pre-RunManifest
behaviour (free-floating step dirs + per-rank watermarks) for callers that
manage their own cursor persistence; new code should go through
``TrainSession``.

Layout under ``{ns}/checkpoints/{step:010d}/`` — the reference's, byte for
byte, so a checkpoint written by either package restores in the other:
    MANIFEST.ckpt             msgpack: schema, step, cursor, leaf index
    leaf-{i:05d}.npy          raw little-endian array bytes per tree leaf

Leaves are torch tensors (any device) or numpy arrays / scalars. A tensor
leaf is copied to the host one leaf at a time; its ``dtype`` entry is the
name numpy gives the same dtype (``float32``, ``bfloat16``, ``int32``...).
bf16 needs no ``ml_dtypes``: its bits are written and read as ``int16``.
On restore the template gives only the structure — the recorded dtype and
shape win — and each leaf lands on its template leaf's device; a numpy (or
Python scalar) template leaf gives a numpy array, as the reference does
without JAX.

torch is imported only where a leaf is a tensor, so the host modules that
import this one (the RunManifest, fsck, the ops CLI, the chaos harness and
its numpy leaves) start without it.
"""
from __future__ import annotations

import functools
import sys
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core import _msgpack as msgpack
from repro_torch.core.objectstore import Namespace, NoSuchKey

#: model-checkpoint MANIFEST schema tag (independent of the RunManifest's)
CKPT_SCHEMA = 2

#: the dtype names a leaf may carry, as numpy spells them (numpy's names
#: are the wire format: the reference writes ``str(np.asarray(leaf).dtype)``;
#: torch names each dtype the same), and their bytes per element
_ITEMSIZE = {
    "bool": 1, "uint8": 1, "int8": 1, "int16": 2, "int32": 4, "int64": 8,
    "float16": 2, "bfloat16": 2, "float32": 4, "float64": 8,
    "complex64": 8, "complex128": 16,
}


@functools.cache
def _torch_dtypes() -> Dict[str, Any]:
    """Each dtype name of ``_ITEMSIZE`` to its torch dtype."""
    import torch
    return {name: getattr(torch, name) for name in _ITEMSIZE}


def _is_tensor(x) -> bool:
    """Whether ``x`` is a torch tensor; where torch is not loaded, nothing
    is one."""
    torch = sys.modules.get("torch")
    return torch is not None and isinstance(x, torch.Tensor)


def dtype_itemsize(name: str) -> int:
    """Bytes per element of a leaf dtype recorded in ``MANIFEST.ckpt``."""
    return _ITEMSIZE[name]


# ---------------------------------------------------------------------------
# Tree flattening (the reference's pure-Python flattener; its JAX flattener
# gives the same paths for nested dicts, lists and tuples)
# ---------------------------------------------------------------------------

def _flatten_py(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """Deterministic nested dict/list/tuple flattener (sorted dict keys),
    path-compatible with the jax flattener for those container types."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out.extend(_flatten_py(tree[k], f"{prefix}{k}/"))
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, leaf in enumerate(tree):
            out.extend(_flatten_py(leaf, f"{prefix}{i}/"))
        return out
    return [(prefix.rstrip("/"), tree)]


def _rebuild(node, it):
    """``node``'s structure holding the leaves ``it`` yields, in
    ``_flatten_py`` order. A module-level function, not a recursive
    closure: the closure's reference cycle would keep the restored leaves
    alive until the cycle collector ran."""
    if isinstance(node, dict):
        return {k: _rebuild(node[k], it) for k in sorted(node)}
    if isinstance(node, (list, tuple)):
        return type(node)(_rebuild(x, it) for x in node)
    return next(it)


# ---------------------------------------------------------------------------
# Leaves to bytes and back
# ---------------------------------------------------------------------------

def _leaf_bytes(leaf) -> Tuple[bytes, List[int], str]:
    """(raw little-endian bytes, shape, numpy dtype name) of one leaf."""
    if _is_tensor(leaf):
        import torch
        t = leaf.detach().cpu().contiguous()
        name = str(t.dtype).removeprefix("torch.")
        if name not in _ITEMSIZE:
            raise TypeError(f"no checkpoint dtype for a {t.dtype} leaf")
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)   # numpy has no bf16 without ml_dtypes
        return t.numpy().tobytes(), list(leaf.shape), name
    arr = np.asarray(leaf)
    # str(dtype) round-trips extended dtypes (bfloat16 via ml_dtypes)
    return arr.tobytes(), list(arr.shape), str(arr.dtype)


def _as_tensor(buf: bytes, dtype_str: str, shape: List[int], device):
    import torch
    dt = _torch_dtypes().get(dtype_str)
    if dt is None:
        raise TypeError(f"checkpoint leaf dtype {dtype_str!r} has no torch "
                        f"dtype")
    if not buf:
        return torch.empty(shape, dtype=dt, device=device)
    # one leaf's private copy: torch.frombuffer over the store's immutable
    # bytes would alias them (and warns)
    host = torch.frombuffer(bytearray(buf), dtype=torch.uint8)
    return host.view(dt).reshape(shape).to(device)


def _as_array(buf: bytes, dtype_str: str, shape: List[int]) -> np.ndarray:
    if dtype_str == "bfloat16":
        import ml_dtypes  # a numpy bf16 leaf only where the template is numpy
        dt = np.dtype(ml_dtypes.bfloat16)
    else:
        dt = np.dtype(dtype_str)
    return np.frombuffer(buf, dtype=dt).reshape(shape).copy()


def _as_leaf(buf: bytes, entry: dict, like) -> Any:
    if _is_tensor(like):
        return _as_tensor(buf, entry["dtype"], entry["shape"], like.device)
    return _as_array(buf, entry["dtype"], entry["shape"])


# ---------------------------------------------------------------------------
# Model-state upload / load (the RunManifest-era primitives)
# ---------------------------------------------------------------------------

def checkpoint_dir_step(dirname: str) -> Optional[int]:
    """The step prefix of a checkpoint directory name (``0000000008`` or
    ``0000000008-r1``), or None for foreign directory names."""
    try:
        return int(dirname.split("-", 1)[0])
    except ValueError:
        return None


def upload_model_state(ns: Namespace, step: int, state: Dict[str, Any],
                       cursor: Optional[Tuple[int, int]] = None,
                       tag: Optional[str] = None) -> str:
    """Upload ``state`` (nested dicts/lists/tuples of tensors or arrays)
    under the step's checkpoint prefix; returns the ``MANIFEST.ckpt`` key.

    The upload alone does **not** make the checkpoint recoverable — only a
    RunManifest entry naming the returned key does. ``cursor`` is recorded
    for the legacy two-file flow and for human inspection. ``tag`` suffixes
    the directory name (``{step:010d}-{tag}``) so distinct upload attempts
    at the same step never overwrite an object an earlier RunManifest entry
    already binds.
    """
    dirname = f"{step:010d}" + (f"-{tag}" if tag else "")
    index = []
    for i, (path, leaf) in enumerate(_flatten_py(state)):
        raw, shape, dtype = _leaf_bytes(leaf)
        key = ns.key("checkpoints", dirname, f"leaf-{i:05d}.npy")
        ns.store.put(key, raw)
        index.append({"path": path, "shape": shape, "dtype": dtype,
                      "key": key})
    manifest = msgpack.packb({
        "schema": CKPT_SCHEMA,
        "step": step,
        "cursor": (None if cursor is None
                   else {"version": cursor[0], "step": cursor[1]}),
        "leaves": index,
    }, use_bin_type=True)
    mkey = ns.key("checkpoints", dirname, "MANIFEST.ckpt")
    ns.store.put(mkey, manifest)  # manifest-last: atomic visibility
    return mkey


def load_model_state(ns: Namespace, model_key: str, template: Dict[str, Any]
                     ) -> Tuple[Dict[str, Any], dict]:
    """Read a model checkpoint by its ``MANIFEST.ckpt`` key into a tree
    matching ``template``'s structure, each leaf on its template leaf's
    device. Returns ``(state, manifest_doc)``."""
    raw = ns.store.get(model_key)
    doc = msgpack.unpackb(raw, raw=False)
    by_path = {e["path"]: e for e in doc["leaves"]}
    out_leaves = []
    for path, like in _flatten_py(template):
        e = by_path[path]
        out_leaves.append(_as_leaf(ns.store.get(e["key"]), e, like))
    return _rebuild(template, iter(out_leaves)), doc


# ---------------------------------------------------------------------------
# Legacy two-file flow (pre-RunManifest; kept for direct-namespace callers)
# ---------------------------------------------------------------------------

def save_checkpoint(ns: Namespace, step: int, state: Dict[str, Any],
                    cursor: Tuple[int, int],
                    consumer_ranks: Optional[List[int]] = None) -> str:
    """Persist ``state`` + data cursor the pre-RunManifest way: the cursor
    rides inside ``MANIFEST.ckpt`` and per-rank watermarks are written
    immediately. Not atomic against the data plane — a crash between this
    and a separately-persisted cursor breaks exactly-once, which is exactly
    what ``TrainSession.checkpoint`` (RunManifest) exists to fix."""
    from repro_torch.core.lifecycle import Watermark, write_watermark

    mkey = upload_model_state(ns, step, state, cursor=cursor)
    wm = Watermark(version=cursor[0], step=cursor[1])
    for rank in (consumer_ranks or [0]):
        write_watermark(ns, rank, wm)
    return mkey


def list_checkpoints(ns: Namespace) -> List[int]:
    steps = set()
    for key in ns.store.list(ns.key("checkpoints")):
        if key.endswith("MANIFEST.ckpt"):
            step = checkpoint_dir_step(key.split("/")[-2])
            if step is not None:
                steps.add(step)
    return sorted(steps)


def _manifest_key_for_step(ns: Namespace, step: int) -> str:
    """The MANIFEST key of a step's most recent upload attempt (tagged
    retry dirs supersede the untagged original; tags count upward)."""
    best: Tuple[int, Optional[str]] = (-1, None)
    for key in ns.store.list(ns.key("checkpoints")):
        if not key.endswith("MANIFEST.ckpt"):
            continue
        dirname = key.split("/")[-2]
        if checkpoint_dir_step(dirname) != step:
            continue
        parts = dirname.split("-", 1)
        attempt = 0
        if len(parts) == 2:
            try:
                attempt = int(parts[1].lstrip("r")) or 0
            except ValueError:
                continue
        if attempt > best[0]:
            best = (attempt, key)
    if best[1] is None:
        raise NoSuchKey(f"no checkpoint at step {step}")
    return best[1]


def restore_checkpoint(ns: Namespace, template: Dict[str, Any],
                       step: Optional[int] = None
                       ) -> Tuple[Dict[str, Any], Tuple[int, int], int]:
    """Restore the tree (matching ``template``'s structure) + cursor.

    Returns (state, (cursor_version, cursor_step), ckpt_step). Note this is
    the *legacy* recovery path — it picks a step's newest upload attempt;
    only ``TrainSession.restore_model`` knows which upload a RunManifest
    entry actually bound.
    """
    steps = list_checkpoints(ns)
    if not steps:
        raise NoSuchKey("no checkpoints")
    if step is None:
        step = steps[-1]
    state, doc = load_model_state(ns, _manifest_key_for_step(ns, step),
                                  template)
    cur = doc.get("cursor") or {"version": -1, "step": 0}
    return state, (cur["version"], cur["step"]), doc["step"]
