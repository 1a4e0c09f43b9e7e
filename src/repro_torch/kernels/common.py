"""Build, load and count the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` exports plain ``extern "C"`` launchers. It is
compiled with ``nvcc`` for ``sm_90a`` into ``build/kernels/<name>-<hash>.so``
at the repository root, the hash covering the source, the shared headers
``csrc/*.cuh`` and the flags, and
loaded with ``ctypes``: no PyTorch headers are compiled, so a build takes
seconds. Building happens at first use (or in ``build``), never at import.

``launches`` counts, per kernel, the launches made by its wrapper (keys
``LAUNCHES``: one a source, and K4's backward, ``wkv6_bwd``, beside its
forward); a run resets it with ``reset_launches`` and reads it afterwards
to show that the path went through the kernels.

Each kernel's forward but K5's is an operator of the ``repro_torch`` library
(``define_op``): its CPU and CUDA implementation is the wrapper (plain
version on CPU tensors, the kernel or a raise on CUDA ones), its fake
implementation gives the output shapes alone, so fake tensors and DTensors
(``register_shardings``) trace it while plain meta tensors stay refused,
and its FLOPs are registered with ``torch.utils.flop_counter``. The operators are registered
through ``torch.library.Library`` rather than ``custom_op``: the
lower-level route costs less host time a call, which the host-bound
decode step pays at every launch (PERF.md, the kernel table). K5, AdamW
(``kernels/adamw``), updates its leaves in place and runs only on real CUDA
tensors: ``train/optimizer.py`` calls its wrapper directly and keeps fake
tensors, and DTensors over fake or CPU shards, on the plain loop.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Callable, Dict, Iterable, List

import torch

KERNELS = ("rmsnorm", "flash_attention", "decode_attention", "wkv6", "adamw")
#: the launch counters: a source's kernel, and K4's backward (``csrc/wkv6.cu``)
LAUNCHES = ("rmsnorm", "flash_attention", "decode_attention", "wkv6", "wkv6_bwd",
            "adamw")

CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

launches: Dict[str, int] = {name: 0 for name in LAUNCHES}
_loaded: Dict[str, ctypes.CDLL] = {}

LIB = torch.library.Library("repro_torch", "FRAGMENT")
#: (operator, sharding function) pairs, registered with DTensor on demand
_SHARDINGS: List[tuple] = []
_shardings_registered = False


def define_op(name: str, schema: str, impl: Callable, fake: Callable,
              flops: Callable, sharding: Callable):
    """Define ``repro_torch::<name><schema>`` with ``impl`` for CPU and CUDA
    tensors, ``fake`` for fake ones and ``flops`` (taking the tensor
    arguments' shapes, the others as given, and ``out_shape``) for
    ``FlopCounterMode``; ``sharding`` is its DTensor strategy (see
    ``register_shardings``). Returns the operator's overload."""
    from torch.utils.flop_counter import register_flop_formula

    LIB.define(name + schema)
    for key in ("CPU", "CUDA"):
        LIB.impl(name, impl, key)

    def fake_only(*args):
        # ``register_fake`` also serves the Meta key: plain meta tensors,
        # or a mix of devices, are refused there as the wrapper refuses them
        from torch._subclasses.fake_tensor import FakeTensor
        tensors = [a for a in args if isinstance(a, torch.Tensor)]
        if not all(isinstance(t, FakeTensor) for t in tensors):
            on_cpu(*tensors)
            raise ValueError(f"{name} takes CPU or CUDA tensors")
        return fake(*args)

    torch.library.register_fake(f"repro_torch::{name}", fake_only, lib=LIB)
    packet = getattr(torch.ops.repro_torch, name)
    register_flop_formula(packet)(flops)
    _SHARDINGS.append((packet.default, sharding))
    return packet.default


def register_shardings() -> None:
    """Give DTensor each kernel operator's sharding strategy (once per
    process; ``torch.distributed.tensor`` is imported only here)."""
    global _shardings_registered
    if _shardings_registered:
        return
    from torch.distributed.tensor.experimental import register_sharding
    for op, fn in _SHARDINGS:
        register_sharding(op)(fn)
    _shardings_registered = True


def mesh_divides(spec, *sizes: int) -> bool:
    """True if every mesh dim of the DTensor ``spec``'s mesh divides each
    of ``sizes``: a head dim shards only where each device keeps whole
    query groups."""
    return all(n % d == 0 for d in spec.mesh.shape for n in sizes)


def cdiv(a: int, b: int) -> int:
    return (a + b - 1) // b


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def on_cpu(*tensors: torch.Tensor) -> bool:
    """True if every tensor lies on the CPU (take the plain version), False
    if every tensor lies on a CUDA device (launch the kernel); raises on a
    mix or on any other device."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return True
    if kinds == {"cuda"}:
        if len({t.device for t in tensors}) != 1:
            raise ValueError("kernel inputs lie on different CUDA devices")
        return False
    raise ValueError(f"kernel inputs must all lie on the CPU or all on one "
                     f"CUDA device, got {sorted(kinds)}")


def nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = shutil.which("nvcc") or os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                           "the CUDA toolkit is installed")
    return path


def library_path(name: str) -> Path:
    """The build output of ``csrc/<name>.cu``, keyed by that source, the
    shared headers ``csrc/*.cuh`` it may include, and the flags."""
    digest = hashlib.sha256((CSRC_DIR / f"{name}.cu").read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def build(names: Iterable[str] = KERNELS, force: bool = False
          ) -> Dict[str, dict]:
    """Compile the named kernels, one ``nvcc`` per source, all at once.

    Returns ``{name: {"seconds": s, "log": ptxas output}}`` for each source
    compiled (``log`` lists each kernel's registers, shared memory and
    spills). Raises with the compiler's output if any build fails.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists() and not force:
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out, time.monotonic())
    results, failed = {}, []
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"--- {name} (nvcc exit {proc.returncode}) ---\n{log}")
            continue
        os.replace(tmp, out)  # atomic: concurrent builders never see a torn .so
        results[name] = {"seconds": time.monotonic() - t0, "log": log}
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return results


def load(name: str, argtypes: Dict[str, list]) -> ctypes.CDLL:
    """The kernel library for ``name``, built at first use, with each
    launcher's ``argtypes`` declared (``c_void_p`` for pointers and the
    stream, so none is cut to 32 bits) and ``restype`` ``c_int``."""
    lib = _loaded.get(name)
    if lib is None:
        path = library_path(name)
        if not path.exists():
            build([name])
        lib = ctypes.CDLL(str(path))
        for fn, types in argtypes.items():
            getattr(lib, fn).argtypes = types
            getattr(lib, fn).restype = ctypes.c_int
        _loaded[name] = lib
    return lib


def launch(name: str, fn, device: torch.device, *args) -> None:
    """Call launcher ``fn(*args, stream)`` on ``device``'s current stream,
    raise on a non-zero ``cudaError_t`` (a refused launch never runs, and no
    later synchronise reports it), and count the launch."""
    with torch.cuda.device(device):
        rc = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed with CUDA error {rc}")
    launches[name] += 1


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def aligned16(*tensors: torch.Tensor) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in tensors)
