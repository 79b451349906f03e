"""Build, load and launch the port's hand-written CUDA kernels.

Each source under consensus_overlord_tpu_torch/csrc/ is one shared
library with a plain C interface, compiled by ``nvcc`` for ``sm_90a``
into consensus_overlord_tpu_torch/_build/ at first use and loaded with
ctypes.  The library's file name carries a hash of its sources and flags,
so an edited source is never served by a stale build.  Nothing falls back:
a missing ``nvcc``, a failed build or a refused launch raises.

Each kernel keeps a launch counter (``Kernel.launches``) that its wrapper
increments once per launch and nowhere else, so a run can show that the
main path went through the kernel.

The wrappers take the JAX package's (B, n) limb layout, int32, contiguous,
on one CUDA device; they allocate outputs with ``torch.empty`` and launch
on ``torch.cuda.current_stream()``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

# Table layout shared with csrc/fq_field.cuh (the FQ_TAB_* macros).
FQ_N = 39
FQ_BITS = 10
FQ_MAXW = 80
FQ_FOLD_ROWS = 47
FQ_MAX_STEPS = 16
#: Reduction plans in the order of the header's FQ_PLAN_* enum (their
#: input bounds: plan_bounds).
PLAN_NAMES = ("mul", "add2", "sub", "small2", "small3", "small8", "small12")
_STEP_KIND = {"pad": 0, "fold": 1, "carry": 2}


class Kernel:
    """One hand-written kernel: where it lives, what TPU kernel it
    replaces, and how many times its wrapper launched it."""

    def __init__(self, name: str, source: str, replaces: str):
        self.name = name
        self.route = "cuda"
        self.source = source
        self.replaces = replaces
        self.launches = 0


FQ_MUL = Kernel(
    "fq_mul", "consensus_overlord_tpu_torch/csrc/fq_mul.cu",
    "consensus_overlord_tpu/ops/pallas_field.py:41")
G1_ADD = Kernel(
    "g1_add", "consensus_overlord_tpu_torch/csrc/g1_point.cu",
    "consensus_overlord_tpu/ops/pallas_point.py:150")
G1_DBL = Kernel(
    "g1_dbl", "consensus_overlord_tpu_torch/csrc/g1_point.cu",
    "consensus_overlord_tpu/ops/pallas_point.py:150")
KERNELS = (FQ_MUL, G1_ADD, G1_DBL)


def reset_counts() -> None:
    for k in KERNELS:
        k.launches = 0


def counts() -> Dict[str, int]:
    return {k.name: k.launches for k in KERNELS}


# -- building and loading ------------------------------------------------------

#: Library name → (source file, exported functions with their argtypes).
_VP, _I = ctypes.c_void_p, ctypes.c_int
_LIBS = {
    "fq_mul": ("fq_mul.cu", {
        "fq_mul_launch": [_VP, _VP, _VP, _I, _I, _VP],
    }),
    "g1_point": ("g1_point.cu", {
        "g1_add_launch": [_VP] * 9 + [_I, _I, _VP],
        "g1_dbl_launch": [_VP] * 6 + [_I, _I, _VP],
    }),
}
_HEADERS = ("fq_field.cuh",)

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}
_tables_set: set = set()


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels of "
                           "consensus_overlord_tpu_torch cannot be built")
    return path


def _so_path(lib: str) -> str:
    src, _ = _LIBS[lib]
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in (src,) + _HEADERS:
        with open(os.path.join(CSRC, name), "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"{lib}_{h.hexdigest()[:16]}.so")


def _start_build(lib: str) -> Optional[Tuple[subprocess.Popen, str, str]]:
    so = _so_path(lib)
    if os.path.exists(so):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    cmd = [_nvcc()] + NVCC_FLAGS + ["-o", tmp,
                                    os.path.join(CSRC, _LIBS[lib][0])]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT)
    return proc, tmp, so


def _finish_build(lib: str, job) -> None:
    proc, tmp, so = job
    out, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {lib} "
                           f"(exit {proc.returncode}):\n"
                           f"{out.decode(errors='replace')}")
    os.replace(tmp, so)  # atomic: no process loads a half-written object


def build_all() -> float:
    """Compile every library that is not built yet, one nvcc per source,
    all started together.  Returns the wall seconds spent building."""
    t0 = time.perf_counter()
    with _lock:
        jobs = {lib: _start_build(lib) for lib in _LIBS}
        for lib, job in jobs.items():
            if job is not None:
                _finish_build(lib, job)
    return time.perf_counter() - t0


def _library(lib: str) -> ctypes.CDLL:
    handle = _loaded.get(lib)
    if handle is not None:
        return handle
    with _lock:
        if lib in _loaded:
            return _loaded[lib]
        job = _start_build(lib)
        if job is not None:
            _finish_build(lib, job)
        handle = ctypes.CDLL(_so_path(lib))
        for fn, argtypes in _LIBS[lib][1].items():
            f = getattr(handle, fn)
            f.argtypes = argtypes
            f.restype = ctypes.c_int
        handle.fq_set_tables.argtypes = [_VP, _I, _I]
        handle.fq_set_tables.restype = ctypes.c_int
        handle.fq_table_ints.argtypes = []
        handle.fq_table_ints.restype = ctypes.c_int
        handle.fq_error_string.argtypes = [_I]
        handle.fq_error_string.restype = ctypes.c_char_p
        if handle.fq_table_ints() != table_ints():
            raise RuntimeError(f"{lib}: table layout differs from "
                               "ops/kernels.py")
        _loaded[lib] = handle
        return handle


# -- the field tables the kernels replay ---------------------------------------

def table_ints() -> int:
    return (FQ_FOLD_ROWS * FQ_N + FQ_N + len(PLAN_NAMES)
            + len(PLAN_NAMES) * FQ_MAX_STEPS * 2)


def plan_bounds(spec, name: str) -> List[int]:
    """Per-position input bounds of the named reduction plan."""
    n, L = spec.n, spec.loose_max
    if name == "mul":
        return spec._conv_bounds()
    if name == "sub":
        return [L + int(spec._pad_np.max())] * n
    k = {"add2": 2, "small2": 2, "small3": 3, "small8": 8, "small12": 12}
    return [k[name] * L] * n


def fq_tables(spec) -> np.ndarray:
    """The int32 table the kernels read from constant memory: fold rows,
    subtraction pad, then each plan's step count and (kind, arg) steps.
    Checks that every plan stays inside the kernels' fixed widths."""
    if spec.n != FQ_N or spec.b != FQ_BITS:
        raise ValueError(f"{spec.name}: the CUDA field kernels are built "
                         f"for {FQ_N} limbs of {FQ_BITS} bits")
    fold = spec._fold_np[:FQ_FOLD_ROWS]
    nsteps = np.zeros(len(PLAN_NAMES), np.int64)
    steps = np.zeros((len(PLAN_NAMES), FQ_MAX_STEPS, 2), np.int64)
    for p, name in enumerate(PLAN_NAMES):
        bounds = plan_bounds(spec, name)
        plan = spec._plan(list(bounds))
        if len(plan) > FQ_MAX_STEPS:
            raise ValueError(f"plan {name} has {len(plan)} steps")
        width = len(bounds)
        for s, (kind, arg) in enumerate(plan):
            if kind == "fold":
                if arg > FQ_MAXW - FQ_N:
                    raise ValueError(f"plan {name} folds {arg} rows")
                width = FQ_N
            else:
                width += arg
            if width > FQ_MAXW:
                raise ValueError(f"plan {name} reaches width {width}")
            steps[p, s] = (_STEP_KIND[kind], arg)
        nsteps[p] = len(plan)
    tab = np.concatenate([fold.reshape(-1), spec._pad_np, nsteps,
                          steps.reshape(-1)]).astype(np.int32)
    assert tab.size == table_ints()
    return tab


def _check(name: str, tensors: Sequence[torch.Tensor], n: int) -> int:
    """Validate kernel operands; returns the batch (lane) count."""
    t0 = tensors[0]
    if t0.device.type != "cuda":
        raise ValueError(f"{name}: operands must be CUDA tensors, got "
                         f"{t0.device}")
    for t in tensors:
        if t.device != t0.device:
            raise ValueError(f"{name}: operands on different devices")
        if t.dtype != torch.int32:
            raise ValueError(f"{name}: operands must be int32, got {t.dtype}")
        if t.dim() != 2 or t.shape[1] != n or t.shape != t0.shape:
            raise ValueError(f"{name}: operands must share one (B, {n}) "
                             f"shape, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")
    return t0.shape[0]


def _prepare(lib: str, spec, device: torch.device) -> ctypes.CDLL:
    handle = _library(lib)
    key = (lib, device.index, id(spec))
    if key not in _tables_set:
        tab = fq_tables(spec)
        err = handle.fq_set_tables(tab.ctypes.data, tab.size, device.index)
        if err:
            raise RuntimeError(f"{lib}: setting the field tables failed: "
                               f"{handle.fq_error_string(err).decode()}")
        _tables_set.add(key)
    return handle


def _raise_if(handle: ctypes.CDLL, name: str, err: int) -> None:
    if err:
        raise RuntimeError(f"{name} launch failed: "
                           f"{handle.fq_error_string(err).decode()}")


def fq_mul(spec, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Batched loose-limb Fq multiply on the card (csrc/fq_mul.cu):
    x, y (B, n) int32 → (B, n) int32, bit-identical to spec.mul_plain."""
    batch = _check("fq_mul", (x, y), spec.n)
    handle = _prepare("fq_mul", spec, x.device)
    out = torch.empty_like(x)
    if batch:
        stream = torch.cuda.current_stream(x.device).cuda_stream
        _raise_if(handle, "fq_mul", handle.fq_mul_launch(
            out.data_ptr(), x.data_ptr(), y.data_ptr(), batch,
            x.device.index, stream))
        FQ_MUL.launches += 1
    return out


def g1_add(spec, p: Tuple[torch.Tensor, ...],
           q: Tuple[torch.Tensor, ...]) -> Tuple[torch.Tensor, ...]:
    """Fused RCB complete addition on G1 (csrc/g1_point.cu): projective
    (x1,y1,z1) + (x2,y2,z2) → (x3,y3,z3), each (B, n) int32."""
    ins = tuple(p) + tuple(q)
    batch = _check("g1_add", ins, spec.n)
    handle = _prepare("g1_point", spec, ins[0].device)
    outs = tuple(torch.empty_like(ins[0]) for _ in range(3))
    if batch:
        stream = torch.cuda.current_stream(ins[0].device).cuda_stream
        _raise_if(handle, "g1_add", handle.g1_add_launch(
            *(t.data_ptr() for t in outs + ins), batch,
            ins[0].device.index, stream))
        G1_ADD.launches += 1
    return outs


def g1_dbl(spec, p: Tuple[torch.Tensor, ...]) -> Tuple[torch.Tensor, ...]:
    """Fused a=0 doubling on G1 (csrc/g1_point.cu)."""
    ins = tuple(p)
    batch = _check("g1_dbl", ins, spec.n)
    handle = _prepare("g1_point", spec, ins[0].device)
    outs = tuple(torch.empty_like(ins[0]) for _ in range(3))
    if batch:
        stream = torch.cuda.current_stream(ins[0].device).cuda_stream
        _raise_if(handle, "g1_dbl", handle.g1_dbl_launch(
            *(t.data_ptr() for t in outs + ins), batch,
            ins[0].device.index, stream))
        G1_DBL.launches += 1
    return outs
