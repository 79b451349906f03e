"""Build, load and launch the port's hand-written CUDA kernels.

Each source under consensus_overlord_tpu_torch/csrc/ is one shared
library with a plain C interface, compiled by ``nvcc`` for ``sm_90a``
into consensus_overlord_tpu_torch/_build/ at first use and loaded with
ctypes.  The field's reduction plans reach the kernels at build time: a
header generated from ``FieldSpec._plan`` (``plan_header``) is written
into _build/ and included by the sources, so every plan step unrolls
over its live positions only.  The library's file name carries a hash
of its sources, that header and the flags, so an edited source or a
changed plan is never served by a stale build.  Nothing falls back: a
missing ``nvcc``, a failed build or a refused launch raises.

Each kernel keeps a launch counter (``Kernel.launches``) that its wrapper
increments once per launch and nowhere else, so a run can show that the
main path went through the kernel, and a histogram of the lanes per
launch (``Kernel.sizes``); both are updated under a lock, since a fleet
of providers launches from many threads.  The field tables are uploaded
once per device per process, under the module's lock.

The wrappers take the JAX package's limb layouts — (B, n) for the field
and G1 kernels, the tower's (B, 2, n), (B, 2, 3, 2, n) for the pairing
kernels — int32, contiguous, on one CUDA device; they allocate outputs
with ``torch.empty`` and launch on ``torch.cuda.current_stream()``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from .. import compile_cache

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
PLAN_HEADER = "fq_plans.h"

# -Xptxas -v: ptxas reports each kernel's registers and spills; the
# report is kept beside the library (build_log).
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              "-I", BUILD_DIR]

# Table layout shared with csrc/fq_field.cuh (the FQ_TAB_* macros).
FQ_N = 39
FQ_BITS = 10
FQ_MAXW = 80
FQ_FOLD_ROWS = 47
#: Reduction plans in the order of the generated FQ_PLAN_* enum (their
#: input bounds: plan_bounds).
PLAN_NAMES = ("mul", "add2", "sub", "small2", "small3", "small8", "small12",
              "neg")

#: Threads per lane ("lane group") of each kernel, fixed at build time
#: (MUL_G in csrc/fq_mul.cu, ADD_G and DBL_G in csrc/g1_point.cu,
#: TOWER_G in csrc/pairing.cu).
FQ_MUL_GROUP = 8
G1_ADD_GROUP = 16
G1_DBL_GROUP = 16
TOWER_GROUP = 16
#: Threads of a pairing kernel's block (TOWER_THREADS in csrc/pairing.cu):
#: its programs are built for TOWER_THREADS // 32 warps.
TOWER_THREADS = 512
GROUP_SIZES = tuple(sorted({FQ_MUL_GROUP, G1_ADD_GROUP, G1_DBL_GROUP,
                            TOWER_GROUP}))


class Kernel:
    """One hand-written kernel: where it lives, what TPU kernel it
    replaces, how many times its wrapper launched it, and how many lanes
    each launch carried."""

    def __init__(self, name: str, source: str, replaces: str):
        self.name = name
        self.route = "cuda"
        self.source = source
        self.replaces = replaces
        self.launches = 0
        self.sizes: Dict[int, int] = {}  # lanes per launch → launches
        self._lock = threading.Lock()

    def count(self, lanes: int) -> None:
        with self._lock:
            self.launches += 1
            self.sizes[lanes] = self.sizes.get(lanes, 0) + 1


FQ_MUL = Kernel(
    "fq_mul", "consensus_overlord_tpu_torch/csrc/fq_mul.cu",
    "consensus_overlord_tpu/ops/pallas_field.py:41")
G1_ADD = Kernel(
    "g1_add", "consensus_overlord_tpu_torch/csrc/g1_point.cu",
    "consensus_overlord_tpu/ops/pallas_point.py:150")
G1_DBL = Kernel(
    "g1_dbl", "consensus_overlord_tpu_torch/csrc/g1_point.cu",
    "consensus_overlord_tpu/ops/pallas_point.py:150")
# The pairing kernels replace XLA jits of the JAX package, not Pallas
# kernels: the Miller product (_miller_product_fn, whose pair tree is
# fq12_tree_product) and the final exponentiation (_final_is_one_fn).
MILLER_PRODUCT = Kernel(
    "miller_product", "consensus_overlord_tpu_torch/csrc/pairing.cu",
    "consensus_overlord_tpu/ops/pairing.py:203")
FQ12_MUL = Kernel(
    "fq12_mul", "consensus_overlord_tpu_torch/csrc/pairing.cu",
    "consensus_overlord_tpu/ops/pairing.py:147")
FINAL_EXP = Kernel(
    "final_exp", "consensus_overlord_tpu_torch/csrc/pairing.cu",
    "consensus_overlord_tpu/ops/pairing.py:211")
KERNELS = (FQ_MUL, G1_ADD, G1_DBL, MILLER_PRODUCT, FQ12_MUL, FINAL_EXP)
PAIRING_KERNELS = (MILLER_PRODUCT, FQ12_MUL, FINAL_EXP)


def reset_counts() -> None:
    for k in KERNELS:
        with k._lock:
            k.launches = 0
            k.sizes = {}


def counts() -> Dict[str, int]:
    return {k.name: k.launches for k in KERNELS}


def sizes() -> Dict[str, Dict[int, int]]:
    """Launches by exact lane count, per kernel (a copy)."""
    return {k.name: dict(k.sizes) for k in KERNELS}


def size_buckets(by_size: Dict[int, int]) -> Dict[int, int]:
    """Launches by power-of-two bucket: key 2**k counts the launches of
    2**(k−1) < lanes ≤ 2**k."""
    out: Dict[int, int] = {}
    for lanes, n in by_size.items():
        b = 1 << max(0, (lanes - 1).bit_length())
        out[b] = out.get(b, 0) + n
    return dict(sorted(out.items()))


# -- reduction plans fixed at build time --------------------------------------

def plan_bounds(spec, name: str) -> List[int]:
    """Per-position input bounds of the named reduction plan."""
    n, L = spec.n, spec.loose_max
    if name == "mul":
        return spec._conv_bounds()
    if name == "sub":
        return [L + int(spec._pad_np.max())] * n
    if name == "neg":
        return [int(spec._pad_np.max())] * n
    k = {"add2": 2, "small2": 2, "small3": 3, "small8": 8, "small12": 12}
    return [k[name] * L] * n


def plan_steps(spec, name: str) -> List[Tuple[str, int, int, int]]:
    """The named plan as (kind, arg, width before, width after) steps,
    checked against the kernels' fixed widths."""
    bounds = plan_bounds(spec, name)
    width = len(bounds)
    out = []
    for kind, arg in spec._plan(list(bounds)):
        w_in = width
        if kind == "fold":
            if arg > FQ_FOLD_ROWS or w_in != FQ_N + arg:
                raise ValueError(f"plan {name} folds {arg} rows")
            width = FQ_N
        else:
            width += arg
        if width > FQ_MAXW:
            raise ValueError(f"plan {name} reaches width {width}")
        out.append((kind, arg, w_in, width))
    if width != FQ_N:
        raise ValueError(f"plan {name} ends at width {width}")
    return out


def _check_spec(spec) -> None:
    if spec.n != FQ_N or spec.b != FQ_BITS:
        raise ValueError(f"{spec.name}: the CUDA field kernels are built "
                         f"for {FQ_N} limbs of {FQ_BITS} bits")


def plan_header(spec) -> str:
    """The C header the kernels include: every plan of PLAN_NAMES as an
    X-macro of its steps, FQ_STEP(kind, arg, width before, width after),
    and the most fold rows any step uses.  Deterministic in the spec."""
    _check_spec(spec)
    plans = {name: plan_steps(spec, name) for name in PLAN_NAMES}
    rows = max(a for steps in plans.values() for k, a, _, _ in steps
               if k == "fold")
    lines = [
        f"// Reduction plans of {spec.name}: FieldSpec._plan over",
        "// ops/kernels.py plan_bounds, written by ops/kernels.py",
        "// plan_header at build time.  Do not edit.",
        "#pragma once",
        f"#define FQ_GEN_N {spec.n}",
        f"#define FQ_GEN_BITS {spec.b}",
        f"#define FQ_GEN_FOLD_ROWS {rows}",
        "enum {",
    ]
    lines += [f"  FQ_PLAN_{name.upper()}," for name in PLAN_NAMES]
    lines += ["  FQ_NUM_PLANS", "};"]
    for name in PLAN_NAMES:
        lines.append(f"#define FQ_PLAN_{name.upper()}_STEPS(FQ_STEP) \\")
        body = [f"  FQ_STEP({k.upper()}, {a}, {wi}, {wo})"
                for k, a, wi, wo in plans[name]]
        lines += [ln + " \\" for ln in body[:-1]] + [body[-1]]
    lines.append("#define FQ_PLANS(X) " + " ".join(
        f"X({name.upper()})" for name in PLAN_NAMES))
    return "\n".join(lines) + "\n"


def group_layout(g: int) -> Tuple[int, int]:
    """(L, W) of a lane group of g threads: each thread owns L slots of
    the lane's element (positions tL..tL+L−1 of the W = gL low positions)
    and L of the high part (W+tL..W+tL+L−1).  Mirrors fq_group.cuh."""
    if g not in GROUP_SIZES:
        raise ValueError(f"lane groups of {g} threads are not built")
    L = -(-(FQ_N + 1) // g)
    return L, g * L


def group_terms(g: int) -> List[List[Tuple[int, int, int]]]:
    """The product terms a_i·b_j each thread of a g-thread lane group adds
    and the column it adds each to, (i, j, column), in the order and by
    the rule of csrc/fq_group.cuh fq_conv_rotated; zero terms left
    out."""
    L, W = group_layout(g)
    out = []
    for t in range(g):
        terms = []
        for s in range(L):
            c = t * L + s
            for k in range(W):
                i, j = (t * L + k) % W, (s - k) % W
                q, u = divmod(k, L)
                low = u <= s if q == 0 else q >= g - t
                if i < FQ_N and j < FQ_N:
                    terms.append((i, j, c if low else W + c))
        out.append(terms)
    return out


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
    "pairing": ("pairing.cu", {
        "miller_product_launch": [_VP] * 8 + [_I, _I, _I, _VP],
        "fq12_mul_launch": [_VP] * 5 + [_I, _I, _I, _VP],
        "final_exp_launch": [_VP] * 4 + [_I, _I, _I, _VP],
        "tower_probe_launch": [_VP] * 3 + [_I, _I, _I, _I, _VP],
    }),
}
_HEADERS = ("fq_field.cuh", "fq_group.cuh")

_lock = threading.Lock()
_loaded: Dict[Tuple[str, int], ctypes.CDLL] = {}  # (lib, id(spec))
_tables_set: set = set()


def _default_spec():
    from .field import BLS12_381_FQ  # field.py imports this module
    return BLS12_381_FQ


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels of "
                           "consensus_overlord_tpu_torch cannot be built")
    return path


def _so_path(lib: str, header: str) -> str:
    """The library's build path, named by the hash of the nvcc flags, its
    sources and the generated plan header's text."""
    src, _ = _LIBS[lib]
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in (src,) + _HEADERS:
        with open(os.path.join(CSRC, name), "rb") as f:
            h.update(f.read())
    h.update(header.encode())
    return os.path.join(BUILD_DIR, f"{lib}_{h.hexdigest()[:16]}.so")


def _write_header(header: str) -> None:
    path = os.path.join(BUILD_DIR, PLAN_HEADER)
    if os.path.exists(path):
        with open(path) as f:
            if f.read() == header:
                return
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "w") as f:
        f.write(header)
    os.replace(tmp, path)


def _start_build(lib: str, header: str):
    so = _so_path(lib, header)
    built = os.path.exists(so)
    compile_cache.record(hit=built)
    if built:
        return None
    _write_header(header)
    tmp = f"{so}.{os.getpid()}.tmp"
    cmd = [_nvcc()] + NVCC_FLAGS + ["-o", tmp,
                                    os.path.join(CSRC, _LIBS[lib][0])]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT)
    return proc, tmp, so


def _finish_build(lib: str, job) -> None:
    proc, tmp, so = job
    out, _ = proc.communicate()
    text = out.decode(errors="replace")
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {lib} "
                           f"(exit {proc.returncode}):\n{text}")
    with open(f"{so}.log", "w") as f:
        f.write(text)
    os.replace(tmp, so)  # atomic: no process loads a half-written object


def build_all(spec=None) -> float:
    """Compile every library that is not built yet, one nvcc per source,
    all started together.  Returns the wall seconds spent building."""
    header = plan_header(spec or _default_spec())
    t0 = time.perf_counter()
    with _lock:
        jobs = {lib: _start_build(lib, header) for lib in _LIBS}
        for lib, job in jobs.items():
            if job is not None:
                _finish_build(lib, job)
    return time.perf_counter() - t0


def load_all(device: torch.device, spec=None) -> None:
    """Build every library that is not built yet (in parallel), load each
    and upload the field tables to `device`: what a provider on a CUDA
    device does first, so that a failed build or load raises there."""
    spec = spec or _default_spec()
    if any((lib, id(spec)) not in _loaded for lib in _LIBS):
        build_all(spec)
    for lib in _LIBS:
        _prepare(lib, spec, device)


def build_log(lib: str, spec=None) -> str:
    """nvcc's output (the ptxas register and spill report) of the built
    library."""
    so = _so_path(lib, plan_header(spec or _default_spec()))
    with open(f"{so}.log") as f:
        return f.read()


def _library(lib: str, spec) -> ctypes.CDLL:
    key = (lib, id(spec))
    handle = _loaded.get(key)  # the per-launch path: no hashing, no I/O
    if handle is not None:
        return handle
    with _lock:
        if key in _loaded:
            return _loaded[key]
        header = plan_header(spec)
        so = _so_path(lib, header)
        job = _start_build(lib, header)
        if job is not None:
            _finish_build(lib, job)
        handle = ctypes.CDLL(so)
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
        _loaded[key] = handle
        return handle


# -- the field tables the kernels read -----------------------------------------

def table_ints() -> int:
    return FQ_FOLD_ROWS * FQ_N + FQ_N


def fq_tables(spec) -> np.ndarray:
    """The int32 table the kernels read from device memory: the fold rows
    (row k = 2**(b·(n+k)) mod p in limbs), then the subtraction pad.
    Checks that every plan stays inside the kernels' fixed widths."""
    _check_spec(spec)
    for name in PLAN_NAMES:
        plan_steps(spec, name)
    fold = spec._fold_np[:FQ_FOLD_ROWS]
    tab = np.concatenate([fold.reshape(-1), spec._pad_np]).astype(np.int32)
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
    """The loaded library, with the field tables uploaded to `device`:
    once per library, device and spec in the process, under the lock, so
    that no provider built later rewrites tables that another provider's
    kernels may be reading."""
    handle = _library(lib, spec)
    key = (id(handle), device.index, id(spec))
    if key in _tables_set:  # the per-launch path: no lock
        return handle
    with _lock:
        if key not in _tables_set:
            tab = fq_tables(spec)
            err = handle.fq_set_tables(tab.ctypes.data, tab.size,
                                       device.index)
            if err:
                raise RuntimeError(
                    f"{lib}: setting the field tables failed: "
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
        FQ_MUL.count(batch)
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
        G1_ADD.count(batch)
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
        G1_DBL.count(batch)
    return outs


# -- the pairing kernels (csrc/pairing.cu) ------------------------------------

_programs: Dict[Tuple[str, int, torch.device], Tuple] = {}
_programs_lock = threading.Lock()


def tower_smem_bytes(nregs: int) -> int:
    """Dynamic shared memory of a pairing-kernel launch (csrc/pairing.cu
    tower_prepare): the lane groups' product scratch, then `nregs`
    registers of one Fq element each."""
    _, W = group_layout(TOWER_GROUP)
    lane_ints = 3 * W  # FqGroup::LANE_INTS: W of b, then 2W of a
    g = TOWER_GROUP
    stride = lane_ints + (3 * g - lane_ints % (2 * g)) % (2 * g)
    return 4 * (TOWER_THREADS // g * stride + nregs * W)


def _program(name: str, spec, device: torch.device):
    """The named pairing kernel's program table, its constants and its
    register count, on `device` (made and uploaded once)."""
    key = (name, id(spec), device)
    got = _programs.get(key)
    if got is not None:
        return got
    with _programs_lock:  # many providers' threads: record it once
        got = _programs.get(key)
        if got is None:
            from .tower_program import VERSION, program  # imports the tower
            prog = program(name, spec, TOWER_THREADS // 32)
            if int(prog.words[0]) != VERSION:
                raise RuntimeError(f"{name}: program version mismatch")
            consts = prog.consts if len(prog.consts) else np.zeros(
                (1, spec.n), np.int32)
            got = (torch.as_tensor(prog.words, device=device),
                   torch.as_tensor(consts, device=device), prog.nregs)
            _programs[key] = got
    return got


def _check_tower(name: str, spec, operands, batch: int) -> None:
    """Validate pairing-kernel operands: (tensor, Fq elements per lane)
    pairs, int32, contiguous, one CUDA device, `batch` lanes."""
    dev = operands[0][0].device
    for t, k in operands:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{name}: operands must be CUDA tensors on one "
                             f"device, got {t.device}")
        if t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous int32")
        if t.shape[0] != batch or t.numel() != batch * k * spec.n:
            raise ValueError(f"{name}: operand of shape {tuple(t.shape)} is "
                             f"not ({batch}, {k} x {spec.n}) limbs")


def _tower_launch(name: str, kernel: Kernel, spec, ins, batch: int,
                  extra=(), program: str = None) -> torch.Tensor:
    _check_spec(spec)
    dev = ins[0].device
    handle = _prepare("pairing", spec, dev)
    words, consts, nregs = _program(program or name, spec, dev)
    out = torch.empty((batch, 2, 3, 2, spec.n), dtype=torch.int32,
                      device=dev)
    if batch:
        stream = torch.cuda.current_stream(dev).cuda_stream
        launch = getattr(handle, f"{name}_launch")
        _raise_if(handle, name, launch(
            out.data_ptr(), *(t.data_ptr() for t in ins),
            *(t.data_ptr() for t in extra), words.data_ptr(),
            consts.data_ptr(), nregs, batch, dev.index, stream))
        kernel.count(batch)
    return out


def miller_product(spec, px, py, qx, qy, skip) -> torch.Tensor:
    """Per-pair Miller loops on the card (csrc/pairing.cu): px, py (P, n);
    qx, qy (P, 2, n) int32; skip (P,) bool → (P, 2, 3, 2, n), the
    conjugated Miller value, Fq12 one where skip; bit-identical to
    pairing.miller_loop + FQ12.where(skip, one, f)."""
    pairs = px.shape[0]
    _check_tower("miller_product", spec,
                 [(px, 1), (py, 1), (qx, 2), (qy, 2)], pairs)
    if skip.dtype != torch.bool or skip.shape != (pairs,) or \
            skip.device != px.device or not skip.is_contiguous():
        raise ValueError("miller_product: skip must be a contiguous "
                         f"({pairs},) bool tensor on {px.device}")
    return _tower_launch("miller_product", MILLER_PRODUCT, spec,
                         (px, py, qx, qy), pairs, extra=(skip,))


def fq12_mul(spec, x, y) -> torch.Tensor:
    """Batched Fq12 product on the card: x, y (B, 2, 3, 2, n) int32 →
    (B, 2, 3, 2, n), bit-identical to FQ12.mul."""
    batch = x.shape[0]
    _check_tower("fq12_mul", spec, [(x, 12), (y, 12)], batch)
    return _tower_launch("fq12_mul", FQ12_MUL, spec, (x, y), batch)


def final_exp(spec, f, program: str = "final_exp") -> torch.Tensor:
    """f^(3(p¹²−1)/r) on the card: (B, 2, 3, 2, n) int32 → the same
    shape, bit-identical to FQ12.final_exponentiation.  `program` may
    name another 12-in, 12-out program of ops/tower_program.py for the
    same kernel ("fq_inv": the measuring chain)."""
    batch = f.shape[0]
    _check_tower("final_exp", spec, [(f, 12)], batch)
    return _tower_launch("final_exp", FINAL_EXP, spec, (f,), batch,
                         program=program)


#: tower_probe modes, in the order of csrc/pairing.cu's tower_probe_kernel.
PROBE_MODES = ("mul", "add", "barrier")


def tower_probe(spec, x, y, mode: str, k: int, threads: int) -> torch.Tensor:
    """The pairing kernels' field-core measuring kernel (csrc/pairing.cu
    tower_probe_kernel), no program table: on one block of `threads`
    threads, every lane group runs k dependent ops of one lane ("mul":
    x <- x*y, "add": x <- x + y), or the block runs k barriers
    ("barrier").  x, y (1, n) int32 on the card; returns the chain's
    result (1, n).  A measuring tool: no main path launches it, so it
    keeps no launch count."""
    _check("tower_probe", (x, y), spec.n)
    _check_spec(spec)
    handle = _prepare("pairing", spec, x.device)
    out = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    _raise_if(handle, "tower_probe", handle.tower_probe_launch(
        out.data_ptr(), x.data_ptr(), y.data_ptr(), PROBE_MODES.index(mode),
        k, threads, x.device.index, stream))
    return out
