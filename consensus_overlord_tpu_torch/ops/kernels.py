"""Build, load and launch the port's hand-written CUDA kernels.

Each source under consensus_overlord_tpu_torch/csrc/ is one shared
library with a plain C interface, compiled by ``nvcc`` for ``sm_90a``
into this host's build directory (compile_cache.build_dir():
_build/host-<fingerprint>/, a namespace per host and toolchain, bounded
in size) at first use and loaded with ctypes, once for each field it
serves (``SPEC_LIBS``: BLS12-381's Fq, and the 26-limb fields of
Ed25519, secp256k1 and SM2).  The field's limb count, table size and
reduction plans reach the kernels at build time: a header generated
from ``FieldSpec._plan`` (``plan_header``) is written into the field's
own directory there, <build dir>/<field name>/, and included by the
sources, so every plan step unrolls over its live
positions only; g2_point also includes a header generated for it alone
(``lib_header``: the word programs of ops/g2_words.py).  The library's
file name carries a hash of its sources, those headers and the flags,
so an edited source or a changed plan is never served by a stale
build.  Nothing falls back: a missing ``nvcc``,
a failed build or a refused launch raises.

Each kernel, built for one field, keeps a launch counter
(``Kernel.launches``) that its wrapper increments once per launch and
nowhere else, so a run can show that the main path went through the
kernel, and a histogram of the lanes per launch (``Kernel.sizes``);
both are updated under a lock, since a fleet of providers launches from
many threads.  The field tables are uploaded
once per device per process, under the module's lock.

The wrappers take the JAX package's limb layouts — (B, n) for the field
and point kernels, (B, 2, n) for the G2 point kernels, the tower's
(B, 2, n), (B, 2, 3, 2, n) for the pairing kernels — int32, contiguous, on one CUDA device; they allocate outputs
with ``torch.empty`` and launch on ``torch.cuda.current_stream()``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from .. import compile_cache

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
PLAN_HEADER = "fq_plans.h"

# -Xptxas -v: ptxas reports each kernel's registers and spills; the
# report is kept beside the library (build_log).
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

#: Limb width the kernels take (FQ_BITS in csrc/fq_field.cuh), and the
#: most limbs: the lane groups' registers are sized and measured up to
#: BLS12-381's 39.
FQ_BITS = 10
FQ_MAX_N = 39
#: Reduction plans every field's header carries, in the order of the
#: generated FQ_PLAN_* enum (their input bounds: plan_bounds); a field
#: that g1_point.cu is built for adds its 3b plan (plan_names).
PLAN_NAMES = ("mul", "add2", "sub", "small2", "small3", "small8", "small12",
              "neg")
#: 3·b of the a = 0 curve csrc/g1_point.cu is built for, by field name:
#: BLS12-381's G1 (b = 4) and secp256k1 (b = 7).
G1_B3 = {"bls12381_fq": 12, "secp256k1_fq": 21}
#: The libraries built for each field, by field name.
SPEC_LIBS = {
    "bls12381_fq": ("fq_mul", "g1_point", "g2_point", "pairing"),
    "F_ed25519": ("fq_mul", "ed_point"),
    "secp256k1_fq": ("fq_mul", "g1_point"),
    "sm2_fq": ("fq_mul", "wp_point"),
}


def fold_rows(spec) -> int:
    """Fold rows in the kernels' table (FQ_FOLD_ROWS in fq_field.cuh):
    every row FieldSpec keeps, n + 8."""
    return spec.n + 8


def max_width(spec) -> int:
    """The widest accumulator a plan may reach (FQ_MAXW in
    fq_field.cuh): the product's 2n − 1 positions and three carries."""
    return 2 * spec.n + 2

#: Threads per lane ("lane group") of each kernel on the lane-group
#: core, fixed at build time (MUL_G in csrc/fq_mul.cu, ADD_G and DBL_G in
#: csrc/g1_point.cu, TOWER_G in csrc/pairing.cu, ED_ADD_G and ED_LADDER_G
#: in csrc/ed_point.cu, WP_G in csrc/wp_point.cu).  The G2 kernels
#: (csrc/g2_point.cu) run on the word core instead: G2_ADD_WARPS and
#: G2_DBL_WARPS warps a block of 32 lanes, which nothing here mirrors.
FQ_MUL_GROUP = 8
G1_ADD_GROUP = 16
G1_DBL_GROUP = 16
TOWER_GROUP = 16
ED_ADD_GROUP = 8
ED_LADDER_GROUP = 16
WP_GROUP = 16
#: Threads of a pairing kernel's block (TOWER_THREADS in csrc/pairing.cu):
#: its programs are built for TOWER_THREADS // 32 warps.
TOWER_THREADS = 512
GROUP_SIZES = tuple(sorted({FQ_MUL_GROUP, G1_ADD_GROUP, G1_DBL_GROUP,
                            TOWER_GROUP, ED_ADD_GROUP, ED_LADDER_GROUP,
                            WP_GROUP}))


class Kernel:
    """One hand-written kernel: where it lives, what TPU kernel it
    replaces, how many times its wrapper launched it, and how many lanes
    each launch carried."""

    def __init__(self, name: str, source: str, replaces: str,
                 spec: str = "bls12381_fq"):
        self.name = name
        self.spec = spec  # the name of the field it is built for
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
PAIRING_KERNELS = (MILLER_PRODUCT, FQ12_MUL, FINAL_EXP)
# final_exp_kernel running the fq_inv12 program: FieldSpec.inv on the
# card, which the JAX package runs inside its XLA jits (to_affine, the QC
# pubkey sum), 489 products on the field kernel.
FQ_INV = Kernel(
    "fq_inv", "consensus_overlord_tpu_torch/csrc/pairing.cu",
    "consensus_overlord_tpu/ops/field.py:340")
# BLS12-381's G2 group law (csrc/g2_point.cu) replaces CurveOps.add and
# CurveOps.dbl over Fq2 inside the JAX package's XLA jits
# (crypto/tpu_provider.py verify_round_fn, _g2_sum_rows, _g2_validate,
# _build_g2_tables), which have no Pallas twin.
G2_ADD = Kernel(
    "g2_add", "consensus_overlord_tpu_torch/csrc/g2_point.cu",
    "consensus_overlord_tpu/ops/curve.py:78")
G2_DBL = Kernel(
    "g2_dbl", "consensus_overlord_tpu_torch/csrc/g2_point.cu",
    "consensus_overlord_tpu/ops/curve.py:104")
BLS_KERNELS = ((FQ_MUL, G1_ADD, G1_DBL, G2_ADD, G2_DBL) + PAIRING_KERNELS
               + (FQ_INV,))
# The kernels of the Ed25519, secp256k1 and SM2 paths.  fq_mul serves
# each field's decompression, x tests and predicates; the secp256k1 add
# and doubling are g1_point.cu's bodies built with 3b = 21; ed_add and
# wp_add_general replace the group laws inside the JAX package's XLA
# jits (crypto/ed25519_tpu.py _ed_msm_is_identity, crypto/ecdsa_tpu.py
# _verify_kernel), which have no Pallas twin.
_FIELD = "consensus_overlord_tpu/ops/pallas_field.py:41"
FQ_MUL_ED25519 = Kernel(
    "fq_mul_ed25519", "consensus_overlord_tpu_torch/csrc/fq_mul.cu", _FIELD,
    "F_ed25519")
FQ_MUL_SECP256K1 = Kernel(
    "fq_mul_secp256k1", "consensus_overlord_tpu_torch/csrc/fq_mul.cu",
    _FIELD, "secp256k1_fq")
FQ_MUL_SM2 = Kernel(
    "fq_mul_sm2", "consensus_overlord_tpu_torch/csrc/fq_mul.cu", _FIELD,
    "sm2_fq")
ED_ADD = Kernel(
    "ed_add", "consensus_overlord_tpu_torch/csrc/ed_point.cu",
    "consensus_overlord_tpu/crypto/ed25519_tpu.py:60", "F_ed25519")
SECP_ADD = Kernel(
    "secp_add", "consensus_overlord_tpu_torch/csrc/g1_point.cu",
    "consensus_overlord_tpu/ops/pallas_point.py:150", "secp256k1_fq")
SECP_DBL = Kernel(
    "secp_dbl", "consensus_overlord_tpu_torch/csrc/g1_point.cu",
    "consensus_overlord_tpu/ops/pallas_point.py:150", "secp256k1_fq")
WP_ADD_GENERAL = Kernel(
    "wp_add_general", "consensus_overlord_tpu_torch/csrc/wp_point.cu",
    "consensus_overlord_tpu/crypto/ecdsa_tpu.py:224", "sm2_fq")
# The scalar-multiplication ladders in one launch each, on the bodies of
# ed_add and wp_add_general: Ed25519's scalar_mul_bits (the scan inside
# _ed_msm_is_identity) and SM2's dual_scalar_mul_bits (the scan inside
# _verify_kernel("sm2")).
ED_LADDER = Kernel(
    "ed_ladder", "consensus_overlord_tpu_torch/csrc/ed_point.cu",
    "consensus_overlord_tpu/crypto/ed25519_tpu.py:60", "F_ed25519")
WP_DUAL_LADDER = Kernel(
    "wp_dual_ladder", "consensus_overlord_tpu_torch/csrc/wp_point.cu",
    "consensus_overlord_tpu/crypto/ecdsa_tpu.py:224", "sm2_fq")
CURVE_KERNELS = (FQ_MUL_ED25519, ED_ADD, ED_LADDER, FQ_MUL_SECP256K1,
                 SECP_ADD, SECP_DBL, FQ_MUL_SM2, WP_ADD_GENERAL,
                 WP_DUAL_LADDER)
KERNELS = BLS_KERNELS + CURVE_KERNELS
_FQ_MUL_OF = {k.spec: k for k in (FQ_MUL, FQ_MUL_ED25519, FQ_MUL_SECP256K1,
                                  FQ_MUL_SM2)}
_G1_OF = {"bls12381_fq": (G1_ADD, G1_DBL),
          "secp256k1_fq": (SECP_ADD, SECP_DBL)}
_G2_OF = {"bls12381_fq": (G2_ADD, G2_DBL)}


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
    """Per-position input bounds of the named reduction plan
    ("small<k>": a product by the constant k)."""
    n, L = spec.n, spec.loose_max
    if name == "mul":
        return spec._conv_bounds()
    if name == "sub":
        return [L + int(spec._pad_np.max())] * n
    if name == "neg":
        return [int(spec._pad_np.max())] * n
    k = 2 if name == "add2" else int(name[len("small"):])
    return [k * L] * n


def plan_names(spec) -> Tuple[str, ...]:
    """The plans of the spec's header: PLAN_NAMES, and the 3b plan of the
    a = 0 curve g1_point.cu is built for over it (G1_B3)."""
    b3 = G1_B3.get(spec.name)
    if b3 is None or f"small{b3}" in PLAN_NAMES:
        return PLAN_NAMES
    return PLAN_NAMES + (f"small{b3}",)


def plan_steps(spec, name: str) -> List[Tuple[str, int, int, int]]:
    """The named plan as (kind, arg, width before, width after) steps,
    checked against the kernels' widths for the spec."""
    n = spec.n
    bounds = plan_bounds(spec, name)
    width = len(bounds)
    out = []
    for kind, arg in spec._plan(list(bounds)):
        w_in = width
        if kind == "fold":
            if arg > fold_rows(spec) or w_in != n + arg:
                raise ValueError(f"plan {name} folds {arg} rows")
            width = n
        else:
            width += arg
        if width > max_width(spec):
            raise ValueError(f"plan {name} reaches width {width}")
        out.append((kind, arg, w_in, width))
    if width != n:
        raise ValueError(f"plan {name} ends at width {width}")
    return out


def _check_spec(spec) -> None:
    if spec.b != FQ_BITS or not 2 <= spec.n <= FQ_MAX_N:
        raise ValueError(f"{spec.name}: the CUDA field kernels are built "
                         f"for at most {FQ_MAX_N} limbs of {FQ_BITS} bits")


def plan_header(spec) -> str:
    """The C header the kernels include: the limb count, every plan of
    plan_names(spec) as an X-macro of its steps, FQ_STEP(kind, arg, width
    before, width after), the most fold rows any step uses, and the 3b
    of the spec's a = 0 curve where g1_point.cu is built for it.
    Deterministic in the spec."""
    _check_spec(spec)
    names = plan_names(spec)
    plans = {name: plan_steps(spec, name) for name in names}
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
    lines += [f"  FQ_PLAN_{name.upper()}," for name in names]
    lines += ["  FQ_NUM_PLANS", "};"]
    b3 = G1_B3.get(spec.name)
    if b3 is not None:
        lines += [f"#define FQ_GEN_B3 {b3}",
                  f"#define FQ_GEN_B3_PLAN FQ_PLAN_SMALL{b3}"]
    for name in names:
        lines.append(f"#define FQ_PLAN_{name.upper()}_STEPS(FQ_STEP) \\")
        body = [f"  FQ_STEP({k.upper()}, {a}, {wi}, {wo})"
                for k, a, wi, wo in plans[name]]
        lines += [ln + " \\" for ln in body[:-1]] + [body[-1]]
    lines.append("#define FQ_PLANS(X) " + " ".join(
        f"X({name.upper()})" for name in names))
    return "\n".join(lines) + "\n"


def group_layout(g: int, n: int) -> Tuple[int, int]:
    """(L, W) of a lane group of g threads for n-limb elements: each
    thread owns L slots of the lane's element (positions tL..tL+L−1 of
    the W = gL low positions) and L of the high part (W+tL..W+tL+L−1).
    Mirrors fq_group.cuh."""
    if g not in GROUP_SIZES:
        raise ValueError(f"lane groups of {g} threads are not built")
    L = -(-(n + 1) // g)
    return L, g * L


def group_terms(g: int, n: int) -> List[List[Tuple[int, int, int]]]:
    """The product terms a_i·b_j each thread of a g-thread lane group adds
    and the column it adds each to, (i, j, column), in the order and by
    the rule of csrc/fq_group.cuh fq_conv_rotated; zero terms left
    out."""
    L, W = group_layout(g, n)
    out = []
    for t in range(g):
        terms = []
        for s in range(L):
            c = t * L + s
            for k in range(W):
                i, j = (t * L + k) % W, (s - k) % W
                q, u = divmod(k, L)
                low = u <= s if q == 0 else q >= g - t
                if i < n and j < n:
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
    "g2_point": ("g2_point.cu", {
        "g2_add_launch": [_VP] * 9 + [_I, _I, _VP],
        "g2_dbl_launch": [_VP] * 6 + [_I, _I, _VP],
        "g2_point_occupancy": [_I, _VP, _VP],
    }),
    "pairing": ("pairing.cu", {
        "miller_product_launch": [_VP] * 8 + [_I, _I, _I, _VP],
        "fq12_mul_launch": [_VP] * 5 + [_I, _I, _I, _VP],
        "final_exp_launch": [_VP] * 4 + [_I, _I, _I, _VP],
        "tower_probe_launch": [_VP] * 3 + [_I, _I, _I, _I, _VP],
    }),
    "ed_point": ("ed_point.cu", {
        "ed_add_launch": [_VP] * 13 + [_I, _I, _VP],
        "ed_ladder_launch": [_VP] * 11 + [_I, _I, _I, _VP],
        "ed_point_occupancy": [_I, _VP, _VP],
    }),
    "wp_point": ("wp_point.cu", {
        "wp_add_general_launch": [_VP] * 10 + [_I, _I, _VP],
        "wp_dual_ladder_launch": [_VP] * 12 + [_I, _I, _I, _VP],
        "wp_point_occupancy": [_I, _VP, _VP],
    }),
}
_HEADERS = ("fq_field.cuh", "fq_group.cuh")
#: Headers of one library alone, hashed into its build path only: the
#: sources it includes beyond _HEADERS, and the name of the header
#: generated for it (lib_header).
_LIB_HEADERS = {"g2_point": (("fp381_words.cuh",), "g2_words.h")}

_lock = threading.Lock()
_loaded: Dict[Tuple[str, int], ctypes.CDLL] = {}  # (lib, id(spec))
_tables_set: set = set()


def _default_spec():
    from .field import BLS12_381_FQ  # field.py imports this module
    return BLS12_381_FQ


def all_specs() -> Tuple:
    """Every field the kernels are built for, BLS12-381's first."""
    from .field import BLS12_381_FQ, ED25519_FQ, SECP256K1_FQ, SM2_FQ
    return (BLS12_381_FQ, ED25519_FQ, SECP256K1_FQ, SM2_FQ)


def spec_libs(spec) -> Tuple[str, ...]:
    """The libraries built for the spec (fq_mul alone for a field no
    curve kernel is built for)."""
    return SPEC_LIBS.get(spec.name, ("fq_mul",))


def header_dir(spec) -> str:
    """The spec's own directory in the build directory, which holds its
    plan header: each spec's sources are compiled with -I there, so two
    specs never share, or race on, one header file."""
    return os.path.join(compile_cache.build_dir(), spec.name)


def _nvcc() -> str:
    path = compile_cache.nvcc_path()
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels of "
                           "consensus_overlord_tpu_torch cannot be built")
    return path


def lib_header(lib: str):
    """(file name, text) of the header generated for the library alone,
    or None: g2_point's word constants and programs (ops/g2_words.py
    header_text)."""
    if lib not in _LIB_HEADERS:
        return None
    from . import g2_words  # imports field.py, which imports this module
    return _LIB_HEADERS[lib][1], g2_words.header_text()


def _so_path(lib: str, header: str) -> str:
    """The library's build path, named by the hash of the nvcc flags, its
    sources (_HEADERS and its own), the generated plan header's text
    (which names the spec) and the text of its own generated header."""
    src, _ = _LIBS[lib]
    own, _ = _LIB_HEADERS.get(lib, ((), None))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in (src,) + _HEADERS + own:
        with open(os.path.join(CSRC, name), "rb") as f:
            h.update(f.read())
    h.update(header.encode())
    extra = lib_header(lib)
    if extra is not None:
        h.update(extra[1].encode())
    return os.path.join(compile_cache.build_dir(),
                        f"{lib}_{h.hexdigest()[:16]}.so")


def _write_header(spec, header: str, name: str = PLAN_HEADER) -> None:
    path = os.path.join(header_dir(spec), name)
    if os.path.exists(path):
        with open(path) as f:
            if f.read() == header:
                return
    os.makedirs(header_dir(spec), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "w") as f:
        f.write(header)
    os.replace(tmp, path)


def _start_build(lib: str, spec, header: str):
    so = _so_path(lib, header)
    try:
        compile_cache.touch(so)  # held now, so no eviction takes it
    except FileNotFoundError:
        built = False
    else:
        built = True
    compile_cache.record(hit=built)
    if built:
        return None
    _write_header(spec, header)
    extra = lib_header(lib)
    if extra is not None:
        _write_header(spec, extra[1], extra[0])
    tmp = f"{so}.{os.getpid()}.tmp"
    cmd = [_nvcc()] + NVCC_FLAGS + ["-I", header_dir(spec), "-o", tmp,
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
    compile_cache.touch(so)


def build_all(specs=None) -> float:
    """Compile every library of every spec (default: all_specs()) that is
    not built yet, one nvcc per (source, spec), all started together.
    Returns the wall seconds spent building."""
    specs = all_specs() if specs is None else specs
    t0 = time.perf_counter()
    with _lock:
        jobs = []
        for spec in specs:
            header = plan_header(spec)
            jobs += [(lib, _start_build(lib, spec, header))
                     for lib in spec_libs(spec)]
        built = [(lib, job) for lib, job in jobs if job is not None]
        for lib, job in built:
            _finish_build(lib, job)
        if built:
            compile_cache.evict()
    return time.perf_counter() - t0


def load_all(device: torch.device, spec=None) -> None:
    """Build the spec's libraries that are not built yet (in parallel),
    load each and upload the spec's field tables to `device`: what a
    provider on a CUDA device does first, so that a failed build or load
    raises there."""
    spec = spec or _default_spec()
    libs = spec_libs(spec)
    if any((lib, id(spec)) not in _loaded for lib in libs):
        build_all((spec,))
    for lib in libs:
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
        if lib not in spec_libs(spec):
            raise ValueError(f"{lib} is not built for {spec.name}")
        header = plan_header(spec)
        so = _so_path(lib, header)
        job = _start_build(lib, spec, header)
        if job is not None:
            _finish_build(lib, job)
            compile_cache.evict()
        handle = ctypes.CDLL(so)
        compile_cache.touch(so)
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
        if handle.fq_table_ints() != table_ints(spec):
            raise RuntimeError(f"{lib}: table layout differs from "
                               "ops/kernels.py")
        _loaded[key] = handle
        return handle


# -- the field tables the kernels read -----------------------------------------

def table_ints(spec) -> int:
    return fold_rows(spec) * spec.n + spec.n


def fq_tables(spec) -> np.ndarray:
    """The int32 table the kernels read from device memory: the fold rows
    (row k = 2**(b·(n+k)) mod p in limbs), then the subtraction pad.
    Checks that every plan stays inside the kernels' widths."""
    _check_spec(spec)
    for name in plan_names(spec):
        plan_steps(spec, name)
    fold = spec._fold_np[:fold_rows(spec)]
    tab = np.concatenate([fold.reshape(-1), spec._pad_np]).astype(np.int32)
    assert tab.size == table_ints(spec)
    return tab


def _check(name: str, tensors: Sequence[torch.Tensor], n: int,
           comps: int = 1) -> int:
    """Validate kernel operands, each (B, n), or (B, comps, n) for an
    extension field's elements; returns the batch (lane) count."""
    t0 = tensors[0]
    if t0.device.type != "cuda":
        raise ValueError(f"{name}: operands must be CUDA tensors, got "
                         f"{t0.device}")
    lane = (n,) if comps == 1 else (comps, n)
    for t in tensors:
        if t.device != t0.device:
            raise ValueError(f"{name}: operands on different devices")
        if t.dtype != torch.int32:
            raise ValueError(f"{name}: operands must be int32, got {t.dtype}")
        if tuple(t.shape[1:]) != lane or t.shape != t0.shape:
            raise ValueError(f"{name}: operands must share one "
                             f"(B, {', '.join(map(str, lane))}) shape, got "
                             f"{tuple(t.shape)}")
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


def _kernel_of(table: Dict, spec, what: str):
    got = table.get(spec.name)
    if got is None:
        raise ValueError(f"{what} is not built for {spec.name}")
    return got


def fq_mul(spec, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Batched loose-limb Fq multiply on the card (csrc/fq_mul.cu, built
    for the spec): x, y (B, n) int32 → (B, n) int32, bit-identical to
    spec.mul_plain."""
    kernel = _kernel_of(_FQ_MUL_OF, spec, "fq_mul")
    batch = _check(kernel.name, (x, y), spec.n)
    handle = _prepare("fq_mul", spec, x.device)
    out = torch.empty_like(x)
    if batch:
        stream = torch.cuda.current_stream(x.device).cuda_stream
        _raise_if(handle, kernel.name, handle.fq_mul_launch(
            out.data_ptr(), x.data_ptr(), y.data_ptr(), batch,
            x.device.index, stream))
        kernel.count(batch)
    return out


def _check_like(name: str, what: str, tensors: Sequence[torch.Tensor],
                shape: Tuple[int, ...], dev: torch.device) -> None:
    """Each tensor must be contiguous int32 of `shape` on `dev`."""
    for t in tensors:
        if t.device != dev or t.dtype != torch.int32 or \
                tuple(t.shape) != tuple(shape) or not t.is_contiguous():
            raise ValueError(f"{name}: {what} must be contiguous "
                             f"{tuple(shape)} int32 on {dev}")


def _point_launch(kernel: Kernel, lib: str, fn: str, spec, ins,
                  nout: int, consts=(), comps: int = 1
                  ) -> Tuple[torch.Tensor, ...]:
    """Launch a point kernel over (B, n) coordinates `ins` ((B, comps, n)
    over an extension field; then the constant rows `consts`, each
    (1, n)) into `nout` new coordinates."""
    batch = _check(kernel.name, ins, spec.n, comps)
    dev = ins[0].device
    _check_like(kernel.name, "constant rows", consts, (1, spec.n), dev)
    handle = _prepare(lib, spec, dev)
    outs = tuple(torch.empty_like(ins[0]) for _ in range(nout))
    if batch:
        stream = torch.cuda.current_stream(dev).cuda_stream
        _raise_if(handle, kernel.name, getattr(handle, fn)(
            *(t.data_ptr() for t in outs + tuple(ins) + tuple(consts)),
            batch, dev.index, stream))
        kernel.count(batch)
    return outs


def g1_add(spec, p: Tuple[torch.Tensor, ...],
           q: Tuple[torch.Tensor, ...]) -> Tuple[torch.Tensor, ...]:
    """Fused RCB complete addition of an a = 0 curve (csrc/g1_point.cu,
    built for BLS12-381's G1 or secp256k1): projective (x1,y1,z1) +
    (x2,y2,z2) → (x3,y3,z3), each (B, n) int32."""
    kernel = _kernel_of(_G1_OF, spec, "g1_add")[0]
    return _point_launch(kernel, "g1_point", "g1_add_launch", spec,
                         tuple(p) + tuple(q), 3)


def g1_dbl(spec, p: Tuple[torch.Tensor, ...]) -> Tuple[torch.Tensor, ...]:
    """Fused a=0 doubling (csrc/g1_point.cu, built for BLS12-381's G1 or
    secp256k1)."""
    kernel = _kernel_of(_G1_OF, spec, "g1_dbl")[1]
    return _point_launch(kernel, "g1_point", "g1_dbl_launch", spec,
                         tuple(p), 3)


def g2_add(spec, p: Tuple[torch.Tensor, ...],
           q: Tuple[torch.Tensor, ...]) -> Tuple[torch.Tensor, ...]:
    """Fused RCB complete addition on BLS12-381's G2 (csrc/g2_point.cu):
    projective (x1,y1,z1) + (x2,y2,z2) → (x3,y3,z3) over Fq2, each
    (B, 2, n) int32 of loose limbs.  Each output coordinate is the same
    field element as bls12381_groups.G2.add_plain's, as a plain 10-bit
    split of a value below 2p: equal after FieldSpec.strict, not limb
    for limb."""
    kernel = _kernel_of(_G2_OF, spec, "g2_add")[0]
    return _point_launch(kernel, "g2_point", "g2_add_launch", spec,
                         tuple(p) + tuple(q), 3, comps=2)


def g2_dbl(spec, p: Tuple[torch.Tensor, ...]) -> Tuple[torch.Tensor, ...]:
    """Fused a=0 doubling on BLS12-381's G2 (csrc/g2_point.cu), each
    coordinate (B, 2, n) int32.  The same field elements as
    bls12381_groups.G2.dbl_plain's, in g2_add's limb form."""
    kernel = _kernel_of(_G2_OF, spec, "g2_dbl")[1]
    return _point_launch(kernel, "g2_point", "g2_dbl_launch", spec,
                         tuple(p), 3, comps=2)


def ed_add(spec, p: Tuple[torch.Tensor, ...], q: Tuple[torch.Tensor, ...],
           d2: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Unified twisted-Edwards addition, a = −1 (csrc/ed_point.cu):
    extended (x1,y1,z1,t1) + (x2,y2,z2,t2) → (x3,y3,z3,t3), each (B, n)
    int32; d2 is the (1, n) limb row of 2d.  Bit-identical to the plain
    ops/edwards.py add_plain."""
    return _point_launch(ED_ADD, "ed_point", "ed_add_launch", spec,
                         tuple(p) + tuple(q), 4, consts=(d2,))


def wp_add_general(spec, p: Tuple[torch.Tensor, ...],
                   q: Tuple[torch.Tensor, ...],
                   b3: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Complete projective addition for a = −3 (csrc/wp_point.cu, RCB
    2016 Algorithm 1): (x1,y1,z1) + (x2,y2,z2) → (x3,y3,z3), each (B, n)
    int32; b3 is the (1, n) limb row of 3b.  Bit-identical to the plain
    ops/weierstrass.py GeneralCurveOps add."""
    return _point_launch(WP_ADD_GENERAL, "wp_point",
                         "wp_add_general_launch", spec, tuple(p) + tuple(q),
                         3, consts=(b3,))


def packed_words(count: int, per_word: int) -> int:
    """int32 words a lane's packed ladder input takes: `count` bits (32 a
    word) or window digits (4 a word)."""
    return -(-count // per_word)


def ed_ladder(spec, p: Tuple[torch.Tensor, ...], bits: torch.Tensor,
              nbits: int, d2: torch.Tensor,
              one: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """p_i · k_i for every lane in one launch (csrc/ed_point.cu
    ed_ladder_kernel): p extended (x, y, z, t), each (B, n) int32; bits
    (B, packed_words(nbits, 32)) int32, k_i's nbits MSB-first bits, bit i
    of word i // 32 at position 31 − i % 32 (ops/edwards.py pack_bits);
    d2 and one the (1, n) limb rows of 2d and 1.  Bit-identical to the
    plain ops/edwards.py ladder_plain."""
    batch = _check(ED_LADDER.name, p, spec.n)
    dev = p[0].device
    _check_like(ED_LADDER.name, "constant rows", (d2, one), (1, spec.n), dev)
    _check_like(ED_LADDER.name, "packed bits", (bits,),
                (batch, packed_words(nbits, 32)), dev)
    handle = _prepare("ed_point", spec, dev)
    outs = tuple(torch.empty_like(p[0]) for _ in range(4))
    if batch:
        stream = torch.cuda.current_stream(dev).cuda_stream
        _raise_if(handle, ED_LADDER.name, handle.ed_ladder_launch(
            *(t.data_ptr() for t in outs + tuple(p) + (bits, d2, one)),
            batch, nbits, dev.index, stream))
        ED_LADDER.count(batch)
    return outs


#: The window of wp_dual_ladder's digits, and the rows of the tables it
#: reads (WP_TABLE in csrc/wp_point.cu).
LADDER_WINDOW = 4
LADDER_TABLE = 1 << LADDER_WINDOW


def wp_dual_ladder(spec, tq: Tuple[torch.Tensor, ...],
                   tg: Tuple[torch.Tensor, ...], digits: torch.Tensor,
                   windows: int, b3: torch.Tensor,
                   one: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """u1·G + u2·Q for every lane in one launch (csrc/wp_point.cu
    wp_dual_ladder_kernel, window 4): tq the lanes' Q tables, each
    coordinate (16, B, n) int32; tg G's table, each (16, n); digits
    (B, packed_words(windows, 4)) int32, window j's byte (G's digit
    << 4 | Q's digit) at bits 8·(j % 4) of word j // 4
    (ops/weierstrass.py pack_digits); b3 and one the (1, n) rows of 3b
    and 1.  Bit-identical to the plain ops/weierstrass.py
    dual_ladder_plain."""
    name = WP_DUAL_LADDER.name
    dev = tq[0].device
    if dev.type != "cuda":
        raise ValueError(f"{name}: operands must be CUDA tensors, got {dev}")
    batch = tq[0].shape[1] if tq[0].dim() == 3 else 0
    _check_like(name, "Q tables", tq, (LADDER_TABLE, batch, spec.n), dev)
    _check_like(name, "G tables", tg, (LADDER_TABLE, spec.n), dev)
    _check_like(name, "constant rows", (b3, one), (1, spec.n), dev)
    _check_like(name, "packed digits", (digits,),
                (batch, packed_words(windows, 4)), dev)
    handle = _prepare("wp_point", spec, dev)
    outs = tuple(torch.empty((batch, spec.n), dtype=torch.int32, device=dev)
                 for _ in range(3))
    if batch:
        stream = torch.cuda.current_stream(dev).cuda_stream
        _raise_if(handle, name, handle.wp_dual_ladder_launch(
            *(t.data_ptr() for t in outs + tuple(tq) + tuple(tg)
              + (digits, b3, one)), batch, windows, dev.index, stream))
        WP_DUAL_LADDER.count(batch)
    return outs


#: Kernels whose library reports its occupancy: name → (library, the
#: kernel's index in `<library>_occupancy`).
_OCCUPANCY = {"g2_add": ("g2_point", 0), "g2_dbl": ("g2_point", 1),
              "ed_add": ("ed_point", 0), "ed_ladder": ("ed_point", 1),
              "wp_add_general": ("wp_point", 0),
              "wp_dual_ladder": ("wp_point", 1)}


def resident_warps(name: str, spec, device: torch.device) -> int:
    """Warps of the named kernel an SM holds at once (the CUDA occupancy
    calculator on its registers, shared memory and block size): a
    measuring aid, no launch."""
    lib, index = _OCCUPANCY[name]
    if device.index is None:
        device = torch.device(device.type, torch.cuda.current_device())
    handle = _prepare(lib, spec, device)
    threads, blocks = ctypes.c_int(), ctypes.c_int()
    _raise_if(handle, f"{name} occupancy", getattr(
        handle, f"{lib}_occupancy")(index, ctypes.byref(threads),
                                    ctypes.byref(blocks)))
    return blocks.value * threads.value // 32


# -- the pairing kernels (csrc/pairing.cu) ------------------------------------

_programs: Dict[Tuple[str, int, torch.device], Tuple] = {}
_programs_lock = threading.Lock()


def tower_smem_bytes(nregs: int) -> int:
    """Dynamic shared memory of a pairing-kernel launch (csrc/pairing.cu
    tower_prepare): the lane groups' product scratch, then `nregs`
    registers of one Fq element each."""
    _, W = group_layout(TOWER_GROUP, _default_spec().n)
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
    same kernel ("fq_inv": the measuring chain; "fq_inv12": fq_inv's)."""
    batch = f.shape[0]
    _check_tower("final_exp", spec, [(f, 12)], batch)
    return _tower_launch("final_exp", FINAL_EXP, spec, (f,), batch,
                         program=program)


#: Fq elements fq_inv packs into one lane of final_exp_kernel (one Fq12).
FQ_INV_PER_LANE = 12


def has_fq_inv(spec) -> bool:
    """Whether fq_inv serves the spec: the pairing library is built for
    it."""
    return "pairing" in spec_libs(spec)


def fq_inv(spec, x: torch.Tensor) -> torch.Tensor:
    """x^(p−2) of every element of x (..., n) int32 on the card, in one
    launch of final_exp_kernel running the fq_inv12 program
    (ops/tower_program.py): the elements packed twelve to a lane, zeros
    after the last (inv(0) = 0).  Bit-identical to FieldSpec.inv_chain,
    whose products the program records.  Counted as FQ_INV."""
    flat = x.reshape(-1, spec.n)
    count = flat.shape[0]
    lanes = -(-count // FQ_INV_PER_LANE)
    packed = torch.zeros((lanes * FQ_INV_PER_LANE, spec.n),
                         dtype=torch.int32, device=x.device)
    packed[:count] = flat
    f = packed.view(lanes, 2, 3, 2, spec.n)
    _check_tower("fq_inv", spec, [(f, 12)], lanes)
    out = _tower_launch("final_exp", FQ_INV, spec, (f,), lanes,
                        program="fq_inv12")
    return out.view(-1, spec.n)[:count].reshape(x.shape)


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
