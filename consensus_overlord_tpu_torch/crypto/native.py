"""ctypes bridge to the native BLS12-381 pairing backend (csrc/bls381.c).

The repository's C source is compiled on demand with the system C
compiler into this host's build directory (compile_cache.build_dir():
consensus_overlord_tpu_torch/_build/host-<fingerprint>/, git-ignored),
and only there: the shared object
the JAX package builds beside the source is never loaded.  If no compiler
is available, ``available()`` is False and the oracle falls back to its
pure-Python pairing.

Layout conventions (must match csrc/bls381.c):
  Fp          6 x u64 little-endian canonical limbs
  G1 affine   12 u64 (x, y);  all-zero = point at infinity
  G2 affine   24 u64 (x.c0, x.c1, y.c0, y.c1); all-zero = infinity
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import threading
from typing import Iterable, List, Optional, Tuple

from .. import compile_cache

logger = logging.getLogger("consensus_overlord_tpu_torch.native")

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC_PATH = os.path.join(os.path.dirname(_PKG), "csrc", "bls381.c")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_load_failed = False  # memoized: never retry a failed build per process


def _build() -> Optional[str]:
    """Compile csrc/bls381.c into the build directory (named by the
    source's hash, so an edited source never loads a stale object);
    returns the path."""
    if not os.path.exists(_SRC_PATH):
        return None
    with open(_SRC_PATH, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    so_path = os.path.join(compile_cache.build_dir(),
                           f"bls381_{digest}.so")
    try:
        compile_cache.touch(so_path)  # held now, so no eviction takes it
        return so_path
    except FileNotFoundError:
        pass
    # Compile to a temp path and rename into place: concurrent processes
    # sharing a checkout must never dlopen a half-written object.
    tmp_path = f"{so_path}.{os.getpid()}.tmp"
    for cc in ("cc", "gcc", "clang"):
        try:
            subprocess.run(
                [cc, "-O3", "-shared", "-fPIC", "-o", tmp_path, _SRC_PATH],
                check=True, capture_output=True, timeout=120)
            os.replace(tmp_path, so_path)
            compile_cache.touch(so_path)
            compile_cache.evict()
            return so_path
        except (FileNotFoundError, subprocess.CalledProcessError,
                subprocess.TimeoutExpired, OSError) as e:
            logger.debug("native build with %s failed: %s", cc, e)
    try:
        os.unlink(tmp_path)
    except OSError:
        pass
    return None


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _load_failed
    with _lock:
        if _lib is not None:
            return _lib
        if _load_failed:
            return None
        so_path = _build()
        if so_path is None:
            _load_failed = True
            logger.info("native BLS backend unavailable; "
                        "using the pure-Python pairing path")
            return None
        lib = ctypes.CDLL(so_path)
        compile_cache.touch(so_path)
        u64p = ctypes.POINTER(ctypes.c_uint64)
        lib.bls381_multi_pairing_is_one.restype = ctypes.c_int
        lib.bls381_multi_pairing_is_one.argtypes = [u64p, u64p,
                                                    ctypes.c_int32]
        _lib = lib
        return lib


def _fp_limbs(v: int) -> List[int]:
    return [(v >> (64 * i)) & 0xFFFFFFFFFFFFFFFF for i in range(6)]


def _pack_g1(pt) -> List[int]:
    if pt is None:
        return [0] * 12
    x, y = pt
    return _fp_limbs(x) + _fp_limbs(y)


def _pack_g2(pt) -> List[int]:
    if pt is None:
        return [0] * 24
    (x0, x1), (y0, y1) = pt
    return _fp_limbs(x0) + _fp_limbs(x1) + _fp_limbs(y0) + _fp_limbs(y1)


def available() -> bool:
    return _load() is not None


def multi_pairing_is_one(pairs: Iterable[Tuple[object, object]]) -> bool:
    """Native Π e(P_i, Q_i) == 1 over oracle-format affine points
    (ints for G1, int-pairs for G2; None = infinity).  Raises
    RuntimeError if the backend is unavailable."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native BLS backend unavailable")
    g1s: List[int] = []
    g2s: List[int] = []
    k = 0
    for p, q in pairs:
        g1s.extend(_pack_g1(p))
        g2s.extend(_pack_g2(q))
        k += 1
    if k == 0:
        return True
    a1 = (ctypes.c_uint64 * len(g1s))(*g1s)
    a2 = (ctypes.c_uint64 * len(g2s))(*g2s)
    return bool(lib.bls381_multi_pairing_is_one(a1, a2, k))
