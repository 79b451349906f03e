"""The kernel build cache: where the port's compiled libraries live, and
its hit and miss counts.

The port's counterpart of consensus_overlord_tpu/compile_cache.py.
Where the JAX package points XLA's persistent cache at a host-keyed
namespace, the port keeps its own builds there: the CUDA kernels
(ops/kernels.py, one ``.so`` per source and field, with the fields'
generated headers) and the native pairing backend (crypto/native.py).

Why a namespace per host: a built library's name hashes its sources,
headers and flags, but not what built it or what it runs on.  An
object from another nvcc release, another driver or another card (or
host code from another CPU) would load, and may fail at launch or
compute on a different target.  So ``build_dir()`` is
``<root>/host-<fingerprint>``, where the fingerprint digests the
machine type, the CPU's model name and flags, the card's name and
compute capability, nvcc's release line and the NVIDIA driver's
version.  Each input comes from a reader in ``READERS`` (a test can
replace one); an input that is missing (no nvcc, no card) digests as
the fixed word ``none``.  The fingerprint is computed once per
process, at the first build or load, never at import: nvcc runs once.

The root is consensus_overlord_tpu_torch/_build unless
CONSENSUS_TORCH_BUILD_ROOT names another.  A root that cannot be
written raises RuntimeError: the kernels must be built to a file
before they can load, so there is no run without the cache.  The
namespace is bounded (``MAX_BYTES``, the JAX package's 4 GB): a
library is touched when it is built or loaded, and ``evict()`` after
each build removes the objects touched least recently, never one this
process built or loaded and never a ``.tmp`` file another build is
still writing.  The flat objects of the layout before the namespaces
(``*.so`` and ``*.so.log`` at the top of the root) are deleted, but
only at the default root: a root from the environment may be shared.

The hit and miss counts are those of the build lookups
(ops/kernels.py ``_start_build``: a library already built under its
source hash is a hit, one that must be compiled a miss); they are
process-wide, and the ``compile_cache_*`` gauges of obs/metrics.py and
the telemetry samples read them.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
import threading
from typing import Dict, Optional

ENV_ROOT = "CONSENSUS_TORCH_BUILD_ROOT"
DEFAULT_ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "_build")
#: LRU bound on one host namespace (bytes): the JAX package's _MAX_BYTES.
MAX_BYTES = 4 << 30
#: What a missing fingerprint input digests as.
MISSING = "none"

_STATS = {"hits": 0, "misses": 0}
_lock = threading.Lock()
_fingerprint: Optional[str] = None
_pruned: set = set()
#: Objects this process built or loaded: never evicted.
_held: set = set()


def record(hit: bool) -> None:
    """Count one build-cache lookup."""
    with _lock:
        _STATS["hits" if hit else "misses"] += 1


def stats() -> dict:
    """Snapshot of the build-cache hit/miss counts (process-wide)."""
    with _lock:
        return dict(_STATS)


# -- the host fingerprint -------------------------------------------------------

def nvcc_path() -> Optional[str]:
    """The nvcc the kernels build with, or None."""
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    return path if os.path.exists(path) else None


def _read_machine() -> str:
    return platform.machine()


def _read_cpu() -> str:
    """The CPU's model name and sorted feature flags (the host code of
    both builds is compiled for this CPU)."""
    model = flags = ""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if not model and line.startswith("model name"):
                    model = line.split(":", 1)[1].strip()
                elif not flags and line.startswith(("flags", "Features")):
                    flags = " ".join(sorted(line.split(":", 1)[1].split()))
                if model and flags:
                    break
    except OSError:
        return ""
    return f"{model} {flags}".strip()


def _read_gpu() -> str:
    """Card 0's name and compute capability, when CUDA is present."""
    import torch

    if not torch.cuda.is_available():
        return ""
    major, minor = torch.cuda.get_device_capability(0)
    return f"{torch.cuda.get_device_name(0)} sm_{major}{minor}"


def _read_nvcc() -> str:
    """nvcc's `--version` release line."""
    path = nvcc_path()
    if path is None:
        return ""
    try:
        out = subprocess.run([path, "--version"], capture_output=True,
                             text=True, timeout=60).stdout
    except (OSError, subprocess.SubprocessError):
        return ""
    return next((ln.strip() for ln in out.splitlines() if "release" in ln),
                "")


def _read_driver() -> str:
    """The NVIDIA kernel driver's version line where the host exposes
    it, else the CUDA driver's version (libcuda's cuDriverGetVersion)."""
    try:
        with open("/proc/driver/nvidia/version") as f:
            return f.readline().strip()
    except OSError:
        pass
    try:
        libcuda = ctypes.CDLL("libcuda.so.1")
    except OSError:
        return ""
    version = ctypes.c_int(0)
    if libcuda.cuDriverGetVersion(ctypes.byref(version)) != 0:
        return ""
    return f"CUDA driver {version.value}"


#: The fingerprint's inputs, by name, in digest order.
READERS = {"machine": _read_machine, "cpu": _read_cpu, "gpu": _read_gpu,
           "nvcc": _read_nvcc, "driver": _read_driver}


def fingerprint_inputs() -> Dict[str, str]:
    """Each fingerprint input as read now (MISSING where a reader finds
    nothing)."""
    return {name: read() or MISSING for name, read in READERS.items()}


def _digest(inputs: Dict[str, str]) -> str:
    text = "\n".join(f"{k}={v}" for k, v in inputs.items())
    return hashlib.sha256(text.encode()).hexdigest()[:12]


def host_fingerprint() -> str:
    """The digest of fingerprint_inputs(), computed once per process."""
    global _fingerprint
    with _lock:
        if _fingerprint is None:
            _fingerprint = _digest(fingerprint_inputs())
        return _fingerprint


# -- the namespace --------------------------------------------------------------

def root() -> str:
    """The build root: $CONSENSUS_TORCH_BUILD_ROOT, else DEFAULT_ROOT."""
    return os.path.abspath(os.environ.get(ENV_ROOT) or DEFAULT_ROOT)


def build_dir() -> str:
    """This host's namespace under the root, created if missing.  Raises
    RuntimeError when it cannot be created or written."""
    base = root()
    path = os.path.join(base, f"host-{host_fingerprint()}")
    try:
        os.makedirs(path, exist_ok=True)
        writable = os.access(path, os.W_OK | os.X_OK)
    except OSError as e:
        writable, why = False, f": {e}"
    else:
        why = ""
    if not writable:
        raise RuntimeError(
            f"the kernel build directory {path} cannot be written{why}; "
            f"set {ENV_ROOT} to a writable directory")
    _prune_legacy(base)
    return path


def _prune_legacy(base: str) -> None:
    """Delete the flat ``*.so`` and ``*.so.log`` files at the top of the
    default root (the layout before the host namespaces: nothing loads
    them any more), once per process.  A root named by the environment
    is never pruned: it may be shared with another checkout."""
    if base != os.path.abspath(DEFAULT_ROOT) or base in _pruned:
        return
    _pruned.add(base)
    try:
        names = os.listdir(base)
    except OSError:
        return
    for name in names:
        full = os.path.join(base, name)
        if name.endswith((".so", ".so.log")) and os.path.isfile(full):
            try:
                os.unlink(full)
            except OSError:
                pass  # another process pruned it first


def touch(path: str) -> None:
    """Mark a library as used now (its LRU stamp), and held by this
    process: called when it is built and when it is loaded."""
    os.utime(path)
    with _lock:
        _held.add(os.path.abspath(path))


def held() -> set:
    """The libraries this process built or loaded."""
    with _lock:
        return set(_held)


def evict() -> list:
    """Bound build_dir() to MAX_BYTES: delete the libraries touched
    least recently, each with its ``.log``, until the ``.so`` files and
    logs fit.  A library this process holds and a ``.tmp`` file are
    never deleted.  Returns the deleted libraries."""
    libs, total = [], 0
    with os.scandir(build_dir()) as it:
        for e in it:
            if not e.is_file():
                continue
            st = e.stat()
            total += st.st_size
            if e.name.endswith(".so"):
                libs.append((st.st_mtime, e.path))
    gone = []
    keep = held()
    for _, lib in sorted(libs):
        if total <= MAX_BYTES:
            break
        if os.path.abspath(lib) in keep:
            continue
        for victim in (lib, lib + ".log"):
            try:
                freed = os.path.getsize(victim)
                os.unlink(victim)
                total -= freed
            except OSError:
                pass  # no log, or another process evicted it first
        gone.append(lib)
    return gone
