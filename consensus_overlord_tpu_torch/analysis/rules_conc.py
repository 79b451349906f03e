"""CONC rules: lock discipline (CONC001) and the device-path failure
contract (CONC002).

CONC001 is the JAX rule, over the port's lock files: within a class
that takes `with self.<lock>:`, any attribute written both under the
lock and outside it is a race.  Helper methods whose every intra-class
call site sits under the lock (transitively — the `_transition` /
"caller holds the lock" convention) count as lock-held; `__init__`-time
writes are construction, not sharing, and are exempt.

CONC002 holds device paths to the port's contract, which differs from
the JAX package's by design (ROADMAP Queue 3): a real device error
raises to the caller, and only the faults raised in Python (an injected
breaker fault, a lost lane, a timeout an injected stall caused:
cuda_provider.py `_injected`) are re-verified on the host.  A `try`
whose body reaches the device (a readback, the dispatch watchdog, the
kernel set, an injected-fault check, a device-wide wait or a launch
wrapper) must, in every handler, re-raise, or pass the error through
the gate that re-raises what was not injected (`_device_failed`,
`_pairing_failed`), or catch only injected faults and feed the breaker,
a counter or a log.  A broad handler that does none of these sends a
device error to the host oracle, or swallows it: a finding.  The
uncontained half: a readback of a device result outside the dispatch
watchdog (`CudaBlsCrypto._watched`, which turns a hung readback into a
DispatchTimeout) is a finding.
"""

from __future__ import annotations

import ast
from typing import Dict, Iterable, List, Set, Tuple

from .core import Finding, Project, SourceFile
from .rules_cuda import LAUNCH_WRAPPERS, READBACK_FUNCS, _call_name

_PKG = "consensus_overlord_tpu_torch"

LOCK_FILE_GLOBS = (
    f"{_PKG}/crypto/frontier.py",
    f"{_PKG}/crypto/tenancy.py",
    f"{_PKG}/crypto/breaker.py",
    f"{_PKG}/crypto/cuda_provider.py",
    f"{_PKG}/obs/telemetry.py",
    f"{_PKG}/parallel/supervisor.py",
)

DEVICE_FILE_GLOBS = (
    f"{_PKG}/crypto/cuda_provider.py",
    f"{_PKG}/crypto/ed25519_cuda.py",
    f"{_PKG}/crypto/ecdsa_cuda.py",
    f"{_PKG}/crypto/tenancy.py",
    f"{_PKG}/parallel/*.py",
)

#: Presence of any of these in a try body marks it a device path.
DEVICE_MARKERS = ({"_readback", "_watched", "_kernels", "raise_if_injected",
                   "_raise_if_injected", "synchronize"}
                  | set(LAUNCH_WRAPPERS))

#: The dispatch watchdog: a readback inside one of its calls is contained.
WATCHDOG_FUNCS = {"_watched"}
#: Calls that copy a device result to the host.
READBACK_CALLS = READBACK_FUNCS | {"cpu", "item"}

#: Handlers that re-raise every fault not raised in Python, and feed the
#: breaker and the counters with the rest.
RAISING_GATES = {"_device_failed", "_pairing_failed"}
#: The faults raised in Python (cuda_provider.py `_injected`).
INJECTED_FAULTS = {"InjectedDeviceFault", "DeviceLossError",
                   "DispatchTimeout"}
#: Handler types that also catch a real device error (a launch or CUDA
#: runtime error is a RuntimeError).
BROAD_TYPES = {"Exception", "BaseException", "RuntimeError"}

#: A narrow handler that reaches any of these has handled its fault:
#: breaker feedback, metrics, or logging.
MITIGATION_NAMES = {
    "record_failure", "record_success", "_device_succeeded",   # breaker
    "host_fallbacks", "device_failures", "labels", "inc", "observe",
    "exception", "warning", "error", "info", "debug",          # logging
}


# ---------------------------------------------------------------------------
# CONC001 — lock discipline
# ---------------------------------------------------------------------------

class _MethodScan(ast.NodeVisitor):
    """Per-method facts: self-attribute writes and self-method calls,
    each tagged with whether it happened under a `with self.<lock>`."""

    def __init__(self, lock_attrs: Set[str]):
        self.lock_attrs = lock_attrs
        self.depth = 0
        #: [(attr, lineno, under_lock)]
        self.writes: List[Tuple[str, int, bool]] = []
        #: [(method, under_lock)]
        self.calls: List[Tuple[str, bool]] = []

    def visit_With(self, node: ast.With) -> None:
        locked = any(
            isinstance(item.context_expr, ast.Attribute)
            and isinstance(item.context_expr.value, ast.Name)
            and item.context_expr.value.id == "self"
            and item.context_expr.attr in self.lock_attrs
            for item in node.items)
        if locked:
            self.depth += 1
        self.generic_visit(node)
        if locked:
            self.depth -= 1

    visit_AsyncWith = visit_With  # async-held locks count the same

    def _record_target(self, target: ast.AST, lineno: int) -> None:
        for node in ast.walk(target):
            if (isinstance(node, ast.Attribute)
                    and isinstance(node.value, ast.Name)
                    and node.value.id == "self"):
                self.writes.append((node.attr, lineno, self.depth > 0))

    def visit_Assign(self, node: ast.Assign) -> None:
        for t in node.targets:
            self._record_target(t, node.lineno)
        self.generic_visit(node)

    def visit_AugAssign(self, node: ast.AugAssign) -> None:
        self._record_target(node.target, node.lineno)
        self.generic_visit(node)

    def visit_AnnAssign(self, node: ast.AnnAssign) -> None:
        if node.value is not None:
            self._record_target(node.target, node.lineno)
        self.generic_visit(node)

    def visit_Call(self, node: ast.Call) -> None:
        if (isinstance(node.func, ast.Attribute)
                and isinstance(node.func.value, ast.Name)
                and node.func.value.id == "self"):
            self.calls.append((node.func.attr, self.depth > 0))
        self.generic_visit(node)


def _class_lock_findings(sf: SourceFile, cls: ast.ClassDef
                         ) -> Iterable[Finding]:
    methods = [n for n in cls.body
               if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]
    lock_attrs: Set[str] = set()
    for node in ast.walk(cls):
        if isinstance(node, (ast.With, ast.AsyncWith)):
            for item in node.items:
                ce = item.context_expr
                if (isinstance(ce, ast.Attribute)
                        and isinstance(ce.value, ast.Name)
                        and ce.value.id == "self"
                        and "lock" in ce.attr.lower()):
                    lock_attrs.add(ce.attr)
    if not lock_attrs:
        return

    scans: Dict[str, _MethodScan] = {}
    for m in methods:
        scan = _MethodScan(lock_attrs)
        scan.visit(m)
        scans[m.name] = scan

    # Fixpoint: a method is lock-held iff it has intra-class call sites
    # and EVERY one of them is under the lock or inside a lock-held
    # method ("caller holds the lock" helpers).
    call_sites: Dict[str, List[Tuple[str, bool]]] = {}
    for caller, scan in scans.items():
        for callee, locked in scan.calls:
            call_sites.setdefault(callee, []).append((caller, locked))
    lock_held: Set[str] = set()
    changed = True
    while changed:
        changed = False
        for name in scans:
            if name in lock_held:
                continue
            sites = call_sites.get(name, [])
            if sites and all(locked or caller in lock_held
                             for caller, locked in sites):
                lock_held.add(name)
                changed = True

    locked_writes: Dict[str, List[int]] = {}
    unlocked_writes: Dict[str, List[int]] = {}
    for name, scan in scans.items():
        if name in ("__init__", "__post_init__", "__new__"):
            continue  # construction happens before the object is shared
        for attr, lineno, under in scan.writes:
            if attr in lock_attrs:
                continue
            bucket = (locked_writes if under or name in lock_held
                      else unlocked_writes)
            bucket.setdefault(attr, []).append(lineno)

    for attr in sorted(set(locked_writes) & set(unlocked_writes)):
        for lineno in sorted(unlocked_writes[attr]):
            yield sf.finding(
                "CONC001", lineno,
                f"`self.{attr}` is written here without "
                f"{'/'.join(sorted(lock_attrs))} but under it elsewhere "
                f"in {cls.name} (lines "
                f"{sorted(locked_writes[attr])}) — a torn read/write "
                "race on shared state")


def check_conc001(project: Project) -> Iterable[Finding]:
    for sf in project.target_files(LOCK_FILE_GLOBS):
        tree = sf.tree
        if tree is None:
            continue
        for node in ast.walk(tree):
            if isinstance(node, ast.ClassDef):
                yield from _class_lock_findings(sf, node)


# ---------------------------------------------------------------------------
# CONC002 — the device-path failure contract
# ---------------------------------------------------------------------------

def _names_in(node: ast.AST) -> Set[str]:
    out: Set[str] = set()
    for n in ast.walk(node):
        if isinstance(n, ast.Attribute):
            out.add(n.attr)
        elif isinstance(n, ast.Name):
            out.add(n.id)
    return out


def _is_device_try(body: List[ast.stmt]) -> bool:
    names: Set[str] = set()
    for stmt in body:
        names |= _names_in(stmt)
    return bool(names & DEVICE_MARKERS)


def _handler_types(handler: ast.ExceptHandler) -> Set[str]:
    """The bare names of the caught types ({"BaseException"} for a bare
    except)."""
    if handler.type is None:
        return {"BaseException"}
    elts = (handler.type.elts if isinstance(handler.type, ast.Tuple)
            else [handler.type])
    out = set()
    for e in elts:
        name = e.attr if isinstance(e, ast.Attribute) else getattr(
            e, "id", "")
        out.add(name)
    return out


def _handler_finding(handler: ast.ExceptHandler) -> str:
    """Why the handler breaks the contract, or ''."""
    if any(isinstance(n, ast.Raise) for n in ast.walk(handler)):
        return ""
    names = _names_in(handler)
    if names & RAISING_GATES:
        return ""
    if _handler_types(handler) & BROAD_TYPES:
        return ("a broad device-path handler that neither re-raises nor "
                "passes the error through _device_failed — a real device "
                "error would be swallowed or re-verified on the host, "
                "where the port's rule is that it raises")
    if names & MITIGATION_NAMES:
        return ""
    return ("device-path except swallows the failure without breaker "
            "feedback, metrics, or a log — a sick device degrades "
            "silently instead of visibly")


def check_conc002(project: Project) -> Iterable[Finding]:
    for sf in project.target_files(DEVICE_FILE_GLOBS):
        tree = sf.tree
        if tree is None:
            continue
        # (a) device try-blocks whose handlers break the contract
        for node in ast.walk(tree):
            if not isinstance(node, ast.Try) or not _is_device_try(
                    node.body):
                continue
            for handler in node.handlers:
                why = _handler_finding(handler)
                if why:
                    yield sf.finding("CONC002", handler.lineno, why)
        # (b) readbacks outside the dispatch watchdog; the readback
        # helpers themselves are where the copy happens
        for fn in [n for n in ast.walk(tree)
                   if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
                   and n.name not in READBACK_FUNCS]:
            hits = _unwatched_readbacks(fn)
            if hits:
                lineno, name = hits[0]
                yield sf.finding(
                    "CONC002", lineno,
                    f"readback `{name}` in `{fn.name}` runs outside the "
                    "dispatch watchdog (_watched) — a hung card blocks "
                    "this thread forever instead of raising "
                    "DispatchTimeout")


def _unwatched_readbacks(fn: ast.AST) -> List[Tuple[int, str]]:
    hits: List[Tuple[int, str]] = []

    def visit(node: ast.AST) -> None:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return  # nested defs are their own scopes
        if isinstance(node, ast.Call):
            name = _call_name(node)
            if name in WATCHDOG_FUNCS:
                return  # its arguments run under the watchdog
            if name in READBACK_CALLS:
                hits.append((node.lineno, name))
        for child in ast.iter_child_nodes(node):
            visit(child)

    for child in ast.iter_child_nodes(fn):
        visit(child)
    return hits


RULES = {
    "CONC001": check_conc001,
    "CONC002": check_conc002,
}
