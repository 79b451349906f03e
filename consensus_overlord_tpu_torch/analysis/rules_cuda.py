"""CUDA rules: host syncs reachable from a device body (CUDA001) and
int32-limb upcast hazards in ops/ (CUDA002).

The port's counterparts of rules_tpu.py's TPU001 and TPU002.  The port
traces nothing: a device body is a Python function that queues kernel
launches and torch ops on CUDA tensors and returns before the card has
run them.  A host sync inside one (``.item()``, ``.tolist()``,
``.cpu()``, ``.numpy()``, ``bool``/``int``/``float`` of a tensor,
``torch.cuda.synchronize``, ``np.asarray`` of a tensor, ``print``)
stalls the issuing thread until the card drains the queue, and it is
what a CUDA graph of the round cannot capture.  The blocking end of a
device path belongs in the readback helpers (``READBACK_FUNCS``), which
the provider runs under its dispatch watchdog.

Reachability is the JAX rule's: intra-module and name-based (calls to
``name(...)``, ``self.name(...)``, ``Cls.name(...)`` resolve to every
same-named function of the module), cross-module calls are not
followed.  The roots are named here (``DEVICE_ENTRIES``, by file), as
the JAX rules find theirs from ``jax.jit`` and ``pallas_call``: the
launch wrappers of ops/kernels.py, the group laws, MSMs and pairing of
ops/, the device steps of the providers and parallel/sharded.py.  The
plain versions' host code is reached only where a device body calls it
by name.
"""

from __future__ import annotations

import ast
from typing import Dict, FrozenSet, Iterable, List, Optional, Set

from .core import Finding, Project, SourceFile

_PKG = "consensus_overlord_tpu_torch"

#: The launch wrappers of ops/kernels.py: each launches one kernel.
LAUNCH_WRAPPERS: FrozenSet[str] = frozenset({
    "fq_mul", "g1_add", "g1_dbl", "g2_add", "g2_dbl", "ed_add",
    "wp_add_general", "ed_ladder", "wp_dual_ladder", "miller_product",
    "fq12_mul", "final_exp", "fq_inv", "tower_probe"})

_FIELD = {"add", "sub", "neg", "mul", "sq", "mul_small", "pow_static",
          "inv", "sqrt_candidate", "strict", "is_zero", "eq", "where",
          "geq_const"}
#: What every tower field (fq2, fq6, fq12) defines.
_TOWER = {"add", "mul", "sq", "inv", "eq", "where"}
_CURVE = {"add", "dbl", "neg", "select", "eq", "on_curve", "is_infinity",
          "scalar_mul_static", "scalar_mul_bits", "msm_bits",
          "msm_table_build", "msm_from_tables", "tree_sum", "to_affine"}

#: The device bodies of each file: the roots of CUDA001's reachability.
DEVICE_ENTRIES: Dict[str, FrozenSet[str]] = {
    f"{_PKG}/ops/kernels.py": LAUNCH_WRAPPERS,
    f"{_PKG}/ops/field.py": frozenset(_FIELD),
    f"{_PKG}/ops/fq2.py": frozenset(_TOWER | {
        "sub", "neg", "is_zero", "mul_small", "mul_small_xi", "conj",
        "sqrt_checked", "is_lex_largest"}),
    f"{_PKG}/ops/fq6.py": frozenset(_TOWER | {
        "sub", "neg", "is_zero", "mul_xi", "mul_v", "mul_by_01",
        "mul_by_1"}),
    f"{_PKG}/ops/fq12.py": frozenset(_TOWER | {
        "conj", "mul_by_014", "cyc_sq", "cyc_pow_abs", "frobenius",
        "final_exponentiation", "is_one"}),
    f"{_PKG}/ops/curve.py": frozenset(_CURVE),
    f"{_PKG}/ops/bls12381_groups.py": frozenset({
        "add", "dbl", "g1_decompress_device", "g2_decompress_device",
        "g1_in_subgroup", "g2_in_subgroup", "unpack_weight_bits",
        "gather_rows", "g1_validate_batch"}),
    f"{_PKG}/ops/pairing.py": frozenset({
        "miller_loop", "fq12_tree_product", "multi_pairing_product",
        "multi_pairing_is_one", "fq12_mul", "final_exponentiation",
        "miller_product", "final_is_one", "multi_pairing_is_one_staged"}),
    f"{_PKG}/ops/edwards.py": frozenset({
        "add", "neg", "select", "is_identity", "scalar_mul_steps",
        "ladder", "scalar_mul_bits", "tree_sum", "mul8", "decompress"}),
    f"{_PKG}/ops/weierstrass.py": frozenset({
        "add", "dbl", "on_curve", "dual_scalar_mul_steps", "dual_ladder",
        "dual_scalar_mul_bits"}),
    f"{_PKG}/parallel/sharded.py": frozenset({
        "sharded_verify_round", "sharded_verify_round_local",
        "sharded_verify_round_multi", "sharded_miller_product",
        "sharded_final_is_one", "sharded_multi_pairing_is_one",
        "sharded_miller_partial_local", "sharded_g2_sum_rows",
        "sharded_g2_validate", "sharded_g1_validate_sum",
        "sharded_round_step", "round_step", "gather_lanes"}),
    f"{_PKG}/crypto/cuda_provider.py": frozenset({
        "verify_round", "verify_round_multi", "verify_round_tab",
        "verify_round_multi_tab", "build_g2_tables", "g2_validate",
        "g1_validate_sum", "g2_sum_rows", "_g2_affine_strict"}),
    f"{_PKG}/crypto/ed25519_cuda.py": frozenset({
        "decompress_lanes", "msm_is_identity"}),
    f"{_PKG}/crypto/ecdsa_cuda.py": frozenset({"verify_lanes"}),
}

OPS_FILE_GLOBS = (f"{_PKG}/ops/*.py",)

#: The one legal place for a host sync on a device path: the readback
#: helpers, which the provider runs under CudaBlsCrypto._watched.
#: Reachability does not enter them.
READBACK_FUNCS = {"_readback"}

#: Host-synchronizing calls: a tensor method that copies to the host,
#: a device-wide wait, or a conversion of a tensor to a Python value.
HOST_SYNC_ATTRS = {"item", "tolist", "cpu", "numpy", "synchronize"}
HOST_SYNC_NAMES = {"bool", "int", "float", "print"}
HOST_NP_ROOTS = {"np", "numpy"}
#: Arguments of bool/int/float that are host values whatever the tensor:
#: sizes and shapes.
_HOST_ATTRS = {"shape", "ndim", "size", "dim", "numel", "bit_length"}
_TENSOR_TYPES = {"Tensor", "torch.Tensor"}

_I32_MAX = 2**31 - 1

#: Functions that ARE the overflow guard: an integer matrix product over
#: limbs is legal only inside the planned reduction (ops/field.py
#: `_reduce`, whose per-position bounds `_plan` proved fit int32).
OVERFLOW_GUARD_FUNCS = {"_reduce", "_plan"}
INT_MATMUL_FUNCS = {"einsum", "dot", "matmul", "tensordot", "mm", "bmm"}
#: Where an int64 tensor is not limbs: ops/field.py's canonicalisation
#: words (several limbs to a word, exact in int64), the 32-bit words of
#: the ladder kernels, and the gather indices and packed scalar bits of
#: the ladders, tables and the pairing interpreter's register file.
INT64_FUNCS = {"_to_words", "_word_carry", "_strict_words", "geq_const",
               "const", "int32_words", "_table_lookup", "msm_from_tables",
               "pack_bits", "unpack_bits", "_window_digits", "pack_digits",
               "unpack_digits", "run_program"}


def _dotted(node: ast.AST) -> str:
    """'torch.cuda.synchronize' for Attribute/Name chains, '' otherwise."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def _call_name(call: ast.Call) -> str:
    return _dotted(call.func).rsplit(".", 1)[-1]


class ModuleIndex:
    """Functions and the name-based call graph of one module."""

    def __init__(self, sf: SourceFile):
        self.sf = sf
        #: every def in the module, by bare name
        self.functions: Dict[str, List[ast.AST]] = {}
        if sf.tree is not None:
            for node in ast.walk(sf.tree):
                if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    self.functions.setdefault(node.name, []).append(node)

    def reachable_from(self, names: Iterable[str],
                       stop: Iterable[str] = ()) -> List[ast.AST]:
        """The functions named `names` plus every module-local function
        reachable from them through name-based calls, never entering a
        function named in `stop`."""
        stop = set(stop)
        worklist = [fn for name in sorted(set(names) - stop)
                    for fn in self.functions.get(name, [])]
        seen: Set[int] = {id(fn) for fn in worklist}
        out: List[ast.AST] = []
        while worklist:
            fn = worklist.pop()
            out.append(fn)
            for node in ast.walk(fn):
                if not isinstance(node, ast.Call):
                    continue
                name = _call_name(node)
                if name in stop:
                    continue
                for callee in self.functions.get(name, []):
                    if id(callee) not in seen:
                        seen.add(id(callee))
                        worklist.append(callee)
        return sorted(out, key=lambda fn: fn.lineno)


def device_entries(project: Project) -> Dict[str, FrozenSet[str]]:
    """CUDA001's roots: DEVICE_ENTRIES, or the `device_entries` override
    ({path: names}) of a fixture run, where the override's files are
    the `files` given."""
    override = project.overrides.get("device_entries")
    return DEVICE_ENTRIES if override is None else override


def _returns_tensor(fn: ast.AST) -> bool:
    return fn.returns is not None and _dotted(fn.returns) in _TENSOR_TYPES


def _tensor_names(fn: ast.AST, tensor_fns: Set[str]) -> Set[str]:
    """Names of the function that hold tensors, as far as the source
    says: parameters annotated Tensor, and names assigned from an
    expression that holds one (to a fixpoint)."""
    args = fn.args
    names = {a.arg for a in args.posonlyargs + args.args + args.kwonlyargs
             if a.annotation is not None
             and _dotted(a.annotation) in _TENSOR_TYPES}
    assigns = [n for n in ast.walk(fn) if isinstance(n, ast.Assign)]
    changed = True
    while changed:
        changed = False
        for node in assigns:
            if not _tensorish(node.value, names, tensor_fns):
                continue
            for target in node.targets:
                for t in ast.walk(target):
                    if isinstance(t, ast.Name) and t.id not in names:
                        names.add(t.id)
                        changed = True
    return names


def _tensorish(expr: ast.AST, names: Set[str], tensor_fns: Set[str]
               ) -> bool:
    """Whether the expression holds a tensor: a tensor name, a torch op,
    or a call of a device body or of a module function annotated to
    return a Tensor."""
    for n in ast.walk(expr):
        if isinstance(n, ast.Name) and n.id in names:
            return True
        if isinstance(n, ast.Call):
            dotted = _dotted(n.func)
            if dotted.startswith("torch.") and not dotted.startswith(
                    "torch.cuda."):
                return True
            if dotted.rsplit(".", 1)[-1] in tensor_fns:
                return True
    return False


def _host_value(node: ast.AST) -> bool:
    """Whether bool/int/float of this expression is evidently of a host
    value: a constant, a length, a size or shape."""
    if isinstance(node, ast.Constant):
        return True
    if isinstance(node, ast.Call):
        name = _call_name(node)
        return name in ("len", "max", "min", "round") or name in _HOST_ATTRS
    if isinstance(node, ast.Subscript):
        return _host_value(node.value)
    if isinstance(node, ast.Attribute):
        return node.attr in _HOST_ATTRS
    if isinstance(node, ast.BinOp):
        return _host_value(node.left) and _host_value(node.right)
    return False


def _host_sync(node: ast.Call, tensors: Set[str], tensor_fns: Set[str]
               ) -> Optional[str]:
    """The host sync this call is, or None.  bool/int/float count where
    their argument holds a tensor (_tensorish) and is not a size."""
    dotted = _dotted(node.func)
    if isinstance(node.func, ast.Attribute):
        attr = node.func.attr
        if attr in HOST_SYNC_ATTRS:
            return f"{dotted or '…'}()" if attr == "synchronize" \
                else f".{attr}()"
        if attr == "asarray" and dotted.split(".", 1)[0] in HOST_NP_ROOTS:
            return f"{dotted}()"
    elif isinstance(node.func, ast.Name) and node.func.id in HOST_SYNC_NAMES:
        if node.func.id == "print":
            return "print()"
        arg = node.args[0] if node.args else None
        if (arg is not None and not _host_value(arg)
                and _tensorish(arg, tensors, tensor_fns)):
            return f"{node.func.id}() of a tensor"
    return None


# ---------------------------------------------------------------------------
# CUDA001 — host syncs reachable from a device body
# ---------------------------------------------------------------------------

def check_cuda001(project: Project) -> Iterable[Finding]:
    entries = device_entries(project)
    explicit = project.overrides.get("files") is not None
    if explicit:
        names = frozenset().union(*entries.values()) if entries else ()
        files = [(sf, names) for sf in project.target_files(())]
    else:
        files = []
        for rel, names in sorted(entries.items()):
            sf = project.file(rel)
            if sf is None:
                yield Finding("CUDA001", rel, 0,
                              "file named in DEVICE_ENTRIES is missing — "
                              "its device bodies go unchecked")
            else:
                files.append((sf, names))
    for sf, names in files:
        if sf.tree is None:
            continue
        index = ModuleIndex(sf)
        if not explicit:
            # a renamed root would switch the rule off without a word
            for name in sorted(set(names) - set(index.functions)):
                yield Finding("CUDA001", sf.relpath, 0,
                              f"device root `{name}` of DEVICE_ENTRIES is "
                              "not defined here — it goes unchecked")
        reachable = index.reachable_from(names, stop=READBACK_FUNCS)
        # what a device body returns is device data
        tensor_fns = {fn.name for fn in reachable} | {
            name for name, fns in index.functions.items()
            if any(_returns_tensor(fn) for fn in fns)}
        for fn in reachable:
            tensors = _tensor_names(fn, tensor_fns)
            for node in ast.walk(fn):
                if not isinstance(node, ast.Call):
                    continue
                hit = _host_sync(node, tensors, tensor_fns)
                if hit:
                    yield sf.finding(
                        "CUDA001", node.lineno,
                        f"host sync {hit} reachable from the device body "
                        f"`{getattr(fn, 'name', '?')}` — it waits for the "
                        "card to drain the queue (move it to a readback "
                        f"helper, {sorted(READBACK_FUNCS)})")


# ---------------------------------------------------------------------------
# CUDA002 — int32-limb upcast hazards in ops/
# ---------------------------------------------------------------------------

def _is_int64_ref(node: ast.AST) -> bool:
    if isinstance(node, ast.Constant) and node.value == "int64":
        return True
    return _dotted(node) in ("torch.int64", "torch.long")


def _mentions_torch(fn: ast.AST) -> bool:
    """Does this function's body touch torch?  Host helpers do exact
    Python bigint math legitimately; the int32-lane literal hazard only
    exists where the arithmetic can land on tensors."""
    return any(isinstance(n, ast.Name) and n.id == "torch"
               for n in ast.walk(fn))


def _owners(tree: ast.AST) -> Dict[int, Optional[ast.AST]]:
    """Each node's innermost enclosing function (None at module level)."""
    owner: Dict[int, Optional[ast.AST]] = {id(tree): None}

    def tag(node: ast.AST, fn: Optional[ast.AST]) -> None:
        for child in ast.iter_child_nodes(node):
            child_fn = child if isinstance(
                child, (ast.FunctionDef, ast.AsyncFunctionDef)) else fn
            owner[id(child)] = child_fn
            tag(child, child_fn)

    tag(tree, None)
    return owner


def _int64_cast(node: ast.Call) -> Optional[str]:
    """The int64 cast of a tensor this call is, or None."""
    func = node.func
    dotted = _dotted(func)
    if isinstance(func, ast.Attribute):
        if func.attr == "long" and not node.args:
            return ".long()"
        if func.attr in ("to", "type") and node.args and _is_int64_ref(
                node.args[0]):
            return f".{func.attr}(torch.int64)"
    if dotted.startswith("torch."):
        for kw in node.keywords:
            if kw.arg == "dtype" and _is_int64_ref(kw.value):
                return f"{dotted}(dtype=torch.int64)"
    if isinstance(func, ast.Attribute) and func.attr == "to":
        for kw in node.keywords:
            if kw.arg == "dtype" and _is_int64_ref(kw.value):
                return ".to(dtype=torch.int64)"
    return None


def check_cuda002(project: Project) -> Iterable[Finding]:
    for sf in project.target_files(OPS_FILE_GLOBS):
        tree = sf.tree
        if tree is None:
            continue
        owner = _owners(tree)
        torch_fns: Dict[int, bool] = {}

        def name_of(node: ast.AST) -> Optional[str]:
            fn = owner.get(id(node))
            return fn.name if fn is not None else None

        for node in ast.walk(tree):
            if isinstance(node, ast.Call):
                cast = _int64_cast(node)
                if cast and name_of(node) not in INT64_FUNCS:
                    yield sf.finding(
                        "CUDA002", node.lineno,
                        f"{cast}: the limb machine is int32-only — widen "
                        "through the reduction pipeline, or to words only "
                        f"in {sorted(INT64_FUNCS)}")
                name = _call_name(node)
                if (name in INT_MATMUL_FUNCS
                        and name_of(node) not in OVERFLOW_GUARD_FUNCS
                        and (_dotted(node.func).startswith("torch.")
                             or isinstance(node.func, ast.Attribute))):
                    yield sf.finding(
                        "CUDA002", node.lineno,
                        f"{_dotted(node.func) or name} on limbs outside "
                        "the overflow-guard pipeline (allowed only in "
                        f"{sorted(OVERFLOW_GUARD_FUNCS)} where _plan "
                        "proved the bounds fit int32)")
            elif isinstance(node, ast.BinOp):
                if isinstance(node.op, ast.MatMult) and name_of(
                        node) not in OVERFLOW_GUARD_FUNCS:
                    yield sf.finding(
                        "CUDA002", node.lineno,
                        "`@` on limbs outside the overflow-guard pipeline "
                        f"(allowed only in {sorted(OVERFLOW_GUARD_FUNCS)})")
                    continue
                # a big literal combined with a dynamic operand: the sum
                # or product overflows int32 lanes at run time
                if _const_int(node) is not None:
                    continue
                fn = owner.get(id(node))
                if fn is None or fn.name in INT64_FUNCS:
                    continue  # module-level math; exact int64 words
                if id(fn) not in torch_fns:
                    torch_fns[id(fn)] = _mentions_torch(fn)
                if not torch_fns[id(fn)]:
                    continue
                for side in (node.left, node.right):
                    v = _const_int(side)
                    if v is not None and abs(v) > _I32_MAX:
                        yield sf.finding(
                            "CUDA002", node.lineno,
                            f"integer literal {v} (≥ 2**31) in arithmetic "
                            "with a dynamic operand — int32 lanes "
                            "overflow; route through the reduction "
                            "pipeline or fold it on the host")


def _const_int(node: ast.AST) -> Optional[int]:
    """Fold a pure-literal integer expression to its value (exact
    Python math, exempt from the literal check)."""
    if isinstance(node, ast.Constant) and isinstance(node.value, int) \
            and not isinstance(node.value, bool):
        return node.value
    if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.USub):
        v = _const_int(node.operand)
        return -v if v is not None else None
    if isinstance(node, ast.BinOp):
        lhs, rhs = _const_int(node.left), _const_int(node.right)
        if lhs is None or rhs is None:
            return None
        op = node.op
        try:
            if isinstance(op, ast.Add):
                return lhs + rhs
            if isinstance(op, ast.Sub):
                return lhs - rhs
            if isinstance(op, ast.Mult):
                return lhs * rhs
            if isinstance(op, ast.Pow):
                return lhs ** rhs if abs(rhs) < 4096 else None
            if isinstance(op, ast.LShift):
                return lhs << rhs if rhs < 4096 else None
            if isinstance(op, ast.RShift):
                return lhs >> rhs
            if isinstance(op, ast.FloorDiv) and rhs:
                return lhs // rhs
            if isinstance(op, ast.Mod) and rhs:
                return lhs % rhs
            if isinstance(op, ast.BitAnd):
                return lhs & rhs
            if isinstance(op, ast.BitOr):
                return lhs | rhs
            if isinstance(op, ast.BitXor):
                return lhs ^ rhs
        except (OverflowError, ValueError):
            return None
    return None


RULES = {
    "CUDA001": check_cuda001,
    "CUDA002": check_cuda002,
}
