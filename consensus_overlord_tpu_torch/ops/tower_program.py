"""The pairing kernels' programs: the plain tower's base-field ops,
recorded, scheduled into stages and given registers.

csrc/pairing.cu runs one interpreter in three kernels
(``miller_product_kernel``, ``fq12_mul_kernel``, ``final_exp_kernel``).
What each computes is a *program*: the exact sequence of base-field ops
(mul, add, sub, neg, mul_small by 2, 3, 8, 12) that the plain PyTorch
version in ops/pairing.py runs, so the kernel's outputs are
bit-identical to it by construction.  This module makes the programs:

* ``TraceField`` stands in for the base field under ops/pairing.py's
  ``Tower``: each element is a value id, and each op records one
  instruction per element instead of computing.  Running the tower's
  Miller loop, Fq12 multiply or final exponentiation over it records
  their whole straight-line op sequence (the bits of |x| are static, so
  the trace is the schedule).
* ``compile_program`` levels the ops (a stage holds the ops whose
  operands are all ready: the kernel runs a stage's ops on all of its
  lane groups at once, with a block barrier between stages), orders each
  stage by kind so the two lane groups of a warp always run the same
  kind, and gives every value a register of the kernel's shared-memory
  register file, reusing a register once its value is dead.
* ``run_program`` executes a program on tensors with a FieldSpec, one
  base-field call per stage and kind: what the kernel does, on the CPU.

The program is a table of int32 words that the kernel walks (layout:
``Program.words``); it is data, uploaded once per device, so the kernel
source stays small and builds in seconds.
"""

from __future__ import annotations

import functools
from typing import Dict, List, Tuple

import numpy as np
import torch

from .field import FieldSpec, Tensor

#: Op kinds, in the order of csrc/pairing.cu's TOWER_OP_* codes.
KINDS = ("mul", "add", "sub", "neg", "small2", "small3", "small8",
         "small12")
_KIND = {k: i for i, k in enumerate(KINDS)}
_UNARY = {"neg", "small2", "small3", "small8", "small12"}
#: Words before the register lists: version, registers, stages,
#: constants, inputs, outputs, ops (mirrored in csrc/pairing.cu).
HEADER = 7
VERSION = 1


class TraceField:
    """A base field whose elements are value ids (limb axis of size 1)
    and whose ops record (kind, out, a, b) instructions: the FieldSpec
    surface the tower uses (add/sub/neg/mul/sq/mul_small/inv/pow_static,
    one/zero/constant)."""

    n = 1

    def __init__(self, spec: FieldSpec):
        self.spec = spec
        self.p = spec.p
        self.ops: List[Tuple[int, int, int, int]] = []
        self.consts: Dict[int, int] = {}  # value mod p → id
        self._count = 0

    def _ids(self, k: int) -> range:
        self._count += k
        return range(self._count - k, self._count)

    def inputs(self, shape: Tuple[int, ...]) -> Tensor:
        """Fresh input ids in the shape of a tower element (limb axis
        last)."""
        k = int(np.prod(shape, dtype=np.int64))
        return torch.tensor(list(self._ids(k))).reshape(tuple(shape) + (1,))

    def constant(self, v: int, device="cpu") -> Tensor:
        v %= self.p
        if v not in self.consts:
            self.consts[v] = self._ids(1)[0]
        return torch.tensor([self.consts[v]])

    def one(self, device="cpu") -> Tensor:
        return self.constant(1)

    def zero(self, device="cpu") -> Tensor:
        return self.constant(0)

    def _record(self, kind: str, *xs: Tensor) -> Tensor:
        xs = torch.broadcast_tensors(*xs)
        cols = [x[..., 0].reshape(-1).tolist() for x in xs]
        out = self._ids(len(cols[0]))
        code = _KIND[kind]
        for o, *args in zip(out, *cols):
            self.ops.append((code, o, args[0], args[-1]))
        return torch.tensor(list(out)).reshape(xs[0].shape)

    def add(self, x: Tensor, y: Tensor) -> Tensor:
        return self._record("add", x, y)

    def sub(self, x: Tensor, y: Tensor) -> Tensor:
        return self._record("sub", x, y)

    def mul(self, x: Tensor, y: Tensor) -> Tensor:
        return self._record("mul", x, y)

    def sq(self, x: Tensor) -> Tensor:
        return self._record("mul", x, x)

    def neg(self, x: Tensor) -> Tensor:
        return self._record("neg", x)

    def mul_small(self, x: Tensor, k: int) -> Tensor:
        if k == 1:  # its plan is empty: x·1 is x, limb for limb
            return x.clone()
        return self._record(f"small{k}", x)

    pow_static = FieldSpec.pow_static
    inv = FieldSpec.inv


class Program:
    """A scheduled, register-allocated op sequence and its constants.

    ``words`` (int32), the table the kernel walks:
      [0:7]   version, registers, stages, constants, inputs, outputs, ops
      then    the constants' registers, the inputs' registers, the
              outputs' registers, stage starts (stages + 1 op indices),
              and the ops, two words each: kind | dst << 8, a | b << 16.
    ``consts``: (constants, n) int32 limbs, in the order of their
    registers.  Input k is Fq element k of a lane's input (the C order
    of its tower layout), output k likewise."""

    def __init__(self, words, consts, stats):
        self.words = words
        self.consts = consts
        self.stats = stats
        h = words[:HEADER]
        self.nregs, self.nstages, nc, ni, no, self.nops = (int(v) for v
                                                           in h[1:])
        o = HEADER
        self.const_regs = words[o:o + nc]
        self.in_regs = words[o + nc:o + nc + ni]
        self.out_regs = words[o + nc + ni:o + nc + ni + no]
        o += nc + ni + no
        self.stage_start = words[o:o + self.nstages + 1]
        ops = words[o + self.nstages + 1:].reshape(-1, 2)
        self.kind = ops[:, 0] & 0xFF
        self.dst = ops[:, 0] >> 8
        self.a = ops[:, 1] & 0xFFFF
        self.b = ops[:, 1] >> 16


def _schedule(ops: List[Tuple[int, int, int, int]]) -> List[list]:
    """Stages of a topologically ordered op list.  A multiply costs a
    product's latency, a linear op a few carry passes, so the schedule
    minimizes the multiply stages first: ``rank`` counts the multiplies
    on the longest path from an op to the outputs (its own included),
    every multiply of one rank runs in one stage, and the linear ops of
    rank k run between the multiply stages of ranks k + 1 and k, as late
    as their consumers allow (``level``: linear ops of the same rank
    that still depend on them).  As late as possible keeps values short-
    lived, so the register file stays small."""
    mul = _KIND["mul"]
    rank: Dict[int, int] = {}
    need: Dict[int, int] = {}
    for kind, o, a, b in reversed(ops):
        r = need.get(o, 0) + (kind == mul)
        rank[o] = r
        for v in (a, b):
            need[v] = max(need.get(v, 0), r)
    level: Dict[int, int] = {}  # (a multiply's operand never has its rank)
    for kind, o, a, b in reversed(ops):
        if kind != mul:
            lv = level.setdefault(o, 0)
            for v in {a, b}:
                if rank.get(v) == rank[o]:
                    level[v] = max(level.get(v, 0), lv + 1)
    keys = {}
    for kind, o, _, _ in ops:
        k = rank[o]
        keys[o] = (2 * k - 1, 0) if kind == mul else (2 * k, level[o])
    order = sorted(set(keys.values()), reverse=True)
    index = {key: i for i, key in enumerate(order)}
    stages: List[list] = [[] for _ in order]
    for op in ops:
        stages[index[keys[op[1]]]].append(op)
    return stages


def compile_program(tf: TraceField, in_ids: Tensor, out_ids: Tensor
                    ) -> Program:
    """Schedule the recorded ops that the outputs need into stages and
    allocate registers (see the module docstring)."""
    ins = [int(v) for v in in_ids.reshape(-1)]
    outs = [int(v) for v in out_ids.reshape(-1)]
    # Keep only the ops the outputs need.
    need = set(outs)
    ops = []
    for op in reversed(tf.ops):
        if op[1] in need:
            ops.append(op)
            need.update(op[2:])
    ops.reverse()
    consts = sorted((i, v) for v, i in tf.consts.items() if i in need)
    stages = _schedule(ops)
    nstages = len(stages)
    last = {}
    for s, st in enumerate(stages):
        for _, _, a, b in st:
            last[a] = last[b] = s
    pinned = set(outs) | {i for i, _ in consts}

    reg: Dict[int, int] = {}
    free: List[int] = []
    top = 0

    def alloc() -> int:
        nonlocal top
        if free:
            return free.pop()
        top += 1
        return top - 1

    for i, _ in consts:
        reg[i] = alloc()
    for i in ins:
        if i not in reg:
            reg[i] = alloc()
    for s, st in enumerate(stages):
        for _, o, _, _ in st:
            reg[o] = alloc()
        dead = {v for _, _, a, b in st for v in (a, b)
                if last[v] == s and v not in pinned}
        free.extend(sorted((reg[v] for v in dead), reverse=True))
    trash = top  # the padding ops' destination: a register of its own
    top += 1
    if top > 0xFFFF:
        raise ValueError("program needs more than 65535 registers")

    starts, body = [0], []
    mul_stages = 0
    for st in stages:
        st = sorted(st, key=lambda op: op[0])
        mul_stages += st[0][0] == _KIND["mul"]
        for kind in sorted({op[0] for op in st}):
            group = [op for op in st if op[0] == kind]
            if len(group) % 2:  # a warp's two lane groups run one kind
                group.append((kind, None, group[-1][2], group[-1][3]))
            for _, o, a, b in group:
                d = trash if o is None else reg[o]
                body += [kind | d << 8, reg[a] | reg[b] << 16]
        starts.append(len(body) // 2)
    header = [VERSION, top, nstages, len(consts), len(ins), len(outs),
              len(body) // 2]
    words = np.array(header + [reg[i] for i, _ in consts]
                     + [reg[i] for i in ins] + [reg[i] for i in outs]
                     + starts + body, dtype=np.int64)
    assert words.max() < 2**31
    spec = tf.spec
    limbs = (np.stack([spec.from_int(v) for _, v in consts])
             if consts else np.zeros((0, spec.n), np.int32))
    counts = {k: sum(op[0] == _KIND[k] for op in ops) for k in KINDS}
    stats = {"ops": len(ops), "by_kind": counts, "stages": nstages,
             "mul_stages": mul_stages, "registers": top,
             "widest_stage": max((len(st) for st in stages), default=0)}
    return Program(words.astype(np.int32), limbs.astype(np.int32), stats)


def run_program(prog: Program, field, inputs: Tensor) -> Tensor:
    """Execute a program on a (B, inputs, n) int32 tensor with a
    FieldSpec-like field: one field call per stage and op kind, reading
    and writing a (registers, B, n) register file — the kernel's walk of
    the same table.  Returns (B, outputs, n)."""
    batch, n = inputs.shape[0], inputs.shape[-1]
    regs = torch.zeros((prog.nregs, batch, n), dtype=torch.int32,
                       device=inputs.device)
    regs[torch.as_tensor(prog.const_regs, dtype=torch.long)] = torch.as_tensor(
        prog.consts, device=inputs.device)[:, None, :]
    regs[torch.as_tensor(prog.in_regs, dtype=torch.long)] = inputs.transpose(0, 1)
    kind, dst = prog.kind, prog.dst
    a, b = prog.a, prog.b
    for s in range(prog.nstages):
        lo, hi = int(prog.stage_start[s]), int(prog.stage_start[s + 1])
        for k in np.unique(kind[lo:hi]):
            sel = np.arange(lo, hi)[kind[lo:hi] == k]
            x = regs[torch.as_tensor(a[sel], dtype=torch.long)]
            name = KINDS[k]
            if name == "mul":
                r = field.mul(x, regs[torch.as_tensor(b[sel], dtype=torch.long)])
            elif name in ("add", "sub"):
                r = getattr(field, name)(
                    x, regs[torch.as_tensor(b[sel], dtype=torch.long)])
            elif name == "neg":
                r = field.neg(x)
            else:
                r = field.mul_small(x, int(name[5:]))
            regs[torch.as_tensor(dst[sel], dtype=torch.long)] = r
    return regs[torch.as_tensor(prog.out_regs, dtype=torch.long)].transpose(0, 1)


# -- the three programs ----------------------------------------------------------

def _tower(spec):
    from .pairing import Tower  # pairing.py imports kernels, which imports us
    tf = TraceField(spec)
    return tf, Tower(tf)


def _miller(spec) -> Program:
    """One pair's Miller loop: inputs px, py, qx (2), qy (2); outputs the
    conjugated Fq12 value (12)."""
    tf, tower = _tower(spec)
    px, py = tf.inputs(()), tf.inputs(())
    qx, qy = tf.inputs((2,)), tf.inputs((2,))
    f = tower.miller_loop(px, py, qx, qy)
    return compile_program(tf, torch.cat([t.reshape(-1) for t in
                                          (px, py, qx, qy)]), f)


def _fq12_mul(spec) -> Program:
    """x · y in Fq12: inputs x (12) then y (12); output 12."""
    tf, tower = _tower(spec)
    x, y = tf.inputs((2, 3, 2)), tf.inputs((2, 3, 2))
    return compile_program(tf, torch.cat([x.reshape(-1), y.reshape(-1)]),
                           tower.fq12.mul(x, y))


def _final_exp(spec) -> Program:
    """f^(3(p¹²−1)/r): input 12, output 12."""
    tf, tower = _tower(spec)
    f = tf.inputs((2, 3, 2))
    return compile_program(tf, f, tower.fq12.final_exponentiation(f))


def _fq_inv(spec) -> Program:
    """A measuring program in final_exp_kernel's shape: element 0 of an
    Fq12 input inverted (x^(p−2): 489 dependent products and nothing
    else), the other 11 passed through.  Its time over 489 is one
    dependent product stage of the kernels at one lane."""
    tf, tower = _tower(spec)
    f = tf.inputs((12,))
    out = torch.cat([tf.inv(f[:1]), f[1:]])
    return compile_program(tf, f, out)


_MAKERS = {"miller_product": _miller, "fq12_mul": _fq12_mul,
           "final_exp": _final_exp, "fq_inv": _fq_inv}


@functools.lru_cache(maxsize=None)
def program(name: str, spec) -> Program:
    """The named kernel's program for `spec` (made once per process)."""
    return _MAKERS[name](spec)
