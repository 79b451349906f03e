"""The pairing kernels' programs: the plain tower's base-field ops,
recorded, scheduled onto the warps of a block in epochs, and given
registers.

csrc/pairing.cu runs one interpreter in three kernels
(``miller_product_kernel``, ``fq12_mul_kernel``, ``final_exp_kernel``).
What each computes is a *program*: the exact sequence of base-field ops
(mul, add, sub, neg, mul_small by 2, 3, 8, 12) that the plain PyTorch
version in ops/pairing.py runs, so the kernel's outputs are
bit-identical to it by construction.  ``final_exp_kernel`` also runs
``fq_inv12``, twelve Fq inversions a lane (FieldSpec.inv on the card).
This module makes the programs:

* ``TraceField`` stands in for the base field under ops/pairing.py's
  ``Tower``: each element is a value id, and each op records one
  instruction per element instead of computing.  Running the tower's
  Miller loop, Fq12 multiply or final exponentiation over it records
  their whole straight-line op sequence (the bits of |x| are static, so
  the trace is the schedule).
* ``compile_program`` (format 2) gives every op to one warp of the
  block: a warp is a processor that runs one *stream* of steps, each step
  a pair of ops of one kind (its two lane groups; the field core shuffles
  with the full warp mask).  The streams run in *epochs* with a block
  barrier only between them: a value may be read by another warp only in
  a later epoch, while a warp reads its own values at its next step (the
  kernel puts a ``__syncwarp`` between steps).  ``_schedule`` is a list
  scheduler, epoch by epoch, steered by modelled op latencies; the
  register allocator reuses a register across warps only after a
  barrier, and within its warp after the value's last read.
* ``run_program`` executes a program on tensors with a FieldSpec, warp
  by warp within each epoch, in any order of the warps: what the kernel
  does, on the CPU.

The program is a table of int32 words that the kernel walks (layout:
``Program``); it is data, uploaded once per device, so the kernel source
stays small and builds in seconds.
"""

from __future__ import annotations

import functools
import heapq
from typing import Dict, List, Tuple

import numpy as np
import torch

from .field import FieldSpec, Tensor

#: Op kinds, in the order of csrc/pairing.cu's TOWER_OP_* codes.
KINDS = ("mul", "add", "sub", "neg", "small2", "small3", "small8",
         "small12")
_KIND = {k: i for i, k in enumerate(KINDS)}
_UNARY = {"neg", "small2", "small3", "small8", "small12"}
#: Words before the register lists: version, registers, warps,
#: constants, inputs, outputs, steps, epochs (mirrored in csrc/pairing.cu).
HEADER = 8
VERSION = 2
#: Warps of a pairing kernel's block (TOWER_THREADS / 32 in
#: csrc/pairing.cu, mirrored in ops/kernels.py); a program is built for
#: one warp count.
WARPS = 16
#: A step word's kind field, its no-op, and its flag for a block barrier
#: after the step (csrc/pairing.cu TOWER_OP_NOP, TOWER_BARRIER).
NOP = 8
BARRIER = 0x10
#: Modelled latencies (us) that steer the scheduler: one product, one
#: linear op, one block barrier (the field-core probe at one warp and a
#: 512-thread block's barrier, NVIDIA H100; scripts/torch_pairing_breakdown.py),
#: and how much ready work (us) one warp may hold while another idles
#: before the epoch closes to share it.
MUL_US, LINEAR_US, BARRIER_US, TRAPPED_US = 0.97, 0.10, 0.023, 3.0


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
    inv = FieldSpec.inv_chain


class Program:
    """A scheduled, register-allocated op sequence and its constants.

    ``words`` (int32), the table the kernel walks:
      [0:8]   version, registers, warps, constants, inputs, outputs,
              steps, epochs
      then    the constants' registers, the inputs' registers, the
              outputs' registers, the warps' stream starts (warps + 1
              step indices), zero words up to a multiple of 4 (the
              steps are read as 16-byte int4), and the steps: four
              words each, two per lane group of the warp,
              kind | flags | dst << 8 and a | b << 16.  Warp w runs
              steps start[w]..start[w + 1] − 1 in order; a step flagged
              BARRIER ends an epoch (every warp has one such step per
              epoch, a NOP step where it has no op).
    ``consts``: (constants, n) int32 limbs, in the order of their
    registers.  Input k is Fq element k of a lane's input (the C order
    of its tower layout), output k likewise."""

    def __init__(self, words, consts, stats):
        self.words = words
        self.consts = consts
        self.stats = stats
        h = words[:HEADER]
        (self.nregs, self.warps, nc, ni, no, self.nsteps,
         self.nepochs) = (int(v) for v in h[1:])
        o = HEADER
        self.const_regs = words[o:o + nc]
        self.in_regs = words[o + nc:o + nc + ni]
        self.out_regs = words[o + nc + ni:o + nc + ni + no]
        o += nc + ni + no
        self.warp_start = words[o:o + self.warps + 1]
        o += self.warps + 1
        o += -o % 4
        st = words[o:].reshape(-1, 2, 2)  # step, group, word
        assert len(st) == self.nsteps
        self.kind = st[:, :, 0] & 0xF
        self.barrier = (st[:, 0, 0] & BARRIER) != 0
        self.dst = st[:, :, 0] >> 8
        self.a = st[:, :, 1] & 0xFFFF
        self.b = st[:, :, 1] >> 16
        # Each step's warp and epoch.
        self.warp = np.repeat(np.arange(self.warps),
                              np.diff(self.warp_start))
        self.epoch = np.zeros(self.nsteps, np.int64)
        for w in range(self.warps):
            lo, hi = int(self.warp_start[w]), int(self.warp_start[w + 1])
            ends = np.cumsum(self.barrier[lo:hi])
            self.epoch[lo:hi] = ends - self.barrier[lo:hi]


def _schedule(ops, warps: int):
    """Give each op of a topologically ordered list a warp and an epoch:
    returns each warp's steps in order, as (epoch, op, op or None) index
    triples, and the number of epochs.

    A list scheduler on modelled latencies (MUL_US, LINEAR_US), epoch by
    epoch.  An op's priority is its longest path to the outputs.  An op
    whose operands all come from earlier epochs is ready for every warp;
    one whose operands of this epoch all come from one warp is ready for
    that warp alone; any other waits for the next epoch.  The warp least
    far along in the epoch takes its most urgent ready op, and the most
    urgent ready op of the same kind beside it for its second lane group.
    It takes its own ops first (those ready for it alone, those that a
    consumer of its values also needs, so that the consumer stays on the
    warp, and those whose latest operand it wrote) and the others' only
    when it has none of its own.  An op may lengthen the epoch only
    if it is more urgent than every op waiting for the next one.  The
    epoch closes when no warp has a ready op, or when one warp holds more
    than TRAPPED_US of work that is ready for it alone while another warp
    idles."""
    mul = _KIND["mul"]
    n = len(ops)
    index = {op[1]: i for i, op in enumerate(ops)}
    kind = [op[0] for op in ops]
    args = [sorted({index[v] for v in op[2:] if v in index}) for op in ops]
    users: List[List[int]] = [[] for _ in range(n)]
    for i, a in enumerate(args):
        for j in a:
            users[j].append(i)
    cost = [MUL_US if k == mul else LINEAR_US for k in kind]
    prio = [0.0] * n
    for i in reversed(range(n)):
        prio[i] = cost[i] + max((prio[u] for u in users[i]), default=0.0)
    missing = [len(a) for a in args]
    WAIT, READY, LOCAL, DONE = range(4)
    state = [WAIT] * n
    epoch, warp = [-1] * n, [-1] * n
    ready: Dict[int, list] = {}  # kind → heap of (−priority, op)
    streams: List[list] = [[] for _ in range(warps)]
    waiting = [i for i in range(n) if not args[i]]
    e, left = 0, n

    def top(heaps, k):
        h = heaps[k]
        while h and state[h[0][1]] == DONE:
            heapq.heappop(h)
        return h[0] if h else None

    def push(heaps, i):
        heapq.heappush(heaps.setdefault(kind[i], []), (-prio[i], i))

    while left:
        for i in waiting:
            state[i] = READY
            push(ready, i)
        waiting = []
        home: List[Dict[int, list]] = [{} for _ in range(warps)]
        for h in ready.values():  # to the warp of the latest operand
            for _, i in h:
                if state[i] == READY:
                    src = [(epoch[j], warp[j]) for j in args[i]]
                    push(home[max(src)[1] if src else i % warps], i)
        local: List[Dict[int, list]] = [{} for _ in range(warps)]
        near: List[Dict[int, list]] = [{} for _ in range(warps)]
        held = [0.0] * warps  # work ready for each warp alone
        turn = [(0.0, w) for w in range(warps)]
        tmax, urgent, parked, idle = 0.0, None, [], 0
        while turn:
            t, w = heapq.heappop(turn)
            best = None
            for src in (local[w], near[w], home[w], ready):
                if src is ready and best is not None:
                    break
                for k in src:
                    c = top(src, k)
                    if c is None or (best is not None and c >= best[0]):
                        continue
                    if t + cost[c[1]] <= tmax + 1e-9 or urgent is None or \
                            t - c[0] >= urgent + tmax + BARRIER_US:
                        best = (c, k)
            if best is None:
                if held[w] or any(top(ready, k) for k in ready):
                    parked.append(w)  # until the epoch grows longer
                idle += 1
                continue
            (_, first), k = best
            if idle and held[w] - 2 * cost[first] > 2 * TRAPPED_US:
                break
            pair = [(first, state[first])]
            state[first] = DONE
            second = min((c for c in (top(src, k) for src in (
                local[w], near[w], home[w], ready) if k in src)
                if c is not None), default=None)
            if second:
                pair.append((second[1], state[second[1]]))
                state[second[1]] = DONE
            for i, was in pair:
                epoch[i], warp[i] = e, w
                held[w] -= cost[i] if was == LOCAL else 0.0
            pair = [i for i, _ in pair]
            left -= len(pair)
            streams[w].append((e, pair[0], pair[1] if second else None))
            for i in pair:
                for u in users[i]:
                    missing[u] -= 1
                    if missing[u]:  # draw u's other operands to this warp
                        for x in args[u]:
                            if state[x] == READY:
                                push(near[w], x)
                    elif {warp[j] for j in args[u] if epoch[j] == e} == {w}:
                        state[u] = LOCAL
                        push(local[w], u)
                        held[w] += cost[u]
                    else:
                        waiting.append(u)
                        urgent = max(urgent or 0.0, prio[u])
            t += cost[first]
            heapq.heappush(turn, (t, w))
            if t > tmax:
                tmax = t
                for p in parked:
                    heapq.heappush(turn, (t, p))
                idle -= len(parked)
                parked = []
        for w in range(warps):  # still on a warp: ready for all next epoch
            waiting += [i for h in local[w].values() for _, i in h
                        if state[i] == LOCAL]
        e += 1
    return streams, e


def _registers(ops, streams, ins, consts, outs):
    """A register for every value of a schedule: returns (value →
    register, register count).  A value's register is rewritten by
    another warp only from the epoch after the value's last read, and by
    the warp that alone reads it last in that epoch from the step after
    that read; constants and outputs keep theirs."""
    order = []  # (epoch, step in epoch, warp, op indices)
    reads: Dict[int, list] = {}
    for w, stream in enumerate(streams):
        s, prev = 0, None
        for e, i, j in stream:
            s = s + 1 if e == prev else 0
            prev = e
            pair = [x for x in (i, j) if x is not None]
            order.append((e, s, w, pair))
            for x in pair:
                for v in set(ops[x][2:]):
                    reads.setdefault(v, []).append((e, w, s))
    order.sort()
    pinned = set(outs) | {i for i, _ in consts}
    to_all: Dict[int, List[int]] = {}   # epoch → values it frees
    to_own: Dict[tuple, List[int]] = {}  # (epoch, warp, step) → values
    for v in list(ins) + [op[1] for op in ops]:
        if v in pinned:
            continue
        r = reads.get(v, [(-1, 0, 0)])
        last = max(e for e, _, _ in r)
        to_all.setdefault(last + 1, []).append(v)
        by = {w for e, w, _ in r if e == last}
        if last >= 0 and len(by) == 1:
            w = by.pop()
            s = max(s for e, ww, s in r if e == last and ww == w)
            to_own.setdefault((last, w, s), []).append(v)
    reg: Dict[int, int] = {}
    holder: List[int] = []  # register → value, or −1 when free
    pool: List[int] = []    # free for every warp: a heap
    pooled: List[bool] = []
    own: List[list] = [[] for _ in streams]  # (from step, register)

    def assign(v, w=None, s=0):
        mine = own[w] if w is not None else []
        k = next((k for k, (t, _) in enumerate(mine) if t <= s), None)
        if k is not None:
            r = mine.pop(k)[1]
        elif pool:
            r = heapq.heappop(pool)
            pooled[r] = False
        else:
            holder.append(-1)
            pooled.append(False)
            r = len(holder) - 1
        assert holder[r] < 0
        holder[r] = v
        reg[v] = r

    def free(v):
        r = reg[v]
        if holder[r] != v:
            return None
        holder[r] = -1
        return r

    for i, _ in consts:
        assign(i)
    for i in ins:
        if i not in reg:
            assign(i)
    epoch = -1
    for e, s, w, pair in order:
        while epoch < e:
            epoch += 1
            own = [[] for _ in streams]
            for v in to_all.get(epoch, ()):
                r = reg[v]
                if holder[r] == v or (holder[r] < 0 and not pooled[r]):
                    holder[r] = -1
                    pooled[r] = True
                    heapq.heappush(pool, r)
        for x in pair:
            assign(ops[x][1], w, s)
        for v in to_own.get((e, w, s), ()):
            r = free(v)
            if r is not None:
                own[w].append((s + 1, r))
    return reg, len(holder)


def compile_program(tf: TraceField, in_ids: Tensor, out_ids: Tensor,
                    warps: int = WARPS) -> Program:
    """Schedule the recorded ops that the outputs need onto `warps` warps
    in epochs and allocate registers (see the module docstring)."""
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
    streams, nepochs = _schedule(ops, warps)
    reg, nregs = _registers(ops, streams, ins, consts, outs)
    trash = nregs  # the padding ops' destination: a register of its own
    nregs += 1
    if nregs > 0xFFFF:
        raise ValueError("program needs more than 65535 registers")

    def words(i, flag):
        k, o, a, b = ops[i]
        return [k | flag | reg[o] << 8, reg[a] | reg[b] << 16]

    starts, body = [0], []
    for stream in streams:
        by_epoch: Dict[int, list] = {}
        for e, i, j in stream:
            by_epoch.setdefault(e, []).append((i, j))
        for e in range(nepochs):
            steps = by_epoch.get(e, [None])
            for n, step in enumerate(steps):
                flag = BARRIER if n == len(steps) - 1 else 0
                if step is None:
                    body += [NOP | flag, 0, NOP | flag, 0]
                    continue
                i, j = step
                mine = words(i, flag)
                body += mine + (words(j, flag) if j is not None else
                                [mine[0] & 0xFF | trash << 8, mine[1]])
        starts.append(len(body) // 4)
    lists = ([reg[i] for i, _ in consts] + [reg[i] for i in ins]
             + [reg[i] for i in outs] + starts)
    header = [VERSION, nregs, warps, len(consts), len(ins), len(outs),
              len(body) // 4, nepochs]
    words_ = np.array(header + lists + [0] * (-(HEADER + len(lists)) % 4)
                      + body, dtype=np.int64)
    assert words_.max() < 2**31
    spec = tf.spec
    limbs = (np.stack([spec.from_int(v) for _, v in consts])
             if consts else np.zeros((0, spec.n), np.int32))
    depth: Dict[int, int] = {}
    for k, o, a, b in ops:
        depth[o] = max(depth.get(a, 0), depth.get(b, 0)) + (k == _KIND["mul"])
    per_warp = np.diff(starts)
    stats = {"ops": len(ops),
             "by_kind": {k: sum(op[0] == _KIND[k] for op in ops)
                         for k in KINDS},
             "mul_depth": max(depth.values(), default=0),
             "epochs": nepochs, "warps": warps,
             "steps_per_warp": {"max": int(per_warp.max()),
                                "mean": float(per_warp.mean())},
             "registers": nregs}
    return Program(words_.astype(np.int32), limbs.astype(np.int32), stats)


def run_program(prog: Program, field, inputs: Tensor, order=None) -> Tensor:
    """Execute a program on a (B, inputs, n) int32 tensor with a
    FieldSpec-like field, reading and writing a (registers, B, n)
    register file as the kernel walks the same table: epoch by epoch,
    each warp's steps of the epoch in turn, one field call a step.  The
    warps of an epoch run in `order`: None (0 first), "reverse", or an
    int seeding a shuffle per epoch; a schedule that let a warp read
    another's value of the same epoch would give different results.
    Returns (B, outputs, n)."""
    batch, n = inputs.shape[0], inputs.shape[-1]
    regs = torch.zeros((prog.nregs, batch, n), dtype=torch.int32,
                       device=inputs.device)
    regs[torch.as_tensor(prog.const_regs, dtype=torch.long)] = torch.as_tensor(
        prog.consts, device=inputs.device)[:, None, :]
    regs[torch.as_tensor(prog.in_regs, dtype=torch.long)] = inputs.transpose(0, 1)
    rng = np.random.default_rng(order) if isinstance(order, int) else None
    ends = [np.flatnonzero(prog.barrier[int(prog.warp_start[w]):int(
        prog.warp_start[w + 1])]) + int(prog.warp_start[w])
        for w in range(prog.warps)]
    kind, dst = prog.kind[:, 0].tolist(), torch.as_tensor(prog.dst)
    a, b = torch.as_tensor(prog.a), torch.as_tensor(prog.b)
    for e in range(prog.nepochs):
        warps = list(range(prog.warps))
        if order == "reverse":
            warps.reverse()
        elif rng is not None:
            rng.shuffle(warps)
        for w in warps:
            lo = int(prog.warp_start[w]) if e == 0 else int(ends[w][e - 1]) + 1
            for s in range(lo, int(ends[w][e]) + 1):
                name = KINDS[kind[s]] if kind[s] != NOP else None
                if name is None:
                    continue
                x = regs[a[s]]
                if name in ("mul", "add", "sub"):
                    r = getattr(field, name)(x, regs[b[s]])
                elif name == "neg":
                    r = field.neg(x)
                else:
                    r = field.mul_small(x, int(name[5:]))
                regs[dst[s]] = r
    return regs[torch.as_tensor(prog.out_regs, dtype=torch.long)].transpose(0, 1)


# -- the three programs ----------------------------------------------------------

def _tower(spec):
    from .pairing import Tower  # pairing.py imports kernels, which imports us
    tf = TraceField(spec)
    return tf, Tower(tf)


def _miller(spec, warps) -> Program:
    """One pair's Miller loop: inputs px, py, qx (2), qy (2); outputs the
    conjugated Fq12 value (12)."""
    tf, tower = _tower(spec)
    px, py = tf.inputs(()), tf.inputs(())
    qx, qy = tf.inputs((2,)), tf.inputs((2,))
    f = tower.miller_loop(px, py, qx, qy)
    return compile_program(tf, torch.cat([t.reshape(-1) for t in
                                          (px, py, qx, qy)]), f, warps)


def _fq12_mul(spec, warps) -> Program:
    """x · y in Fq12: inputs x (12) then y (12); output 12."""
    tf, tower = _tower(spec)
    x, y = tf.inputs((2, 3, 2)), tf.inputs((2, 3, 2))
    return compile_program(tf, torch.cat([x.reshape(-1), y.reshape(-1)]),
                           tower.fq12.mul(x, y), warps)


def _final_exp(spec, warps) -> Program:
    """f^(3(p¹²−1)/r): input 12, output 12."""
    tf, tower = _tower(spec)
    f = tf.inputs((2, 3, 2))
    return compile_program(tf, f, tower.fq12.final_exponentiation(f),
                           warps)


def _fq_inv(spec, warps) -> Program:
    """A measuring program in final_exp_kernel's shape: element 0 of an
    Fq12 input inverted (x^(p−2): 489 dependent products and nothing
    else), the other 11 passed through.  Its time over 489 is one
    dependent product stage of the kernels at one lane."""
    tf, tower = _tower(spec)
    f = tf.inputs((12,))
    out = torch.cat([tf.inv(f[:1]), f[1:]])
    return compile_program(tf, f, out, warps)


def _fq_inv12(spec, warps) -> Program:
    """Twelve Fq inverses in final_exp_kernel's shape: each input element
    to x^(p−2) by FieldSpec.inv_chain's products, twelve independent
    chains of 489 (kernels.fq_inv packs a batch of elements twelve to a
    lane)."""
    tf, _ = _tower(spec)
    f = tf.inputs((12,))
    return compile_program(tf, f, tf.inv(f), warps)


#: Dependent ops in each measuring chain (the inversion's product stages).
CHAIN = 480


def _io(spec, warps) -> Program:
    """A measuring program in final_exp_kernel's shape with no op: the
    input passed through (the kernel's launch, loads and stores)."""
    tf, _ = _tower(spec)
    f = tf.inputs((12,))
    return compile_program(tf, f, f, warps)


def _add_chain(spec, warps) -> Program:
    """A measuring program in final_exp_kernel's shape: element 0 plus
    element 1, CHAIN times over (CHAIN dependent additions on one lane
    group), the other 11 passed through."""
    tf, _ = _tower(spec)
    f = tf.inputs((12,))
    x = f[:1]
    for _ in range(CHAIN):
        x = tf.add(x, f[1:2])
    return compile_program(tf, f, torch.cat([x, f[1:]]), warps)


def _add_wide(spec, warps) -> Program:
    """As _add_chain on 32 independent chains at once (one per lane
    group of a 512-thread block), summed into element 0 at the end."""
    tf, _ = _tower(spec)
    f = tf.inputs((12,))
    j = torch.arange(32)
    x = tf.add(f[j % 12], f[(j // 12 + j + 1) % 12])
    for _ in range(CHAIN):
        x = tf.add(x, f[1:2])
    while len(x) > 1:
        x = tf.add(x[0::2], x[1::2])
    return compile_program(tf, f, torch.cat([x, f[1:]]), warps)


_MAKERS = {"miller_product": _miller, "fq12_mul": _fq12_mul,
           "final_exp": _final_exp, "fq_inv": _fq_inv,
           "fq_inv12": _fq_inv12, "io": _io,
           "add_chain": _add_chain, "add_wide": _add_wide}


@functools.lru_cache(maxsize=None)
def program(name: str, spec, warps: int = WARPS) -> Program:
    """The named kernel's program for `spec` on `warps` warps (made once
    per process)."""
    return _MAKERS[name](spec, warps)
