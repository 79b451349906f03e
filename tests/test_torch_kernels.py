"""The build-time side of the port's CUDA kernels, on the CPU: the plan
header that ops/kernels.py generates from FieldSpec._plan, the build
path that hashes it, the lane group's split of the product terms, the
launch-size histogram, and chip_smoke.py's operation count and bound.  No GPU, no nvcc: nothing here builds."""

import re
from collections import Counter

import pytest

import chip_smoke
from consensus_overlord_tpu_torch.ops import kernels
from consensus_overlord_tpu_torch.ops.field import (BLS12_381_FQ as TFQ,
                                                    BLS12_381_P, FieldSpec)

_STEP = re.compile(r"FQ_STEP\((PAD|FOLD|CARRY), (\d+), (\d+), (\d+)\)")


def _header_plans(text):
    """Plan name → [(kind, arg, width before, width after)] parsed from
    the header's FQ_PLAN_<NAME>_STEPS X-macros."""
    plans = {}
    for block in text.split("#define FQ_PLAN_")[1:]:
        name = block.split("_STEPS", 1)[0].lower()
        plans[name] = [(k.lower(), int(a), int(wi), int(wo))
                       for k, a, wi, wo in _STEP.findall(block)]
    return plans


def test_plan_header_matches_field_plans_step_for_step():
    plans = _header_plans(kernels.plan_header(TFQ))
    assert list(plans) == list(kernels.PLAN_NAMES)
    for name in kernels.PLAN_NAMES:
        bounds = kernels.plan_bounds(TFQ, name)
        want = TFQ._plan(list(bounds))
        got = plans[name]
        assert [(k, a) for k, a, _, _ in got] == want, name
        width = len(bounds)
        for kind, arg, w_in, w_out in got:
            assert w_in == width
            width = TFQ.n if kind == "fold" else width + arg
            assert w_out == width <= kernels.FQ_MAXW
        assert width == TFQ.n


def test_plan_header_is_deterministic():
    text = kernels.plan_header(TFQ)
    fresh = FieldSpec(BLS12_381_P, limb_bits=10, name=TFQ.name)
    assert kernels.plan_header(fresh) == text
    rows = max(a for steps in _header_plans(text).values()
               for k, a, _, _ in steps if k == "fold")
    assert f"#define FQ_GEN_FOLD_ROWS {rows}\n" in text


def test_so_path_follows_the_plan_header():
    text = kernels.plan_header(TFQ)
    for lib in ("fq_mul", "g1_point"):
        path = kernels._so_path(lib, text)
        assert kernels._so_path(lib, text) == path
        assert kernels._so_path(lib, text + "// edited\n") != path
        assert path.startswith(kernels.BUILD_DIR)


@pytest.mark.parametrize("group", kernels.GROUP_SIZES)
def test_lane_group_terms_cover_every_term_once(group):
    L, W = kernels.group_layout(group)
    assert W >= TFQ.n + 1 and 2 * W >= kernels.FQ_MAXW
    n = TFQ.n
    threads = kernels.group_terms(group)
    assert len(threads) == group
    terms = Counter((i, j) for thread in threads for i, j, _ in thread)
    assert set(terms) == {(i, j) for i in range(n) for j in range(n)}
    assert set(terms.values()) == {1}  # every term exactly once
    for t, thread in enumerate(threads):
        assert all(col == i + j for i, j, col in thread)
        own = {t * L + s for s in range(L)} | {W + t * L + s
                                               for s in range(L)}
        assert {col for _, _, col in thread} <= own  # its own columns


def test_lane_ops_count_each_pipe():
    """chip_smoke.py's operation count: the product's 39² multiply-adds
    and every fold row's 39 on the multiply-add pipe, each carry pass's
    mask and shift-add on the ALU pipe."""
    def fold_imads(name):
        return TFQ.n * sum(a for k, a, _, _ in kernels.plan_steps(TFQ, name)
                           if k == "fold")

    mul_steps = kernels.plan_steps(TFQ, "mul")
    carried = sum(w for k, _, w, _ in mul_steps if k == "carry")
    ops = chip_smoke.lane_ops(TFQ)
    mul = TFQ.n * TFQ.n + fold_imads("mul")
    assert ops["fq_mul"] == {"imad": mul, "alu": ops["fq_mul"]["alu"],
                             "either": 0}
    assert 2 * carried - len(mul_steps) <= ops["fq_mul"]["alu"] < 2 * (
        carried + len(mul_steps))
    assert ops["g1_dbl"]["imad"] == 8 * mul + sum(
        fold_imads(p) for p in ("add2", "add2", "sub", "small8", "small12",
                                "small3", "small2"))
    assert ops["g1_dbl"]["either"] == 7 * TFQ.n  # its 7 limb-wise ops


# (imad, alu, either) per lane, bytes in all, and the limit that binds.
_LIMITS = [((6400, 10, 0), 0, "imad"),
           ((10, 6400, 0), 0, "alu"),
           ((6400, 6400, 6400), 0, "issue"),
           ((1, 1, 1), 1e9, "bytes")]


@pytest.mark.parametrize("ops, nbytes, limit", _LIMITS,
                         ids=[lim for _, _, lim in _LIMITS])
def test_bound_takes_the_slowest_limit(ops, nbytes, limit):
    lanes, clock = 1000, 1.5e9
    per_sm = chip_smoke.SMS * clock
    want_s = {"imad": lanes * ops[0] / (chip_smoke.IMAD_PER_CLOCK_PER_SM
                                        * per_sm),
              "alu": lanes * ops[1] / (chip_smoke.ALU_PER_CLOCK_PER_SM
                                       * per_sm),
              "issue": lanes * sum(ops) / (chip_smoke.ISSUE_PER_CLOCK_PER_SM
                                           * per_sm),
              "bytes": nbytes / chip_smoke.HBM_BYTES_PER_S}
    ms, by = chip_smoke.bound(dict(zip(("imad", "alu", "either"), ops)),
                              lanes, nbytes, clock)
    assert ms == pytest.approx(max(want_s.values()) * 1e3, rel=1e-12)
    assert max(want_s, key=want_s.get) == limit
    assert by == ("bytes" if limit == "bytes" else "operations")


def test_launch_sizes_histogram():
    k = kernels.Kernel("probe", "nowhere.cu", "nowhere.py:1")
    for lanes in (1, 2, 3, 8192, 8192, 8193, 24576):
        k.count(lanes)
    assert k.launches == 7
    assert k.sizes == {1: 1, 2: 1, 3: 1, 8192: 2, 8193: 1, 24576: 1}
    assert kernels.size_buckets(k.sizes) == {1: 1, 2: 1, 4: 1, 8192: 2,
                                             16384: 1, 32768: 1}
    with pytest.raises(ValueError, match="lane groups"):
        kernels.group_layout(32)
