"""The port's kernel build cache (consensus_overlord_tpu_torch/
compile_cache.py): the host namespace and its fingerprint, where the
kernel and native builds land, the build root from the environment and
its unwritable case, the LRU bound, the legacy prune, and the hit and
miss counts.  Nothing here builds a kernel or needs a card."""

import os

import pytest

from consensus_overlord_tpu_torch import compile_cache as cc
from consensus_overlord_tpu_torch.crypto import native
from consensus_overlord_tpu_torch.ops import kernels
from consensus_overlord_tpu_torch.ops.field import BLS12_381_FQ


@pytest.fixture
def root(tmp_path, monkeypatch):
    """A fresh build root from the environment, and a fingerprint that is
    computed anew."""
    path = tmp_path / "root"
    monkeypatch.setenv(cc.ENV_ROOT, str(path))
    monkeypatch.setattr(cc, "_fingerprint", None)
    return path


@pytest.mark.parametrize("reader", sorted(cc.READERS))
def test_each_fingerprint_input_changes_the_directory(root, monkeypatch,
                                                      reader):
    for name in cc.READERS:
        monkeypatch.setitem(cc.READERS, name, lambda name=name: f"fixed {name}")
    before = cc.build_dir()
    monkeypatch.setitem(cc.READERS, reader, lambda: "another")
    monkeypatch.setattr(cc, "_fingerprint", None)
    after = cc.build_dir()
    assert before != after
    assert os.path.dirname(before) == os.path.dirname(after) == str(root)
    assert os.path.basename(after) == f"host-{cc.host_fingerprint()}"


def test_a_missing_input_digests_as_a_fixed_word(root, monkeypatch):
    for name in cc.READERS:
        monkeypatch.setitem(cc.READERS, name, lambda: "")
    assert cc.fingerprint_inputs() == dict.fromkeys(cc.READERS, cc.MISSING)
    fp = cc.host_fingerprint()
    monkeypatch.setattr(cc, "_fingerprint", None)
    assert cc.host_fingerprint() == fp  # stable, and nothing raised


def test_the_fingerprint_is_computed_once(root, monkeypatch):
    calls = []
    monkeypatch.setitem(cc.READERS, "nvcc",
                        lambda: calls.append(1) or "release 12.4")
    cc.build_dir()
    cc.build_dir()
    kernels.header_dir(BLS12_381_FQ)
    assert calls == [1]


def test_the_readers_of_this_host_return_text():
    inputs = cc.fingerprint_inputs()
    assert list(inputs) == ["machine", "cpu", "gpu", "nvcc", "driver"]
    assert all(isinstance(v, str) and v for v in inputs.values())


def test_kernel_builds_land_under_build_dir(root):
    where = cc.build_dir()
    assert where.startswith(str(root) + os.sep)
    header = kernels.plan_header(BLS12_381_FQ)
    for lib in kernels.spec_libs(BLS12_381_FQ):
        assert os.path.dirname(kernels._so_path(lib, header)) == where
    assert kernels.header_dir(BLS12_381_FQ) == os.path.join(
        where, BLS12_381_FQ.name)


def test_native_build_lands_under_build_dir(root, monkeypatch):
    """The native pairing backend compiles into the namespace (the
    compiler is replaced by one that writes its -o file)."""
    def fake_cc(cmd, **kw):
        with open(cmd[cmd.index("-o") + 1], "wb") as f:
            f.write(b"\x7fELF")

    monkeypatch.setattr(native.subprocess, "run", fake_cc)
    so = native._build()
    assert os.path.dirname(so) == cc.build_dir()
    assert os.path.basename(so).startswith("bls381_")
    assert os.path.abspath(so) in cc.held()


def test_an_unwritable_root_raises(tmp_path, monkeypatch):
    blocker = tmp_path / "file"
    blocker.write_text("not a directory")
    monkeypatch.setenv(cc.ENV_ROOT, str(blocker / "root"))
    with pytest.raises(RuntimeError) as e:
        cc.build_dir()
    assert str(blocker / "root") in str(e.value)
    assert cc.ENV_ROOT in str(e.value)
    with pytest.raises(RuntimeError):
        kernels.header_dir(BLS12_381_FQ)


def _lib(where, name, size, age):
    path = os.path.join(where, name)
    with open(path, "wb") as f:
        f.write(b"\0" * size)
    os.utime(path, (1_000_000 + age, 1_000_000 + age))
    return path


def test_the_lru_keeps_the_bound_and_spares_held_and_tmp_files(root,
                                                               monkeypatch):
    where = cc.build_dir()
    monkeypatch.setattr(cc, "_held", set())
    oldest = _lib(where, "a_1.so", 100, 0)
    _lib(where, "a_1.so.log", 10, 0)
    held = _lib(where, "b_2.so", 100, 1)
    tmp = _lib(where, "c_3.so.77.tmp", 100, 2)
    middle = _lib(where, "d_4.so", 100, 3)
    newest = _lib(where, "e_5.so", 100, 4)
    cc.touch(held)
    os.utime(held, (1_000_001, 1_000_001))  # held, and still old
    monkeypatch.setattr(cc, "MAX_BYTES", 320)
    gone = cc.evict()
    assert gone == [oldest, middle]
    left = sorted(os.listdir(where))
    assert left == ["b_2.so", "c_3.so.77.tmp", "e_5.so"]
    assert sum(os.path.getsize(os.path.join(where, n)) for n in left) <= 320
    assert os.path.exists(tmp) and os.path.exists(newest)
    monkeypatch.setattr(cc, "MAX_BYTES", 0)
    assert cc.evict() == [newest]  # held and .tmp stay


def test_touch_stamps_and_holds(root, monkeypatch):
    monkeypatch.setattr(cc, "_held", set())
    path = _lib(cc.build_dir(), "f_6.so", 1, 0)
    cc.touch(path)
    assert os.path.getmtime(path) > 1_000_000 + 10
    assert cc.held() == {path}


@pytest.mark.parametrize("at_default", [True, False])
def test_the_legacy_prune_runs_only_at_the_default_root(tmp_path,
                                                        monkeypatch,
                                                        at_default):
    base = tmp_path / "_build"
    base.mkdir()
    flat = ["fq_mul_0123.so", "fq_mul_0123.so.log", "bls381_ab.so"]
    for name in flat + ["notes.txt"]:
        (base / name).write_text("x")
    (base / "host-old").mkdir()
    (base / "host-old" / "g1_point_1.so").write_text("x")
    monkeypatch.setattr(cc, "_fingerprint", None)
    monkeypatch.setattr(cc, "_pruned", set())
    if at_default:
        monkeypatch.delenv(cc.ENV_ROOT, raising=False)
        monkeypatch.setattr(cc, "DEFAULT_ROOT", str(base))
    else:
        monkeypatch.setenv(cc.ENV_ROOT, str(base))
    where = cc.build_dir()
    left = set(os.listdir(base))
    assert {"notes.txt", "host-old", os.path.basename(where)} <= left
    assert (set(flat) & left) == (set() if at_default else set(flat))
    assert os.listdir(base / "host-old") == ["g1_point_1.so"]


def test_hits_and_misses_are_counted_as_before(root, monkeypatch):
    """A library already built under its hash is a hit; one that must be
    compiled is a miss, counted before nvcc runs."""
    def no_nvcc():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(cc, "_STATS", {"hits": 0, "misses": 0})
    monkeypatch.setattr(cc, "_held", set())
    monkeypatch.setattr(kernels, "_nvcc", no_nvcc)
    header = kernels.plan_header(BLS12_381_FQ)
    so = kernels._so_path("fq_mul", header)
    with pytest.raises(RuntimeError, match="nvcc"):
        kernels._start_build("fq_mul", BLS12_381_FQ, header)
    assert cc.stats() == {"hits": 0, "misses": 1}
    open(so, "wb").close()
    assert kernels._start_build("fq_mul", BLS12_381_FQ, header) is None
    assert cc.stats() == {"hits": 1, "misses": 1}
    assert cc.held() == {os.path.abspath(so)}  # a hit is held at once
