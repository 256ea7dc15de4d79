"""The port's native packing plane (``data/native.py`` over
``csrc/dataplane.cpp``) against the JAX package's: the native rows equal
JAX's native rows exactly, the Python twin's rows equal JAX's
``use_native=False`` rows exactly, and ``greedy_knapsack`` equals JAX's on
both paths.  A build that cannot run raises with the reason, and nothing
falls back to the Python twin by itself."""

import os

import numpy as np
import pytest

from iadr1_tpu import native as jax_native
from iadr1_tpu.data.packing import greedy_knapsack as jax_knapsack
from iadr1_tpu.data.packing import pack_examples as jax_pack
from iadr1_tpu_torch.data import native
from iadr1_tpu_torch.data.packing import greedy_knapsack, pack_examples
import torch_threads  # noqa: F401  (one intra-op thread)

KEYS = ("input_ids", "labels", "segment_ids", "position_ids")


def _examples(n, lo, hi, seed, extras=True):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        k = int(rng.integers(lo, hi))
        ids = rng.integers(1, 1000, k).tolist()
        labels = list(ids)
        labels[:k // 2] = [-100] * (k // 2)
        ex = {"input_ids": ids, "labels": labels}
        if extras:
            ex["extras"] = {"i": i}
        out.append(ex)
    return out


def _rows_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for key in KEYS:
            assert g[key].dtype == np.int32
            np.testing.assert_array_equal(g[key], np.asarray(w[key]),
                                          err_msg=key)
        assert g["extras"] == w["extras"]


@pytest.fixture(scope="module")
def jax_lib():
    lib = jax_native.load()
    assert lib is not None, "the JAX package's native library did not load"
    return lib


CASES = [(60, 4, 60, 128, 0), (300, 1, 200, 256, 1), (40, 100, 129, 128, 2),
         (200, 16, 4097, 4096, 3)]


@pytest.mark.parametrize("n,lo,hi,cutoff,seed", CASES)
def test_native_rows_equal_jax_native_rows(jax_lib, n, lo, hi, cutoff, seed):
    """Examples longer than the cutoff are dropped on both sides (the last
    case draws some), pad id 7 fills the tails."""
    examples = _examples(n, lo, hi, seed)
    got = pack_examples(examples, cutoff, 7)
    _rows_equal(got, jax_pack(examples, cutoff, 7, use_native=True))
    assert sum(len(r["extras"]) for r in got) == sum(
        len(ex["input_ids"]) <= cutoff for ex in examples)


@pytest.mark.parametrize("n,lo,hi,cutoff,seed", CASES)
def test_python_rows_equal_jax_python_rows(n, lo, hi, cutoff, seed):
    examples = _examples(n, lo, hi, seed)
    _rows_equal(pack_examples(examples, cutoff, 7, use_native=False),
                jax_pack(examples, cutoff, 7, use_native=False))


@pytest.mark.parametrize("n,lo,hi,cutoff,seed", CASES)
def test_native_rows_equal_the_python_twin(n, lo, hi, cutoff, seed):
    """Both take, among examples of one length, the last one left, so the
    two paths give the same rows, not just the same bins."""
    examples = _examples(n, lo, hi, seed, extras=seed % 2 == 0)
    _rows_equal(pack_examples(examples, cutoff, 0),
                pack_examples(examples, cutoff, 0, use_native=False))


def test_no_examples_pack_into_no_rows():
    assert pack_examples([], 64, 0) == []
    assert pack_examples([], 64, 0, use_native=False) == []


@pytest.mark.parametrize("seed", [0, 1])
def test_greedy_knapsack_equals_jax_on_both_paths(jax_lib, seed):
    rng = np.random.default_rng(seed)
    lengths = rng.integers(5, 300, 500).astype(np.int64)
    capacity = 512
    assert greedy_knapsack(lengths.tolist(), capacity) == jax_knapsack(
        lengths.tolist(), capacity)
    out = []
    for lib, mod in ((native.load(), native), (jax_lib, jax_native)):
        indices = np.zeros(len(lengths), np.int64)
        sizes = np.zeros(len(lengths), np.int64)
        n_bins = lib.greedy_knapsack(mod.as_i64(lengths), len(lengths),
                                     capacity, mod.as_i64(indices),
                                     mod.as_i64(sizes))
        out.append((n_bins, indices, sizes[:n_bins]))
    (n_got, idx_got, sz_got), (n_want, idx_want, sz_want) = out
    assert n_got == n_want == len(greedy_knapsack(lengths.tolist(),
                                                  capacity))
    np.testing.assert_array_equal(idx_got, idx_want)
    np.testing.assert_array_equal(sz_got, sz_want)


@pytest.fixture
def fresh_build(tmp_path, monkeypatch):
    """A build directory of its own and an empty cache of loaded
    libraries, so the next load must build."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "native")
    monkeypatch.setattr(native, "_libs", {})
    return tmp_path


def test_a_missing_compiler_fails_loudly(fresh_build, monkeypatch):
    empty = fresh_build / "empty_path"
    empty.mkdir()
    monkeypatch.setenv("PATH", str(empty))
    with pytest.raises(RuntimeError, match=r"no C\+\+ compiler"):
        native.load()
    with pytest.raises(RuntimeError, match=r"no C\+\+ compiler"):
        pack_examples(_examples(4, 2, 8, 0), 16, 0)
    # the caller's explicit choice of the twin still packs
    assert len(pack_examples(_examples(4, 2, 8, 0), 16, 0,
                             use_native=False)) >= 1


def test_a_failed_build_raises_with_the_compiler_log(fresh_build,
                                                     monkeypatch):
    bad = fresh_build / "bad.cpp"
    bad.write_text('extern "C" int greedy_knapsack( {\n')
    monkeypatch.setattr(native, "SOURCE", bad)
    with pytest.raises(RuntimeError, match="building bad.cpp failed") as e:
        native.load()
    assert "error" in str(e.value)
    assert not native.lib_path().exists()
    assert not list((fresh_build / "native").glob("*.tmp*"))


def test_the_library_is_built_once_and_rebuilt_when_its_source_is_newer(
        fresh_build, monkeypatch):
    src = fresh_build / "dataplane.cpp"
    src.write_text(native.SOURCE.read_text())
    monkeypatch.setattr(native, "SOURCE", src)
    assert native.build() > 0 and native.lib_path().exists()
    built = native.lib_path().stat().st_mtime
    assert native.start_build() is None          # fresh: nothing to do
    os.utime(src, (built + 10, built + 10))
    started = native.start_build()
    assert started is not None
    native.finish_build(started)
    assert native.lib_path().stat().st_mtime >= built
    assert native.load().greedy_knapsack is not None
