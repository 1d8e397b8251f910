"""PyTorch port: the host hasher (``two_tower_models_tpu_torch.native``)
against the JAX package's, bit for bit.

The port's C++ path and its numpy fallback are each held against JAX's
``hash_ids`` and ``hash_strings`` on both of JAX's paths (its C++ library and
its fallback): uint64 keys at the edges (0, 1, 2^63, 2^64 - 1) and random,
strings of every tail length (0-17 bytes), non-ASCII ``str`` and raw
``bytes``, over table sizes 1, 7, 2^20 and 2^31 - 1 and the seeds 0 and the
ingest's two table seeds.  Then the shape rule, the ``TypeError`` on
non-string keys, where the library is built, and the fallback's visibility
when no compiler builds it.
"""

import shutil

import numpy as np
import pytest

from two_tower_models_tpu import native as jnative
from two_tower_models_tpu_torch import native

TABLES = [1, 7, 1 << 20, (1 << 31) - 1]
SEEDS = [0, 0xA11CE, 0xB0B]
PORT_BUILD = native.BUILD_DIR.resolve()


def _need_compiler():
    if not any(shutil.which(c) for c in native.COMPILERS):
        pytest.skip("no C++ compiler on this host: only the numpy fallback runs")


def _u64_keys():
    edges = np.array([0, 1, 1 << 63, (1 << 64) - 1], np.uint64)
    rand = np.random.default_rng(5).integers(0, 1 << 64, 2000, dtype=np.uint64, endpoint=False)
    return np.concatenate([edges, rand])


def _string_keys():
    text = "abcdefghijklmnopq"
    keys = [text[:n] for n in range(18)]  # every tail length, 0-7, over 0-2 whole words
    keys += ["héllo", "ключ", "鍵-🔑", "ü" * 9, "naïve café 🙂"]  # non-ASCII: UTF-8 bytes
    keys += [b"", b"\x00", b"\x00" * 8, b"\xff" * 9, bytes(range(17)), "sku-0000001".encode()]
    keys += [f"user:{i}" for i in range(150)]
    return keys


def _assert_all_equal(results: dict):
    ref_name, ref = next(iter(results.items()))
    for name, got in results.items():
        assert got.dtype == np.int32, name
        np.testing.assert_array_equal(got, ref, err_msg=f"{name} vs {ref_name}")


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("table", TABLES)
def test_u64_keys_match_jax(table, seed):
    _need_compiler()
    keys = _u64_keys()
    results = {
        "port cpp": native.hash_ids(keys, table, seed=seed),
        "port numpy": native.hash_ids(keys, table, seed=seed, force_fallback=True),
        "jax cpp": jnative.hash_ids(keys, table, seed=seed),
        "jax numpy": jnative.hash_ids(keys, table, seed=seed, force_fallback=True),
    }
    assert native.library_path() is not None and jnative.native_available()
    _assert_all_equal(results)
    got = results["port cpp"]
    assert got.min() >= 0 and got.max() < table
    if table > 7:  # not everything on one slot
        assert len(np.unique(got)) > len(keys) // 2


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("table", TABLES)
def test_string_keys_match_jax(table, seed):
    _need_compiler()
    keys = _string_keys()
    results = {
        "port cpp": native.hash_strings(keys, table, seed=seed),
        "port numpy": native.hash_strings(keys, table, seed=seed, force_fallback=True),
        "jax cpp": jnative.hash_strings(keys, table, seed=seed),
        "jax numpy": jnative.hash_strings(keys, table, seed=seed, force_fallback=True),
    }
    _assert_all_equal(results)
    got = results["port cpp"]
    assert got.shape == (len(keys),) and got.min() >= 0 and got.max() < table
    # a str key hashes as its UTF-8 bytes
    np.testing.assert_array_equal(
        native.hash_strings(["héllo", "鍵-🔑"], table, seed=seed),
        native.hash_strings(["héllo".encode(), "鍵-🔑".encode()], table, seed=seed),
    )


@pytest.mark.parametrize("fallback", [False, True], ids=["cpp", "numpy"])
def test_shape_kept_and_empty_input(fallback):
    _need_compiler()
    ids = np.arange(24, dtype=np.uint64).reshape(4, 6)
    out = native.hash_ids(ids, 128, seed=3, force_fallback=fallback)
    assert out.shape == (4, 6) and out.dtype == np.int32
    np.testing.assert_array_equal(out, jnative.hash_ids(ids, 128, seed=3))
    np.testing.assert_array_equal(out.reshape(-1), native.hash_ids(ids.reshape(-1), 128, seed=3))
    for got in (native.hash_ids(np.zeros((0,), np.uint64), 7, force_fallback=fallback),
                native.hash_strings([], 7, force_fallback=fallback)):
        assert got.shape == (0,) and got.dtype == np.int32


@pytest.mark.parametrize("fallback", [False, True], ids=["cpp", "numpy"])
@pytest.mark.parametrize("keys", [[3], ["a", 3], [b"a", None], [np.int64(7)]],
                         ids=["int", "str-int", "bytes-none", "np-int"])
def test_non_string_keys_raise_type_error(keys, fallback):
    with pytest.raises(TypeError) as want:
        jnative.hash_strings(keys, 128, force_fallback=fallback)
    with pytest.raises(TypeError) as got:
        native.hash_strings(keys, 128, force_fallback=fallback)
    assert str(got.value) == str(want.value)


def test_table_size_out_of_range_raises():
    for size in (0, -1, (1 << 31) + 1):
        with pytest.raises(ValueError, match="table_size"):
            native.hash_ids([1, 2], size)
        with pytest.raises(ValueError, match="table_size"):
            native.hash_strings(["a"], size)


def test_library_is_built_under_the_ports_build_dir():
    """The port compiles its own hashing.cpp into its own _build/, never
    beside the JAX package's source."""
    _need_compiler()
    assert native.native_available() and native.build_error() is None
    path = native.library_path().resolve()
    assert path.is_file() and path.parent.parent == PORT_BUILD
    assert path.parent.name.startswith("hashing-") and path == native._target().resolve()
    assert native._SRC.parent.name == "native" and native._SRC.parent.parent.name == (
        "two_tower_models_tpu_torch")
    assert "two_tower_models_tpu/" not in str(path) + "/"


def test_calls_count_the_path_taken():
    _need_compiler()
    native.reset_calls()
    native.hash_ids([1, 2, 3], 7)
    native.hash_strings(["a", "b"], 7)
    native.hash_strings(["a"], 7, force_fallback=True)
    assert native.calls == {"cpp": 2, "numpy": 1}
    native.reset_calls()
    assert not native.calls


def test_failed_build_is_visible_and_falls_back(monkeypatch, tmp_path):
    """No compiler builds the library: native_available() is False,
    build_error() holds why, every call takes (and counts) the numpy path
    and still gives JAX's slots."""
    for name, value in (("_lib", None), ("_lib_path", None), ("_error", None),
                        ("BUILD_DIR", tmp_path / "_build"),
                        ("COMPILERS", ("no-such-compiler-a", "no-such-compiler-b"))):
        monkeypatch.setattr(native, name, value)
    native.reset_calls()
    assert not native.native_available()
    assert "no-such-compiler-a: not found" in native.build_error()
    assert native.library_path() is None
    keys = ["sku-1", "sku-22", ""]
    np.testing.assert_array_equal(native.hash_strings(keys, 1 << 20, seed=0xB0B),
                                  jnative.hash_strings(keys, 1 << 20, seed=0xB0B))
    np.testing.assert_array_equal(native.hash_ids([5, 6], 99), jnative.hash_ids([5, 6], 99))
    assert native.calls == {"numpy": 2}


def test_compiler_error_is_kept(monkeypatch, tmp_path):
    """A compiler that runs and fails: its stderr is what build_error() says."""
    _need_compiler()
    bad = tmp_path / "broken.cpp"
    bad.write_text("this is not C++\n")
    for name, value in (("_lib", None), ("_lib_path", None), ("_error", None),
                        ("BUILD_DIR", tmp_path / "_build"), ("_SRC", bad)):
        monkeypatch.setattr(native, name, value)
    assert not native.native_available()
    assert "exit" in native.build_error() and "broken.cpp" in native.build_error()
    assert not list((tmp_path / "_build").rglob("*.so"))  # no partial library left
