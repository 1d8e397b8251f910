"""PyTorch port: the plain versions of the three exact-MIPS kernels
(tile-max scoring, tournament select, gather-rescore) against the JAX
package's Pallas kernels on the CPU (interpret mode, as tests/test_mips.py
runs them).

Tile-max and rescore are f32 sums taken in another order: 1e-5.  The select
orders int32 keys, so it must agree exactly, tie order included.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import two_tower_models_tpu.ops.pallas.mips_topk as JM
import two_tower_models_tpu_torch.ops.mips_topk as TM


def _normal(seed, shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _pad_rows(x: np.ndarray, rows: int) -> np.ndarray:
    return np.pad(x, ((0, rows - x.shape[0]), (0, 0)))


@pytest.mark.parametrize("c,valid", [(4096, 3000), (4096, 4096), (4000, 4000)])
def test_tile_max_matches_pallas(c, valid):
    """Rows >= valid_count score -inf; a corpus that ends inside a tile
    (C=4000) is padded by the port itself and by the caller on the JAX side."""
    b, d, tile = 16, 32, 128
    corpus, query = _normal(1, (c, d)), _normal(2, (b, d))
    cp = _pad_rows(corpus, -(-c // 2048) * 2048)
    want = JM.tile_max_scores(jnp.asarray(query), jnp.asarray(cp), tile, valid)
    got = TM.tile_max_scores(torch.from_numpy(query), torch.from_numpy(corpus), tile, valid)
    nt = -(-c // tile)
    assert got.shape == (b, nt)
    want = np.asarray(want)[:, :nt]
    assert np.isneginf(want).any() == (valid < c)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_tile_max_propagates_nan_like_pallas():
    """A NaN row makes its tile's max NaN, as jnp.max does in the Pallas
    kernel; a NaN row at or past valid_count is masked to -inf."""
    b, c, d, tile, valid = 16, 4096, 32, 128, 3000
    corpus, query = _normal(3, (c, d)), _normal(4, (b, d))
    corpus[5, 7] = np.nan  # tile 0
    corpus[1000, :] = np.nan  # tile 7
    corpus[3500, 0] = np.nan  # padding, tile 27
    want = np.asarray(JM.tile_max_scores(jnp.asarray(query), jnp.asarray(corpus), tile, valid))
    got = TM.tile_max_scores(torch.from_numpy(query), torch.from_numpy(corpus), tile, valid).numpy()
    assert np.isnan(want[:, [0, 7]]).all() and not np.isnan(want[:, 27]).any()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("d", [32, 64])
def test_gather_rescore_matches_pallas(d):
    c, b, k, tile = 4096, 16, 5, 128
    corpus, query = _normal(3, (c, d)), _normal(4, (b, d))
    tidx = np.random.default_rng(5).integers(0, c // tile, size=(b, k)).astype(np.int32)
    want = JM.gather_rescore(jnp.asarray(query), jnp.asarray(corpus), jnp.asarray(tidx), tile)
    got = TM.gather_rescore(
        torch.from_numpy(query), torch.from_numpy(corpus), torch.from_numpy(tidx), tile
    )
    assert got.shape == (b, k * tile)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def _assert_select_equal(x: np.ndarray, k: int, x_jax_t: np.ndarray | None = None):
    """Port select_topk_t on x.T == JAX select_topk_t on x_jax_t (x.T, or
    x.T padded as the JAX kernel needs), bit for bit."""
    jt = x.T if x_jax_t is None else x_jax_t
    jv, ji = JM.select_topk_t(jnp.asarray(jt), k)
    tv, ti = TM.select_topk_t(torch.from_numpy(np.ascontiguousarray(x.T)), k)
    b = x.shape[0]
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji)[:, :b])
    np.testing.assert_array_equal(
        tv.numpy().view(np.int32), np.asarray(jv)[:, :b].view(np.int32)
    )
    return tv.numpy().T, ti.numpy().T


@pytest.mark.parametrize("nt,b,k", [(64, 8, 5), (256, 130, 16)])
def test_select_matches_pallas_with_ties(nt, b, k):
    x = np.round(_normal(6, (b, nt)) * 4) / 4  # many exact ties
    x[0] = 0.0  # an all-equal row: pure tie order
    spad = 0 if b <= 128 else (-b) % 128
    xt = np.pad(x.T, ((0, 0), (0, spad)), constant_values=-np.inf)
    _assert_select_equal(x, k, xt)


def test_select_signed_zero_total_order():
    """Every +0.0 ranks above every -0.0 (the case of tests/test_mips.py's
    test_select_topk_signed_zero_total_order)."""
    x = np.round(_normal(7, (16, 256)) * 2) / 2
    assert ((x == 0) & np.signbit(x)).any() and ((x == 0) & ~np.signbit(x)).any()
    v, _ = _assert_select_equal(x, 200)
    assert np.signbit(v[v == 0]).any()  # -0.0 survives the key round trip


def test_select_full_payload_negative_nan():
    """The f32 whose key is INT32_MIN (bits 0xFFFFFFFF) is clamped to
    INT32_MIN + 1, so picks stay distinct (tests/test_mips.py's
    test_select_topk_full_payload_negative_nan)."""
    k = 12
    x = _normal(8, (8, 64))
    x[:, 40:] = np.uint32(0xFFFFFFFF).view(np.float32)
    v, i = _assert_select_equal(x, k)
    assert all(len(set(r.tolist())) == k for r in i) and np.isfinite(v).all()
    allnan = np.full((8, 24), x[0, 40], np.float32)
    v, i = _assert_select_equal(allnan, 5)
    assert all(len(set(r.tolist())) == 5 for r in i)
    assert np.isnan(v).all() and (v.view(np.uint32) >> 31 == 1).all()


@pytest.mark.parametrize("nt,b,k", [(300, 16, 20), (265, 16, 20)])
def test_select_hierarchical_matches_pallas(monkeypatch, nt, b, k):
    """Rows longer than the kernel's shared-memory limit split into chunks
    and merge (265: a short tail chunk below k, padded survivors)."""
    monkeypatch.setattr(JM, "_SELECT_MAX_ROWS", 64)
    monkeypatch.setattr(TM, "SELECT_MAX_ROWS", 64)
    x = np.round(_normal(9, (b, nt)) * 2) / 2  # ties across chunk seams
    xt = np.pad(x.T, ((0, (-nt) % 8), (0, 0)), constant_values=-np.inf)
    _assert_select_equal(x, k, xt)


def test_key_map_round_trip_and_order():
    specials = np.asarray(
        [-np.inf, -1e38, -1.0, -1e-45, -0.0, 0.0, 1e-45, 1.0, 1e38, np.inf], np.float32
    )
    x = np.concatenate([specials, _normal(10, (4096,)) * 1e3])
    kt = TM.f32_keys(torch.from_numpy(x))
    np.testing.assert_array_equal(kt.numpy(), np.asarray(JM._f32_keys(jnp.asarray(x))))
    np.testing.assert_array_equal(TM.keys_f32(kt).numpy().view(np.int32), x.view(np.int32))
