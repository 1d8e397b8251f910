"""PyTorch port: the plain versions of the large-table kernels, the row
scatter-add (B18) and the in-place row write (B19), and the lane-block
plan of the lazy-Adam write-back, against the JAX package on the CPU.

The JAX side runs its Pallas kernels in interpret mode, as
tests/test_pallas_scatter_add.py and tests/test_rows_write.py do; the
port's wrappers are given CPU tensors and so run their plain versions.
Tolerances: the scatter-add sums in another order than the Pallas kernel,
rtol and atol 1e-5, and sums of small integers must come out exact; the
row write and the plan move values without arithmetic and must be exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from two_tower_models_tpu.nn import packed_table as jpt
from two_tower_models_tpu.ops.pallas import rows_write as jrw
from two_tower_models_tpu.ops.pallas import scatter_add as jsa
from two_tower_models_tpu_torch.nn import packed_table as tpt
from two_tower_models_tpu_torch.ops import rows_write as trw
from two_tower_models_tpu_torch.ops import scatter_add as tsa

_BIG = np.iinfo(np.int32).max


def _scatter_both(ids, rows, v, tile):
    want = np.asarray(jsa.rows_scatter_add(jnp.asarray(ids), jnp.asarray(rows), v, tile_v=tile))
    got = tsa.rows_scatter_add(torch.from_numpy(ids), torch.from_numpy(rows), v)
    assert got.shape == (v, rows.shape[1]) and got.dtype == torch.float32
    return got.numpy(), want


@pytest.mark.parametrize(
    "v,d,n,tile",
    [(300, 33, 777, 64), (512, 64, 100, 128), (64, 128, 4096, 64), (2048, 64, 0, 256)],
    ids=["unaligned", "sparse", "dense-collisions", "no-updates"],
)
def test_rows_scatter_add_matches_pallas(v, d, n, tile):
    r = np.random.default_rng(v + n)
    ids = r.integers(0, v, n).astype(np.int32)
    got, want = _scatter_both(ids, r.normal(size=(n, d)).astype(np.float32), v, tile)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("case", ["all-one-row", "tile-boundaries"])
def test_rows_scatter_add_exact_on_ones(case):
    """Every update on one row (1000 ones sum exactly), and ids on the
    Pallas kernel's tile boundaries."""
    if case == "all-one-row":
        v, d, tile = 128, 64, 64
        ids = np.full(1000, 7, np.int32)
    else:
        v, d, tile = 256, 64, 64
        ids = np.array([0, 63, 64, 127, 128, 191, 192, 255], np.int32)
    got, want = _scatter_both(ids, np.ones((ids.size, d), np.float32), v, tile)
    np.testing.assert_array_equal(got, want)
    if case == "all-one-row":
        assert got[7].min() == got[7].max() == 1000 and np.abs(got).sum() == 1000 * d


def test_rows_scatter_add_drops_out_of_range_ids():
    """Ids below 0 and at or past V land in no row, as in the Pallas
    kernel (its tiles cover [0, V) only)."""
    v, d = 100, 16
    r = np.random.default_rng(3)
    ids = np.array([-3, 0, 99, 100, 5, -1, 107, 5, 99, _BIG], np.int32)
    rows = r.normal(size=(ids.size, d)).astype(np.float32)
    got, want = _scatter_both(ids, rows, v, 64)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got[5], rows[4] + rows[7], rtol=1e-6)


def test_packed_rows_scatter_add_matches_jax():
    """The packed gradient (the logical view's scatter-add) against the JAX
    package's one-hot-widened physical rows: bit-equal, since the widening
    adds only zeros; logical ids past the table or below 0 are dropped."""
    vocab, d = 70, 32  # P = 4, 18 physical rows (two padding rows)
    rows_p, width = jpt.packed_shape(vocab, d)
    r = np.random.default_rng(4)
    ids = np.concatenate([r.integers(0, vocab, 60), [8, 9, 10, 11, 8, 71, 72, -2, 500]]).astype(np.int32)
    rows = r.normal(size=(ids.size, d)).astype(np.float32)
    want = np.asarray(jpt.packed_rows_scatter_add(jnp.asarray(ids), jnp.asarray(rows), rows_p, width))
    got = tpt.packed_rows_scatter_add(torch.from_numpy(ids), torch.from_numpy(rows), rows_p, width)
    assert got.shape == (rows_p, width)
    np.testing.assert_array_equal(got.numpy(), want)


def _write_both(dst, ids, bits, vals, d, tile):
    want = np.asarray(jrw.rows_write(jnp.asarray(dst), jnp.asarray(ids), jnp.asarray(bits),
                                     jnp.asarray(vals), block_dim=d, tile_v=tile))
    got = torch.from_numpy(dst.copy())
    out = trw.rows_write(got, torch.from_numpy(ids), torch.from_numpy(bits), torch.from_numpy(vals), d)
    assert out is got  # in place
    np.testing.assert_array_equal(got.numpy(), want)
    return got.numpy()


@pytest.mark.parametrize("v,w,n,tile", [(300, 128, 40, 64), (1000, 256, 100, 256)])
def test_rows_write_full_rows_match_pallas(v, w, n, tile):
    """Every lane block live; ids on the first and last row; untouched rows
    unchanged."""
    r = np.random.default_rng(v)
    dst = r.normal(size=(v, w)).astype(np.float32)
    ids = np.sort(np.unique(np.concatenate([r.choice(v, n, replace=False), [0, v - 1]]))).astype(np.int32)
    bits = np.full(ids.size, (1 << (w // 64)) - 1, np.int32)
    vals = r.normal(size=(ids.size, w)).astype(np.float32)
    got = _write_both(dst, ids, bits, vals, 64, tile)
    untouched = np.setdiff1d(np.arange(v), ids)
    np.testing.assert_array_equal(got[untouched], dst[untouched])


def test_rows_write_partial_lane_blocks_match_pallas():
    """Partner lane blocks of a physical row survive a masked write."""
    v, w, d = 128, 128, 32  # 4 lane blocks a row
    r = np.random.default_rng(2)
    dst = r.normal(size=(v, w)).astype(np.float32)
    ids = np.array([3, 17, 81, 90], np.int32)
    bits = np.array([0b0001, 0b1010, 0b0100, 0b1111], np.int32)
    vals = r.normal(size=(4, w)).astype(np.float32)
    got = _write_both(dst, ids, bits, vals, d, 64)
    np.testing.assert_array_equal(got[3, d:], dst[3, d:])
    np.testing.assert_array_equal(got[3, :d], vals[0, :d])


@pytest.mark.parametrize("case", ["dead-slots", "no-updates"])
def test_rows_write_drops_dead_slots(case):
    """Slots past the table, and slots with no live lane block sharing a
    live slot's row (merge_lane_blocks' no-ops), write nothing."""
    v, w = 200, 128
    r = np.random.default_rng(5)
    dst = r.normal(size=(v, w)).astype(np.float32)
    if case == "dead-slots":
        ids = np.array([5, 5, 60, _BIG, _BIG], np.int32)
        bits = np.array([1, 0, 3, 0, 0], np.int32)
        vals = np.ones((5, w), np.float32)
    else:
        ids = np.full(8, _BIG, np.int32)
        bits = np.zeros(8, np.int32)
        vals = np.zeros((8, w), np.float32)
    got = _write_both(dst, ids, bits, vals, 64, 128)
    if case == "no-updates":
        np.testing.assert_array_equal(got, dst)


_PLAN_IDS = np.array([0, 1, 1, 8, 9, 30, 30, 31, 40, 40, 40, 43, 63], np.int32)


@pytest.mark.parametrize("pack", [2, 4])
def test_lane_block_plan_and_merge_match_jax(pack):
    """Duplicates, partners sharing a physical row, and a lone id: the plan
    (physical ids, lane bitmasks, partner positions, found flags, keep) and
    the merged rows equal the JAX functions'; merged and written, they equal
    a logical write with duplicates dropped."""
    d = 128 // pack
    s = _PLAN_IDS
    dup = np.concatenate([[False], s[1:] == s[:-1]])
    rows = np.random.default_rng(pack).normal(size=(s.size, d)).astype(np.float32)
    j_plan = jrw.lane_block_plan(jnp.asarray(s), jnp.asarray(dup), pack)
    t_plan = trw.lane_block_plan(torch.from_numpy(s), torch.from_numpy(dup), pack)
    for name, a, b in zip(("phys", "bits", "pos", "found", "keep"), t_plan, j_plan):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)
    want = np.asarray(jrw.merge_rows(j_plan, jnp.asarray(s), jnp.asarray(rows)))
    got = trw.merge_rows(t_plan, torch.from_numpy(s), torch.from_numpy(rows))
    np.testing.assert_array_equal(got.numpy(), want)

    table = np.random.default_rng(10 + pack).normal(size=(64 // pack, 128)).astype(np.float32)
    out = trw.rows_write(torch.from_numpy(table.copy()), t_plan[0], t_plan[1], got, d)
    logical = table.reshape(64, d).copy()
    logical[s[~dup]] = rows[~dup]
    np.testing.assert_array_equal(out.numpy(), logical.reshape(table.shape))


def test_merge_lane_blocks_partner_behind_duplicates():
    """A partner's first slot far behind the other id's duplicates: the
    merged row holds both, at the run's first slot only."""
    ids = np.array([8, 8, 8, 8, 9], np.int32)
    dup = np.array([0, 1, 1, 1, 0], bool)
    rows = np.arange(5 * 64, dtype=np.float32).reshape(5, 64)
    want = jrw.merge_lane_blocks(jnp.asarray(ids), jnp.asarray(dup), jnp.asarray(rows), 2)
    got = trw.merge_lane_blocks(torch.from_numpy(ids), torch.from_numpy(dup), torch.from_numpy(rows), 2)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(got[0].numpy(), [4] * 5)
    assert int(got[1][0]) == 0b11 and not got[1][1:].any()
    np.testing.assert_array_equal(got[2][0].numpy(), np.concatenate([rows[0], rows[4]]))
