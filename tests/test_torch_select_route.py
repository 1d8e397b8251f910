"""PyTorch port: the routes of the top-k select (B3) and the one-launch
lazy-Adam write-back (B19), on the CPU.

``ops.mips_topk._select_route`` sends k <= ``K_MAX`` to the radix select
and larger k to the tournament; its choice is checked at both serving
passes, at the edges and on the leaves of a hierarchical select.  The
radix kernel's algorithm (csrc/select_topk.cu: 8-bit digit histograms
from the top, the early stop, the ties taken in position order, the
survivors ranked) is emulated in numpy and held to ``select_keys_plain``
and to the JAX package's ``select_topk_t`` exactly, on the cases that
could break it; the kernel itself is held to the plain version on the
card (tests/test_torch_cuda_kernels.py).

``ops.rows_write.rows_write_many`` on CPU tensors equals the JAX
package's ``rows_write`` (Pallas, interpret mode) applied to each array in
turn, and ``apply_sparse_adam`` through it equals the JAX package's on
packed tables, with one call for a table and its two moments: a lazy step
makes one call a table.  Values move without arithmetic in the writes, so
they must be exact; the Adam arithmetic runs in f32 on both sides, at
1e-6 of each array's largest magnitude.
"""

from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from two_tower_models_tpu import config as jcfg
from two_tower_models_tpu.ops.pallas import mips_topk as jmt
from two_tower_models_tpu.ops.pallas import rows_write as jrw
from two_tower_models_tpu.training import sparse_tables as jsparse
from two_tower_models_tpu_torch import config as tcfg
from two_tower_models_tpu_torch.ops import mips_topk as mt
from two_tower_models_tpu_torch.ops import rows_write as rw
from two_tower_models_tpu_torch.training import sparse_tables as tsparse

_INT_MIN, _INT_MAX = np.iinfo(np.int32).min, np.iinfo(np.int32).max


@pytest.mark.parametrize("n,k,want", [
    (8192, 100, "radix"),  # pass 2 of the serving batch: NT = 2^20 / 128
    (12800, 100, "radix"),  # pass 4: k * TILE candidates
    (4096, mt.K_MAX, "radix"),
    (4096, mt.K_MAX + 1, "tournament"),
    (1, 1, "radix"),
    (mt.SELECT_MAX_ROWS, 100, "radix"),  # a hierarchical leaf
    (mt.SELECT_MAX_ROWS, 256, "radix"),
    (mt.SELECT_MAX_ROWS, 257, "tournament"),  # 8 KB of survivors past the row
])
def test_select_route(n, k, want):
    assert mt._select_route(n, k) == want


def test_hierarchical_leaves_take_the_radix_route():
    """A row longer than SELECT_MAX_ROWS: every chunk and the merge of the
    survivors go through ``_select_leaf`` at a radix shape, and the result
    is the flat top-k."""
    x = torch.from_numpy((np.round(np.random.default_rng(1).normal(size=(2, 1 << 17)) * 4) / 4)
                         .astype(np.float32))
    leaves = []
    real = mt._select_leaf

    def spy(part, k, is_f32):
        leaves.append((part.shape[1], k))
        return real(part, k, is_f32)

    with mock.patch.object(mt, "_select_leaf", spy):
        keys, pos = mt.select_rows(x, 100)
    assert leaves == [(mt.SELECT_MAX_ROWS, 100), (mt.SELECT_MAX_ROWS, 100),
                      ((1 << 17) - 2 * mt.SELECT_MAX_ROWS, 100), (300, 100)]
    assert all(mt._select_route(n, k) == "radix" for n, k in leaves)
    wk, wp = mt.select_keys_plain(mt.f32_keys(x).clamp_min(_INT_MIN + 1), 100)
    assert torch.equal(keys, wk) and torch.equal(pos, wp)


def radix_select_emulated(keys: np.ndarray, k: int):
    """select_radix_kernel on one row of int32 keys, step for step:
    (keys [k], positions [k], histogram passes, stopped early)."""
    u = (keys.astype(np.int64) & 0xFFFFFFFF) ^ 0x80000000
    prefix, krem, shift, passes = 0, k, 24, 0
    while True:
        passes += 1
        on = ((u ^ prefix) >> (shift + 8)) == 0
        hist = np.bincount((u[on] >> shift) & 255, minlength=256)
        above, b = 0, 255
        while above + hist[b] < krem:  # the bins summed from the top
            above += hist[b]
            b -= 1
        prefix |= b << shift
        krem -= above
        exact = hist[b] == krem
        if exact or shift == 0:
            break
        shift -= 8
    lo, need_eq = (prefix, 0) if exact else (prefix + 1, krem)
    # compaction: the keys above the threshold in any order (the rank sort
    # orders them), the ties to T in position order (the warps' runs are
    # contiguous and in order), the first need_eq taken
    gt = np.random.default_rng(k).permutation(np.nonzero(u >= lo)[0])
    eq = np.nonzero(u == prefix)[0][:need_eq]
    pos = np.concatenate([gt, eq])
    assert pos.size == k
    comp = (u[pos].astype(np.uint64) << np.uint64(32)) | (0xFFFFFFFF - pos).astype(np.uint64)
    rank = (comp[None, :] > comp[:, None]).sum(axis=1)
    assert sorted(rank.tolist()) == list(range(k))  # all distinct
    out_u, out_p = np.empty(k, np.int64), np.empty(k, np.int64)
    out_u[rank], out_p[rank] = u[pos], pos
    return ((out_u ^ 0x80000000).astype(np.uint32).view(np.int32), out_p.astype(np.int32),
            passes, bool(exact))


def _select_case(name):
    """(rows [R, n], k, f32 scores or int32 keys)."""
    r = np.random.default_rng(sum(map(ord, name)))
    if name == "pass2":
        return r.normal(size=(2, 8192)).astype(np.float32), 100, True
    if name == "pass4-ties":
        return (np.round(r.normal(size=(2, 12800)) * 2) / 2).astype(np.float32), 100, True
    if name == "all-equal":
        return np.full((2, 3000), 0.25, np.float32), 100, True
    if name == "k-equals-n":
        return r.normal(size=(2, 700)).astype(np.float32), 700, True
    if name == "n1":
        return np.array([[-2.5], [np.nan]], np.float32), 1, True
    if name == "ragged":  # n not a multiple of the 512-thread block
        return (np.round(r.normal(size=(3, 1001)) * 3) / 3).astype(np.float32), 37, True
    if name == "nan-inf":
        x = r.normal(size=(2, 300)).astype(np.float32)
        x[:, 200:] = np.uint32(0xFFFFFFFF).view(np.float32)  # clamps to INT_MIN + 1
        x[:, 7], x[:, 8], x[:, 9] = np.inf, np.nan, -np.inf
        x[1, :50] = -0.0
        return x, 120, True
    if name == "int-extremes":
        x = r.integers(-4, 4, size=(2, 2500)).astype(np.int32)
        x[:, ::5], x[:, 3], x[1, 100:] = _INT_MIN, _INT_MAX, _INT_MIN
        return x, 200, False
    if name == "ties-across-warps":  # the 215 ties of T taken span 14 warps' runs
        x = np.zeros((1, 8192), np.float32)
        x[0, ::31] = 0.5
        x[0, ::97] = 1.0
        return x, 300, True
    if name == "k-max":
        return r.normal(size=(1, 4096)).astype(np.float32), mt.K_MAX, True
    raise ValueError(name)


_CASES = ["pass2", "pass4-ties", "all-equal", "k-equals-n", "n1", "ragged", "nan-inf",
          "int-extremes", "ties-across-warps", "k-max"]


@pytest.mark.parametrize("name", _CASES)
def test_radix_select_algorithm_matches_plain(name):
    x, k, is_f32 = _select_case(name)
    keys = mt.f32_keys(torch.from_numpy(x)).clamp_min(_INT_MIN + 1) if is_f32 else torch.from_numpy(x)
    wk, wp = mt.select_keys_plain(keys, k)
    for row in range(x.shape[0]):
        gk, gp, passes, exact = radix_select_emulated(keys[row].numpy(), k)
        np.testing.assert_array_equal(gk, wk[row].numpy())
        np.testing.assert_array_equal(gp, wp[row].numpy())
        if name == "all-equal":  # every digit to the end, the lowest k positions
            assert passes == 4 and not exact and gp.tolist() == list(range(k))


@pytest.mark.parametrize("name", ["nan-inf", "ragged"])
def test_radix_select_algorithm_matches_pallas(name):
    """The emulation against the JAX package's select_topk_t (Pallas,
    interpret mode) on f32 scores, keys and positions bit for bit; the JAX
    kernel's rows padded to a multiple of 8 with -inf, below the top k."""
    x, k, _ = _select_case(name)
    xt = np.pad(x.T, ((0, (-x.shape[1]) % 8), (0, 0)), constant_values=-np.inf)
    jv, ji = jmt.select_topk_t(jnp.asarray(xt), k)
    jkeys = mt.f32_keys(torch.from_numpy(np.ascontiguousarray(np.asarray(jv).T)))
    for row in range(x.shape[0]):
        keys = mt.f32_keys(torch.from_numpy(x[row])).clamp_min(_INT_MIN + 1).numpy()
        gk, gp, _, _ = radix_select_emulated(keys, k)
        np.testing.assert_array_equal(gp, np.asarray(ji)[:, row])
        np.testing.assert_array_equal(gk, jkeys[row].clamp_min(_INT_MIN + 1).numpy())


def _write_stream(pack, n_logical, vocab, seed, n_arrays):
    """A lazy-Adam write-back for a packed [vocab / P, 128] table and its
    moments: one plan (sorted logical ids with duplicates, merged into
    physical rows), a merged value array per destination."""
    d = 128 // pack
    r = np.random.default_rng(seed)
    s = torch.from_numpy(np.sort(r.integers(0, vocab, n_logical)).astype(np.int32))
    dup = torch.cat([torch.zeros(1, dtype=torch.bool), s[1:] == s[:-1]])
    plan = rw.lane_block_plan(s, dup, pack)
    vals = [rw.merge_rows(plan, s, torch.from_numpy(r.normal(size=(n_logical, d)).astype(np.float32)))
            for _ in range(n_arrays)]
    dsts = [r.normal(size=(vocab // pack, 128)).astype(np.float32) for _ in range(n_arrays)]
    return dsts, plan[0], plan[1], vals, d


@pytest.mark.parametrize("pack,n,vocab,n_arrays", [(2, 300, 1024, 3), (4, 500, 256, 3),
                                                   (8, 40, 512, 2), (2, 64, 4096, 1)])
def test_rows_write_many_matches_pallas_per_array(pack, n, vocab, n_arrays):
    """rows_write_many's plain path against the JAX rows_write applied to
    each array in turn, exactly; every array written in place."""
    dsts, pids, bits, vals, d = _write_stream(pack, n, vocab, pack + n, n_arrays)
    got = [torch.from_numpy(a.copy()) for a in dsts]
    out = rw.rows_write_many(got, pids, bits, vals, d)
    assert all(o is g for o, g in zip(out, got))
    for dst, v, g in zip(dsts, vals, got):
        want = jrw.rows_write(jnp.asarray(dst), jnp.asarray(pids.numpy().astype(np.int32)),
                              jnp.asarray(bits.numpy()), jnp.asarray(v.numpy()), block_dim=d)
        np.testing.assert_array_equal(g.numpy(), np.asarray(want))


def test_rows_write_many_dead_slots_and_nan():
    """Dead slots (bits 0, ids past the table) write nothing in any array;
    a NaN in a live lane's old or new value comes out NaN, a NaN in a dead
    lane stays, as in the JAX rows_write."""
    v, w, d = 64, 128, 64
    r = np.random.default_rng(3)
    dsts = [r.normal(size=(v, w)).astype(np.float32) for _ in range(3)]
    dsts[0][3, 5] = dsts[2][9, 100] = np.nan
    ids = np.array([3, 3, 9, 40, _INT_MAX, -1], np.int32)
    bits = np.array([0b01, 0, 0b01, 0b11, 0b11, 0b01], np.int32)
    vals = [r.normal(size=(ids.size, w)).astype(np.float32) for _ in range(3)]
    vals[1][2, 7] = np.nan
    got = rw.rows_write_many([torch.from_numpy(a.copy()) for a in dsts], torch.from_numpy(ids),
                             torch.from_numpy(bits), [torch.from_numpy(a) for a in vals], d)
    for dst, val, g in zip(dsts, vals, got):
        want = np.asarray(jrw.rows_write(jnp.asarray(dst), jnp.asarray(ids), jnp.asarray(bits),
                                         jnp.asarray(val), block_dim=d, tile_v=64))
        np.testing.assert_array_equal(g.numpy(), want)
    assert bool(got[0][3, 5].isnan() & got[1][9, 7].isnan() & got[2][9, 100].isnan())


def test_rows_write_many_rejects_what_the_kernel_does_not_take():
    z = torch.zeros(4, 128)
    ids, bits = torch.zeros(2, dtype=torch.int64), torch.ones(2, dtype=torch.int32)
    with pytest.raises(ValueError):
        rw.rows_write_many([z] * 4, ids, bits, [torch.zeros(2, 128)] * 4, 64)
    with pytest.raises(ValueError):
        rw.rows_write_many([z, z.clone()], ids, bits, [torch.zeros(2, 128)], 64)


@pytest.mark.parametrize("pack", [2, 8])
def test_apply_sparse_adam_matches_jax_in_one_write_a_table(pack):
    """One lazy-Adam update of a packed table against the JAX package's:
    table, mu and nu at 1e-6 of their scale, written back by one
    rows_write_many call for the three arrays."""
    d, vocab, n = 128 // pack, 64 * pack, 50
    r = np.random.default_rng(pack)
    ids = np.sort(np.concatenate([r.integers(0, vocab, n - 4), [0, 0, 1, vocab - 1]])).astype(np.int32)
    dup = np.concatenate([[False], ids[1:] == ids[:-1]])
    table = r.normal(size=(vocab // pack, 128)).astype(np.float32)
    mu = (r.normal(size=table.shape) * 1e-3).astype(np.float32)
    nu = (r.uniform(0.5, 1.5, table.shape) * 1e-6).astype(np.float32)
    mini = table.reshape(vocab, d)[ids]
    g = np.where(dup[:, None], 0.0, r.normal(size=(n, d))).astype(np.float32)
    want = jsparse.apply_sparse_adam(
        jnp.asarray(table), jnp.asarray(mu), jnp.asarray(nu), jnp.asarray(mini), jnp.asarray(g),
        jnp.asarray(ids), jnp.asarray(dup), jnp.asarray(4, jnp.int32),
        jcfg.TrainConfig(learning_rate=1e-3))
    calls = []
    real = tsparse.rows_write_many

    def spy(dsts, *a, **kw):
        calls.append(len(dsts))
        return real(dsts, *a, **kw)

    t = lambda a: torch.from_numpy(a.copy())
    with mock.patch.object(tsparse, "rows_write_many", spy):
        got = tsparse.apply_sparse_adam(t(table), t(mu), t(nu), t(mini), t(g), t(ids), t(dup),
                                        torch.tensor(4), tcfg.TrainConfig(learning_rate=1e-3))
    assert calls == [3]
    for a, e in zip(got, want):
        e = np.asarray(e)
        np.testing.assert_allclose(a.numpy(), e, rtol=0, atol=1e-6 * float(np.abs(e).max()))


def test_lazy_step_writes_each_table_in_one_call():
    """A lazy-Adam training step on packed tables calls rows_write_many
    once a table (user and item), three arrays each: on the card, two B19
    launches a step."""
    from two_tower_models_tpu_torch.training.data import make_synthetic_data
    from two_tower_models_tpu_torch.training.state import create_train_state
    from two_tower_models_tpu_torch.training.step import make_train_step

    cfg = tcfg.ModelConfig(
        user_id_hash_size=256, user_id_embedding_dim=16, item_id_hash_size=256,
        item_id_embedding_dim=16, user_features_size=8, item_features_size=8,
        feature_hidden_dim=32, history_len=8,
        history_encoder=tcfg.HistoryEncoderConfig(num_heads=2, num_layers=1)).validate()
    train_cfg = tcfg.TrainConfig(batch_size=16, lazy_table_adam=True, pack_tables_min_rows=0)
    state = create_train_state(0, cfg, train_cfg, device="cpu")
    data = make_synthetic_data(tcfg.DataConfig(num_samples=32, num_users=256, num_items=256,
                                               feature_dim=8, history_len=8), device="cpu")
    calls = []
    real = tsparse.rows_write_many

    def spy(dsts, *a, **kw):
        calls.append(len(dsts))
        return real(dsts, *a, **kw)

    with mock.patch.object(tsparse, "rows_write_many", spy):
        state, metrics = make_train_step(cfg, train_cfg)(state, data, torch.arange(16))
    assert calls == [3, 3]
    assert all(bool(torch.isfinite(v).all()) for v in metrics.values())
