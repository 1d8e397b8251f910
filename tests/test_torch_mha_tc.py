"""PyTorch port: what B13's and B14's tensor-core kernels rely on, on the
CPU.

``ops/fused_mha.py`` sends a layer to the tensor-core kernel or to the FMA
kernel by ``_fwd_route`` (B13) and ``_bwd_route`` (B14), functions of
dtype and shape alone, and sizes a tensor-core launch by ``_fwd_tc_plan``
and ``_bwd_tc_plan``; all are checked here without a card.  The kernels
pad each example's H rows with zero rows to Hp = round_up(H, 16) and mask
the padded keys, so the plain versions on x (and the backward's cotangent)
padded that way, with every length clipped to H, must give the layer and
its gradients on the H rows: held against the JAX package's
``fused_mha_layer`` and its VJP (its Pallas kernels in interpret mode, as
its own tests run them).  So is ``fused_mha_layer_f64_sums``, the
yardstick of the card's checks.

Tolerances, as ``tests/test_torch_fused_mha.py`` holds B13's and B14's
plain versions: f32 at 1e-5 of the output's largest magnitude; bf16 y
within one bf16 step of JAX's, value by value; bf16 dx at most 0.5% of its
values beyond one step, all within 1e-2 of scale; the f32 weight grads of
bf16 inputs within 1e-3 of scale.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from two_tower_models_tpu.ops.pallas import fused_mha as jfm
from two_tower_models_tpu_torch.ops import fused_mha as tfm
from two_tower_models_tpu_torch.ops.fused_encoder import _SMEM_LIMIT

_DT = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


@pytest.mark.parametrize("dtype,h,d,nh,route", [
    (torch.bfloat16, 32, 64, 4, "tc"),  # the cells' layer
    (torch.bfloat16, 64, 64, 4, "tc"),  # the longest history on the tensor cores
    (torch.bfloat16, 1, 64, 4, "tc"),
    (torch.bfloat16, 16, 128, 8, "tc"),  # D = 128: fewer examples a tile
    (torch.bfloat16, 16, 48, 3, "fma"),  # D not a multiple of 32
    (torch.float32, 32, 64, 4, "fma"),  # f32 stays f32 (TF32 would not match)
    (torch.bfloat16, 32, 32, 4, "fma"),  # head width 8
    (torch.bfloat16, 65, 64, 4, "fma"),  # Hp = 80, above the kernel's limit
    (torch.bfloat16, 256, 64, 4, "fma"),
], ids=["cell", "h64", "h1", "d128", "d48", "f32", "hd8", "h65", "h256"])
def test_fwd_route(dtype, h, d, nh, route):
    assert tfm._fwd_route(dtype, h, d, nh) == route


@pytest.mark.parametrize("b", [1, 1001, 4096])
@pytest.mark.parametrize("h,d,nh", [(32, 64, 4), (1, 64, 4), (10, 64, 1), (40, 64, 4),
                                    (12, 32, 2), (16, 128, 8), (64, 64, 4)])
def test_fwd_tc_plan(b, h, d, nh):
    """Every tensor-core shape: rows a tile a multiple of 32 (so of 16), the
    examples a tile times Hp; shared memory within a block's limit and the
    same as ``_fwd_tc_smem_bytes``; a grid of at least one block and at
    most one a tile, within two blocks an SM of 132 SMs."""
    assert tfm._fwd_route(torch.bfloat16, h, d, nh) == "tc"
    ept, rows, smem, grid = tfm._fwd_tc_plan(b, h, d, 132)
    hp = -(-h // 16) * 16
    assert ept >= 1 and rows == ept * hp and rows % 32 == 0 and rows <= 128
    assert smem == tfm._fwd_tc_smem_bytes(h, d, ept) <= _SMEM_LIMIT
    tiles = -(-b // ept)
    assert 1 <= grid <= min(tiles, 2 * 132)
    if (h, d) == (32, 64):  # the cells: 4 examples of 32 rows, two blocks an SM
        assert (ept, rows, smem) == (4, 128, 105472)
        assert grid == min(tiles, 264)


def _inputs(b, h, d, seed):
    r = np.random.default_rng(seed)
    lim_in, lim_out = np.sqrt(6.0 / (4 * d)), np.sqrt(6.0 / (2 * d))
    x = r.normal(size=(b, h, d)).astype(np.float32)
    w = [r.uniform(-lim_in, lim_in, (d, 3 * d)).astype(np.float32),
         r.uniform(-0.1, 0.1, (3 * d,)).astype(np.float32),
         r.uniform(-lim_out, lim_out, (d, d)).astype(np.float32),
         r.uniform(-0.1, 0.1, (d,)).astype(np.float32)]
    lens = r.integers(1, h + 1, size=(b,)).astype(np.int32)
    lens[0] = h
    return x, w, lens


def _bf16_steps(got: torch.Tensor, want) -> torch.Tensor:
    a = got.contiguous().view(torch.int16).int()
    e = torch.from_numpy(np.asarray(want).view(np.int16).astype(np.int32))
    key = lambda t: torch.where(t < 0, -(t & 0x7FFF), t)
    return (key(a) - key(e)).abs()


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("with_lens", [False, True], ids=["full", "lens"])
@pytest.mark.parametrize("h", [1, 10, 20, 40])
def test_zero_padded_rows_leave_the_layer_unchanged(dt, with_lens, h):
    """The plain version on x padded with zero rows to Hp, lengths clipped
    to H (H where there are none): its first H rows are the JAX layer on the
    H rows."""
    jdt, tdt = _DT[dt]
    b, d, nh = 3, 32, 2
    x, w, lens = _inputs(b, h, d, seed=100 + h)
    hp = -(-h // 16) * 16
    want = jfm.fused_mha_layer(jnp.asarray(x).astype(jdt), *map(jnp.asarray, w), nh,
                               lengths=jnp.asarray(lens) if with_lens else None)
    xp = np.zeros((b, hp, d), np.float32)
    xp[:, :h] = x
    lp = torch.from_numpy(np.clip(lens if with_lens else np.full(b, h, np.int32), 1, h))
    got = tfm.fused_mha_layer_plain(torch.from_numpy(xp).to(tdt), lp,
                                    *map(torch.from_numpy, w), nh)
    assert got.shape == (b, hp, d) and got.dtype == tdt
    got = got[:, :h]
    if dt == "f32":
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-5 * float(np.abs(want).max()))
    else:
        assert want.dtype == jnp.bfloat16
        assert int(_bf16_steps(got, want).max()) <= 1


@pytest.mark.parametrize("with_lens", [False, True], ids=["full", "lens"])
@pytest.mark.parametrize("h", [10, 32])
def test_f64_sums_yardstick_matches_pallas(with_lens, h):
    """``fused_mha_layer_f64_sums``, the yardstick the card's checks measure
    the plain version and the tensor-core kernel against: the layer at the
    same bf16 rounding points, so within one bf16 step of the JAX layer."""
    b, d, nh = 3, 32, 2
    x, w, lens = _inputs(b, h, d, seed=200 + h)
    lens = lens if with_lens else None
    want = jfm.fused_mha_layer(jnp.asarray(x).astype(jnp.bfloat16), *map(jnp.asarray, w), nh,
                               lengths=None if lens is None else jnp.asarray(lens))
    got = tfm.fused_mha_layer_f64_sums(torch.from_numpy(x).to(torch.bfloat16),
                                       None if lens is None else torch.from_numpy(lens),
                                       *map(torch.from_numpy, w), nh)
    assert got.dtype == torch.bfloat16 and int(_bf16_steps(got, want).max()) <= 1


@pytest.mark.parametrize("dtype,h,d,nh,route", [
    (torch.bfloat16, 32, 64, 4, "tc"),  # the cells' layer
    (torch.bfloat16, 1, 64, 4, "tc"),
    (torch.bfloat16, 10, 64, 4, "tc"),
    (torch.bfloat16, 40, 64, 4, "tc"),  # Hp = 48: two examples a tile
    (torch.bfloat16, 64, 64, 4, "tc"),  # the longest history: one example a tile
    (torch.bfloat16, 12, 32, 2, "tc"),  # D = 32
    (torch.float32, 32, 64, 4, "fma"),  # f32 stays f32 (TF32 would not match)
    (torch.bfloat16, 32, 32, 4, "fma"),  # head width 8
    (torch.bfloat16, 16, 48, 3, "fma"),  # D not a multiple of 32
    (torch.bfloat16, 65, 64, 4, "fma"),  # Hp = 80, above the kernel's limit
    (torch.bfloat16, 16, 128, 8, "fma"),  # D = 128: 256 grad sums a lane, beyond the registers
], ids=["cell", "h1", "h10", "h40", "h64", "d32", "f32", "hd8", "d48", "h65", "d128"])
def test_bwd_route(dtype, h, d, nh, route):
    assert tfm._bwd_route(dtype, h, d, nh) == route


@pytest.mark.parametrize("b", [1, 1001, 4096])
@pytest.mark.parametrize("h,d,nh", [(32, 64, 4), (1, 64, 4), (10, 64, 1), (40, 64, 4),
                                    (12, 32, 2), (64, 64, 4)])
def test_bwd_tc_plan(b, h, d, nh):
    """Every tensor-core backward shape: rows a tile a multiple of 32 (so
    of 16), the examples a tile times Hp, at most 128; shared memory within
    a block's limit and the same as ``_bwd_tc_smem_bytes``; a grid of at
    least one block and at most one a tile, within one block an SM of 132."""
    assert tfm._bwd_route(torch.bfloat16, h, d, nh) == "tc"
    ept, rows, smem, grid = tfm._bwd_tc_plan(b, h, d, 132)
    hp = -(-h // 16) * 16
    assert ept >= 1 and rows == ept * hp and rows % 32 == 0 and rows <= 128
    assert smem == tfm._bwd_tc_smem_bytes(h, d, ept) <= _SMEM_LIMIT
    tiles = -(-b // ept)
    assert 1 <= grid <= min(tiles, 132)
    if (h, d) == (32, 64):  # the cells: 4 examples of 32 rows, one block an SM
        assert (ept, rows, smem) == (4, 128, 201472)
        assert grid == min(tiles, 132)
    if h == 64:  # H = 64: one example (64 rows), four warp slabs
        assert (ept, rows, smem) == (1, 64, 171776)


def _vjp_jax(x, w, lens, g, nh, jdt):
    jl = None if lens is None else jnp.asarray(lens)
    _, vjp = jax.vjp(lambda xx, *ww: jfm.fused_mha_layer(xx, *ww, nh, lengths=jl),
                     jnp.asarray(x).astype(jdt), *map(jnp.asarray, w))
    return vjp(jnp.asarray(g).astype(jdt))


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("with_lens", [False, True], ids=["full", "lens"])
@pytest.mark.parametrize("h", [1, 10, 40])
def test_zero_padded_rows_leave_the_backward_unchanged(dt, with_lens, h):
    """B14's plain version on x and a cotangent padded with zero rows to
    Hp, lengths clipped to H (H where there are none): its dx rows < H and
    its weight grads are the JAX VJP on the H rows (the padded rows add
    exact zeros to every sum)."""
    jdt, tdt = _DT[dt]
    b, d, nh = 3, 32, 2
    x, w, lens = _inputs(b, h, d, seed=400 + h)
    g = np.random.default_rng(500 + h).normal(size=(b, h, d)).astype(np.float32)
    want = _vjp_jax(x, w, lens if with_lens else None, g, nh, jdt)
    hp = -(-h // 16) * 16
    xp, gp = np.zeros((2, b, hp, d), np.float32)
    xp[:, :h], gp[:, :h] = x, g
    lp = torch.from_numpy(np.clip(lens if with_lens else np.full(b, h, np.int32), 1, h))
    got = tfm.fused_mha_layer_bwd_plain(torch.from_numpy(gp), torch.from_numpy(xp).to(tdt), lp,
                                        *map(torch.from_numpy, w), nh)
    assert got[0].shape == (b, hp, d) and got[0].dtype == tdt
    assert not got[0][:, h:].float().any()  # no gradient flows into the padded rows
    for i, (a, e) in enumerate(zip((got[0][:, :h], *got[1:]), want)):
        a, e = a.float().numpy(), np.asarray(e.astype(jnp.float32))
        if dt == "f32" or i:
            tol = 1e-5 if dt == "f32" else 1e-3
            np.testing.assert_allclose(a, e, rtol=0, atol=tol * float(np.abs(e).max()))
        else:
            steps = _bf16_steps(torch.from_numpy(a).to(torch.bfloat16), e.astype(jnp.bfloat16))
            assert float((steps > 1).float().mean()) <= 5e-3
            np.testing.assert_allclose(a, e, rtol=0, atol=1e-2 * float(np.abs(e).max()))
