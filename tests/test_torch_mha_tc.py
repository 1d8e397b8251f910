"""PyTorch port: what B13's tensor-core kernel relies on, on the CPU.

``ops/fused_mha.py`` sends a layer to the tensor-core kernel or to the FMA
kernel by ``_fwd_route``, a function of dtype and shape alone, and sizes a
tensor-core launch by ``_fwd_tc_plan``; both are checked here without a
card.  The kernel pads each example's H rows with zero rows to Hp =
round_up(H, 16) and masks the padded keys, so the plain version on x
padded that way, with every length clipped to H, must give the layer on
the H rows: held against the JAX package's ``fused_mha_layer`` (its Pallas
kernel in interpret mode, as its own tests run it) at H = 1, 10, 20, 40.
So is ``fused_mha_layer_f64_sums``, the yardstick of the card's checks.

Tolerances, as ``tests/test_torch_fused_mha.py`` holds B13's plain version:
f32 at 1e-5 of the output's largest magnitude; bf16 within one bf16 step of
JAX's, value by value.
"""

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
