"""PyTorch port: what the tensor-core backward of the whole encoder (B6) and
of the length-masked stack (B9), ``encoder_bwd_tc_kernel``, relies on, on
the CPU.

``ops/fused_encoder.py`` sends a backward to the tensor-core kernel or to
the FMA kernel by ``_enc_bwd_route``, a function of dtype and shape alone,
and sizes a tensor-core launch by ``_enc_bwd_tc_plan``; both are checked
here without a card.  The card's checks measure the kernel and the plain
versions against the same functions with every sum in f64
(``fused_history_encoder_bwd_f64_sums``, ``fused_attn_stack_bwd_f64_sums``):
those are held here against the plain versions (f32 input, where nothing
rounds: 1e-5 of each output's largest magnitude; bf16 input: at most 0.5%
of dx's values beyond one bf16 step, since an f32 sum and an f64 sum can
round a bf16 operand to its two neighbours, and the grads within 1e-3 of
scale) and, on f32 input, against ``jax.vjp`` of the JAX package's
``fused_history_encoder`` and ``fused_attn_stack`` (their Pallas kernels in
interpret mode, as its own tests run them) at 1e-5 of scale.  The plain
versions are held to JAX by ``tests/test_torch_train_kernels.py`` and
``tests/test_torch_attn_stack.py``; here also B9's on histories padded
with zero rows, as the kernel pads them to Hp.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from two_tower_models_tpu.ops.pallas import fused_encoder as jfe
from two_tower_models_tpu_torch.ops import fused_encoder as tfe


def _inputs(b, h, d, nl, seed):
    """x, PE, stacked weights with non-zero biases, lengths covering H, 1
    and a mix, and the cotangents of the encoder [B, 2, D] and of the stack
    [B, D], from a numpy seed."""
    r = np.random.default_rng(seed)
    lim_in, lim_out = np.sqrt(6.0 / (4 * d)), np.sqrt(6.0 / (2 * d))
    x = r.normal(size=(b, h, d)).astype(np.float32)
    pe = (r.normal(size=(h, d)) * 0.5).astype(np.float32)
    w = [r.uniform(-lim_in, lim_in, (nl, d, 3 * d)).astype(np.float32),
         r.uniform(-0.1, 0.1, (nl, 3 * d)).astype(np.float32),
         r.uniform(-lim_out, lim_out, (nl, d, d)).astype(np.float32),
         r.uniform(-0.1, 0.1, (nl, d)).astype(np.float32)]
    lens = r.integers(1, h + 1, size=b).astype(np.int32)
    lens[:2] = [h, 1]
    g_enc = (r.normal(size=(b, 2, d)) * 0.1).astype(np.float32)
    g_stack = (r.normal(size=(b, d)) * 0.1).astype(np.float32)
    return x, pe, w, lens, g_enc, g_stack


def _stack_x(x, lens):
    """x zeroed at rows past each length, as the encoder hands it to the stack."""
    return np.where((np.arange(x.shape[1])[None, :] < lens[:, None])[..., None], x, 0).astype(
        np.float32)


def _f64(t):
    return t.double() if torch.is_tensor(t) else torch.from_numpy(np.asarray(t, np.float64))


def _scaled(got, want, tol):
    got, want = _f64(got), _f64(want)
    assert got.shape == want.shape
    assert float((got - want).abs().max()) <= tol * float(want.abs().max())


def _far_share(got, want):
    """Share of two bf16 tensors' values more than one bf16 step apart."""
    key = lambda t: (lambda i: torch.where(i < 0, -(i & 0x7FFF), i))(
        t.contiguous().view(torch.int16).int())
    return float(((key(got) - key(want)).abs() > 1).float().mean())


def _check_bwd(got, want, dtype):
    """A backward's outputs (dx first, then f32 or f64 grads) against another's."""
    assert len(got) == len(want)
    assert got[0].dtype == want[0].dtype == dtype
    if dtype == torch.float32:
        for a, e in zip(got, want):
            _scaled(a, e, 1e-5)
        return
    assert _far_share(got[0], want[0]) <= 5e-3
    for a, e in zip(got[1:], want[1:]):
        _scaled(a, e, 1e-3)


# the cells' widths at a small batch; the thin layer alone; H = 10 and 20
# (not multiples of 16); one head
_SHAPES = [(4, 32, 64, 4, 3), (5, 10, 32, 2, 1), (6, 20, 32, 2, 2), (3, 12, 64, 1, 2)]


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("b,h,d,nh,nl", _SHAPES)
def test_encoder_bwd_f64_sums_match_plain(dt, b, h, d, nh, nl):
    """B6 with f64 sums against its plain version, on the plain forward's
    residuals: dx, dPE and the four weight grads."""
    x, pe, w, _, g, _ = _inputs(b, h, d, nl, seed=b + h + 2)
    tw = [torch.from_numpy(t) for t in w]
    _, xs, ps, p0 = tfe.fused_history_encoder_res_plain(
        torch.from_numpy(x).to(dt), torch.from_numpy(pe), *tw, nh)
    args = (torch.from_numpy(g).to(dt), xs, ps, p0, tw[0], tw[1], tw[2], nh)
    got = tfe.fused_history_encoder_bwd_f64_sums(*args)
    assert got[0].dtype == dt and all(t.dtype == torch.float64 for t in got[1:])
    _check_bwd(got, tfe.fused_history_encoder_bwd_plain(*args), dt)


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("b,h,d,nh,nl", _SHAPES)
def test_attn_stack_bwd_f64_sums_match_plain(dt, b, h, d, nh, nl):
    """B9 with f64 sums against its plain version: dx, zero past each
    length in both, and the four weight grads."""
    x, _, w, lens, _, g = _inputs(b, h, d, nl, seed=b + h + 3)
    args = (torch.from_numpy(g).to(dt), torch.from_numpy(_stack_x(x, lens)).to(dt),
            torch.from_numpy(lens), *map(torch.from_numpy, w), nh)
    got = tfe.fused_attn_stack_bwd_f64_sums(*args)
    want = tfe.fused_attn_stack_bwd_plain(*args)
    _check_bwd(got, want, dt)
    past = torch.arange(h)[None, :] >= torch.from_numpy(lens)[:, None]
    assert not got[0][past].float().any() and not want[0][past].float().any()


# shapes no other test traces the JAX encoder's backward at
@pytest.mark.parametrize("h,nl", [(5, 1), (12, 2)])
def test_bwd_f64_sums_match_jax_vjp(h, nl):
    """On f32 input the f64-sum backwards are jax.vjp of the JAX package's
    ``fused_history_encoder`` (with its stored residuals) and
    ``fused_attn_stack`` (2 heads, D = 32)."""
    b, d, nh = 6, 32, 2
    x, pe, w, lens, g_enc, g_stack = _inputs(b, h, d, nl, seed=700 + h + nl)
    jw, tw = [jnp.asarray(t) for t in w], [torch.from_numpy(t) for t in w]
    _, vjp = jax.vjp(lambda xx, pp, *ww: jfe.fused_history_encoder(xx, pp, *ww, nh),
                     jnp.asarray(x), jnp.asarray(pe), *jw)
    want = vjp(jnp.asarray(g_enc))
    _, xs, ps, p0 = tfe.fused_history_encoder_res_f64_sums(
        torch.from_numpy(x), torch.from_numpy(pe), *tw, nh)
    got = tfe.fused_history_encoder_bwd_f64_sums(torch.from_numpy(g_enc), xs, ps, p0,
                                                 tw[0], tw[1], tw[2], nh)
    assert len(got) == 6 and len(want) == 6
    for a, e in zip(got, want):  # dx, dPE, dW_in, db_in, dW_out, db_out
        _scaled(a, e, 1e-5)
    xm = _stack_x(x, lens)
    _, vjp = jax.vjp(lambda xx, *ww: jfe.fused_attn_stack(xx, jnp.asarray(lens), *ww, nh),
                     jnp.asarray(xm), *jw)
    want = vjp(jnp.asarray(g_stack))
    got = tfe.fused_attn_stack_bwd_f64_sums(torch.from_numpy(g_stack), torch.from_numpy(xm),
                                            torch.from_numpy(lens), *tw, nh)
    assert len(got) == 5 and len(want) == 5
    for a, e in zip(got, want):
        _scaled(a, e, 1e-5)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("h,nl", [(10, 2), (20, 3)])
def test_zero_padded_rows_leave_the_stack_backward_unchanged(dt, h, nl):
    """B9's plain version on x padded with zero rows to Hp = round_up(H,
    16), as the tensor-core kernel pads a tile, the lengths as they are:
    its dx rows < H and its weight grads are the JAX VJP on the H rows, and
    no gradient flows into the padded rows (keys past each length are
    masked, and row 0 alone is the stack's output)."""
    jdt, tdt, tol = {"f32": (jnp.float32, torch.float32, 1e-4),
                     "bf16": (jnp.bfloat16, torch.bfloat16, 1e-3)}[dt]
    b, d, nh = 5, 32, 2
    x, _, w, lens, _, g = _inputs(b, h, d, nl, seed=800 + h)
    x = _stack_x(x, lens)
    _, vjp = jax.vjp(lambda xx, *ww: jfe.fused_attn_stack(xx, jnp.asarray(lens), *ww, nh),
                     jnp.asarray(x).astype(jdt), *map(jnp.asarray, w))
    want = vjp(jnp.asarray(g).astype(jdt))
    hp = -(-h // 16) * 16
    xp = np.zeros((b, hp, d), np.float32)
    xp[:, :h] = x
    got = tfe.fused_attn_stack_bwd_plain(torch.from_numpy(g).to(tdt),
                                         torch.from_numpy(xp).to(tdt), torch.from_numpy(lens),
                                         *map(torch.from_numpy, w), nh)
    assert got[0].shape == (b, hp, d) and got[0].dtype == tdt
    assert not got[0][:, h:].float().any()
    for a, e in zip((got[0][:, :h], *got[1:]), want):
        _scaled(a, e, tol)


@pytest.mark.parametrize("dtype,h,d,nh,nl,route", [
    (torch.bfloat16, 32, 64, 4, 3, "tc"),  # the cells' encoder
    (torch.bfloat16, 64, 64, 4, 3, "tc"),  # the longest history on the tensor cores
    (torch.bfloat16, 1, 64, 4, 1, "tc"),
    (torch.bfloat16, 40, 64, 4, 2, "tc"),  # Hp = 48
    (torch.bfloat16, 16, 32, 2, 3, "tc"),  # D = 32
    (torch.bfloat16, 32, 64, 1, 3, "tc"),  # one head, head width 64
    # one layer's weights are staged at a time: depths whose weights the
    # forward's kernel cannot hold (_enc_route's "fma") still take the tensor cores
    (torch.bfloat16, 32, 64, 4, 6, "tc"),
    (torch.bfloat16, 32, 64, 4, 12, "tc"),
    (torch.float32, 32, 64, 4, 3, "fma"),  # f32 stays f32 (TF32 would not match)
    (torch.bfloat16, 32, 32, 4, 3, "fma"),  # head width 8
    (torch.bfloat16, 16, 128, 8, 2, "fma"),  # D = 128: the grad slices exceed the registers
    (torch.bfloat16, 16, 96, 2, 2, "fma"),  # D = 96
    (torch.bfloat16, 65, 64, 4, 3, "fma"),  # Hp = 80, above the kernel's limit
], ids=["cell", "h64", "h1", "h40", "d32", "nh1", "l6", "l12", "f32", "hd8", "d128", "d96", "h65"])
def test_enc_bwd_route(dtype, h, d, nh, nl, route):
    assert tfe._enc_bwd_route(dtype, h, d, nh, nl) == route
    if nl >= 6:
        assert tfe._enc_route(dtype, h, d, nh, nl) == "fma"


@pytest.mark.parametrize("b", [1, 3, 5, 1000, 4096])
@pytest.mark.parametrize("h,d", [(1, 64), (10, 64), (32, 64), (40, 64), (64, 64), (16, 32),
                                 (32, 32)])
def test_enc_bwd_tc_plan(b, h, d):
    """Every tensor-core shape: rows a tile a multiple of 32, at most 128,
    the examples a tile times Hp; shared memory (with the 32 static bytes of
    the tile's lengths) within a block's limit and the same as
    ``_enc_bwd_tc_smem_bytes``; a grid of at least one block and at most one
    an SM of 132, each owning tiles k, k + grid, ..., so that every tile is
    some block's, once; the depth changes nothing."""
    nh = d // 16
    assert tfe._enc_bwd_route(torch.bfloat16, h, d, nh, 3) == "tc"
    plan = tfe._enc_bwd_tc_plan(b, h, d, 3, 132)
    assert tfe._enc_bwd_tc_plan(b, h, d, 1, 132) == plan
    ept, rows, smem, grid = plan
    hp = -(-h // 16) * 16
    assert ept >= 1 and rows == ept * hp and rows % 32 == 0 and rows <= 128
    assert smem == tfe._enc_bwd_tc_smem_bytes(h, d, ept)
    assert smem + tfe._TC_STATIC_SMEM <= tfe._SMEM_LIMIT
    tiles = -(-b // ept)
    assert 1 <= grid <= min(tiles, 132)
    owned = sorted(t for k in range(grid) for t in range(k, tiles, grid))
    assert owned == list(range(tiles))
    if (h, d) == (32, 64):  # the cells: 4 examples of 32 rows
        assert (ept, rows, smem) == (4, 128, 218112)
        assert grid == min(tiles, 132)
    if (h, d) == (40, 64):  # Hp = 48: two examples
        assert (ept, rows) == (2, 96)
