"""PyTorch port: what the whole-encoder tensor-core kernel (B1, B5 and B8
on ``encoder_tc_kernel``) relies on, on the CPU.

``ops/fused_encoder.py`` sends an encoder to the tensor-core kernel or to
the FMA kernel by ``_enc_route``, a function of dtype and shape alone, and
sizes a tensor-core launch by ``_enc_tc_plan``; both are checked here
without a card.  The card's checks measure the kernel and the plain version
against the same functions with every sum in f64
(``fused_history_encoder_f64_sums``, ``fused_history_encoder_res_f64_sums``
and ``fused_attn_stack_f64_sums``): those are held here against the plain
versions (f32 input, where nothing rounds: 1e-5 of each output's largest
magnitude; bf16 input: at most 0.5% of values beyond one bf16 step, since
an f32 sum and an f64 sum can round a bf16 operand to its two neighbours)
and, on f32 input, against the JAX package's ``fused_history_encoder`` and
``fused_attn_stack`` (their Pallas kernels in interpret mode, as its own
tests run them) at 1e-5 of scale.  The plain versions are held to JAX by
``tests/test_torch_encoder.py`` and ``tests/test_torch_attn_stack.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from two_tower_models_tpu.ops.pallas import fused_encoder as jfe
from two_tower_models_tpu_torch.ops import fused_encoder as tfe


def _inputs(b, h, d, nl, seed):
    """x, PE, stacked weights with non-zero biases, and lengths covering H, 1
    and a mix, from a numpy seed."""
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
    return x, pe, w, lens


def _stack_x(x, lens):
    """x zeroed at rows past each length, as the encoder hands it to the stack."""
    return np.where((np.arange(x.shape[1])[None, :] < lens[:, None])[..., None], x, 0).astype(
        np.float32)


def _scaled(got, want, tol):
    got, want = got.double(), want.double()
    assert got.shape == want.shape
    assert float((got - want).abs().max()) <= tol * float(want.abs().max())


def _far_share(got, want):
    """Share of two bf16 tensors' values more than one bf16 step apart."""
    key = lambda t: (lambda i: torch.where(i < 0, -(i & 0x7FFF), i))(
        t.contiguous().view(torch.int16).int())
    return float(((key(got) - key(want)).abs() > 1).float().mean())


def _check(got, want, dtype):
    assert got.dtype == want.dtype == dtype
    if dtype == torch.float32:
        _scaled(got, want, 1e-5)
    else:
        assert _far_share(got, want) <= 5e-3


# the cells' widths at a small batch; the thin layer alone; H = 10 and 20
# (not multiples of 16); one head
_SHAPES = [(4, 32, 64, 4, 3), (5, 10, 32, 2, 1), (6, 20, 32, 2, 2), (3, 12, 64, 1, 2)]


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("b,h,d,nh,nl", _SHAPES)
def test_encoder_f64_sums_match_plain(dt, b, h, d, nh, nl):
    """B5's outputs (y, xs, ps, p0) and B1's y with f64 sums against the
    plain versions."""
    x, pe, w, _ = _inputs(b, h, d, nl, seed=b + h)
    args = (torch.from_numpy(x).to(dt), torch.from_numpy(pe), *map(torch.from_numpy, w), nh)
    got = tfe.fused_history_encoder_res_f64_sums(*args)
    want = tfe.fused_history_encoder_res_plain(*args)
    assert (got[2] is None) == (want[2] is None) == (nl == 1)
    for a, e in zip(got, want):
        if e is not None:
            _check(a, e, dt)
    assert torch.equal(tfe.fused_history_encoder_f64_sums(*args), got[0])


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("b,h,d,nh,nl", _SHAPES)
def test_attn_stack_f64_sums_match_plain(dt, b, h, d, nh, nl):
    x, _, w, lens = _inputs(b, h, d, nl, seed=b + h + 1)
    args = (torch.from_numpy(_stack_x(x, lens)).to(dt), torch.from_numpy(lens),
            *map(torch.from_numpy, w), nh)
    _check(tfe.fused_attn_stack_f64_sums(*args), tfe.fused_attn_stack_fwd_plain(*args), dt)


@pytest.mark.parametrize("h,nl", [(5, 2), (12, 2), (12, 1)])
def test_f64_sums_match_pallas(h, nl):
    """On f32 input the f64-sum encoder and stack are the JAX package's
    ``fused_history_encoder`` and ``fused_attn_stack`` (2 heads, D = 32)."""
    b, d, nh = 3, 32, 2
    x, pe, w, lens = _inputs(b, h, d, nl, seed=300 + h + nl)
    jw, tw = [jnp.asarray(t) for t in w], [torch.from_numpy(t) for t in w]
    want = jfe.fused_history_encoder(jnp.asarray(x), jnp.asarray(pe), *jw, nh)
    got = tfe.fused_history_encoder_f64_sums(torch.from_numpy(x), torch.from_numpy(pe), *tw, nh)
    _scaled(got, torch.from_numpy(np.array(want)), 1e-5)
    xs = _stack_x(x, lens)
    want = jfe.fused_attn_stack(jnp.asarray(xs), jnp.asarray(lens), *jw, nh)
    got = tfe.fused_attn_stack_f64_sums(torch.from_numpy(xs), torch.from_numpy(lens), *tw, nh)
    _scaled(got, torch.from_numpy(np.array(want)), 1e-5)


@pytest.mark.parametrize("dtype,h,d,nh,nl,route", [
    (torch.bfloat16, 32, 64, 4, 3, "tc"),  # the cells' encoder
    (torch.bfloat16, 64, 64, 4, 3, "tc"),  # the longest history on the tensor cores
    (torch.bfloat16, 1, 64, 4, 1, "tc"),
    (torch.bfloat16, 40, 64, 4, 2, "tc"),  # Hp = 48
    (torch.bfloat16, 16, 32, 2, 3, "tc"),  # D = 32
    (torch.bfloat16, 32, 64, 4, 4, "tc"),  # four layers: 231,424 bytes, just within a block
    (torch.bfloat16, 32, 64, 1, 3, "tc"),  # one head, head width 64
    (torch.float32, 32, 64, 4, 3, "fma"),  # f32 stays f32 (TF32 would not match)
    (torch.bfloat16, 32, 32, 4, 3, "fma"),  # head width 8
    (torch.bfloat16, 16, 48, 3, 2, "fma"),  # D not a multiple of 32
    (torch.bfloat16, 65, 64, 4, 3, "fma"),  # Hp = 80, above the kernel's limit
    (torch.bfloat16, 32, 64, 4, 6, "fma"),  # six layers' weights do not fit beside a tile
    (torch.bfloat16, 16, 128, 8, 2, "fma"),  # D = 128: two layers' weights do not fit
], ids=["cell", "h64", "h1", "h40", "d32", "l4", "nh1", "f32", "hd8", "d48", "h65", "l6", "d128"])
def test_enc_route(dtype, h, d, nh, nl, route):
    assert tfe._enc_route(dtype, h, d, nh, nl) == route


@pytest.mark.parametrize("b", [1, 5, 1000, 4096])
@pytest.mark.parametrize("h,d,nh,nl", [(32, 64, 4, 3), (1, 64, 4, 1), (10, 64, 2, 1),
                                       (40, 64, 4, 2), (16, 32, 2, 3), (64, 64, 4, 3),
                                       (32, 64, 4, 4), (32, 64, 4, 5)])
def test_enc_tc_plan(b, h, d, nh, nl):
    """Every tensor-core shape: rows a tile a multiple of 32, at most 128,
    the examples a tile times Hp; shared memory (with the 32 static bytes of
    the tile's lengths) within a block's limit and the same as
    ``_enc_tc_smem_bytes``; a grid of at least one block and at most one a
    tile, within one block an SM of 132 SMs."""
    assert tfe._enc_route(torch.bfloat16, h, d, nh, nl) == "tc"
    ept, rows, smem, grid = tfe._enc_tc_plan(b, h, d, nl, 132)
    hp = -(-h // 16) * 16
    assert ept >= 1 and rows == ept * hp and rows % 32 == 0 and rows <= 128
    assert smem == tfe._enc_tc_smem_bytes(h, d, nl, ept)
    assert smem + tfe._TC_STATIC_SMEM <= tfe._SMEM_LIMIT
    tiles = -(-b // ept)
    assert 1 <= grid <= min(tiles, 132)
    if (h, d, nl) == (32, 64, 3):  # the cells: 4 examples of 32 rows
        assert (ept, rows, smem) == (4, 128, 195584)
        assert grid == min(tiles, 132)
    if (h, d, nl) == (32, 64, 5):  # five layers' weights leave room for 64 rows
        assert (ept, rows) == (2, 64)
