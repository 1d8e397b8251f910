"""PyTorch port: the fused attention layer (B13 forward, B14 backward)
against the JAX package's ``fused_mha_layer`` on the CPU.

The JAX side runs its Pallas kernels in interpret mode, as its own tests do
(tests/test_pallas_fused_mha.py); the port's wrappers take the plain
versions for CPU tensors, so this holds the plain versions, rounding points
and all, against the kernels they replace.  Every query row is compared,
rows past an example's length included: their keys are masked like every
row's, and a random cotangent on them flows like any other.  The Pallas
kernels pad H to 8 or 16 rows and B to their tile; the port pads neither,
so H = 10 and 12 and a B that is a multiple of no tile show that the
padding does not leak.

Tolerances: f32 at 1e-5 of each output's largest magnitude (the same sums
in another order).  bf16: y within one bf16 step of JAX's, value by value
(the rounding points are the same, so only an f32 sum in another order can
flip a rounding, by one step).  dx within one bf16 step too, except where a
flip upstream (in do, ds or dqkv, each rounded before the next product)
carries into the sums: at most 0.5% of its values may be further off, and
none by more than 1e-2 of dx's largest magnitude (measured: 10 of 10,240
values, 3.7e-3).  The f32 weight grads within 1e-3 of their largest
magnitude (JAX sums its tiles in another order, over bf16 products).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from two_tower_models_tpu.ops.pallas import fused_mha as jfm
from two_tower_models_tpu_torch.ops import fused_mha as tfm

_DT = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
# (B, H, D, NH): H not a multiple of 8 or 16, B a multiple of no tile, and
# the JAX tests' wider model (D = 128, 8 heads)
_SHAPES = [(13, 10, 32, 4), (9, 12, 64, 4), (5, 16, 128, 8)]


def _inputs(b, h, d, seed):
    """x, the layer's weights (non-zero biases), lengths covering H, 1 and a
    mix, and a cotangent on every row, from a numpy seed."""
    r = np.random.default_rng(seed)
    lim_in, lim_out = np.sqrt(6.0 / (4 * d)), np.sqrt(6.0 / (2 * d))
    x = r.normal(size=(b, h, d)).astype(np.float32)
    w = [
        r.uniform(-lim_in, lim_in, (d, 3 * d)).astype(np.float32),
        r.uniform(-0.1, 0.1, (3 * d,)).astype(np.float32),
        r.uniform(-lim_out, lim_out, (d, d)).astype(np.float32),
        r.uniform(-0.1, 0.1, (d,)).astype(np.float32),
    ]
    lens = r.integers(1, h + 1, size=(b,)).astype(np.int32)
    lens[0], lens[1] = h, 1
    g = r.normal(size=(b, h, d)).astype(np.float32)
    return x, w, lens, g


def bf16_steps(got: torch.Tensor, want) -> torch.Tensor:
    """Distance between two bf16 tensors, value by value, in steps of the
    bf16 number line (0 = bit-equal up to the sign of zero)."""
    a = got.detach().contiguous().view(torch.int16).int()
    e = torch.from_numpy(np.asarray(want).view(np.int16).astype(np.int32))
    key = lambda t: torch.where(t < 0, -(t & 0x7FFF), t)
    return (key(a) - key(e)).abs()


def _close(got, want, tol):
    got = got.detach().float().numpy()
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * max(float(np.abs(want).max()), 1e-30))


def _check(dt, got, want, kind: str):
    """``kind`` y, dx or grad; the tolerances of the module docstring."""
    if dt == "f32":
        _close(got, want, 1e-5)
    elif kind == "grad":
        _close(got, want, 1e-3)
    else:
        assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
        steps = bf16_steps(got, want)
        if kind == "y":
            assert int(steps.max()) <= 1
        else:
            assert float((steps > 1).float().mean()) <= 5e-3
            _close(got, want, 1e-2)


def _jax(lens, nh):
    jl = None if lens is None else jnp.asarray(lens)
    return lambda xx, *ww: jfm.fused_mha_layer(xx, *ww, nh, lengths=jl)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("with_lens", [False, True], ids=["full", "lens"])
@pytest.mark.parametrize("b,h,d,nh", _SHAPES)
def test_layer_fwd_plain_matches_pallas(dt, with_lens, b, h, d, nh):
    """B13's plain version against fused_mha_layer: y [B, H, D] in x's dtype."""
    jdt, tdt = _DT[dt]
    x, w, lens, _ = _inputs(b, h, d, seed=b + h)
    lens = lens if with_lens else None
    want = _jax(lens, nh)(jnp.asarray(x).astype(jdt), *map(jnp.asarray, w))
    got = tfm.fused_mha_layer(torch.from_numpy(x).to(tdt), *map(torch.from_numpy, w), nh,
                              lengths=None if lens is None else torch.from_numpy(lens))
    assert got.dtype == tdt and got.grad_fn is None
    _check(dt, got, want, "y")


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("with_lens", [False, True], ids=["full", "lens"])
@pytest.mark.parametrize("b,h,d,nh", _SHAPES)
def test_layer_bwd_plain_matches_jax_vjp(dt, with_lens, b, h, d, nh):
    """B14's plain version against jax.vjp of fused_mha_layer, with a
    random cotangent on every row: dx, dW_in, db_in, dW_out, db_out."""
    jdt, tdt = _DT[dt]
    x, w, lens, g = _inputs(b, h, d, seed=b + h + 1)
    lens = lens if with_lens else None
    _, vjp = jax.vjp(_jax(lens, nh), jnp.asarray(x).astype(jdt), *map(jnp.asarray, w))
    want = vjp(jnp.asarray(g).astype(jdt))
    got = tfm.fused_mha_bwd(torch.from_numpy(g), torch.from_numpy(x).to(tdt),
                            None if lens is None else torch.from_numpy(lens),
                            *map(torch.from_numpy, w), nh)
    assert len(got) == len(want) == 5
    assert got[0].dtype == tdt and all(t.dtype == torch.float32 for t in got[1:])
    for i, (a, e) in enumerate(zip(got, want)):
        _check(dt, a, e, "grad" if i else "dx")


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_layer_autograd_function_on_cpu(dt):
    """fused_mha_layer with grad wanted goes through _FusedMHALayer (B13,
    then B14's plain version, not autograd of the plain forward): its output
    and grads against the JAX VJP, lengths clipped to [1, H] on both sides
    (0 and H + 3 among them); the lengths get no grad."""
    jdt, tdt = _DT[dt]
    b, h, d, nh = 6, 10, 32, 2
    x, w, lens, g = _inputs(b, h, d, seed=41)
    lens[2], lens[3] = 0, h + 3
    tx = torch.from_numpy(x).to(tdt).requires_grad_()
    tw = [torch.from_numpy(a).requires_grad_() for a in w]
    tl = torch.from_numpy(lens)
    y = tfm.fused_mha_layer(tx, *tw, nh, lengths=tl)
    assert type(y.grad_fn).__name__ == "_FusedMHALayerBackward"
    y.backward(torch.from_numpy(g).to(tdt))
    yj, vjp = jax.vjp(_jax(lens, nh), jnp.asarray(x).astype(jdt), *map(jnp.asarray, w))
    _check(dt, y, yj, "y")
    for i, (leaf, e) in enumerate(zip([tx, *tw], vjp(jnp.asarray(g).astype(jdt)))):
        assert leaf.grad.dtype == leaf.dtype
        _check(dt, leaf.grad, e, "grad" if i else "dx")
    assert tl.grad is None


@pytest.mark.parametrize("with_lens", [False, True], ids=["full", "lens"])
@pytest.mark.parametrize("h", [1, 10, 32])
def test_layer_bwd_f64_sums_yardstick(with_lens, h):
    """``fused_mha_layer_bwd_f64_sums``, the yardstick the card's checks
    measure B14's plain version and its tensor-core kernel against: B14's
    function at the same bf16 rounding points with f64 sums, so held as the
    plain version is (the module docstring's bf16 tolerances) against both
    jax.vjp of fused_mha_layer and ``fused_mha_layer_bwd_plain``."""
    b, d, nh = 5, 64, 4
    x, w, lens, g = _inputs(b, h, d, seed=300 + h)
    lens = lens if with_lens else None
    _, vjp = jax.vjp(_jax(lens, nh), jnp.asarray(x).astype(jnp.bfloat16), *map(jnp.asarray, w))
    want = vjp(jnp.asarray(g).astype(jnp.bfloat16))
    args = (torch.from_numpy(g), torch.from_numpy(x).to(torch.bfloat16),
            None if lens is None else torch.from_numpy(lens), *map(torch.from_numpy, w), nh)
    got = tfm.fused_mha_layer_bwd_f64_sums(*args)
    plain = tfm.fused_mha_bwd(*args)
    assert got[0].dtype == torch.bfloat16 and all(t.dtype == torch.float64 for t in got[1:])
    as_jax = lambda t: jnp.asarray(t.float().numpy()).astype(want[0].dtype if t is plain[0]
                                                             else jnp.float32)
    for i, (a, e, p) in enumerate(zip(got, want, plain)):
        _check("bf16", a, e, "grad" if i else "dx")
        _check("bf16", a, as_jax(p), "grad" if i else "dx")
