"""PyTorch port: blockwise (flash) self-attention against the JAX package on
the CPU.

``ops.history_attention.blockwise_self_attention`` (B15 forward; B16, B17
backward through ``_BlockwiseAttention``) against the JAX package's
``blockwise_self_attention`` run in interpret mode, as
tests/test_pallas_history_attention.py runs it: the same numpy-seeded q, k,
v and cotangent on both sides, the output and ``jax.grad`` against
``torch.autograd.grad``.  On the CPU the port's wrappers take their plain
versions, so this holds the plain versions, lse and delta included,
against the kernels they replace.  Tolerance: rtol 1e-4, atol 1e-5, the
JAX package's own for its blockwise kernel against the dense reference
(f32 sums in another order, another exp).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from two_tower_models_tpu.ops.pallas import history_attention as jha
from two_tower_models_tpu_torch.ops import history_attention as tha

RTOL, ATOL = 1e-4, 1e-5

# tests/test_pallas_history_attention.py's shapes: a production-ish history
# (4, 128, 16), H not a tile multiple (2, 200, 32), several tiles
# (3, 384, 64), the non-square tiles' case (2, 300, 16)
SHAPES = [(4, 128, 16), (2, 200, 32), (3, 384, 64), (2, 300, 16)]


def _inputs(n, h, dh, seed, mag=1.0):
    r = np.random.default_rng(seed)
    q, k = ((r.normal(size=(n, h, dh)) * mag).astype(np.float32) for _ in range(2))
    v, g = (r.normal(size=(n, h, dh)).astype(np.float32) for _ in range(2))
    lens = r.integers(1, h + 1, size=n).astype(np.int32)
    lens[0], lens[-1] = 1, h  # the extremes of the clip
    return q, k, v, g, lens


def _jax(q, k, v, lens):
    return jha.blockwise_self_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        lengths=None if lens is None else jnp.asarray(lens))


def _port(q, k, v, lens):
    return tha.blockwise_self_attention(
        q, k, v, lengths=None if lens is None else torch.from_numpy(lens))


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               rtol=rtol, atol=atol)


@pytest.mark.parametrize("with_lens", [False, True], ids=["full", "lens"])
@pytest.mark.parametrize("n,h,dh", SHAPES)
def test_forward_matches_jax(n, h, dh, with_lens):
    """Every row, the rows past an example's length included (attention
    over its valid keys)."""
    q, k, v, _, lens = _inputs(n, h, dh, seed=n * h + dh)
    lens = lens if with_lens else None
    with torch.no_grad():
        got = _port(*(torch.from_numpy(t) for t in (q, k, v)), lens)
    assert got.shape == (n, h, dh) and got.dtype == torch.float32
    _close(got.numpy(), _jax(q, k, v, lens))


@pytest.mark.parametrize("with_lens", [False, True], ids=["full", "lens"])
@pytest.mark.parametrize("n,h,dh", SHAPES)
def test_grads_match_jax(n, h, dh, with_lens):
    """jax.grad of <out, g> through the custom VJP (the flash backward)
    against torch.autograd.grad through _BlockwiseAttention; masked keys
    get dk = dv = 0."""
    q, k, v, g, lens = _inputs(n, h, dh, seed=n * h + dh + 1)
    lens = lens if with_lens else None
    want = jax.grad(lambda *a: jnp.sum(_jax(*a, lens) * g), argnums=(0, 1, 2))(q, k, v)
    leaves = [torch.from_numpy(t).requires_grad_() for t in (q, k, v)]
    out = _port(*leaves, lens)
    got = torch.autograd.grad((out * torch.from_numpy(g)).sum(), leaves)
    for a, b in zip(got, want):
        _close(a.numpy(), b)
    if lens is not None:
        masked = np.arange(h)[None, :] >= lens[:, None]
        assert (got[1].numpy()[masked] == 0).all() and (got[2].numpy()[masked] == 0).all()


def test_extreme_scores_match_jax():
    """q and k at 30 sigma: scores of some thousands; the online softmax
    stays finite (the JAX test's case, at its rtol 1e-3, atol 1e-4)."""
    q, k, v, g, lens = _inputs(2, 256, 16, seed=5, mag=30.0)
    for ln in (None, lens):
        with torch.no_grad():
            got = _port(*(torch.from_numpy(t) for t in (q, k, v)), ln).numpy()
        assert np.isfinite(got).all()
        _close(got, _jax(q, k, v, ln), 1e-3, 1e-4)


@pytest.mark.parametrize("n,h,dh", [(3, 70, 16), (2, 130, 32)])
def test_plain_versions_match_the_pallas_kernels(n, h, dh):
    """The plain versions at the kernels' own boundary: B15's lse (JAX's
    [N, 1, Hp] cropped to [N, H]) and B16/B17's dq, dk, dv given the same
    lse and delta (JAX's _blockwise_vjp_bwd)."""
    q, k, v, g, lens = _inputs(n, h, dh, seed=n + h)
    jout, jlse = jha._blockwise_fwd_impl(*(jnp.asarray(t) for t in (q, k, v, lens)))
    t = lambda a: torch.from_numpy(np.array(a))
    out, lse = tha.blockwise_attn_fwd_plain(t(q), t(k), t(v), t(lens))
    _close(out.numpy(), jout)
    _close(lse.numpy(), np.asarray(jlse)[:, 0, :h])
    res = tuple(jnp.asarray(a) for a in (q, k, v, lens)) + (jout, jlse)
    want = jha._blockwise_vjp_bwd(128, 128, res, jnp.asarray(g))[:3]
    delta = (t(g) * t(jout)).sum(-1)
    got = tha.blockwise_attn_bwd_plain(t(q), t(k), t(v), t(g), t(np.asarray(jlse)[:, 0, :h]),
                                       delta, t(lens))
    for a, b in zip(got, want):
        _close(a.numpy(), b)


def test_bf16_inputs_cast_like_jax():
    """bf16 q, k, v (a direct caller): cast to f32 on entry, the f32 output
    and grads cast back to bf16, as _pad3 and the crop do.  One bf16 step
    is 2^-8 of a value, and a rounding can flip between two f32 sums taken
    in other orders: rtol 8e-3, atol 1e-2 of each output's scale."""
    q, k, v, g, lens = _inputs(3, 64, 32, seed=7)
    bf = lambda a: torch.from_numpy(a).bfloat16()
    leaves = [bf(a).requires_grad_() for a in (q, k, v)]
    out = _port(*leaves, lens)
    got = torch.autograd.grad(out, leaves, bf(g))
    jin = [jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)]
    jout, vjp = jax.vjp(lambda *a: jha.blockwise_self_attention(*a, lengths=jnp.asarray(lens)),
                        *jin)
    want = vjp(jnp.asarray(g, jnp.bfloat16))
    assert out.dtype == torch.bfloat16 and all(a.dtype == torch.bfloat16 for a in got)
    for a, b in zip((out, *got), (jout, *want)):
        b = np.asarray(b, np.float32)
        _close(a.detach().float().numpy(), b, 8e-3, 1e-2 * float(np.abs(b).max()))


def test_attention_reference_matches_jax():
    q, k, v, _, _ = _inputs(2, 50, 16, seed=8)
    got = tha.attention_reference(*(torch.from_numpy(t) for t in (q, k, v)))
    _close(got.numpy(), jha.attention_reference(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))


def test_no_grad_runs_the_forward_alone():
    """Without a gradient wanted, blockwise_self_attention returns a plain
    tensor (B15 alone); with one, the output carries the autograd.Function."""
    q, k, v, _, lens = _inputs(2, 40, 16, seed=9)
    t = [torch.from_numpy(a) for a in (q, k, v)]
    assert _port(*t, lens).grad_fn is None
    out = _port(t[0].requires_grad_(), t[1], t[2], lens)
    assert type(out.grad_fn).__name__.startswith("_BlockwiseAttention")
