"""PyTorch port: the plain versions of the training slice's kernels against
the JAX package on the CPU.

B10-B12 (``ops/fused_softmax.py``) against ``fused_in_batch_ce`` /
``fused_lse`` and their custom VJPs; B5 and B6 (``ops/fused_encoder.py``)
against ``_enc_fwd_res_impl`` and ``jax.vjp`` of ``fused_history_encoder``.
The JAX side runs its Pallas kernels in interpret mode, as its own tests
do (tests/test_pallas_fused_softmax.py, tests/test_pallas_fused_encoder.py).
The port's wrappers take the plain versions for CPU tensors.

Tolerances, relative to each output's largest magnitude: the CE functions
at 1e-5 (f32 sums in another order); the encoder at 1e-4 in f32, and in
bf16 at 1e-3, where the measured gap is below 2e-7 (the plain versions
round at the Pallas kernel's points, so bf16 values agree bit for bit and
only f32 sums differ in order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from two_tower_models_tpu.ops.pallas import fused_encoder as jfe
from two_tower_models_tpu.ops.pallas import fused_softmax as jfs
from two_tower_models_tpu_torch.ops import fused_encoder as tfe
from two_tower_models_tpu_torch.ops import fused_softmax as tfs


def _close(got, want, tol):
    got = got.detach().float().numpy()
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)


def _emb(seed, *shape):
    return (np.random.default_rng(seed).normal(size=shape) * 0.3).astype(np.float32)


@pytest.mark.parametrize("b,d", [(128, 32), (200, 32)])
def test_in_batch_ce_plain_matches_pallas(b, d):
    u, i = _emb(b, b, d), _emb(b + 1, b, d)
    ce_j, lse_j = jfs.fused_in_batch_ce(jnp.asarray(u), jnp.asarray(i))
    ce, lse = tfs.in_batch_ce_fwd(torch.from_numpy(u), torch.from_numpy(i))
    _close(ce, ce_j, 1e-5)
    _close(lse, lse_j, 1e-5)


def test_fused_lse_rectangle_matches_pallas():
    """C != B at D = 65, the width the logQ route feeds."""
    u, i = _emb(1, 96, 65), _emb(2, 300, 65)
    want = jfs.fused_lse(jnp.asarray(u), jnp.asarray(i))
    got = tfs.fused_lse(torch.from_numpy(u), torch.from_numpy(i))
    _close(got, want, 1e-5)


@pytest.mark.parametrize("rect", [False, True], ids=["in_batch_ce", "fused_lse"])
def test_ce_backward_plain_matches_jax_vjp(rect):
    """The B11 and B12 plain versions, called directly and through the
    autograd Functions, against jax.vjp with a random cotangent."""
    b, c, d = (96, 300, 65) if rect else (200, 200, 32)
    u, i, g = _emb(3, b, d), _emb(4, c, d), _emb(5, b)
    fn = jfs.fused_lse if rect else (lambda x, y: jfs.fused_in_batch_ce(x, y)[0])
    _, vjp = jax.vjp(fn, jnp.asarray(u), jnp.asarray(i))
    du_j, di_j = vjp(jnp.asarray(g))

    tu, ti, tg = (torch.from_numpy(a) for a in (u, i, g))
    _, lse = tfs.in_batch_ce_fwd_plain(tu, ti, not rect)
    _close(tfs.in_batch_ce_bwd_du_plain(tu, ti, lse, tg, not rect), du_j, 1e-5)
    _close(tfs.in_batch_ce_bwd_di_plain(tu, ti, lse, tg, not rect), di_j, 1e-5)

    tu.requires_grad_(), ti.requires_grad_()
    out = tfs.fused_lse(tu, ti) if rect else tfs.fused_in_batch_ce(tu, ti)[0]
    (out * tg).sum().backward()
    _close(tu.grad, du_j, 1e-5)
    _close(ti.grad, di_j, 1e-5)


def _enc_inputs(b, h, d, nl, seed):
    r = np.random.default_rng(seed)
    lim_in, lim_out = np.sqrt(6.0 / (4 * d)), np.sqrt(6.0 / (2 * d))
    return [
        r.normal(size=(b, h, d)).astype(np.float32),
        (r.normal(size=(h, d)) * 0.5).astype(np.float32),
        r.uniform(-lim_in, lim_in, (nl, d, 3 * d)).astype(np.float32),
        r.uniform(-0.1, 0.1, (nl, 3 * d)).astype(np.float32),
        r.uniform(-lim_out, lim_out, (nl, d, d)).astype(np.float32),
        r.uniform(-0.1, 0.1, (nl, d)).astype(np.float32),
        r.normal(size=(b, 2, d)).astype(np.float32),  # cotangent
    ]


_DT = {"f32": (jnp.float32, torch.float32, 1e-4), "bf16": (jnp.bfloat16, torch.bfloat16, 1e-3)}
# (12, 8, ...) has two full layers' probabilities; (5, 10, ...) is one thin
# layer (no ps) at an H the Pallas kernel pads
_ENC = [(12, 8, 32, 2, 2), (5, 10, 16, 2, 1)]


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("b,h,d,nh,nl", _ENC)
def test_encoder_res_plain_matches_pallas(dt, b, h, d, nh, nl):
    """B5's plain version: y and the residuals, with the Pallas padding
    sliced off and its merged-head probabilities split per head."""
    jdt, tdt, tol = _DT[dt]
    x, pe, wi, bi, wo, bo, _ = _enc_inputs(b, h, d, nl, seed=b + h)
    w = [pe, wi, bi, wo, bo]
    yj, xsj, p0j, psj = jfe._enc_fwd_res_impl(
        jnp.asarray(x).astype(jdt), *map(jnp.asarray, w), nh, 64
    )
    y, xs, ps, p0 = tfe.fused_history_encoder_res(
        torch.from_numpy(x).to(tdt), *map(torch.from_numpy, w), nh
    )
    assert xs.dtype == p0.dtype == tdt
    hp = xsj.shape[2]
    _close(y, yj, tol)
    _close(xs, xsj[:, :b, :h], tol)
    _close(p0, p0j[:b, 0].reshape(b, nh, hp)[..., :h], tol)
    if nl == 1:
        assert ps is None and psj is None
    else:
        merged = psj[:, :b, :h].reshape(nl - 1, b, h, nh, hp)[..., :h]
        _close(ps, jnp.transpose(merged, (0, 1, 3, 2, 4)), tol)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("b,h,d,nh,nl", _ENC)
def test_encoder_bwd_plain_matches_jax_vjp(dt, b, h, d, nh, nl):
    """B6's plain version against jax.vjp of the whole encoder: dx, dPE,
    dW_in, db_in, dW_out and db_out."""
    jdt, tdt, tol = _DT[dt]
    x, pe, wi, bi, wo, bo, g = _enc_inputs(b, h, d, nl, seed=b + h + 1)
    w = [pe, wi, bi, wo, bo]
    _, vjp = jax.vjp(
        lambda xx, *ww: jfe.fused_history_encoder(xx, *ww, nh),
        jnp.asarray(x).astype(jdt), *map(jnp.asarray, w),
    )
    want = vjp(jnp.asarray(g).astype(jdt))
    tw = list(map(torch.from_numpy, w))
    _, xs, ps, p0 = tfe.fused_history_encoder_res(torch.from_numpy(x).to(tdt), *tw, nh)
    got = tfe.fused_history_encoder_bwd(torch.from_numpy(g), xs, ps, p0, tw[1], tw[2], tw[3], nh)
    assert got[0].dtype == tdt
    for a, e in zip(got, want):
        _close(a, e, tol)


def test_encoder_autograd_function_on_cpu():
    """A call that wants a gradient goes through the encoder's
    autograd.Function, whose backward is B6's plain version (not autograd
    of the plain forward); without grad the output has no grad_fn."""
    b, h, d, nh, nl = 6, 8, 32, 2, 2
    x, *w, g = _enc_inputs(b, h, d, nl, seed=9)
    tx = torch.from_numpy(x).to(torch.bfloat16).requires_grad_()
    tw = [torch.from_numpy(a).requires_grad_() for a in w]
    y = tfe.fused_history_encoder(tx, *tw, nh)
    assert type(y.grad_fn).__name__ == "_FusedHistoryEncoderBackward"
    y.backward(torch.from_numpy(g).to(torch.bfloat16))
    _, xs, ps, p0 = tfe.fused_history_encoder_res_plain(tx.detach(), *(t.detach() for t in tw), nh)
    want = tfe.fused_history_encoder_bwd_plain(torch.from_numpy(g), xs, ps, p0, *(t.detach() for t in tw[1:4]), nh)
    for leaf, e in zip([tx, *tw[:4]], want):
        assert torch.equal(leaf.grad, e.to(leaf.dtype))
    assert torch.equal(tw[4].grad, want[5])
    with torch.no_grad():
        assert tfe.fused_history_encoder(tx, *tw, nh).grad_fn is None
