"""PyTorch port: the length-masked attention stack (B8 forward, B9 backward)
and the recompute encoder backward (B7) against the JAX package on the CPU.

The JAX side runs its Pallas kernels in interpret mode, as its own tests do
(tests/test_pallas_fused_encoder.py, tests/test_history_lengths.py).  The
port's wrappers take the plain versions for CPU tensors, so this holds the
plain versions, rounding points and all, against the kernels they replace.
The port pads neither H nor B; H = 5 and H = 12 are padded to 8 or 16 rows
by the Pallas kernels, so the padding must not show.

Tolerances, relative to each output's largest magnitude: 1e-4 in f32 (the
same sums in another order; measured below 4e-7), 1e-3 in bf16 (the plain
versions round where the Pallas kernels do, so bf16 values agree bit for
bit and only f32 sums differ in order; measured below 2e-7).  The
truncated-run property holds the fused tier to the dense layers at the JAX
test's rtol 2e-4, atol 2e-5 (another attention formulation in f32).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from two_tower_models_tpu.ops.pallas import fused_encoder as jfe
from two_tower_models_tpu_torch.config import HistoryEncoderConfig
from two_tower_models_tpu_torch.models import history_encoder as the
from two_tower_models_tpu_torch.ops import fused_encoder as tfe

_DT = {"f32": (jnp.float32, torch.float32, 1e-4), "bf16": (jnp.bfloat16, torch.bfloat16, 1e-3)}


def _close(got, want, tol):
    got = got.detach().float().numpy()
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)


def _stack_inputs(b, h, d, nl, seed):
    """x with rows past each length zeroed, lengths covering H, 1 and a mix,
    stacked weights with non-zero biases, and a cotangent of y0."""
    r = np.random.default_rng(seed)
    lim_in, lim_out = np.sqrt(6.0 / (4 * d)), np.sqrt(6.0 / (2 * d))
    lens = r.integers(1, h + 1, size=(b,))
    lens[0], lens[1] = h, 1
    x = r.normal(size=(b, h, d)).astype(np.float32)
    x = np.where((np.arange(h)[None, :] < lens[:, None])[..., None], x, 0).astype(np.float32)
    w = [
        r.uniform(-lim_in, lim_in, (nl, d, 3 * d)).astype(np.float32),
        r.uniform(-0.1, 0.1, (nl, 3 * d)).astype(np.float32),
        r.uniform(-lim_out, lim_out, (nl, d, d)).astype(np.float32),
        r.uniform(-0.1, 0.1, (nl, d)).astype(np.float32),
    ]
    g = r.normal(size=(b, d)).astype(np.float32)
    return x, lens.astype(np.int32), w, g


_STACK = [(nl, h) for nl in (1, 2, 3) for h in (5, 12)]  # L = 1: the thin layer alone
B, D, NH = 8, 16, 2


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("nl,h", _STACK)
def test_stack_fwd_plain_matches_pallas(dt, nl, h):
    """B8's plain version against fused_attn_stack: y0 [B, D] in x's dtype."""
    jdt, tdt, tol = _DT[dt]
    x, lens, w, _ = _stack_inputs(B, h, D, nl, seed=h + nl)
    want = jfe.fused_attn_stack(jnp.asarray(x).astype(jdt), jnp.asarray(lens), *map(jnp.asarray, w), NH)
    got = tfe.fused_attn_stack(torch.from_numpy(x).to(tdt), torch.from_numpy(lens),
                               *map(torch.from_numpy, w), NH)
    assert got.dtype == tdt and got.grad_fn is None
    _close(got, want, tol)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("nl,h", _STACK)
def test_stack_bwd_plain_matches_jax_vjp(dt, nl, h):
    """B9's plain version against jax.vjp of fused_attn_stack: dx, dW_in,
    db_in, dW_out and db_out; dx is zero at rows past each length."""
    jdt, tdt, tol = _DT[dt]
    x, lens, w, g = _stack_inputs(B, h, D, nl, seed=h + nl + 1)
    _, vjp = jax.vjp(
        lambda xx, *ww: jfe.fused_attn_stack(xx, jnp.asarray(lens), *ww, NH),
        jnp.asarray(x).astype(jdt), *map(jnp.asarray, w),
    )
    want = vjp(jnp.asarray(g).astype(jdt))
    got = tfe.fused_attn_stack_bwd(torch.from_numpy(g), torch.from_numpy(x).to(tdt),
                                   torch.from_numpy(lens), *map(torch.from_numpy, w), NH)
    assert got[0].dtype == tdt and len(got) == len(want) == 5
    for a, e in zip(got, want):
        _close(a, e, tol)
    past = torch.arange(h)[None, :] >= torch.from_numpy(lens)[:, None]
    assert bool((got[0][past] == 0).all())


def _enc_inputs(b, h, d, nl, seed):
    x, _, w, _ = _stack_inputs(b, h, d, nl, seed)
    r = np.random.default_rng(seed + 100)
    pe = (r.normal(size=(h, d)) * 0.5).astype(np.float32)
    g = r.normal(size=(b, 2, d)).astype(np.float32)
    return r.normal(size=(b, h, d)).astype(np.float32), pe, w, g


# shapes no other test traces the JAX encoder at, so no trace made with the
# residual backward is reused under the patched flag
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("b,h,d,nh,nl", [(7, 12, 16, 2, 3), (3, 5, 16, 4, 1)])
def test_recompute_bwd_plain_matches_jax_vjp(monkeypatch, dt, b, h, d, nh, nl):
    """B7's plain version against jax.vjp of fused_history_encoder with the
    JAX module's _RESIDUAL_BWD set False (read when jax.vjp runs, no jit):
    dx, dPE and the four weight grads."""
    jdt, tdt, tol = _DT[dt]
    x, pe, w, g = _enc_inputs(b, h, d, nl, seed=b + h)
    calls = []
    recompute_bwd = jfe._vjp_bwd
    monkeypatch.setattr(jfe, "_RESIDUAL_BWD", False)
    monkeypatch.setattr(jfe, "_vjp_bwd", lambda *a: calls.append(1) or recompute_bwd(*a))
    _, vjp = jax.vjp(
        lambda xx, *ww: jfe.fused_history_encoder(xx, *ww, nh),
        jnp.asarray(x).astype(jdt), jnp.asarray(pe), *map(jnp.asarray, w),
    )
    want = vjp(jnp.asarray(g).astype(jdt))
    assert calls == [1]  # the JAX side took its recompute backward (B7)
    got = tfe.fused_history_encoder_bwd_recompute(
        torch.from_numpy(g), torch.from_numpy(x).to(tdt), torch.from_numpy(pe),
        *map(torch.from_numpy, w), nh,
    )
    assert got[0].dtype == tdt
    for a, e in zip(got, want):
        _close(a, e, tol)


def _jax_stack_vjp(x, lens, w, g, dt):
    jdt = _DT[dt][0]
    y, vjp = jax.vjp(
        lambda xx, *ww: jfe.fused_attn_stack(xx, jnp.asarray(lens), *ww, NH),
        jnp.asarray(x).astype(jdt), *map(jnp.asarray, w),
    )
    return y, vjp(jnp.asarray(g).astype(jdt))


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_stack_autograd_function_on_cpu(dt):
    """fused_attn_stack with grad wanted goes through _FusedAttnStack (B8
    then B9's plain version, not autograd of the plain forward): its
    output and grads against the JAX VJP; lengths get no grad."""
    _, tdt, tol = _DT[dt]
    x, lens, w, g = _stack_inputs(B, 12, D, 2, seed=3)
    tx = torch.from_numpy(x).to(tdt).requires_grad_()
    tw = [torch.from_numpy(a).requires_grad_() for a in w]
    tl = torch.from_numpy(lens)
    y = tfe.fused_attn_stack(tx, tl, *tw, NH)
    assert type(y.grad_fn).__name__ == "_FusedAttnStackBackward"
    y.backward(torch.from_numpy(g).to(tdt))
    yj, want = _jax_stack_vjp(x, lens, w, g, dt)
    _close(y, yj, tol)
    for leaf, e in zip([tx, *tw], want):
        assert leaf.grad.dtype == leaf.dtype
        _close(leaf.grad, e, tol)
    assert tl.grad is None


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_encoder_recompute_route_on_cpu(monkeypatch, dt):
    """With _RESIDUAL_BWD False the encoder's autograd.Function runs B1
    forward and B7 backward (their plain versions here): same output as B1,
    grads those of B7's plain version (to 1e-6 of each grad's scale) and
    within 3e-2 of B6's, which rounds p where B7 does not."""
    _, tdt, tol = _DT[dt]
    x, pe, w, g = _enc_inputs(6, 8, 16, 2, seed=11)
    leaves = [torch.from_numpy(x).to(tdt), torch.from_numpy(pe), *map(torch.from_numpy, w)]
    grads = {}
    for residual in (False, True):
        monkeypatch.setattr(tfe, "_RESIDUAL_BWD", residual)
        ts = [t.clone().requires_grad_() for t in leaves]
        y = tfe.fused_history_encoder(*ts, NH)
        assert torch.equal(y, tfe.fused_history_encoder_plain(*leaves, NH))
        y.backward(torch.from_numpy(g).to(tdt))
        grads[residual] = [t.grad for t in ts]
    want = tfe.fused_history_encoder_bwd_recompute_plain(torch.from_numpy(g), *leaves, NH)
    for got, e in zip(grads[False], want):  # f32 matmuls may block by alignment
        scale = float(e.float().abs().max())
        torch.testing.assert_close(got, e.to(got.dtype), rtol=0, atol=1e-6 * scale)
    for a, e in zip(grads[False], grads[True]):
        scale = float(e.float().abs().max())
        assert float((a.float() - e.float()).abs().max()) <= 3e-2 * scale


@pytest.mark.parametrize("use_pe", [True, False], ids=["pe", "nope"])
def test_fused_tier_equals_truncated_runs(use_pe):
    """history_encoder_apply with lengths on the fused tier equals, per
    example, the dense encoder run on that example's truncated history
    (mean over L, keys masked, PE flipped at L), as the JAX package's
    tests/test_history_lengths.py holds its tiers; grads of the history are
    zero past each length."""
    h, d, nh, nl, b = 12, 16, 2, 2, 8
    cfg = HistoryEncoderConfig(num_heads=nh, num_layers=nl, use_positional_encoding=use_pe,
                               fused_encoder=True)
    gen = torch.Generator().manual_seed(0)
    enc = the.HistoryEncoder(d, cfg)
    enc.reset_parameters(gen)
    r = np.random.default_rng(2)
    lens = r.integers(1, h + 1, size=(b,))
    lens[0], lens[1] = h, 1
    lens = torch.from_numpy(lens)
    emb = torch.from_numpy(r.normal(size=(b, h, d)).astype(np.float32)).requires_grad_()
    got = the.history_encoder_apply(enc, emb, cfg, lengths=lens)
    dense = dataclasses.replace(cfg, fused_encoder=False)
    with torch.no_grad():
        for i in range(b):
            n = int(lens[i])
            want = the.history_encoder_apply(enc, emb[i : i + 1, :n], dense)
            np.testing.assert_allclose(got[i].detach().numpy(), want[0].numpy(),
                                       rtol=2e-4, atol=2e-5, err_msg=f"example {i} L={n}")
    (got**2).sum().backward()
    for i in range(b):
        n = int(lens[i])
        assert bool((emb.grad[i, n:] == 0).all())
        assert float(emb.grad[i, :n].abs().max()) > 0
