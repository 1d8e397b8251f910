"""PyTorch port: the whole-encoder kernel's plain version and the history
encoder module against the JAX package on the CPU.

The JAX side runs its Pallas kernel in interpret mode, as its own tests do
(tests/test_pallas_fused_encoder.py).  The port's wrapper takes the plain
version for CPU tensors, so this holds the plain version, rounding points
and all, against the kernel it replaces.  Tolerances: f32 at 1e-5 (the same
sums in another order); bf16 at 3e-2 (three layers of bf16 rounding, where
one ulp of a rounded operand is 2^-8 relative).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from two_tower_models_tpu.config import HistoryEncoderConfig as JHistCfg
from two_tower_models_tpu.models import history_encoder as jhe
from two_tower_models_tpu.ops.pallas.fused_encoder import (
    fused_history_encoder as jax_fused_history_encoder,
)
from two_tower_models_tpu_torch import bridge
from two_tower_models_tpu_torch.config import HistoryEncoderConfig as THistCfg
from two_tower_models_tpu_torch.models import history_encoder as the
from two_tower_models_tpu_torch.ops import fused_encoder as tfe

TOL = {np.float32: 1e-5, jnp.bfloat16: 3e-2}


def _inputs(b, h, d, nl, seed):
    """History rows, PE and stacked weights from a numpy seed; biases are
    non-zero so their add is checked too."""
    r = np.random.default_rng(seed)
    lim_in, lim_out = np.sqrt(6.0 / (4 * d)), np.sqrt(6.0 / (2 * d))
    return dict(
        x=r.normal(size=(b, h, d)).astype(np.float32),
        pe=np.asarray(jhe._cached_pe(h, d)),
        w_in=r.uniform(-lim_in, lim_in, (nl, d, 3 * d)).astype(np.float32),
        b_in=r.uniform(-0.1, 0.1, (nl, 3 * d)).astype(np.float32),
        w_out=r.uniform(-lim_out, lim_out, (nl, d, d)).astype(np.float32),
        b_out=r.uniform(-0.1, 0.1, (nl, d)).astype(np.float32),
    )


def _close(got: torch.Tensor, want, tol: float):
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(want, np.float32), rtol=tol, atol=tol
    )


@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("b,h,d,nh,nl", [(48, 32, 64, 4, 3), (64, 10, 64, 2, 1)])
@pytest.mark.parametrize("use_pe", [True, False], ids=["pe", "nope"])
def test_encoder_kernel_plain_matches_pallas(dtype, b, h, d, nh, nl, use_pe):
    a = _inputs(b, h, d, nl, seed=b + h)
    if not use_pe:
        a["pe"] = np.zeros_like(a["pe"])
    xj = jnp.asarray(a["x"]).astype(dtype)
    want = jax_fused_history_encoder(
        xj, *(jnp.asarray(a[k]) for k in ("pe", "w_in", "b_in", "w_out", "b_out")), nh
    )
    tdt = torch.float32 if dtype is np.float32 else torch.bfloat16
    got = tfe.fused_history_encoder(
        torch.from_numpy(a["x"]).to(tdt),
        *(torch.from_numpy(a[k]) for k in ("pe", "w_in", "b_in", "w_out", "b_out")),
        nh,
    )
    assert got.shape == (b, 2, d) and got.dtype == tdt
    _close(got, np.asarray(want.astype(jnp.float32)), TOL[dtype])


def _encoders(d, nh, nl, seed, **cfg_kw):
    jcfg = JHistCfg(num_heads=nh, num_layers=nl, **cfg_kw)
    jparams = jhe.history_encoder_init(jax.random.key(seed), d, jcfg)
    tcfg = THistCfg(num_heads=nh, num_layers=nl, **cfg_kw)
    enc = the.HistoryEncoder(d, tcfg)
    flat = bridge.flatten(jax.tree_util.tree_map(np.asarray, jparams))
    enc.load_state_dict({k: torch.from_numpy(v) for k, v in flat.items()})
    return jcfg, jparams, tcfg, enc


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "dense"])
@pytest.mark.parametrize("use_pe", [True, False], ids=["pe", "nope"])
@pytest.mark.parametrize("cd", [None, "bfloat16"], ids=["f32", "bf16"])
def test_history_encoder_apply_matches_jax(fused, use_pe, cd):
    """history_encoder_apply: the fused branch (kernel, its plain version
    here) and the dense mha_apply branch, with and without PE."""
    b, h, d, nh, nl = 16, 8, 32, 4, 2
    jcfg, jparams, tcfg, enc = _encoders(
        d, nh, nl, seed=5, use_positional_encoding=use_pe, fused_encoder=fused
    )
    x = np.random.default_rng(6).normal(size=(b, h, d)).astype(np.float32)
    jcd = None if cd is None else jnp.bfloat16
    tcd = None if cd is None else torch.bfloat16
    want = jhe.history_encoder_apply(jparams, jnp.asarray(x), jcfg, jcd)
    got = the.history_encoder_apply(enc, torch.from_numpy(x), tcfg, tcd)
    assert got.shape == (b, 2, d) and got.dtype == torch.float32
    _close(got.detach(), want, 1e-5 if cd is None else 3e-2)


def test_history_encoder_lengths_dense_matches_jax():
    """Variable-length histories through the dense layers (the fused
    variable-length kernel is not ported and raises)."""
    b, h, d, nh, nl = 12, 8, 32, 2, 2
    jcfg, jparams, tcfg, enc = _encoders(d, nh, nl, seed=7, fused_encoder=False)
    r = np.random.default_rng(8)
    x = r.normal(size=(b, h, d)).astype(np.float32)
    lengths = r.integers(0, h + 1, size=(b,)).astype(np.int32)
    want = jhe.history_encoder_apply(
        jparams, jnp.asarray(x), jcfg, lengths=jnp.asarray(lengths)
    )
    got = the.history_encoder_apply(
        enc, torch.from_numpy(x), tcfg, lengths=torch.from_numpy(lengths)
    )
    _close(got.detach(), want, 1e-5)
    with pytest.raises(NotImplementedError, match="Variable-length"):
        the.history_encoder_apply(
            enc, torch.from_numpy(x), dataclasses.replace(tcfg, fused_encoder=True),
            lengths=torch.from_numpy(lengths),
        )


def test_positional_encoding_matches_jax():
    np.testing.assert_array_equal(
        the.sinusoidal_positional_encoding(32, 64).numpy(),
        np.asarray(jhe.sinusoidal_positional_encoding(32, 64)),
    )
    lengths = np.asarray([1, 5, 32], np.int32)
    np.testing.assert_array_equal(
        the.per_example_positional_encoding(torch.from_numpy(lengths), 32, 64).numpy(),
        np.asarray(jhe.per_example_positional_encoding(jnp.asarray(lengths), 32, 64)),
    )


def test_encoder_kernel_rejects_unported_layer_kernels():
    _, _, tcfg, enc = _encoders(32, 2, 1, seed=9)
    x = torch.zeros(2, 4, 32)
    for flag in ("fused_kernel", "blockwise_kernel"):
        with pytest.raises(NotImplementedError, match="queue B"):
            the.history_encoder_apply(enc, x, dataclasses.replace(tcfg, **{flag: True}))
