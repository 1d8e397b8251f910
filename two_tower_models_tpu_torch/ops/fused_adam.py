"""One-pass fused Adam (B20).

Port of ``two_tower_models_tpu/ops/pallas/fused_adam.py``: the whole Adam
update of one leaf in a single read-modify-write pass
(``_adam_leaf_kernel``, ``pallas_call`` at :84; ``csrc/fused_adam.cu``):

    m <- b1 m + (1 - b1) g
    v <- b2 v + (1 - b2) g g
    p <- p - lr (m c0) / (sqrt(v c1) + eps),  c = [1/(1 - b1^t), 1/(1 - b2^t)]

The moments are multiplied by the reciprocal bias corrections, as the
Pallas kernel does, where optax and ``training.state.Adam`` divide: the two
differ in the last bits.  ``fused_adam_step`` walks the leaves, the
kernel for leaves of at least ``_MIN_KERNEL_ELEMS`` elements and the plain
formula below that, as the JAX package splits them.  The port updates p, m
and v in place, where JAX returns new arrays; the opt state keeps the
``AdamState`` structure, so checkpoints are interchangeable with the
``Adam`` path.  c is computed on the device from the step count, so a
step has no host sync.
"""

from __future__ import annotations

from typing import Dict

import torch

from two_tower_models_tpu_torch.ops import _lib

# Leaves smaller than this take the plain formula (the JAX constant).
_MIN_KERNEL_ELEMS = 1 << 16
B1, B2, EPS = 0.9, 0.999, 1e-8  # optax.adam's defaults, as the JAX step uses them


def bias_corrections(count: torch.Tensor) -> torch.Tensor:
    """c = [1 / (1 - b1^t), 1 / (1 - b2^t)] f32 [2] for t = ``count``, on
    count's device (``fused_adam_step``'s ``c``)."""
    t = count.float()
    return torch.stack([1.0 / (1.0 - B1**t), 1.0 / (1.0 - B2**t)])


@torch.no_grad()
def fused_adam_leaf_plain(p, m, v, g, c, lr: float) -> None:
    """B20's function in place on one leaf: every operation a torch op of
    its own, rounded on its own (no ``alpha=`` or ``addcmul`` forms, which
    PyTorch's kernels may fuse into one FMA).  p f32 or bf16, m and v f32, g
    any float type (cast to f32), c from ``bias_corrections``."""
    g = g.float()
    m.copy_(m * B1 + g * (1.0 - B1))
    v.copy_(v * B2 + g * (1.0 - B2) * g)
    upd = (m * c[0]) * lr / ((v * c[1]).sqrt() + EPS)
    p.copy_(p.float() - upd)


@torch.no_grad()
def fused_adam_leaf(p, m, v, g, c, lr: float) -> None:
    """One leaf's Adam update in place (``fused_adam_leaf_plain``).  A CPU
    tensor takes the plain version; a CUDA tensor launches kernel B20."""
    if p.device.type == "cpu":
        return fused_adam_leaf_plain(p, m, v, g, c, lr)
    ts = (p, m, v, g, c)
    if any(t.device != p.device for t in ts):
        raise ValueError("fused_adam_leaf: tensors on different devices")
    if p.dtype not in (torch.float32, torch.bfloat16) or g.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError("fused_adam_leaf takes an f32 or bf16 leaf and gradient")
    if m.dtype != torch.float32 or v.dtype != torch.float32 or c.dtype != torch.float32:
        raise TypeError("fused_adam_leaf takes f32 moments and bias corrections")
    if not all(t.is_contiguous() for t in ts) or not (p.shape == m.shape == v.shape == g.shape):
        raise ValueError("fused_adam_leaf takes contiguous p, m, v, g of one shape")
    vec = all(t.data_ptr() % 16 == 0 for t in (p, m, v, g))
    err = _lib.library().tt_fused_adam(
        p.data_ptr(), m.data_ptr(), v.data_ptr(), g.data_ptr(), c.data_ptr(),
        lr, B1, 1.0 - B1, B2, 1.0 - B2, EPS,
        int(p.dtype == torch.bfloat16), int(g.dtype == torch.bfloat16), int(vec), p.numel(),
        _lib.stream_ptr(p),
    )
    _lib.check(err, "fused_adam")
    _lib.launches["fused_adam"] += 1


@torch.no_grad()
def fused_adam_step(params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor], state,
                    learning_rate: float):
    """One Adam step on every leaf ``state`` holds moments for, in place on
    ``params`` (name -> tensor) and the moments: B20 for leaves of at least
    ``_MIN_KERNEL_ELEMS`` elements, the plain formula otherwise.  Returns
    the state with its count incremented (``training.state.AdamState``)."""
    count = state.count + 1
    c = bias_corrections(count)
    for name, m in state.mu.items():
        p, g, v = params[name], grads[name], state.nu[name]
        leaf = fused_adam_leaf if p.numel() >= _MIN_KERNEL_ELEMS else fused_adam_leaf_plain
        leaf(p, m, v, g.contiguous(), c, learning_rate)
    return state._replace(count=count)
