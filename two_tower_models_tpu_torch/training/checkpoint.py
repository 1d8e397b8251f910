"""Checkpoint and resume with ``torch.save`` / ``torch.load``.

Port of ``two_tower_models_tpu/training/checkpoint.py``.  A checkpoint is
the whole ``TrainState``: the step, the params' ``state_dict`` in storage
shapes (packed tables stay [V/P, 128]), the optimizer state (``AdamState``,
or ``LazyAdamState`` with its table moments), the ``rng`` generator's state
and the streaming estimator's counts, one file a step,
``<dir>/step_<step>.pt``.  A write goes to a temporary file that
``os.replace`` renames into place, so a reader sees a whole checkpoint or
none; the newest ``max_to_keep`` are kept.

The port updates params and moments IN PLACE (``training.state.Adam``,
``FusedAdam``, lazy Adam's row writes), where the JAX package makes new
arrays.  So ``save`` takes its snapshot before it returns: with
``async_save`` it clones the state on the device, copies the clones to
pinned host memory on a side stream and hands the write to a background
thread, which waits for that copy before it serializes; without, it copies
to the host and writes before it returns.  The writer only ever sees host
tensors, and the next step may overwrite the state at once.

``async_save=None`` picks the mode as the JAX package does: async when the
device-to-host copy runs at ``ASYNC_MIN_D2H_MBPS`` or more (one 8 MB probe
a process and device type), sync below, where the snapshot is the save.
"""

from __future__ import annotations

import os
import re
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Dict, Optional

import torch

from two_tower_models_tpu_torch.config import resolve_device
from two_tower_models_tpu_torch.training.state import AdamState, LazyAdamState, TrainState

ASYNC_MIN_D2H_MBPS = 100.0

_d2h_mbps_cache: Dict[str, float] = {}
_STEP_FILE = re.compile(r"^step_(\d+)\.pt$")


def device_to_host_mbps(device="cuda", probe_mb: float = 8.0) -> float:
    """Measured device-to-host bandwidth in MB/s: one copy of ``probe_mb``
    MB, timed once a process for each device type."""
    dev = resolve_device(device)
    if dev.type not in _d2h_mbps_cache:
        x = torch.arange(int(probe_mb * 1e6 / 4), dtype=torch.float32, device=dev)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        x.to("cpu", copy=True)
        _d2h_mbps_cache[dev.type] = probe_mb / max(time.perf_counter() - t0, 1e-9)
    return _d2h_mbps_cache[dev.type]


def _adam_tensors(prefix: str, s: AdamState) -> Dict[str, torch.Tensor]:
    out = {f"{prefix}count": s.count}
    out.update({f"{prefix}mu.{n}": t for n, t in s.mu.items()})
    out.update({f"{prefix}nu.{n}": t for n, t in s.nu.items()})
    return out


def state_tensors(state: TrainState) -> Dict[str, torch.Tensor]:
    """Every tensor of ``state`` under a flat name: ``step``,
    ``params.<name>``, and ``opt.count``/``opt.mu.<name>``/``opt.nu.<name>``
    (``AdamState``) or ``opt.dense.*`` and ``opt.tables.{mu,nu}.<name>``
    (``LazyAdamState``), ``rng`` (the generator's ``get_state()``, a host
    snapshot) and ``logq.counts``/``logq.total`` where the state has them.
    The other tensors are the state's own, not copies."""
    out = {"step": state.step}
    if state.rng is not None:
        out["rng"] = state.rng.get_state()
    if state.logq_state is not None:
        out["logq.counts"], out["logq.total"] = state.logq_state
    out.update({f"params.{n}": t for n, t in state.params.state_dict().items()})
    opt = state.opt_state
    if isinstance(opt, LazyAdamState):
        out.update(_adam_tensors("opt.dense.", opt.dense))
        for m in ("mu", "nu"):
            out.update({f"opt.tables.{m}.{n}": t for n, t in opt.tables[m].items()})
    else:
        out.update(_adam_tensors("opt.", opt))
    return out


class CheckpointManager:
    """``save`` / ``restore_latest`` of a ``TrainState`` under ``directory``
    on ``device`` (the one the state lives on)."""

    def __init__(
        self,
        directory: str,
        max_to_keep: int = 3,
        async_save: Optional[bool] = None,
        device="cuda",
    ):
        self._device = resolve_device(device)
        if async_save is None:
            async_save = device_to_host_mbps(self._device) >= ASYNC_MIN_D2H_MBPS
        self.async_save = async_save
        self.max_to_keep = max_to_keep
        self._dir = os.path.abspath(directory)
        os.makedirs(self._dir, exist_ok=True)
        self._writer = ThreadPoolExecutor(max_workers=1) if async_save else None
        self._pending: Optional[Future] = None

    def all_steps(self) -> list:
        """The steps saved under the directory, in ascending order."""
        return sorted(int(m.group(1)) for m in map(_STEP_FILE.match, os.listdir(self._dir)) if m)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def _path(self, step: int) -> str:
        return os.path.join(self._dir, f"step_{step}.pt")

    def save(self, state: TrainState, force: bool = False) -> bool:
        """Snapshot ``state`` and write it as its step's checkpoint; with
        ``async_save`` the write finishes in the background (wait with
        ``wait_until_finished`` or ``close``).  Returns False, and writes
        nothing, if the step is already saved: a resumed run that trains no
        new step re-saves its restored step at exit.  ``force`` is the JAX
        manager's override of its save interval; this manager has none, so
        every call saves."""
        self.wait_until_finished()  # one write in flight; its error surfaces here
        step = int(state.step)
        if step in self.all_steps():
            return False
        tensors = state_tensors(state)
        if self._writer is None:
            self._write(step, {k: v.detach().to("cpu", copy=True) for k, v in tensors.items()})
            return True
        self._pending = self._writer.submit(self._write, step, *self._snapshot(tensors))
        return True

    def _snapshot(self, tensors: Dict[str, torch.Tensor]):
        """Host copies of ``tensors`` taken as of now: (copies, an event to
        wait for before reading them, the device clones to hold until
        then).  On CUDA the clones run on the current stream and the copies
        to pinned memory on a side stream, so ``save`` does not wait for
        them."""
        if self._device.type != "cuda":
            return {k: v.detach().clone() for k, v in tensors.items()}, None, None
        clones = {k: v.detach().clone() for k, v in tensors.items()}
        side = torch.cuda.Stream(device=self._device)
        side.wait_stream(torch.cuda.current_stream(self._device))
        host = {}
        with torch.cuda.stream(side):
            for k, v in clones.items():
                host[k] = torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
                host[k].copy_(v, non_blocking=True)
            done = torch.cuda.Event()
            done.record(side)
        return host, done, clones

    def _write(self, step: int, host: Dict[str, torch.Tensor], done=None, clones=None) -> None:
        if done is not None:
            done.synchronize()  # the copies have landed; the clones may go
        del clones
        final = self._path(step)
        tmp = os.path.join(self._dir, f".step_{step}.pt.tmp")
        with open(tmp, "wb") as f:
            torch.save(host, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, final)
        for old in self.all_steps()[: -self.max_to_keep]:
            os.remove(self._path(old))

    def wait_until_finished(self) -> None:
        """Block until the write in flight, if any, is on disk; re-raise its
        error."""
        pending, self._pending = self._pending, None
        if pending is not None:
            pending.result()

    def restore_latest(self, template: TrainState) -> Optional[TrainState]:
        """Copy the newest checkpoint into ``template``'s tensors in place
        (parameters stay the same ``nn.Parameter`` objects; ``rng`` takes
        the saved generator state) and return the template, or None when the
        directory holds none.  Raises
        ``ValueError`` on any missing or extra tensor, or a shape or dtype
        that differs from the template's."""
        self.wait_until_finished()  # an in-flight save must land to be the latest
        step = self.latest_step()
        if step is None:
            return None
        saved = torch.load(self._path(step), map_location="cpu", weights_only=True)
        target = state_tensors(template)
        if saved.keys() != target.keys():
            missing, extra = target.keys() - saved.keys(), saved.keys() - target.keys()
            raise ValueError(
                f"checkpoint step {step} does not match the template: missing "
                f"{sorted(missing)[:5]}, unexpected {sorted(extra)[:5]}"
            )
        for name, t in target.items():
            s = saved[name]
            if s.shape != t.shape or s.dtype != t.dtype:
                raise ValueError(
                    f"checkpoint step {step}: {name} is {s.dtype} {tuple(s.shape)}, "
                    f"the template's {t.dtype} {tuple(t.shape)}"
                )
        with torch.no_grad():
            for name, t in target.items():
                if name == "rng":
                    template.rng.set_state(saved[name])
                else:
                    t.copy_(saved[name])
        return template

    def close(self) -> None:
        """Land the write in flight and stop the writer thread."""
        try:
            self.wait_until_finished()
        finally:
            if self._writer is not None:
                self._writer.shutdown(wait=True)
                self._writer = None
