"""Structured host-side logging.

Port of ``two_tower_models_tpu/utils/logging.py``: one JSON object a line
(``event``, ``t`` in seconds since the logger was made, then the fields) to
a file and/or stderr, and an optional TensorBoard mirror of the scalar
fields.  Metrics arrive as device tensors; they become host floats only
here, at log boundaries, all of a call's in one transfer.
"""

from __future__ import annotations

import json
import sys
import time
from typing import IO, Mapping, Optional

import torch


def _to_float(v):
    try:
        return float(v)
    except (TypeError, ValueError, RuntimeError):
        return v


class JsonlLogger:
    """One JSON object per line to a file and/or stderr; with
    ``tensorboard_dir``, every numeric field is mirrored to TensorBoard
    (``tensorboardX``) as ``<event>/<field>`` at the record's ``step``
    field, or, for a record without one, at the last step logged."""

    def __init__(
        self,
        path: Optional[str] = None,
        echo: bool = True,
        tensorboard_dir: Optional[str] = None,
    ):
        self._tb = None
        self._tb_step = 0
        if tensorboard_dir:
            try:
                from tensorboardX import SummaryWriter
            except ImportError as e:
                raise ImportError(
                    "tensorboard_dir (--tensorboard_dir) needs the tensorboardX "
                    "package, which is not installed"
                ) from e
            self._tb = SummaryWriter(tensorboard_dir)
        self._fh: Optional[IO[str]] = open(path, "a") if path else None
        self._echo = echo
        self._t0 = time.monotonic()

    def log(self, event: str, **fields):
        record = {"event": event, "t": round(time.monotonic() - self._t0, 3)}
        record.update({k: _to_float(v) for k, v in fields.items()})
        line = json.dumps(record)
        if self._fh:
            self._fh.write(line + "\n")
            self._fh.flush()
        if self._echo:
            print(line, file=sys.stderr)
        if self._tb is not None:
            # A step-less event describes the state as of the last explicit
            # step.  Every field that became a float is mirrored (a bool
            # logs as 0.0 or 1.0, as in the JAX logger); strings are not.
            if "step" in record:
                self._tb_step = int(record["step"])
            for k, v in record.items():
                if k not in ("event", "t", "step") and isinstance(v, float):
                    self._tb.add_scalar(f"{event}/{k}", v, self._tb_step)

    def log_metrics(self, event: str, metrics: Mapping, **fields):
        """Log ``metrics`` (0-d tensors, on any device) read in one transfer:
        one ``torch.stack``, one ``.cpu()``."""
        names = [k for k, v in metrics.items() if isinstance(v, torch.Tensor)]
        host = {k: v for k, v in metrics.items() if k not in names}
        if names:
            stacked = torch.stack([metrics[k].detach().float().reshape(()) for k in names])
            host.update(zip(names, stacked.cpu().tolist()))
        self.log(event, **host, **fields)

    def close(self):
        if self._fh:
            self._fh.close()
            self._fh = None
        if self._tb is not None:
            self._tb.close()
            self._tb = None
