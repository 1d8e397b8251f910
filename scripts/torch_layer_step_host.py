"""Host and device time of the PyTorch port's per-layer tier training step.

Measures the port of the checkout it is run from (its
``two_tower_models_tpu_torch`` and ``chip_smoke.py``), so that one copy of
this script compares two commits on the same card:

    python3 scripts/torch_layer_step_host.py
    (cd ../other_checkout && python3 /abs/path/scripts/torch_layer_step_host.py)

For train-65k-layer and train-65k-layer-varlen (chip_smoke.py phase 6's
configuration, data and seed; 3 warm-up steps each):

- ``ms_step``: 20 steps back to back, CUDA events (as chip_smoke.py);
- ``host_ms_step``: one step dispatched onto an idle card (synchronize,
  then the wall time until the step returns), median of 10: the host's own
  cost of a step, under which ms/step cannot fall;
- ``syncs``: operations of one step that make the host wait for the card
  (CUDA's sync debug mode).

Then B13's wrapper ``fused_mha_fwd`` and B14's ``fused_mha_bwd`` (with a
random cotangent) on layer 0's training input, without and with lengths:
``host_ms`` one call onto an idle card (median of 50) and ``ms`` over 20
calls back to back (CUDA events).

Prints the card's name and power limit, then one JSON line.  Needs a GPU.
"""

import json
import os
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.getcwd())

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def idle_host_ms(fn, n: int) -> float:
    """Median wall time of one call of ``fn`` onto an idle card."""
    times = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return statistics.median(times)


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    from two_tower_models_tpu_torch.config import DataConfig, TrainConfig
    from two_tower_models_tpu_torch.ops import fused_mha as fm
    from two_tower_models_tpu_torch.training.data import gather_batch, make_synthetic_data
    from two_tower_models_tpu_torch.training.state import create_train_state
    from two_tower_models_tpu_torch.training.step import make_train_step

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    torch.set_grad_enabled(False)
    dev = torch.device("cuda")
    cfg = cs.layer_cfg(cs.flagship_cfg(cs.TRAIN_ROWS))
    bt, seed = cs.TRAIN_BATCH, 0
    train_cfg = TrainConfig(batch_size=bt, learning_rate=1e-3)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 9)
    state = create_train_state(gen, cfg, train_cfg, device=dev)
    data = cs.fixed_batch(torch, gen, dev, cfg, bt)
    idx = torch.arange(bt, device=dev)
    var_data = make_synthetic_data(DataConfig(
        num_samples=bt, num_users=cs.TRAIN_ROWS, num_items=cs.TRAIN_ROWS, feature_dim=16,
        history_len=cs.HIST, num_tasks=3, max_position=cfg.position_table_size,
        seed=seed, variable_history=True,
    ), device=dev)
    step = make_train_step(cfg, train_cfg)
    out = {"commit_dir": os.getcwd(), "device": torch.cuda.get_device_name(0), "smi": smi}

    def one_step():
        nonlocal state
        with torch.enable_grad():
            state, _ = step(state, dat, idx)

    for label, dat in (("train-65k-layer", data), ("train-65k-layer-varlen", var_data)):
        state, _, _, _, _ = cs.run_steps(torch, step, state, dat, idx, 3)
        state, _, ms_step, _, _ = cs.run_steps(torch, step, state, dat, idx, cs.TRAIN_STEPS)
        host = idle_host_ms(one_step, 10)
        state, syncs = cs.count_syncs(torch, step, state, dat, idx)
        out[label] = {"ms_step": ms_step, "host_ms_step": host, "syncs": syncs}

    layer = state.params.history_encoder.attn_layers[0]
    w = [getattr(getattr(layer, p), a).detach()
         for p, a in (("in_proj", "w"), ("in_proj", "b"), ("out_proj", "w"), ("out_proj", "b"))]
    x = cs.layer_input(torch, state.params, gather_batch(data, idx).user_history, None)
    lens = torch.randint(1, cs.HIST + 1, (bt,), generator=gen, device=dev)
    g = (torch.randn(x.shape, generator=gen, device=dev) / bt).to(x.dtype)
    for label, ll in (("b13", None), ("b13_varlen", lens), ("b14", None), ("b14_varlen", lens)):
        if label.startswith("b13"):
            call = lambda: fm.fused_mha_fwd(x, ll, *w, 4)  # noqa: E731
        else:
            call = lambda: fm.fused_mha_bwd(g, x, ll, *w, 4)  # noqa: E731
        out[label] = {"host_ms": idle_host_ms(call, 50), "ms": cs.time_ms(torch, call, 20)}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
