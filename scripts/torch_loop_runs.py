"""What the training loop of the PyTorch port learns at the flagship's width,
and what determinism costs its step, for the checkout it is run from:

    python3 scripts/torch_loop_runs.py

``chip_smoke.py`` phase 9's data (2^21 samples, 65,536 users and items,
B = 4096) through ``training.loop.train`` for 8 epochs, twice: the
flagship (phase 4's model, debias_aux_weight 1/4096, lr 1e-3) and the JAX
package's round-5 quality anchor at the same widths (no debiasing, lr 3e-3;
BASELINE.md:199-209), each with an eval every epoch: per eval recall@100,
per step log (every 512 steps) the loss, the in-batch softmax CE (ln 4096
= 8.318 for uniform scores) and the mean CE weight ``nuv_mean``.  Before
them: F.embedding's backward at the position table's shape (100 x 1,
4096 ids on 10 rows) 20 times with the default and with deterministic
algorithms (distinct results), and the bare flagship step over 128 steps
with each kind of algorithms, in the order deterministic, default,
default, deterministic (host clock, ms/step).

Prints the card's name and power limit, one line a part, then one JSON
line.  Needs a GPU.
"""

import dataclasses
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.getcwd())

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from two_tower_models_tpu_torch.config import (  # noqa: E402
    DataConfig,
    Debias,
    ExperimentConfig,
    TrainConfig,
    resolve_kernel_flags,
)
from two_tower_models_tpu_torch.ops import _lib  # noqa: E402
from two_tower_models_tpu_torch.training import loop  # noqa: E402
from two_tower_models_tpu_torch.training.data import make_synthetic_data  # noqa: E402
from two_tower_models_tpu_torch.training.state import create_train_state  # noqa: E402
from two_tower_models_tpu_torch.training.step import make_train_step  # noqa: E402

B = 4096
EPOCHS = 8
BARE_STEPS = 128
SAMPLES, ROWS = 1 << 21, 65536  # chip_smoke.py's LOOP_SAMPLES, LOOP_USERS = LOOP_ITEMS
DEVICE = "cuda"


def embedding_distinct(dev, calls: int = 20) -> int:
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    table = torch.randn(100, 1, device=dev, generator=gen).requires_grad_()
    ids = torch.randint(0, 10, (B,), device=dev, generator=gen)
    up = torch.randn(B, 1, device=dev, generator=gen)
    seen = set()
    with torch.enable_grad():
        for _ in range(calls):
            (g,) = torch.autograd.grad(torch.nn.functional.embedding(ids, table), table, up)
            seen.add(g.cpu().numpy().tobytes())
    return len(seen)


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    _lib.library()
    torch.set_grad_enabled(False)
    dev = torch.device(DEVICE)
    out = {"device": torch.cuda.get_device_name(0), "smi": smi}

    cs.deterministic(torch, False)
    out["embedding_distinct_default"] = embedding_distinct(dev)
    cs.deterministic(torch, True)
    out["embedding_distinct_deterministic"] = embedding_distinct(dev)
    print(f"F.embedding backward, 100 x 1 table, {B} ids on 10 rows, 20 calls: distinct "
          f"results {out['embedding_distinct_default']} (default algorithms), "
          f"{out['embedding_distinct_deterministic']} (deterministic)", flush=True)

    cfg = dataclasses.replace(cs.flagship_cfg(ROWS), debias_aux_weight=1.0 / 4096)
    data_cfg = DataConfig(num_samples=SAMPLES, num_users=ROWS, num_items=ROWS,
                          feature_dim=16, history_len=cs.HIST, num_tasks=cfg.num_tasks)
    train_cfg = TrainConfig(batch_size=B, learning_rate=1e-3)
    data = make_synthetic_data(data_cfg, label_cols=cfg.num_tasks, device=dev)
    perm = loop.epoch_permutation(0, 0, data_cfg.num_samples, dev)
    step = make_train_step(resolve_kernel_flags(cfg, dev), train_cfg)
    state = create_train_state(0, cfg, train_cfg, device=dev)
    bare = []
    with torch.enable_grad():
        for i in range(3):
            state, _ = step(state, data, perm[i * B:(i + 1) * B])
        for det in (True, False, False, True):
            cs.deterministic(torch, det)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for i in range(BARE_STEPS):
                state, m = step(state, data, perm[(3 + i) * B:(4 + i) * B])
            float(m["loss"])
            bare.append([det, (time.perf_counter() - t0) * 1e3 / BARE_STEPS])
    cs.deterministic(torch, False)
    out["bare_ms_step"] = bare
    print("bare flagship step, ms/step: " + ", ".join(
        f"{'deterministic' if d else 'default'} {ms:.3f}" for d, ms in bare), flush=True)
    del state, data

    n_batches = data_cfg.num_samples // B
    runs = {
        "flagship": (cfg, 1e-3),
        "anchor": (dataclasses.replace(cfg, debias=Debias.NONE), 3e-3),
    }
    for label, (model, lr) in runs.items():
        rec = cs.loop_recorder()
        exp = ExperimentConfig(model=model, data=data_cfg, train=TrainConfig(
            batch_size=B, num_epochs=EPOCHS, learning_rate=lr, log_every=n_batches,
            eval_every=n_batches, seed=0))
        t0 = time.perf_counter()
        summary = loop.train(exp, rec, device=dev)
        res = {
            "seconds": time.perf_counter() - t0,
            "epoch_losses": summary["epoch_losses"],
            "recall_by_epoch": [f["recall_at_k"] for e, f, _ in rec.events
                                if e == "eval" and "step" in f],
            "steps": [{k: f[k] for k in ("step", "loss", "softmax_ce", "nuv_mean")}
                      for e, f, _ in rec.events if e == "step"],
        }
        out[label] = res
        join = lambda values, fmt: " ".join(format(v, fmt) for v in values)
        print(f"{label} (lr {lr}), {EPOCHS} epochs in {res['seconds']:.1f} s: epoch losses "
              f"{join(res['epoch_losses'], '.4f')}; recall@100 by epoch "
              f"{join(res['recall_by_epoch'], '.4f')}; softmax_ce by epoch "
              f"{join([r['softmax_ce'] for r in res['steps']], '.3f')}; nuv_mean "
              f"{join([r['nuv_mean'] for r in res['steps']], '.4f')}", flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
