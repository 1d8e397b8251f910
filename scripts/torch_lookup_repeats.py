"""Which lookup gradients of the PyTorch port's training step give new bits
on repeat with the default algorithms, on the card, for the checkout it is
run from:

    python3 scripts/torch_lookup_repeats.py

Two configurations: the flagship step (``chip_smoke.py`` phase 4: 65,536-row
tables, D = 64, H = 32, ``Debias.BOTH``, one batch of B = 4096 uniform ids,
positions on 10 of the 100 rows) and the Zipf one of
``scripts/exp_mns_scale.py`` (the same tables without debiasing, 2^21
samples with ``popularity_skew`` 1.0, one batch of the epoch-0
permutation, 64 uniform catalog ids as the mixed negatives).  For each
lookup of a step (table rows, D, its id stream): the distinct results of
five identical ``F.embedding`` backwards and of five B18 calls
(``ops.scatter_add.rows_scatter_add``), B18 against the plain
``index_add_`` in f64, and the device time of both (torch.profiler).
Then the step's whole gradient (``train_loss``, every leaf) three times
from one state, with the lookups as the checkout routes them and with
every lookup's gradient through B18: the leaves whose bits differ between
calls.

Prints the card's name and power limit, one line a part, then one JSON
line.  Needs a GPU.
"""

import contextlib
import dataclasses
import json
import os
import subprocess
import sys

sys.path.insert(0, os.getcwd())

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from two_tower_models_tpu_torch.config import DataConfig, Debias, resolve_kernel_flags  # noqa: E402
from two_tower_models_tpu_torch.models import two_tower as tt  # noqa: E402
from two_tower_models_tpu_torch.nn import layers  # noqa: E402
from two_tower_models_tpu_torch.ops import _lib  # noqa: E402
from two_tower_models_tpu_torch.ops.scatter_add import rows_scatter_add  # noqa: E402
from two_tower_models_tpu_torch.training import loop  # noqa: E402
from two_tower_models_tpu_torch.training.data import gather_batch, make_synthetic_data  # noqa: E402

B, ROWS, CALLS = 4096, 65536, 5
DEVICE = "cuda"


def distinct(fn, calls: int = CALLS) -> int:
    return len({fn().cpu().numpy().tobytes() for _ in range(calls)})


def lookup_report(dev, name, rows, d, ids):
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    table = torch.randn(rows, d, device=dev, generator=gen).requires_grad_()
    up = torch.randn(*ids.shape, d, device=dev, generator=gen)

    def f_emb():
        with torch.enable_grad():
            return torch.autograd.grad(torch.nn.functional.embedding(ids, table), table, up)[0]

    b18 = lambda: rows_scatter_add(ids.reshape(-1), up.reshape(-1, d), rows)
    want = torch.zeros(rows, d, dtype=torch.float64, device=dev).index_add_(
        0, ids.reshape(-1), up.reshape(-1, d).double())
    err = float((b18().double() - want).abs().max()) / max(float(want.abs().max()), 1e-30)
    n = ids.numel()
    uniq = int(torch.unique(ids).numel())
    top = int(torch.bincount(ids.reshape(-1)).max())
    out = {"lookup": name, "rows": rows, "d": d, "ids": n, "distinct_ids": uniq,
           "most_repeats": top,
           "f_embedding_distinct": distinct(f_emb), "b18_distinct": distinct(b18),
           "b18_err_vs_f64": err,
           "f_embedding_device_ms": cs.call_device_ms(torch, f_emb),
           "b18_device_ms": cs.call_device_ms(torch, b18)}
    print(f"lookup {name}: [{rows}, {d}], {n} ids ({uniq} distinct, at most {top} of one): "
          f"F.embedding backward {out['f_embedding_distinct']} distinct results in {CALLS} calls, "
          f"device {out['f_embedding_device_ms']:.4f} ms; B18 {out['b18_distinct']} distinct, "
          f"device {out['b18_device_ms']:.4f} ms, {err:.3g} of scale from f64 sums", flush=True)
    return out


@contextlib.contextmanager
def every_lookup_through_b18():
    """Every table's lookup gradient through B18: the scatter window opened
    down to one row."""
    lo = layers._SCATTER_KERNEL_MIN_ROWS
    layers._SCATTER_KERNEL_MIN_ROWS = 0
    try:
        yield
    finally:
        layers._SCATTER_KERNEL_MIN_ROWS = lo


def grad_repeats(model, cfg, batch, calls: int = 3):
    """The leaves whose gradient bits differ over ``calls`` identical calls."""
    seen = {}
    with torch.enable_grad():
        for _ in range(calls):
            model.zero_grad(set_to_none=True)
            loss, _ = tt.train_loss(model, cfg, batch)
            loss.backward()
            for n, p in model.named_parameters():
                seen.setdefault(n, set()).add(p.grad.cpu().numpy().tobytes())
    model.zero_grad(set_to_none=True)
    return sorted(n for n, s in seen.items() if len(s) > 1)


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    _lib.library()
    torch.set_grad_enabled(False)
    torch.use_deterministic_algorithms(False)
    dev = torch.device(DEVICE)
    out = {"device": torch.cuda.get_device_name(0), "smi": smi, "lookups": [], "steps": {}}

    # the flagship step: phase 4's configuration and batch
    cfg = resolve_kernel_flags(cs.flagship_cfg(ROWS), dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    model = tt.init_params(gen, cfg, device=dev)
    batch = gather_batch(cs.fixed_batch(torch, gen, dev, cfg, B), torch.arange(B, device=dev))
    for name, rows, d, ids in (
        ("flagship position", cfg.position_table_size, 1, batch.position),
        ("flagship user", ROWS, 64, batch.user_id),
        ("flagship item", ROWS, 64, batch.item_id),
        ("flagship history", ROWS, 64, batch.user_history),
    ):
        out["lookups"].append(lookup_report(dev, name, rows, d, ids))
    out["steps"]["flagship"] = grad_repeats(model, cfg, batch)
    with every_lookup_through_b18():
        out["steps"]["flagship_b18"] = grad_repeats(model, cfg, batch)
    print(f"flagship step, default algorithms: leaves whose gradient differs over 3 calls: "
          f"{out['steps']['flagship']}; with every lookup's gradient through B18: "
          f"{out['steps']['flagship_b18']}", flush=True)
    del model, batch

    # the Zipf configuration of scripts/exp_mns_scale.py
    zcfg = resolve_kernel_flags(dataclasses.replace(cfg, debias=Debias.NONE), dev)
    data_cfg = DataConfig(num_samples=1 << 21, num_users=ROWS, num_items=ROWS, feature_dim=16,
                          history_len=cs.HIST, num_tasks=zcfg.num_tasks, popularity_skew=1.0,
                          seed=42)
    data = make_synthetic_data(data_cfg, label_cols=zcfg.num_tasks, device=dev)
    idx = loop.epoch_permutation(42, 0, data.num_samples, dev)[:B]
    zb = gather_batch(data, idx)
    neg = torch.randint(0, ROWS, (64,), generator=gen, device=dev)
    for name, rows, d, ids in (
        ("zipf user", ROWS, 64, zb.user_id),
        ("zipf item", ROWS, 64, zb.item_id),
        ("zipf history", ROWS, 64, zb.user_history),
        ("zipf negatives", ROWS, 64, neg),
    ):
        out["lookups"].append(lookup_report(dev, name, rows, d, ids))
    model = tt.init_params(gen, zcfg, device=dev)
    out["steps"]["zipf"] = grad_repeats(model, zcfg, zb)
    with every_lookup_through_b18():
        out["steps"]["zipf_b18"] = grad_repeats(model, zcfg, zb)
    print(f"zipf step (no negatives), default algorithms: leaves whose gradient differs over 3 "
          f"calls: {out['steps']['zipf']}; with every lookup's gradient through B18: "
          f"{out['steps']['zipf_b18']}", flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
