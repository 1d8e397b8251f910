"""Times of the in-batch CE forward (B10) and the recompute encoder
backward (B7) of the PyTorch port and the busy time of the training steps
that run them, for the checkout it is run from, so that one copy of this
script compares two commits on the same card:

    python3 scripts/torch_ce_times.py
    (cd ../other_checkout && python3 /abs/path/scripts/torch_ce_times.py)

At the flagship training cell (chip_smoke.py phase 4's configuration, model
and fixed batch from seed 0: B = C = 4096, D = 64): ``in_batch_ce_fwd`` on
the step's own user and item embeddings, ``ms`` (CUDA events over 20 calls,
the host's dispatch included) and ``device_ms`` (every kernel of one call,
from torch.profiler, mean of 20, and its split by kernel name); its ce and
lse against a logsumexp of f64 scores (max abs error over max |f64 lse|),
beside the plain version's; the one-call library yardstick
``logsumexp(U I^T) - diag`` timed the same way.  B7
(``fused_history_encoder_bwd_recompute``, the route the checkout gives it)
on the step's own history embeddings and encoder weights with a random
cotangent, timed the same way.  Then four training legs, each 3 warm-up
and 10 timed steps (ms/step by CUDA events, host ms/step, the CE forward's
launches) and three steps under torch.profiler (device busy ms a step):
train-65k-flagship (the fixed batch), the same with B1 + B7 in place of B5
+ B6 (``_RESIDUAL_BWD`` False: -b7), -varlen (make_synthetic_data's
variable-length histories) and train-4M-packed (2^22-row tables stored
packed, dense Adam).  The configurations, batches and step loops are
chip_smoke.py's own, imported from the checkout.

Prints the card's name and power limit, then one JSON line.  Needs a GPU.
"""

import json
import os
import subprocess
import sys

sys.path.insert(0, os.getcwd())

import torch  # noqa: E402

ITERS = 20


def events_ms(fn, iters: int = ITERS) -> float:
    """Mean time of one call, CUDA events over ``iters`` calls."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_times(fn, iters: int = ITERS) -> tuple[float, dict]:
    """Mean device time of one call (every kernel and copy it launches, from
    torch.profiler) and its split by kernel name."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            name = e.name.replace("void ", "").replace("(anonymous namespace)::", "")
            name = name.split("(")[0].split("<")[0].split("::")[-1].strip()[:48]
            by_name[name] = by_name.get(name, 0.0) + e.time_range.elapsed_us() / iters / 1e3
    return sum(by_name.values()), by_name


def train_leg(cs, label, cfg, train_cfg, data, seed):
    """3 warm-up and 10 timed steps, then three under the profiler; the
    encoder's launches of each backward (B6, B7) in the timed steps."""
    from two_tower_models_tpu_torch.training.state import create_train_state
    from two_tower_models_tpu_torch.training.step import make_train_step

    dev = torch.device("cuda")
    state = create_train_state(seed, cfg, train_cfg, device=dev)
    step = make_train_step(cfg, train_cfg)
    idx = torch.arange(train_cfg.batch_size, device=dev)
    state, _, _, _, _ = cs.run_steps(torch, step, state, data, idx, 3)
    state, metrics, ms, host_ms, counts = cs.run_steps(torch, step, state, data, idx, 10)
    state, busy = cs.trace_steps(torch, step, state, data, idx, label)
    out = {"ms_step": ms, "host_ms_step": host_ms, "busy_ms_step": busy,
           "ce_fwd_launches": counts.get("fused_in_batch_ce", 0),
           "b6_launches": counts.get("fused_history_encoder_bwd", 0),
           "b7_launches": counts.get("fused_history_encoder_bwd_recompute", 0),
           "finite": cs.finite(torch, metrics)}
    del state, step
    torch.cuda.empty_cache()
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from two_tower_models_tpu_torch.config import DataConfig, TrainConfig
    from two_tower_models_tpu_torch.models import two_tower as tt
    from two_tower_models_tpu_torch.models.history_encoder import (
        sinusoidal_positional_encoding,
    )
    from two_tower_models_tpu_torch.ops import fused_encoder as fe
    from two_tower_models_tpu_torch.ops import fused_softmax as fs
    from two_tower_models_tpu_torch.training.data import gather_batch, make_synthetic_data
    from two_tower_models_tpu_torch.training.state import create_train_state

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    b, rows = cs.TRAIN_BATCH, cs.TRAIN_ROWS
    cfg = cs.flagship_cfg(rows)
    train_cfg = TrainConfig(batch_size=b, learning_rate=1e-3)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    data = cs.fixed_batch(torch, gen, dev, cfg, b)
    out = {"checkout": os.getcwd()}

    # -- B10 on the flagship step's own embeddings --
    with torch.no_grad():
        model = create_train_state(0, cfg, train_cfg, device=dev).params
        batch = gather_batch(data, torch.arange(b, device=dev))
        u, _ = tt.compute_user_embedding(model, cfg, batch.user_id, batch.user_features,
                                         batch.user_history)
        it = tt.compute_item_embeddings(model, cfg, batch.item_id, batch.item_features)
        s64 = u.double() @ it.double().T
        lse64 = torch.logsumexp(s64, 1)
        ce64 = lse64 - torch.diagonal(s64)
        del s64
        scale = float(lse64.abs().max())
        err = lambda got, want: float((got.double() - want).abs().max()) / scale
        # B7 on the step's history embeddings (bf16, as the encoder takes them)
        layers = model.history_encoder.attn_layers
        w = [torch.stack([getattr(getattr(l, p), a) for l in layers]).detach()
             for p, a in (("in_proj", "w"), ("in_proj", "b"), ("out_proj", "w"),
                          ("out_proj", "b"))]
        x = model.item_id_table.detach()[batch.user_history].to(torch.bfloat16)
        pe = sinusoidal_positional_encoding(x.shape[1], x.shape[2], dev)
        g = (torch.randn(b, 2, x.shape[2], generator=gen, device=dev) / b).to(torch.bfloat16)
        b7 = lambda: fe.fused_history_encoder_bwd_recompute(g, x, pe, *w, 4)  # noqa: E731
        dms7, kernels7 = device_times(b7)
        out["b7"] = {"shape": list(x.shape), "ms": events_ms(b7), "device_ms": dms7,
                     "kernels": kernels7}
        del x, pe, g, w, layers, model
        ce_k, lse_k = fs.in_batch_ce_fwd(u, it)
        ce_p, lse_p = fs.in_batch_ce_fwd_plain(u, it)
        ce_2, lse_2 = fs.in_batch_ce_fwd(u, it)
        b10 = lambda: fs.in_batch_ce_fwd(u, it)
        lib = lambda: torch.logsumexp(u @ it.T, 1) - (u * it).sum(1)
        dms, kernels = device_times(b10)
        lib_dms, _ = device_times(lib)
        out["b10"] = {
            "shape": [b, it.shape[0], u.shape[1]], "ms": events_ms(b10), "device_ms": dms,
            "kernels": kernels, "library_ms": events_ms(lib), "library_device_ms": lib_dms,
            "lse_f64_err": err(lse_k, lse64), "ce_f64_err": err(ce_k, ce64),
            "plain_lse_f64_err": err(lse_p, lse64), "plain_ce_f64_err": err(ce_p, ce64),
            "bit_equal_on_repeat": bool(torch.equal(ce_k, ce_2) and torch.equal(lse_k, lse_2)),
        }
        del u, it, ce_k, lse_k, ce_p, lse_p, ce_2, lse_2, lse64, ce64
    torch.cuda.empty_cache()
    print(json.dumps(out["b10"]), flush=True)

    print(json.dumps(out["b7"]), flush=True)

    # -- the training legs that run them --
    out["train-65k-flagship"] = train_leg(cs, "train-65k-flagship", cfg, train_cfg, data, 1)
    try:
        fe._RESIDUAL_BWD = False
        out["train-65k-flagship-b7"] = train_leg(cs, "train-65k-flagship-b7", cfg, train_cfg,
                                                 data, 1)
    finally:
        fe._RESIDUAL_BWD = True
    varlen = make_synthetic_data(DataConfig(
        num_samples=b, num_users=rows, num_items=rows, feature_dim=16, history_len=cs.HIST,
        num_tasks=3, max_position=cfg.position_table_size, seed=0, variable_history=True,
    ), device=dev)
    out["train-65k-flagship-varlen"] = train_leg(cs, "train-65k-flagship-varlen", cfg, train_cfg,
                                                 varlen, 2)
    del varlen
    cfg4 = cs.flagship_cfg(cs.TABLE_ROWS)
    train4 = TrainConfig(batch_size=b, learning_rate=1e-3, pack_tables_min_rows=cs.PACK_MIN_ROWS)
    gen.manual_seed(5)
    data4 = cs.fixed_batch(torch, gen, dev, cfg4, b)
    out["train-4M-packed"] = train_leg(cs, "train-4M-packed", cfg4, train4, data4, 6)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
