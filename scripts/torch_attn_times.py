"""Times of the blockwise attention forward (B15) and backward (B16, B17)
of the PyTorch port and of the blockwise tier's legs, for the checkout it
is run from, so that one copy of this script compares two commits on the
same card:

    python3 scripts/torch_attn_times.py [--kernels-only]
    (cd ../other_checkout && python3 /abs/path/scripts/torch_attn_times.py)

B15 (``blockwise_attn_fwd``) at the five shapes chip_smoke.py phase 7
times it, N = 4096, H = 32, Dh = 16 (the serving batch's layer 0, four
heads folded into N) without and with lengths uniform in [1, 32]; N =
16384 (the training batch); N = 4, H = 4096 without and with lengths
uniform in [1, 4096]; and, for the route between them, H = 64, 128, 256
and 512 (N = 4096, 1024, 256, 64), H = 64 and 128 also with lengths
uniform in [1, H]; on normal q, k, v from a numpy seed.
For every kernel the checkout has (the tensor-core kernel on each of its
launch plans, and the FMA kernel), the device time of one
launch (chip_smoke.py's device_ms: torch.profiler, mean of 20) and a hash
of (out, lse).  B16 (dq) and B17 (dk, dv) the same way, at the same
shapes and at N = 1024, H = 4096 (``4k``: the long-history training
batch's fold), given a normal cotangent and the routed B15's lse and delta
= rowsum(do out).  Then the
blockwise tier's legs, with chip_smoke.py's own configurations, seeds and
loops: serve-1M-exact-blockwise and -varlen (ten batches through
RetrievalEngine.query, ms/batch by CUDA events, mean and min) and
train-65k-blockwise and -varlen (3 warm-up and 10 timed steps: ms/step
and host ms/step; then three steps under torch.profiler: device-busy ms a
step), with each leg's launches of B15 and of its tensor-core route, and
train-4k-blockwise (chip_smoke.py phase 7d: B = 256, H = 4096; 2 warm-up
and 5 timed steps, then three profiled) with its launches of B15-B17 on
each route; ``--kernels-only`` leaves the legs out.

Prints the card's name and power limit, then one JSON line.  Needs a GPU.
"""

import hashlib
import inspect
import json
import os
import subprocess
import sys

import numpy as np

sys.path.insert(0, os.getcwd())

import torch  # noqa: E402

ITERS = 20
SHAPES = {"serve": (4096, 32, False), "serve_varlen": (4096, 32, True),
          "train": (16384, 32, False), "long": (4, 4096, False), "long_varlen": (4, 4096, True),
          "h64": (4096, 64, False), "h64_varlen": (4096, 64, True), "h128": (1024, 128, False),
          "h128_varlen": (1024, 128, True), "h256": (256, 256, False), "h512": (64, 512, False)}
BWD_SHAPES = {**SHAPES, "4k": (1024, 4096, False)}  # B16 and B17 also at train-4k-blockwise's
LONG_TRAIN_B, LONG_TRAIN_H, LONG_TRAIN_STEPS = 256, 4096, 5  # chip_smoke.py phase 7d


def digest(*tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().cpu().view(torch.uint8).numpy().tobytes())
    return h.hexdigest()[:16]


def b15_kernels(ha):
    """(label, kernel name, fn(q, k, v, lens)) for every B15 kernel of the
    checkout: the tensor-core kernel on each launch plan, the FMA kernel."""
    if "_route" not in inspect.signature(ha.blockwise_attn_fwd).parameters:
        return [("fma", "attn_fwd_kernel", ha.blockwise_attn_fwd)]
    out = [("fma", "attn_fwd_kernel",
            lambda q, k, v, lens: ha.blockwise_attn_fwd(q, k, v, lens, _route="fma"))]
    for plan in range(len(ha._TC_PLANS)):
        out.append((f"tc_plan{plan}", "attn_fwd_tc_kernel",
                    lambda q, k, v, lens, p=plan: ha._launch_fwd("tc", q, k, v, lens, p)))
    return out


def bwd_kernels(ha):
    """{"B16": [(label, kernel name, fn(*bargs)), ...], "B17": [...]} for
    every B16 and B17 kernel of the checkout: the FMA kernel and, where it
    has them, the tensor-core kernel on each launch plan."""
    if "_route" not in inspect.signature(ha.blockwise_attn_dq).parameters:
        return {"B16": [("fma", "attn_dq_kernel", ha.blockwise_attn_dq)],
                "B17": [("fma", "attn_dkv_kernel", ha.blockwise_attn_dkv)]}
    out = {"B16": [("fma", "attn_dq_kernel", lambda *a: ha.blockwise_attn_dq(*a, _route="fma"))],
           "B17": [("fma", "attn_dkv_kernel",
                    lambda *a: ha.blockwise_attn_dkv(*a, _route="fma"))]}
    for plan in range(len(ha._BWD_PLANS)):
        out["B16"].append((f"tc_plan{plan}", "attn_bwd_tc_kernel<0",
                           lambda *a, p=plan: ha._launch_dq("tc", *a, plan=p)))
        out["B17"].append((f"tc_plan{plan}", "attn_bwd_tc_kernel<1",
                           lambda *a, p=plan: ha._launch_dkv("tc", *a, plan=p)))
    return out


def serve_legs(cs, batches: int = 10) -> dict:
    """chip_smoke.py phase 7b's two serving legs: ms/batch (mean, min) and
    B15's launches on each route."""
    from two_tower_models_tpu_torch.models import two_tower as tt
    from two_tower_models_tpu_torch.ops import _lib
    from two_tower_models_tpu_torch.serving import RetrievalEngine

    dev = torch.device("cuda")
    cfg = cs.blockwise_cfg(cs.serve_cfg())
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    model = tt.init_params(gen, cfg, device=dev)
    feats = torch.randn(cs.CORPUS, 16, generator=gen, device=dev)
    engine = RetrievalEngine.from_params(model, cfg, torch.arange(cs.CORPUS, device=dev), feats,
                                         device=dev)
    engine.warmup(cs.BATCH)
    engine.warmup(cs.BATCH, variable_history=True)
    b, legs = cs.BATCH, {}
    for label, varlen in (("serve-1M-exact-blockwise", False),
                          ("serve-1M-exact-blockwise-varlen", True)):
        bts = []
        for _ in range(batches):
            hist = torch.randint(0, cs.CORPUS, (b, cs.HIST), generator=gen, device=dev)
            lens = None
            if varlen:
                lens = torch.randint(1, cs.HIST + 1, (b,), generator=gen, device=dev)
                hist = torch.where(torch.arange(cs.HIST, device=dev)[None, :] < lens[:, None],
                                   hist, 0)
            bts.append((torch.randint(0, cfg.user_id_hash_size, (b,), generator=gen, device=dev),
                        torch.randn(b, 16, generator=gen, device=dev), hist, lens))
        engine.query(*bts[0][:3], history_len=bts[0][3])
        torch.cuda.synchronize()
        _lib.reset_launch_counts()
        evs = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
               for _ in bts]
        for (s, e), (u, f, h, lens) in zip(evs, bts):
            s.record()
            engine.query(u, f, h, history_len=lens)
            e.record()
        torch.cuda.synchronize()
        ms = [s.elapsed_time(e) for s, e in evs]
        legs[label] = {"ms_batch": sum(ms) / len(ms), "min_ms_batch": min(ms),
                       "b15_launches": _lib.launches.get("blockwise_attn_fwd", 0),
                       "b15_tc_launches": _lib.launches.get("blockwise_attn_fwd_tc", 0)}
    del engine, model, feats
    torch.cuda.empty_cache()
    return legs


def train_legs(cs) -> dict:
    """chip_smoke.py phase 7c's two training legs, 3 warm-up and 10 timed
    steps each, then three under the profiler."""
    from two_tower_models_tpu_torch.config import DataConfig, TrainConfig
    from two_tower_models_tpu_torch.training.data import make_synthetic_data
    from two_tower_models_tpu_torch.training.state import create_train_state
    from two_tower_models_tpu_torch.training.step import make_train_step

    dev = torch.device("cuda")
    bt = cs.TRAIN_BATCH
    cfg = cs.blockwise_cfg(cs.flagship_cfg(cs.TRAIN_ROWS))
    train_cfg = TrainConfig(batch_size=bt, learning_rate=1e-3)
    gen = torch.Generator(device=dev)
    gen.manual_seed(10)
    state = create_train_state(gen, cfg, train_cfg, device=dev)
    data = cs.fixed_batch(torch, gen, dev, cfg, bt)
    var_data = make_synthetic_data(DataConfig(
        num_samples=bt, num_users=cs.TRAIN_ROWS, num_items=cs.TRAIN_ROWS, feature_dim=16,
        history_len=cs.HIST, num_tasks=3, max_position=cfg.position_table_size, seed=0,
        variable_history=True), device=dev)
    idx = torch.arange(bt, device=dev)
    step = make_train_step(cfg, train_cfg)
    legs = {}
    for label, dat in (("train-65k-blockwise", data), ("train-65k-blockwise-varlen", var_data)):
        state, _, _, _, _ = cs.run_steps(torch, step, state, dat, idx, 3)
        state, metrics, ms, host_ms, counts = cs.run_steps(torch, step, state, dat, idx, 10)
        state, busy = cs.trace_steps(torch, step, state, dat, idx, label)
        legs[label] = {"ms_step": ms, "host_ms_step": host_ms, "busy_ms_step": busy,
                       "b15_launches": counts.get("blockwise_attn_fwd", 0),
                       "b15_tc_launches": counts.get("blockwise_attn_fwd_tc", 0),
                       "finite": cs.finite(torch, metrics)}
    del state, data, var_data
    torch.cuda.empty_cache()
    # train-4k-blockwise, with this script's own constants (an older
    # checkout's chip_smoke.py has no phase 7d)
    import dataclasses

    bt = LONG_TRAIN_B
    cfg = dataclasses.replace(cs.blockwise_cfg(cs.flagship_cfg(cs.TRAIN_ROWS)),
                              history_len=LONG_TRAIN_H)
    train_cfg = TrainConfig(batch_size=bt, learning_rate=1e-3)
    gen.manual_seed(20)
    state = create_train_state(gen, cfg, train_cfg, device=dev)
    data = cs.fixed_batch(torch, gen, dev, cfg, bt)
    idx = torch.arange(bt, device=dev)
    label = "train-4k-blockwise"
    step = make_train_step(cfg, train_cfg)
    state, _, _, _, _ = cs.run_steps(torch, step, state, data, idx, 2)
    state, metrics, ms, host_ms, counts = cs.run_steps(torch, step, state, data, idx,
                                                       LONG_TRAIN_STEPS)
    state, busy = cs.trace_steps(torch, step, state, data, idx, label)
    legs[label] = {"ms_step": ms, "host_ms_step": host_ms, "busy_ms_step": busy,
                   "finite": cs.finite(torch, metrics),
                   **{f"{tag}_launches": counts.get(name, 0) for tag, name in (
                       ("b15", "blockwise_attn_fwd"), ("b15_tc", "blockwise_attn_fwd_tc"),
                       ("b16", "blockwise_attn_dq"), ("b16_tc", "blockwise_attn_dq_tc"),
                       ("b17", "blockwise_attn_dkv"), ("b17_tc", "blockwise_attn_dkv_tc"))}}
    del state, data
    torch.cuda.empty_cache()
    return legs


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from two_tower_models_tpu_torch.ops import history_attention as ha

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_grad_enabled(False)
    dev = torch.device("cuda")
    out = {"checkout": os.getcwd(), "card": smi, "b15": {}}
    r = np.random.default_rng(0)
    kernels = b15_kernels(ha)
    for tag, (n, h, varlen) in SHAPES.items():
        q, k, v = (torch.from_numpy(r.normal(size=(n, h, 16)).astype(np.float32)).to(dev)
                   for _ in range(3))
        lens = r.integers(1, h + 1, size=n) if varlen else np.full(n, h)
        lens = torch.from_numpy(lens.astype(np.int32)).to(dev)
        row = {}
        for label, name, fn in kernels:
            row[label] = {"device_ms": cs.device_ms(torch, lambda: fn(q, k, v, lens), name, ITERS),
                          "hash": digest(*fn(q, k, v, lens))}
        out["b15"][tag] = row
        print(f"B15 {tag} (N={n}, H={h}, Dh=16): " + "; ".join(
            f"{lb} {x['device_ms']:.4f} ms" for lb, x in row.items()), flush=True)
        del q, k, v, lens
    torch.cuda.empty_cache()
    bwd = bwd_kernels(ha)
    out["b16"], out["b17"] = {}, {}
    for tag, (n, h, varlen) in BWD_SHAPES.items():
        q, k, v, g = (torch.from_numpy(r.normal(size=(n, h, 16)).astype(np.float32)).to(dev)
                      for _ in range(4))
        lens = r.integers(1, h + 1, size=n) if varlen else np.full(n, h)
        lens = torch.from_numpy(lens.astype(np.int32)).to(dev)
        o, lse = ha.blockwise_attn_fwd(q, k, v, lens)
        bargs = (q, k, v, g, lse, (g * o).sum(-1), lens)
        del o
        for key, kernels in (("b16", bwd["B16"]), ("b17", bwd["B17"])):
            row = {}
            for label, name, fn in kernels:
                row[label] = {"device_ms": cs.device_ms(torch, lambda: fn(*bargs), name,
                                                        10 if h > 1024 else ITERS)}
                res = fn(*bargs)
                row[label]["hash"] = digest(*(res if isinstance(res, tuple) else (res,)))
            out[key][tag] = row
            print(f"{key.upper()} {tag} (N={n}, H={h}, Dh=16): " + "; ".join(
                f"{lb} {x['device_ms']:.4f} ms" for lb, x in row.items()), flush=True)
        del q, k, v, g, lse, bargs
        torch.cuda.empty_cache()
    if "--kernels-only" not in sys.argv[1:]:
        out.update(serve_legs(cs))
        torch.set_grad_enabled(True)
        out.update(train_legs(cs))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
