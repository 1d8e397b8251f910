#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (two_tower_models_tpu_torch) on one GPU.

    python3 chip_smoke.py [--seed 0] [--batches 10]

Phases, any failure exits non-zero:

  1. environment: the card's name and power limit (nvidia-smi), torch and
     CUDA versions, and the build of the CUDA kernels from csrc/ (nvcc, on
     first use; cached under two_tower_models_tpu_torch/_build/);
  2. kernels: each of the four kernels of the serving path is held against
     its plain PyTorch version on the card, on the tensors the serving path
     gives it, and timed beside that plain version, a one-call PyTorch
     yardstick where there is one, and its bound on an H100 SXM;
  3. serve: the full-width serving configuration (the exact leg of
     scripts/bench_serving.py: 2^20-item catalog, D=64, H=32, 3-layer 4-head
     bf16 history encoder, k=100, B=1024), weights random from --seed,
     through RetrievalEngine.from_params / warmup / query.  Launch counters
     are zeroed just before the timed batches and read just after: every
     kernel must have run, the select twice per batch.  Indices are held
     against the dense plain MIPS on the same user embeddings, and the user
     embeddings against the CPU run of the same model on a slice.  The user
     tower and the exact MIPS are then timed alone, for the breakdown of a
     batch's time.

Prints one JSON line of per-kernel numbers, then, last, the ok line.  It
imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import argparse
import copy
import json
import subprocess
import sys
import time

# H100 SXM data sheet (dense): HBM bytes/s, f32 CUDA-core and bf16
# tensor-core FLOP/s.
HBM_BPS = 3.35e12
F32_FLOPS = 67e12
BF16_FLOPS = 989e12

CORPUS = 1 << 20
BATCH = 1024
HIST = 32
TOPK = 100
DEVICE = "cuda"


def _fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    raise SystemExit(1)


def time_ms(torch, fn, iters: int = 10) -> float:
    """Mean device time of one call, CUDA events over ``iters`` calls."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(bytes_: float, flops: float, flops_rate: float):
    t_bytes, t_ops = bytes_ / HBM_BPS * 1e3, flops / flops_rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def close(a, b, rtol: float, atol: float) -> tuple[bool, float]:
    """|a - b| <= atol + rtol*|b| where both are finite, and equal where
    either is not; returns (ok, max abs difference over finite entries)."""
    a, b = a.float(), b.float()
    fin = a.isfinite() & b.isfinite()
    err = (a[fin] - b[fin]).abs()
    ok = bool((a[~fin] == b[~fin]).all()) and bool((err <= atol + rtol * b[fin].abs()).all())
    return ok, float(err.max()) if err.numel() else 0.0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--batches", type=int, default=10)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: this smoke run needs a GPU", file=sys.stderr)
        return 2
    try:
        from two_tower_models_tpu_torch.config import (
            Debias, HistoryEncoderConfig, ModelConfig,
        )
        from two_tower_models_tpu_torch.models import two_tower as tt
        from two_tower_models_tpu_torch.models.history_encoder import (
            sinusoidal_positional_encoding,
        )
        from two_tower_models_tpu_torch.ops import _lib
        from two_tower_models_tpu_torch.ops import fused_encoder as fe
        from two_tower_models_tpu_torch.ops import mips_topk as mt
        from two_tower_models_tpu_torch.retrieval.mips import mips_topk, mips_topk_exact
        from two_tower_models_tpu_torch.serving import RetrievalEngine
    except ImportError as e:
        print(f"the port is not importable here: {e}", file=sys.stderr)
        return 2
    torch.set_grad_enabled(False)

    # ---- phase 1: environment and build --------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    _lib.library()
    print(smi, flush=True)
    print(
        f"env: torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()} "
        f"kernel build {_lib.build_seconds if _lib.build_seconds is not None else 0.0:.1f} s "
        f"(load {time.perf_counter() - t0:.1f} s)",
        flush=True,
    )
    dev = torch.device(DEVICE)

    # ---- set-up: full-width model, catalog, engine ---------------------
    cfg = ModelConfig(
        user_id_hash_size=65536,
        user_id_embedding_dim=64,
        item_id_hash_size=CORPUS,
        item_id_embedding_dim=64,
        user_features_size=16,
        item_features_size=16,
        user_value_weights=(1.0, 0.5, 0.25),
        history_len=HIST,
        history_encoder=HistoryEncoderConfig(fused_encoder=True),
        debias=Debias.BOTH,
        compute_dtype="bfloat16",
        num_items=TOPK,
    )
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    model = tt.init_params(gen, cfg, device=dev)
    catalog_ids = torch.arange(CORPUS, device=dev)
    catalog_feats = torch.randn(CORPUS, 16, generator=gen, device=dev)
    engine = RetrievalEngine.from_params(model, cfg, catalog_ids, catalog_feats, device=dev)
    engine.warmup(BATCH)
    corpus = engine.corpus
    batches = [
        (
            torch.randint(0, cfg.user_id_hash_size, (BATCH,), generator=gen, device=dev),
            torch.randn(BATCH, 16, generator=gen, device=dev),
            torch.randint(0, CORPUS, (BATCH, HIST), generator=gen, device=dev),
        )
        for _ in range(args.batches)
    ]
    torch.cuda.synchronize()
    print(f"setup: model + corpus {tuple(corpus.shape)} {corpus.dtype} "
          f"in {time.perf_counter() - t0:.1f} s", flush=True)

    # ---- phase 2: kernels against their plain versions -----------------
    uid, feat, hist = batches[0]
    with torch.inference_mode():
        q, _ = tt.compute_user_embedding(model, cfg, uid, feat, hist)
    layers = model.history_encoder.attn_layers
    w = [torch.stack([getattr(getattr(l, p), a) for l in layers]).detach()
         for p, a in (("in_proj", "w"), ("in_proj", "b"), ("out_proj", "w"), ("out_proj", "b"))]
    pe = sinusoidal_positional_encoding(HIST, 64, dev)
    x_f32 = model.item_id_table.detach()[hist]
    x_bf16 = x_f32.to(torch.bfloat16)
    nh, nl, d, b, c = 4, 3, 64, BATCH, CORPUS
    nt = c // mt.TILE
    entries, failures = {}, []

    def entry(name, source, replaces, ok, err, ms, plain_ms, bytes_, flops, rate, library_ms):
        bms, by = bound(bytes_, flops, rate)
        if not ok:
            failures.append(name)
        entries[name] = {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": 0, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bms, "bound_by": by, "library_ms": library_ms,
        }
        print(f"kernel {name}: ok={ok} max_abs_err={err:.3g} ms={ms:.4f} "
              f"plain_ms={plain_ms:.4f} bound_ms={bms:.4f} ({by}) "
              f"library_ms={library_ms}", flush=True)

    # kernel 1: whole encoder (main path: bf16); f32 checked too
    enc_args = lambda x: (x, pe, *w, nh)
    yk = fe.fused_history_encoder(*enc_args(x_bf16))
    yp = fe.fused_history_encoder_plain(*enc_args(x_bf16))
    ok_bf, err_bf = close(yk, yp, 3e-2, 3e-2)
    ok_32, err_32 = close(fe.fused_history_encoder(*enc_args(x_f32)),
                          fe.fused_history_encoder_plain(*enc_args(x_f32)), 1e-4, 1e-4)
    print(f"encoder f32: ok={ok_32} max_abs_err={err_32:.3g} (tol 1e-4)", flush=True)
    per_ex = (nl - 1) * (2 * HIST * d * 3 * d + 4 * HIST * HIST * d + 2 * HIST * d * d) \
        + (2 * HIST * d * 2 * d + 2 * d * d + 4 * HIST * d + 2 * d * d)
    entry(
        "fused_history_encoder", "two_tower_models_tpu_torch/csrc/fused_encoder.cu",
        "two_tower_models_tpu/ops/pallas/fused_encoder.py:506", ok_bf and ok_32, err_bf,
        time_ms(torch, lambda: fe.fused_history_encoder(*enc_args(x_bf16))),
        time_ms(torch, lambda: fe.fused_history_encoder_plain(*enc_args(x_bf16))),
        b * HIST * d * 2 + HIST * d * 4 + sum(t.numel() for t in w) * 4 + b * 2 * d * 2,
        b * per_ex, BF16_FLOPS, None,
    )

    # kernel 2: tile maxes
    mk = mt.tile_max_scores(q, corpus, mt.TILE, c)
    mp = mt.tile_max_scores_plain(q, corpus, mt.TILE, c)
    scale = float(mp.abs().max())
    ok, err = close(mk, mp, 1e-5, 1e-5 * scale)
    entry(
        "tile_max_scores", "two_tower_models_tpu_torch/csrc/tile_max.cu",
        "two_tower_models_tpu/ops/pallas/mips_topk.py:112", ok, err,
        time_ms(torch, lambda: mt.tile_max_scores(q, corpus, mt.TILE, c)),
        time_ms(torch, lambda: mt.tile_max_scores_plain(q, corpus, mt.TILE, c), 3),
        b * d * 4 + c * d * 4 + b * nt * 4, 2 * b * c * d, F32_FLOPS,
        time_ms(torch, lambda: (q @ corpus.T).view(b, nt, mt.TILE).amax(-1), 3),
    )

    # kernel 3 at pass 2 ([B, NT]) and pass 4 ([B, k*TILE]); kernel 4 between
    kk, ik = mt.select_rows(mk, TOPK)
    kp, ip = mt.select_keys_plain(mt.f32_keys(mk).clamp_min(-(1 << 31) + 1), TOPK)
    ok2 = torch.equal(kk, kp) and torch.equal(ik, ip)
    tile_idx = torch.sort(ik, dim=1).values
    ck = mt.gather_rescore(q, corpus, tile_idx, mt.TILE)
    cp = mt.gather_rescore_plain(q, corpus, tile_idx, mt.TILE)
    ok, err = close(ck, cp, 1e-5, 1e-5 * scale)
    n_tiles_read = int(torch.unique(tile_idx).numel())
    tiles_lib = corpus.view(nt, mt.TILE, d)
    entry(
        "gather_rescore", "two_tower_models_tpu_torch/csrc/gather_rescore.cu",
        "two_tower_models_tpu/ops/pallas/mips_topk.py:559", ok, err,
        time_ms(torch, lambda: mt.gather_rescore(q, corpus, tile_idx, mt.TILE)),
        time_ms(torch, lambda: mt.gather_rescore_plain(q, corpus, tile_idx, mt.TILE), 3),
        n_tiles_read * mt.TILE * d * 4 + b * d * 4 + b * TOPK * 4 + b * TOPK * mt.TILE * 4,
        2 * b * TOPK * mt.TILE * d, F32_FLOPS,
        time_ms(torch, lambda: torch.bmm(
            tiles_lib[tile_idx.long()].view(b, TOPK * mt.TILE, d), q[:, :, None]), 3),
    )
    ck4, ik4 = mt.select_rows(ck, TOPK)
    cp4, ip4 = mt.select_keys_plain(mt.f32_keys(ck).clamp_min(-(1 << 31) + 1), TOPK)
    ok4 = torch.equal(ck4, cp4) and torch.equal(ik4, ip4)
    # the selected values as f32, kernel against plain, over both passes;
    # the pass condition stays exact equality of keys and positions
    _, err2 = close(mt.keys_f32(kk), mt.keys_f32(kp), 0.0, 0.0)
    _, err4 = close(mt.keys_f32(ck4), mt.keys_f32(cp4), 0.0, 0.0)
    sel_err = max(err2, err4)
    idx_mismatch = int((ik != ip).sum()) + int((ik4 != ip4).sum())
    sel_ms = [time_ms(torch, lambda: mt.select_rows(mk, TOPK)),
              time_ms(torch, lambda: mt.select_rows(ck, TOPK))]
    sel_plain = [
        time_ms(torch, lambda: mt.select_keys_plain(mt.f32_keys(mk).clamp_min(-(1 << 31) + 1), TOPK), 3),
        time_ms(torch, lambda: mt.select_keys_plain(mt.f32_keys(ck).clamp_min(-(1 << 31) + 1), TOPK), 3),
    ]
    sel_lib = [time_ms(torch, lambda: torch.topk(mk, TOPK), 3),
               time_ms(torch, lambda: torch.topk(ck, TOPK), 3)]
    print(f"select pass2 exact={ok2} ms={sel_ms[0]:.4f}; pass4 exact={ok4} "
          f"ms={sel_ms[1]:.4f}; index mismatches {idx_mismatch}", flush=True)
    entry(
        "select_topk", "two_tower_models_tpu_torch/csrc/select_topk.cu",
        "two_tower_models_tpu/ops/pallas/mips_topk.py:319", ok2 and ok4, sel_err,
        sum(sel_ms), sum(sel_plain),
        (b * nt * 4 + b * TOPK * 8) + (b * TOPK * mt.TILE * 4 + b * TOPK * 8), 0, F32_FLOPS,
        sum(sel_lib),
    )
    entries["select_topk"]["note"] = "times are pass 2 + pass 4 of one query batch"
    entries["select_topk"]["index_mismatches"] = idx_mismatch
    del mp, cp, tiles_lib
    torch.cuda.empty_cache()

    # ---- phase 3: serve ------------------------------------------------
    _lib.reset_launch_counts()
    torch.cuda.synchronize()
    evs = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
           for _ in batches]
    outs = []
    t0 = time.perf_counter()
    for (s, e), (u, f, h) in zip(evs, batches):
        s.record()
        outs.append(engine.query(u, f, h))
        e.record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(_lib.launches)
    ms = [s.elapsed_time(e) for s, e in evs]
    print(f"launches on the serving path: {json.dumps(counts)}", flush=True)
    expect = {"fused_history_encoder": 1, "tile_max_scores": 1, "select_topk": 2,
              "gather_rescore": 1}
    for name, per in expect.items():
        entries[name]["launches"] = counts.get(name, 0)
        if counts.get(name, 0) != per * len(batches):
            failures.append(f"launches[{name}]={counts.get(name, 0)}")

    hits, total, margin_rows, mismatched = 0, 0, 0, 0
    for (u, f, h), got in zip(batches, outs):
        with torch.inference_mode():
            qq, _ = tt.compute_user_embedding(model, cfg, u, f, h)
            ridx, rsc, _ = mips_topk(corpus, qq, TOPK + 1)
        if got.shape != (BATCH, TOPK) or int(got.min()) < 0 or int(got.max()) >= CORPUS:
            failures.append("serve output shape/range")
        clear = (rsc[:, TOPK - 1] - rsc[:, TOPK]) > 1e-5 * rsc[:, TOPK - 1].abs()
        margin_rows += int(clear.sum())
        same = torch.sort(got[clear], dim=1).values == torch.sort(ridx[clear, :TOPK], dim=1).values
        mismatched += int((~same).any(dim=1).sum())
        for g, r in zip(got.tolist(), ridx[:, :TOPK].tolist()):
            hits += len(set(g) & set(r))
            total += TOPK
    recall = hits / total
    print(f"serve: recall@{TOPK} vs plain {recall:.6f}; clear-margin rows "
          f"{margin_rows} with index mismatch {mismatched}", flush=True)
    if recall < 0.999 or mismatched:
        failures.append("serve indices")

    # user embeddings against the same model on the CPU (plain kernels), 32 rows
    cpu_model = copy.deepcopy(model).cpu()
    u, f, h = (t[:32] for t in batches[0])
    with torch.inference_mode():
        q_gpu, _ = tt.compute_user_embedding(model, cfg, u, f, h)
        q_cpu, _ = tt.compute_user_embedding(cpu_model, cfg, u.cpu(), f.cpu(), h.cpu())
    ok, err = close(q_gpu.cpu(), q_cpu, 3e-2, 3e-2)
    print(f"user embeddings GPU vs CPU: ok={ok} max_abs_err={err:.3g} (tol 3e-2)", flush=True)
    if not ok or not bool(q_gpu.isfinite().all()):
        failures.append("user embeddings vs CPU")

    # where a batch's time goes: the user tower and the MIPS, each alone
    u, f, h = batches[0]
    with torch.inference_mode():
        tower_ms = time_ms(torch, lambda: tt.compute_user_embedding(model, cfg, u, f, h))
        q_serve, _ = tt.compute_user_embedding(model, cfg, u, f, h)
        mips_ms = time_ms(torch, lambda: mips_topk_exact(corpus, q_serve, TOPK))
    print(f"stages: user tower {tower_ms:.4f} ms, exact MIPS {mips_ms:.4f} ms "
          f"per B={BATCH} batch", flush=True)

    ms_batch = sum(ms) / len(ms)
    print(
        f"serve on {torch.cuda.get_device_name(0)} ({smi}): {len(batches)} batches of "
        f"B={BATCH} over C={CORPUS}, k={TOPK}: ms/batch mean {ms_batch:.3f} "
        f"min {min(ms):.3f} max {max(ms):.3f}; QPS {BATCH / ms_batch * 1e3:.0f}; "
        f"host wall {wall * 1e3 / len(batches):.3f} ms/batch",
        flush=True,
    )
    print(json.dumps({"kernels": list(entries.values())}), flush=True)
    if failures:
        _fail(", ".join(failures))
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
