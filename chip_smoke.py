#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (two_tower_models_tpu_torch) on one GPU.

    python3 chip_smoke.py [--seed 0] [--batches 10]

Phases, in the order they run; any failure exits non-zero:

  1. environment: the card's name and power limit (nvidia-smi), torch and
     CUDA versions, and the build of the CUDA kernels from csrc/ (nvcc, on
     first use; cached under two_tower_models_tpu_torch/_build/); beside the
     build, nvcc -Xptxas -v on csrc/fused_softmax.cu, csrc/fused_mha.cu,
     csrc/select_topk.cu, csrc/rows_write.cu, csrc/fused_encoder.cu and
     csrc/fused_encoder_bwd.cu for the registers, stack and spills of the
     CE backward, of B13's and B14's tensor-core kernels (each instance, by
     key bands), of both select kernels, of each row-write instance, of each
     instance of the whole-encoder tensor-core kernel (encoder_tc_kernel<RES,
     STACK, Hp / 16>: B1, B5, B8) and of its backward
     (encoder_bwd_tc_kernel<MODE, Hp / 16, D>: B6, B9), and their shared
     memory (a spill fails the run);
  2. kernels: each of the four kernels of the serving path is held against
     its plain PyTorch version on the card, on the tensors the serving path
     gives it, and timed beside that plain version, a one-call PyTorch
     yardstick where there is one, and its bound on an H100 SXM.  The
     whole-encoder forward (B1) takes the tensor cores (route "tc"), which
     sum in their own order: its y is held as B13's (at most 0.5% of values
     beyond one bf16 step from plain, all within 1e-2 of scale, at most 1.5
     times the plain version's count beyond one step from the same function
     with f64 sums, bit-equal on repeat), the FMA kernel on the same input
     within one step of plain; its device time beside the FMA kernel's and
     three B13 launches' on the same input; the
     select (B3) on the radix route the path takes and, launched alone,
     on the tournament (k > K_MAX), each with its device time beside
     torch.topk's;
  3. serve: the full-width serving configuration (the exact leg of
     scripts/bench_serving.py: 2^20-item catalog, D=64, H=32, 3-layer 4-head
     bf16 history encoder, k=100, B=1024), weights random from --seed,
     through RetrievalEngine.from_params / warmup / query.  Launch counters
     are zeroed just before the timed batches and read just after: every
     kernel must have run, the select twice per batch on its radix route
     and never on the tournament.  Indices are held
     against the dense plain MIPS on the same user embeddings, and the user
     embeddings against the CPU run of the same model on a slice.  The user
     tower and the exact MIPS are then timed alone, for the breakdown of a
     batch's time;
  2b. serve, variable-length histories: the same engine warmed up with
     variable_history=True, then ten batches with lengths uniform in
     [1, 32] and id 0 past each length.  The length-masked attention stack
     (B8, on the tensor cores) is held and timed as B1 in phase 2 on the
     batch's own tensors;
     launch counts, indices and user embeddings are checked as in phase 3,
     with B8 in place of the whole-encoder forward;
  4. train: the flagship training configuration (bench.py's _bench_cfg,
     copied: 65,536-row user and item tables, D=64, 16 features, T=3,
     H=32, 3-layer 4-head bf16 encoder, Debias.BOTH, fused loss; B=4096,
     Adam at lr 1e-3), weights and one fixed batch random from --seed.
     The training kernels (encoder residual forward on the tensor cores,
     its y and residuals xs, ps, p0 held as B1's y in phase 2, and the
     encoder backward (B6, on the tensor cores) on the plain and on the
     kernel's residuals: within 3e-2 of scale of the plain version, against
     the backward with f64 sums at most 1.5 times the plain version's count
     of dx values beyond one bf16 step and its grads' RMS error, bit-equal
     on repeat, the FMA kernel on the same inputs within 3e-2 of scale; its
     device time beside the FMA kernel's, three B14 launches' of the same
     shape, its bound and phase 1's ptxas line; in-batch
     CE forward, and the CE backward that writes dU and dI in one pass over
     the score tiles, bit-equal on repeat) are held against their plain
     versions on the step's own tensors and timed.  Then 3
     warm-up and 20 timed steps through make_train_step; launch
     counters are zeroed around the timed steps and must show one launch
     per step of each training kernel (and of the backward's reduce), the
     residual forward's and the backward's on the tensor cores, and none
     of the forward-only encoder kernel.  Three more steps run under
     torch.profiler, for the device time per kernel and the device's busy
     share;
  4c. the recompute encoder backward (B7) on phase 4's encoder tensors,
     against its plain version and against B6; then the step with B1 and
     B7 in place of B5 and B6 (_RESIDUAL_BWD False), timed beside the B5/B6
     step in the order B6, B7, B7, B6.  Last, train_loss and its gradients
     at B=256 on the card against a CPU copy of the model;
  4b. train, variable-length histories: the flagship config on
     make_synthetic_data with variable_history (lengths in [1, 32], id 0
     past them).  The stack's backward (B9, on the tensor cores) is held
     and timed as B6 in phase 4 on the step's own tensors, its dx exactly 0
     past each length, and B8 timed there as in phase 2b;
     3 warm-up and 20 timed steps launch B8 and B9 (on the tensor cores) and
     the CE kernels once each and none of the fixed-length encoder kernels; three steps under torch.profiler; grads
     against a CPU copy at B=256;
  5. large tables: scripts/bench_tables.py's configuration (the flagship
     with 2^22-row user and item tables, stored 128-lane packed).  The row
     scatter-add (B18) is held against its plain version at the lookups of
     the legs below and on a stream where id 0 holds about half the ids
     (exactly, on rows of small integers), and timed against F.embedding's
     gradient at 2^16-2^22 rows; the in-place row write (B19) exactly at
     the lazy step's write-backs on its own ids (one launch a table for the
     table and its two moments, and the six one-array launches), timed
     with and without the host's dispatch.  From one seed, the
     first lazy step is held against the first dense step on every
     parameter and table moment.  Three legs, each 2 or 3 warm-up and 10
     timed steps plus three under the profiler: train-4M-packed (dense
     Adam, B18 three times a step through the packed lookups),
     train-4M-lazy (lazy_table_adam: B19 twice a step, no B18) and
     train-1M-plain (2^20-row plain tables, B18 three times a step inside
     the scatter window).  Each leg then runs one step twice from one
     state, through the kernels and on the plain route, and the tables and
     moments must agree.  Last, train_loss and its grads at 2^18 packed
     rows and B=256 on the card against a CPU copy;
  6. the per-layer attention tier (HistoryEncoderConfig fused_kernel=True,
     fused_encoder=False: each attention layer in one kernel, B13 forward,
     B14 backward).  6a: B13 and B14 against their plain versions on layer
     0's tensors of the serving batch (with and without lengths) and of
     the training batch, bf16 and f32, B13 and B14 (bf16: their
     tensor-core kernels) twice (bit-equal), each timed beside its plain
     version, its bound and F.multi_head_attention_forward (B14: that
     call's autograd backward).  The tensor-core kernels sum in f32 in
     their own order, so B13's bf16 y is held as B14's dx is, and against
     the layer (and its backward) with f64 sums they may have at most 1.5
     times the plain version's values beyond one bf16 step (B14's weight
     grads: 1.5 times its RMS error, or 1e-6 of scale); the FMA kernels,
     called through their launchers on the same bf16 inputs, are held as
     before (B13 within one step of the plain version) and timed beside
     them, B14's with its device time, reduce apart, and phase 1's ptxas
     line for its tensor-core instance.
     6b: phase 3's configuration and
     seed on this tier through from_params / warmup / query, ten batches
     with full histories (serve-1M-exact-layer) and ten with lengths
     uniform in [1, 32] (-varlen), launch counts as in phase 3 with three
     B13 a batch, all on the tensor cores, and no B1 or B8, indices and
     user embeddings checked as
     there.  6c: phase 4's configuration on this tier, 3 warm-up and 20
     timed steps on the fixed batch (train-65k-layer) and on
     make_synthetic_data's variable-length histories (-varlen): three B13
     and three B14 (all on the tensor cores) and three reduces a step, the
     CE kernels once, none of B1 and B5-B9; three steps under the profiler
     (the step's device-busy ms beside ms/step and host ms) and
     train_loss's grads at B=256 against a CPU copy for each; the step
     beside phase 4's.
  7. the blockwise attention tier (HistoryEncoderConfig blockwise_kernel=True,
     fused_encoder=False: each layer's attention through B15, and B16 and B17
     for the gradient, between plain projections).  7a: B15 against its plain
     version on layer 0's folded q, k, v of the serving batch (with and without
     lengths) and of the training batch, B16 and B17 there twice (bit-equal),
     and a long-history leg at N=4, H=4096 with and without lengths, whose
     peak memory of forward and backward must stay under a quarter of the
     plain dense autograd's; each timed beside its plain version, its bound
     and F.scaled_dot_product_attention (B16, B17: its autograd backward).
     7b: phase 3's configuration and seed on this tier, ten batches with full
     histories (serve-1M-exact-blockwise) and ten with lengths (-varlen):
     three B15 a batch, none of B1, B8 or B13, indices and user embeddings
     checked as in phase 3.  7c: phase 4's configuration on this tier, 3
     warm-up and 20 timed steps on the fixed batch (train-65k-blockwise) and
     on make_synthetic_data's variable-length histories (-varlen): three
     each of B15, B16 and B17 a step, the CE kernels once, none of B1, B5-B9,
     B13 or B14; a trace and card-vs-CPU grads each; the legs beside phases 4
     and 6;
  8. fused Adam (TrainConfig fused_adam=True) on phase 5's train-4M-packed:
     B20 against its plain version on the state's leaves of 2^16 elements or
     more (the two packed tables), bit for bit over three steps, timed beside
     torch.optim.Adam(fused=True); one step through B20 against one through
     Adam from one state (tables and moments within 1e-6 of their scale);
     the leg train-4M-packed-fusedadam (2 warm-up and 10 timed steps, one B20
     launch a step per such leaf, a trace) beside train-4M-packed.

Phase 2 also holds B2 and the exact pipeline on an integer-grid corpus whose
scores hold +-inf and NaN of both signs (nonfinite_check).

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
TRAIN_ROWS = 65536
TRAIN_BATCH = 4096
TRAIN_STEPS = 20  # timed training steps
CHECK_BATCH = 256  # card-against-CPU gradient check
TABLE_ROWS = 1 << 22  # scripts/bench_tables.py --rows 4194304: packed tables
TABLE_ROWS_1M = 1 << 20  # scripts/bench_checkpoint.py's tables: plain, in the scatter window
PACK_MIN_ROWS = 1 << 22  # TrainConfig's default pack_tables_min_rows
TABLE_STEPS = 10  # timed steps of each large-table leg
CHECK_ROWS = 1 << 18  # large-table card-against-CPU check: the scatter window's lower edge
WINDOW_ROWS = (1 << 16, 1 << 18, 1 << 20, 1 << 22)  # B18 against F.embedding's gradient
BF16_TOL = 1e-2  # tests/test_torch_train_step.py's bf16 tolerance
LONG_N, LONG_H = 4, 4096  # scripts/tpu_kernel_parity.py:275-293's long history (Dh 16)
# a serving batch's selects (k = 100): both on the radix route, none on the tournament
SELECT_ROUTE = {"select_topk_radix": 2, "select_topk": 0}
# the whole-encoder forward's launches on the tensor cores (B1, B5, B8; the
# route of the cells' bf16 encoder): none unless a leg says otherwise
ENC_TC = {"fused_history_encoder_tc": 0, "fused_history_encoder_res_tc": 0,
          "fused_attn_stack_tc": 0, "fused_history_encoder_bwd_tc": 0,
          "fused_attn_stack_bwd_tc": 0}


def _fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    raise SystemExit(1)


def ptxas_report(log: str, kernels, smem: dict) -> tuple[list, dict]:
    """Print each kernel's registers, stack and spills from nvcc -Xptxas -v
    output, a template instance as ``name<n, ...>`` (its int arguments),
    beside the dynamic shared memory ``smem`` gives by that printed name;
    returns (the kernels that spill or gave no report, the report lines by
    printed name)."""
    import re

    lines, cur = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            cur = next((k for k in kernels if k in line), None)
            args = re.findall(r"L[ib](\d+)E", line)
            if cur:
                cur += f"<{', '.join(args)}>" if args else ""
                lines.setdefault(cur, [])
        elif cur and ("Used" in line or "spill" in line):
            lines[cur].append(line.replace("ptxas info    :", "").strip())
    spills = [k for k in kernels if not any(n.split("<")[0] == k for n in lines)]
    for name, got in sorted(lines.items()):
        print(f"ptxas {name}: {'; '.join(got) or 'no report'}; dynamic shared memory "
              + (f"{smem[name]} bytes a block" if name in smem else "set by the launch plan"),
              flush=True)
        if not got or any(" 0 bytes spill stores" not in ln for ln in got if "spill" in ln):
            spills.append(name)
    return spills, lines


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


def device_ms(torch, fn, kernel: str, iters: int = 20) -> float:
    """Mean device time of one launch of the kernel whose name holds
    ``kernel``, from torch.profiler over ``iters`` calls of ``fn``: the
    kernel alone, where time_ms also counts the host's dispatch, which at
    a small batch takes longer than the kernel."""
    fn()
    torch.cuda.synchronize()
    for _ in range(3):  # a window in which the profiler recorded no launch is taken again
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        ev = [e for e in prof.events() if kernel in e.name]
        if ev:
            break
    return sum(e.device_time for e in ev) / max(len(ev), 1) / 1e3


def call_device_ms(torch, fn, iters: int = 20) -> float:
    """Mean device time of one call of ``fn``: every kernel and copy it
    launches, from torch.profiler over ``iters`` calls."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA)
    return us / iters / 1e3


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


def bf16_steps(torch, a, b):
    """Distance between two bf16 tensors value by value, in steps of the
    bf16 number line (0 = bit-equal up to the sign of zero)."""
    keys = [torch.where(v < 0, -(v & 0x7FFF), v)
            for v in (t.contiguous().view(torch.int16).int() for t in (a, b))]
    return (keys[0] - keys[1]).abs()


def bf16_ulps(torch, a, b) -> int:
    """Largest distance between two bf16 tensors in steps of the bf16
    number line; -1 if their NaNs are not in the same places."""
    if not torch.equal(a.isnan(), b.isnan()):
        return -1
    steps = bf16_steps(torch, a, b)[~a.isnan()]
    return int(steps.max()) if steps.numel() else 0


def bf16_far(torch, a, b) -> int:
    """Values of two bf16 tensors more than one bf16 step apart."""
    return int((bf16_steps(torch, a, b) > 1).sum())


def enc_flops(n: int, d: int, nl: int) -> int:
    """Operations of the encoder's layers on one example of n valid rows:
    nl - 1 full layers and the thin last one (query row 0)."""
    return (nl - 1) * (2 * n * d * 3 * d + 4 * n * n * d + 2 * n * d * d) \
        + (2 * n * d * 2 * d + 2 * d * d + 4 * n * d + 2 * d * d)


def bwd_flops(n: int, d: int, nl: int) -> int:
    """Operations of the encoder's backward proper on one example of n valid
    rows.  A full layer: dW_out and do (2nd^2 each), dp, dv, dq and dk (2n^2d
    each), dW_in and dx (6nd^2 each).  The thin last layer, whose output and
    dq are row 0 only: dW_out and do (2d^2 each), dp, dv, dq0 and dk (2nd
    each), dW_in and dx (4nd^2 for k, v and 2d^2 for q, each)."""
    return (nl - 1) * (16 * n * d * d + 8 * n * n * d) \
        + (4 * d * d + 8 * n * d + 8 * n * d * d + 4 * d * d)


def vjp_flops(n: int, d: int, nl: int) -> int:
    """What a backward that recomputes the forward must do on one example of
    n valid rows: the forward but the thin layer's output projection, whose
    result the backward does not need, then the backward."""
    return enc_flops(n, d, nl) - 2 * d * d + bwd_flops(n, d, nl)


def resid_bwd_flops(n: int, d: int, nl: int) -> int:
    """What a backward from stored layer inputs and probabilities must do on
    one example of n valid rows: vjp_flops less the scores and the full
    layers' output projections, which the stored residuals stand for."""
    return vjp_flops(n, d, nl) - (nl - 1) * (2 * n * n * d + 2 * n * d * d) - 2 * n * d


def scaled_close(got, want, tol: float) -> tuple[bool, float]:
    """Each output within ``tol`` of its largest magnitude."""
    return close(got, want, 0.0, tol * float(want.float().abs().max()))


def enc_checks(torch, label, got, again, plain, ref, fma, names):
    """The whole-encoder tensor-core kernel's bf16 outputs ``got`` (y, or y,
    xs, ps, p0; None where the function has none) against the plain
    versions' ``plain``, as B13's y: at most 0.5% of values beyond one bf16
    step, all within 1e-2 of scale; against the same function with f64
    sums ``ref``, at most 1.5 times the plain version's count of values
    beyond one step (or 1e-6 of the values, where both are that rare: ps
    and p0); bit-equal to ``again``, a second run; and the FMA kernel's
    outputs ``fma`` within one step of the plain version's (the same sum
    order).  Returns (ok, max_abs_err)."""
    ok, err, parts = True, 0.0, []
    for name, a, a2, pl, r, f in zip(names, got, again, plain, ref, fma):
        if pl is None:
            continue
        far, n = bf16_far(torch, a, pl), a.numel()
        ok_s, e = scaled_close(a, pl, 1e-2)
        far64 = [bf16_far(torch, t, r) for t in (a, pl)]
        rep = torch.equal(a, a2)
        fma_steps = bf16_ulps(torch, f, pl)
        ok = ok and ok_s and far <= 5e-3 * n and far64[0] <= max(1.5 * far64[1], 1e-6 * n) \
            and rep and 0 <= fma_steps <= 1
        err = max(err, e)
        parts.append(f"{name}: {far} of {n} values beyond one bf16 step (tol 0.5%), max_abs_err "
                     f"{e:.3g} (tol 1e-2 of scale); beyond one step from f64 sums: kernel "
                     f"{far64[0]}, plain {far64[1]} (tol 1.5x, or 1e-6 of the values); "
                     f"bit-equal on repeat={rep}; the FMA kernel {fma_steps} steps from plain")
    print(f"{label} on the tensor cores: " + "; ".join(parts), flush=True)
    return ok, err


def b13_layers(x, lens, w, nh):
    """The per-layer tier's kernel (B13) once a layer on x: full layers,
    every row, the whole-encoder kernels' yardstick."""
    from two_tower_models_tpu_torch.ops import fused_mha as fm

    for l in range(w[0].shape[0]):
        x = fm.fused_mha_fwd(x, lens, w[0][l], w[1][l], w[2][l], w[3][l], nh)
    return x


def bwd_checks(torch, label, got, again, plain, ref, fma, names):
    """An encoder backward on the tensor cores, ``got`` (dx bf16, then the
    f32 grads), against the plain version's ``plain``: each output within
    3e-2 of its scale; against the same function with f64 sums ``ref``: dx
    no more values beyond one bf16 step than 1.5 times the plain version's
    (or 1e-6 of the values, where both are that rare), each grad's RMS
    error relative to its scale at most 1.5 times the plain version's, or
    1e-6 where both are near 0; bit-equal to ``again``, a second run; and
    the FMA kernel's outputs ``fma`` within 3e-2 of scale of the plain
    version's.  Prints a line; returns (ok, max_abs_err)."""
    checks = [scaled_close(a, e, 3e-2) for a, e in zip(got, plain)]
    fma_checks = [scaled_close(a, e, 3e-2) for a, e in zip(fma, plain)]
    n = got[0].numel()
    far = bf16_far(torch, got[0], plain[0])
    far64 = [bf16_far(torch, t[0], ref[0]) for t in (got, plain)]
    rms = [[float((a.double() - e).pow(2).mean().sqrt() / e.abs().max().clamp_min(1e-300))
            for a, e in zip(t[1:], ref[1:])] for t in (got, plain)]
    rep = all(torch.equal(a, a2) for a, a2 in zip(got, again))
    ok64 = far64[0] <= max(1.5 * far64[1], 1e-6 * n) and all(
        k <= max(1.5 * p, 1e-6) for k, p in zip(*rms))
    ok = all(k for k, _ in checks + fma_checks) and ok64 and rep
    print(f"{label} on the tensor cores: dx {far} of {n} values beyond one bf16 step from plain; "
          f"max_abs_err ({', '.join(names)}) {[float(f'{e:.3g}') for _, e in checks]} (tol 3e-2 "
          f"of scale); dx beyond one step from f64 sums: kernel {far64[0]}, plain {far64[1]} "
          f"(tol 1.5x, or 1e-6 of the values); grads' RMS error from f64 sums (of scale) kernel "
          f"{[float(f'{v:.3g}') for v in rms[0]]}, plain {[float(f'{v:.3g}') for v in rms[1]]} "
          f"(tol 1.5x, or 1e-6); bit-equal on repeat={rep}; the FMA kernel max_abs_err "
          f"{[float(f'{e:.3g}') for _, e in fma_checks]} (tol 3e-2 of scale)", flush=True)
    return ok, max(e for _, e in checks)


def b14_layers(torch, x, lens, w, nh):
    """The per-layer tier's backward (B14) once a layer at x's shape, with
    a cotangent of that shape: the whole-encoder backward's yardstick."""
    from two_tower_models_tpu_torch.ops import fused_mha as fm

    g = torch.ones_like(x) / x.shape[0]
    for l in range(w[0].shape[0]):
        fm.fused_mha_bwd(g, x, lens, w[0][l], w[1][l], w[2][l], w[3][l], nh)


def bwd_times(torch, e, tc_fn, fma_fn, b14_fn, ptxas: str) -> None:
    """Beside an encoder backward's entry ``e``: the tensor-core kernel's
    device time and its reduce's, the FMA kernel's on the same inputs (with
    the host's dispatch and device), three B14 launches' device time of the
    same shape, and phase 1's ptxas line of the instance."""
    e["device_ms"] = device_ms(torch, tc_fn, "encoder_bwd_tc_kernel")
    e["reduce_device_ms"] = device_ms(torch, tc_fn, "reduce_kernel")
    e["fma_ms"] = time_ms(torch, fma_fn)
    e["fma_device_ms"] = device_ms(torch, fma_fn, "encoder_bwd_kernel")
    e["b14x3_device_ms"] = call_device_ms(torch, b14_fn)
    e["ptxas"] = ptxas
    e["note"] = (
        "ms includes the second launch that sums the per-block weight grads and the host's "
        "dispatch; device_ms is encoder_bwd_tc_kernel's launch alone and reduce_device_ms the "
        "reduce's (torch.profiler); fma_* the FMA kernel (encoder_bwd_kernel) on the same "
        "inputs; b14x3_device_ms three B14 launches (and reduces) of the same shape")


def bwd_line(torch, smi, label, e) -> str:
    return (f"{label} on {torch.cuda.get_device_name(0)} ({smi}): route {e['kernel_route']} "
            f"{e['ms']:.4f} ms (device time {e['device_ms']:.4f}, its reduce "
            f"{e['reduce_device_ms']:.4f}); the FMA kernel {e['fma_ms']:.4f} (device "
            f"{e['fma_device_ms']:.4f}); three B14 launches, device {e['b14x3_device_ms']:.4f}; "
            f"bound {e['bound_ms']:.4f} ({e['bound_by']}); ptxas {e['ptxas']}")


def enc_times(torch, e, tc_fn, fma_fn, b13_fn, key: str = "") -> None:
    """Beside a whole-encoder kernel's entry ``e`` (``key``: a prefix for
    another shape): the tensor-core kernel's device time, the FMA kernel's
    on the same inputs (with the host's dispatch and device), and the
    device time of three B13 launches on the same input (``b13_layers``)."""
    e[f"{key}device_ms"] = device_ms(torch, tc_fn, "encoder_tc_kernel")
    e[f"{key}fma_ms"] = time_ms(torch, fma_fn)
    e[f"{key}fma_device_ms"] = device_ms(torch, fma_fn, "encoder_kernel")
    e[f"{key}b13x3_device_ms"] = call_device_ms(torch, b13_fn)


def enc_line(torch, smi, label, e, key: str = "") -> str:
    return (f"{label} on {torch.cuda.get_device_name(0)} ({smi}): the tensor cores "
            f"{e[f'{key}ms']:.4f} ms (device {e[f'{key}device_ms']:.4f}); the FMA "
            f"kernel {e[f'{key}fma_ms']:.4f} (device {e[f'{key}fma_device_ms']:.4f}); three B13 "
            f"launches, device {e[f'{key}b13x3_device_ms']:.4f}")


def check_launches(counts: dict, expect: dict, n: int, failures: list, label: str) -> None:
    for name, per in expect.items():
        if counts.get(name, 0) != per * n:
            failures.append(f"{label} launches[{name}]={counts.get(name, 0)}")


def run_steps(torch, step, state, data, idx, n: int):
    """n training steps, the launch counts zeroed just before and read just
    after: (state, metrics, device ms/step, host ms/step, counts)."""
    from two_tower_models_tpu_torch.ops import _lib

    metrics = []
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with torch.enable_grad():
        torch.cuda.synchronize()
        _lib.reset_launch_counts()
        t0 = time.perf_counter()
        start.record()
        for _ in range(n):
            state, m = step(state, data, idx)
            metrics.append(m)
        end.record()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(_lib.launches)
    return state, metrics, start.elapsed_time(end) / n, wall * 1e3 / n, counts


def finite(torch, metrics) -> bool:
    return all(bool(torch.isfinite(v).all()) for m in metrics for v in m.values())


def grads_vs_cpu(torch, model, cfg, data, idx, failures, label: str) -> None:
    """train_loss and every grad leaf on the card against a CPU copy of the
    model, on the first CHECK_BATCH rows of idx, at BF16_TOL of each leaf's
    scale (the zero-gradient leaves against ZERO_GRAD_FLOOR of the top)."""
    from two_tower_models_tpu_torch.models import two_tower as tt
    from two_tower_models_tpu_torch.training.data import gather_batch

    cpu_model = copy.deepcopy(model).cpu()
    sub = gather_batch(data, idx[:CHECK_BATCH])
    sub_cpu = type(sub)(*(None if t is None else t.cpu() for t in sub))
    results = []
    with torch.enable_grad():
        for mdl, bt in ((model, sub), (cpu_model, sub_cpu)):
            mdl.zero_grad(set_to_none=True)
            loss, m = tt.train_loss(mdl, cfg, bt)
            loss.backward()
            results.append(({k: float(v.detach()) for k, v in m.items()},
                            {n: p.grad.detach().float().cpu() for n, p in mdl.named_parameters()}))
    model.zero_grad(set_to_none=True)
    (m_gpu, g_gpu), (m_cpu, g_cpu) = results
    top = max(float(g.abs().max()) for g in g_cpu.values())
    worst, worst_leaf = 0.0, ""
    for name, want in g_cpu.items():
        scale = tt.ZERO_GRAD_FLOOR * top if name in tt.ZERO_GRAD_LEAVES else float(want.abs().max())
        rel = float((g_gpu[name] - want).abs().max()) / max(scale, 1e-30)
        if not (rel <= BF16_TOL):
            failures.append(f"{label} grad {name} card vs CPU: {rel:.3g} of its scale")
        if rel > worst:
            worst, worst_leaf = rel, name
    for k, v in m_cpu.items():
        if not abs(m_gpu[k] - v) <= BF16_TOL * max(abs(v), 1.0):
            failures.append(f"{label} metric {k} card vs CPU: {m_gpu[k]} vs {v}")
    print(f"{label}: train_loss B={CHECK_BATCH} card vs CPU: loss {m_gpu['loss']:.6f} vs "
          f"{m_cpu['loss']:.6f}; worst grad leaf {worst_leaf} at {worst:.3g} of its "
          f"scale (tol {BF16_TOL})", flush=True)


def stack_input(torch, model, hist, lens):
    """What the history encoder hands fused_attn_stack: the embedded
    history zeroed past each length, plus the PE at each length (f32)."""
    from two_tower_models_tpu_torch.models.history_encoder import (
        per_example_positional_encoding,
    )

    emb = model.item_id_table.detach()[hist]
    valid = torch.arange(HIST, device=hist.device)[None, :] < lens[:, None]
    return torch.where(valid[..., None], emb, 0) + per_example_positional_encoding(
        lens, HIST, emb.shape[-1])


def serve_leg(torch, label, engine, model, cpu_model, cfg, batches, expect, own,
              entries, failures, smi) -> None:
    """Ten query batches through engine.query, launch counts zeroed just
    before and read just after (``own``: the kernels whose ``launches`` this
    leg reports); indices against the dense plain MIPS on the same user
    embeddings, and the user embeddings against the CPU model on 32 rows."""
    from two_tower_models_tpu_torch.models import two_tower as tt
    from two_tower_models_tpu_torch.ops import _lib
    from two_tower_models_tpu_torch.retrieval.mips import mips_topk

    _lib.reset_launch_counts()
    torch.cuda.synchronize()
    evs = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
           for _ in batches]
    outs = []
    t0 = time.perf_counter()
    for (s, e), (u, f, h, lens) in zip(evs, batches):
        s.record()
        outs.append(engine.query(u, f, h, history_len=lens))
        e.record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(_lib.launches)
    ms = [s.elapsed_time(e) for s, e in evs]
    print(f"launches on the {label} path: {json.dumps(counts)}", flush=True)
    check_launches(counts, expect, len(batches), failures, label)
    for name in own:
        entries[name]["launches"] = counts.get(name, 0)

    hits, total, margin_rows, mismatched = 0, 0, 0, 0
    for (u, f, h, lens), got in zip(batches, outs):
        with torch.inference_mode():
            qq, _ = tt.compute_user_embedding(model, cfg, u, f, h, lens)
            ridx, rsc, _ = mips_topk(engine.corpus, qq, TOPK + 1)
        if got.shape != (BATCH, TOPK) or int(got.min()) < 0 or int(got.max()) >= CORPUS:
            failures.append(f"{label} output shape/range")
        clear = (rsc[:, TOPK - 1] - rsc[:, TOPK]) > 1e-5 * rsc[:, TOPK - 1].abs()
        margin_rows += int(clear.sum())
        same = torch.sort(got[clear], dim=1).values == torch.sort(ridx[clear, :TOPK], dim=1).values
        mismatched += int((~same).any(dim=1).sum())
        for g, r in zip(got.tolist(), ridx[:, :TOPK].tolist()):
            hits += len(set(g) & set(r))
            total += TOPK
    recall = hits / total
    print(f"{label}: recall@{TOPK} vs plain {recall:.6f}; clear-margin rows "
          f"{margin_rows} with index mismatch {mismatched}", flush=True)
    if recall < 0.999 or mismatched:
        failures.append(f"{label} indices")

    u, f, h, lens = (None if t is None else t[:32] for t in batches[0])
    cpu = lambda t: None if t is None else t.cpu()
    with torch.inference_mode():
        q_gpu, _ = tt.compute_user_embedding(model, cfg, u, f, h, lens)
        q_cpu, _ = tt.compute_user_embedding(cpu_model, cfg, cpu(u), cpu(f), cpu(h), cpu(lens))
    ok, err = close(q_gpu.cpu(), q_cpu, 3e-2, 3e-2)
    print(f"{label} user embeddings GPU vs CPU: ok={ok} max_abs_err={err:.3g} (tol 3e-2)",
          flush=True)
    if not ok or not bool(q_gpu.isfinite().all()):
        failures.append(f"{label} user embeddings vs CPU")
    ms_batch = sum(ms) / len(ms)
    print(
        f"{label} on {torch.cuda.get_device_name(0)} ({smi}): {len(batches)} batches of "
        f"B={BATCH} over C={CORPUS}, k={TOPK}: ms/batch mean {ms_batch:.3f} "
        f"min {min(ms):.3f} max {max(ms):.3f}; QPS {BATCH / ms_batch * 1e3:.0f}; "
        f"host wall {wall * 1e3 / len(batches):.3f} ms/batch",
        flush=True,
    )
    return counts, ms_batch


def phase_serve_varlen(torch, args, gen, smi, dev, cfg, model, cpu_model, engine, w,
                       entry, entries, failures) -> None:
    """Phase 2b: B8 on a variable-length batch, then the varlen serve leg."""
    from two_tower_models_tpu_torch.ops import fused_encoder as fe

    nh, nl, d = 4, 3, 64
    engine.warmup(BATCH, variable_history=True)
    batches = []
    for _ in range(args.batches):
        lens = torch.randint(1, HIST + 1, (BATCH,), generator=gen, device=dev)
        hist = torch.randint(0, CORPUS, (BATCH, HIST), generator=gen, device=dev)
        hist = torch.where(torch.arange(HIST, device=dev)[None, :] < lens[:, None], hist, 0)
        batches.append((
            torch.randint(0, cfg.user_id_hash_size, (BATCH,), generator=gen, device=dev),
            torch.randn(BATCH, 16, generator=gen, device=dev), hist, lens,
        ))
    _, _, hist, lens = batches[0]
    x = stack_input(torch, model, hist, lens)
    xb = x.to(torch.bfloat16)
    route = fe._enc_route(torch.bfloat16, HIST, d, nh, nl)
    l32, w_k = fe._lens(lens, xb), [fe._f32(t, dev) for t in w]
    fma8 = lambda: fe._launch_fwd_fma("fused_attn_stack", xb, l32, *w_k, nh)
    ok_bf, err_bf = enc_checks(
        torch, "attention stack", (fe.fused_attn_stack_fwd(xb, lens, *w, nh),),
        (fe.fused_attn_stack_fwd(xb, lens, *w, nh),), (fe.fused_attn_stack_fwd_plain(xb, lens, *w, nh),),
        (fe.fused_attn_stack_f64_sums(xb, lens, *w, nh),), (fma8(),), ("y",))
    ok_32, err_32 = close(fe.fused_attn_stack_fwd(x, lens, *w, nh),
                          fe.fused_attn_stack_fwd_plain(x, lens, *w, nh), 1e-4, 1e-4)
    print(f"attention stack route {route}; f32: ok={ok_32} max_abs_err={err_32:.3g} (tol 1e-4)",
          flush=True)
    n_valid = int(lens.sum())
    w_bytes = sum(t.numel() for t in w) * 4
    entry(
        "fused_attn_stack", "two_tower_models_tpu_torch/csrc/fused_encoder.cu",
        "two_tower_models_tpu/ops/pallas/fused_encoder.py:853",
        ok_bf and ok_32 and route == "tc", err_bf,
        time_ms(torch, lambda: fe.fused_attn_stack_fwd(xb, lens, *w, nh)),
        time_ms(torch, lambda: fe.fused_attn_stack_fwd_plain(xb, lens, *w, nh)),
        n_valid * d * 2 + BATCH * 4 + w_bytes + BATCH * d * 2,
        sum(enc_flops(n, d, nl) for n in lens.tolist()), BF16_FLOPS, None,
    )
    e8 = entries["fused_attn_stack"]
    e8["kernel_route"] = route
    enc_times(torch, e8, lambda: fe.fused_attn_stack_fwd(xb, lens, *w, nh), fma8,
              lambda: b13_layers(xb, l32, w, nh))
    print(enc_line(torch, smi, f"B8 at B={BATCH}", e8), flush=True)
    e8["note"] = (
        "bytes and operations count each example's valid rows only; kernel_route, device_ms, "
        "fma_* and b13x3_device_ms as fused_history_encoder's, with lengths; train_* at the "
        "training batch (B=4096) of phase 4b")
    counts, _ = serve_leg(
        torch, "serve varlen", engine, model, cpu_model, cfg, batches,
        {"fused_attn_stack": 1, "fused_history_encoder": 0, "tile_max_scores": 1,
         **SELECT_ROUTE, "gather_rescore": 1, **ENC_TC, "fused_attn_stack_tc": 1},
        ["fused_attn_stack"], entries, failures, smi,
    )
    e8["tc_launches"] = counts.get("fused_attn_stack_tc", 0)


def trace_steps(torch, step, state, data, idx, label: str):
    """Three steps under torch.profiler: device time per kernel (device-side
    events only: kernels and copies, one stream) and the device's busy
    share of the window.  Returns (the state, device-busy ms a step, None if
    the profiler recorded no device time)."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with torch.enable_grad(), torch.profiler.profile(activities=acts) as prof:
        start.record()
        for _ in range(3):
            state, _ = step(state, data, idx)
        end.record()
        torch.cuda.synchronize()
    window_us = start.elapsed_time(end) * 1e3
    by_name = {}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            by_name[ev.name] = by_name.get(ev.name, 0.0) + ev.time_range.elapsed_us()
    busy = sum(by_name.values())
    if busy:
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        print(f"{label} trace, 3 steps under the profiler ({window_us / 3e3:.3f} ms/step): "
              f"device busy {busy / 3e3:.3f} ms/step ({busy / window_us * 100:.1f}% of the "
              f"window) in {len(by_name)} distinct kernels and copies; top per step: "
              + "; ".join(f"{k[:48]} {v / 3e3:.3f} ms" for k, v in top), flush=True)
    else:
        print(f"{label} trace: the profiler recorded no device time (not measured)", flush=True)
    return state, busy / 3e3 if busy else None


def flagship_cfg(rows: int):
    """bench.py's _bench_cfg, copied, with ``rows``-row user and item
    tables; at 2^22 rows it is scripts/bench_tables.py's configuration."""
    from two_tower_models_tpu_torch.config import Debias, HistoryEncoderConfig, ModelConfig

    return ModelConfig(
        user_id_hash_size=rows,
        user_id_embedding_dim=64,
        item_id_hash_size=rows,
        item_id_embedding_dim=64,
        user_features_size=16,
        item_features_size=16,
        user_value_weights=(1.0, 0.5, 0.25),
        history_len=HIST,
        history_encoder=HistoryEncoderConfig(fused_encoder=True),
        debias=Debias.BOTH,
        compute_dtype="bfloat16",
        fused_loss=True,
    )


def serve_cfg():
    """The exact leg of scripts/bench_serving.py (phase 3's configuration)."""
    from two_tower_models_tpu_torch.config import Debias, HistoryEncoderConfig, ModelConfig

    return ModelConfig(
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


def fixed_batch(torch, gen, dev, cfg, b: int):
    """One fixed batch of b rows for ``cfg`` with __graft_entry__._make_batch's
    shapes: ids uniform over the tables, positions over the position table."""
    from two_tower_models_tpu_torch.training.data import SyntheticRecData

    randint = lambda hi, *shape: torch.randint(0, hi, shape, generator=gen, device=dev)
    randn = lambda *shape: torch.randn(shape, generator=gen, device=dev)
    return SyntheticRecData(
        user_ids=randint(cfg.user_id_hash_size, b),
        user_features=randn(b, cfg.user_features_size),
        user_history=randint(cfg.item_id_hash_size, b, cfg.history_len),
        item_ids=randint(cfg.item_id_hash_size, b),
        item_features=randn(b, cfg.item_features_size),
        positions=randint(cfg.position_table_size, b),
        labels=torch.bernoulli(torch.full((b, cfg.num_tasks), 0.5, device=dev), generator=gen),
        catalog_ids=torch.arange(4, device=dev),
        catalog_features=torch.zeros(4, cfg.item_features_size, device=dev),
    )


def phase_train(torch, args, smi, dev, entry, entries, failures, b6_ptxas: str):
    from two_tower_models_tpu_torch.config import TrainConfig
    from two_tower_models_tpu_torch.models import two_tower as tt
    from two_tower_models_tpu_torch.models.history_encoder import (
        sinusoidal_positional_encoding,
    )
    from two_tower_models_tpu_torch.ops import fused_encoder as fe
    from two_tower_models_tpu_torch.ops import fused_softmax as fs
    from two_tower_models_tpu_torch.training.data import gather_batch
    from two_tower_models_tpu_torch.training.state import create_train_state
    from two_tower_models_tpu_torch.training.step import make_train_step

    cfg = flagship_cfg(TRAIN_ROWS)
    train_cfg = TrainConfig(batch_size=TRAIN_BATCH, learning_rate=1e-3)
    b, d, h, nh, nl = TRAIN_BATCH, 64, HIST, 4, 3
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed + 1)
    state = create_train_state(gen, cfg, train_cfg, device=dev)
    model = state.params
    randn = lambda *shape: torch.randn(shape, generator=gen, device=dev)
    data = fixed_batch(torch, gen, dev, cfg, b)
    idx = torch.arange(b, device=dev)
    batch = gather_batch(data, idx)

    # -- the five training kernels on the step's own tensors --
    with torch.no_grad():
        u, _ = tt.compute_user_embedding(model, cfg, batch.user_id, batch.user_features,
                                         batch.user_history)
        it = tt.compute_item_embeddings(model, cfg, batch.item_id, batch.item_features)
        nuv, _ = tt.example_weights(model, cfg, u, batch.position, batch.labels)
    g_ce = nuv / b  # the cotangent of ce in the loss
    ce_k, lse_k = fs.in_batch_ce_fwd(u, it)
    ce_p, lse_p = fs.in_batch_ce_fwd_plain(u, it)
    ok_c, err_c = close(ce_k, ce_p, 0.0, 1e-5 * float(ce_p.abs().max()))
    ok_l, err_l = close(lse_k, lse_p, 0.0, 1e-5 * float(lse_p.abs().max()))
    ce_lib = lambda: torch.logsumexp(u @ it.T, 1) - (u * it).sum(1)
    entry(
        "fused_in_batch_ce", "two_tower_models_tpu_torch/csrc/fused_softmax.cu",
        "two_tower_models_tpu/ops/pallas/fused_softmax.py:121", ok_c and ok_l,
        max(err_c, err_l),
        time_ms(torch, lambda: fs.in_batch_ce_fwd(u, it)),
        time_ms(torch, lambda: fs.in_batch_ce_fwd_plain(u, it)),
        2 * b * d * 4 + 2 * b * 4, 2 * b * b * d, F32_FLOPS, time_ms(torch, ce_lib),
    )
    # B11 and B12: one pass over the score tiles writes both gradients
    term = float(g_ce.abs().max()) * max(float(u.abs().max()), float(it.abs().max()))
    (du_k, di_k), (du_p, di_p) = (fs.in_batch_ce_bwd(u, it, lse_k, g_ce),
                                  fs.in_batch_ce_bwd_plain(u, it, lse_p, g_ce))
    checks = [close(got, want, 0.0, 1e-5 * max(float(want.abs().max()), term))
              for got, want in ((du_k, du_p), (di_k, di_p))]
    du_2, di_2 = fs.in_batch_ce_bwd(u, it, lse_k, g_ce)
    repeat = torch.equal(du_k, du_2) and torch.equal(di_k, di_2)
    print(f"CE backward (dU, dI) vs plain: max_abs_err {[float(f'{e:.3g}') for _, e in checks]} "
          f"(tol 1e-5 of scale); bit-equal on repeat={repeat}", flush=True)

    def ce_bwd_lib():  # one softmax, both gradients
        sm = torch.softmax(u @ it.T, 1) * g_ce[:, None]
        return sm @ it - g_ce[:, None] * it, sm.T @ u - g_ce[:, None] * u

    entry(
        "in_batch_ce_bwd", "two_tower_models_tpu_torch/csrc/fused_softmax.cu",
        "two_tower_models_tpu/ops/pallas/fused_softmax.py:228 and :246",
        all(ok for ok, _ in checks) and repeat, max(err for _, err in checks),
        time_ms(torch, lambda: fs.in_batch_ce_bwd(u, it, lse_k, g_ce)),
        time_ms(torch, lambda: fs.in_batch_ce_bwd_plain(u, it, lse_k, g_ce)),
        4 * b * d * 4 + 2 * b * 4, 6 * b * b * d, F32_FLOPS, time_ms(torch, ce_bwd_lib),
    )
    entries["in_batch_ce_bwd"]["note"] = (
        "B11 (dU) and B12 (dI) in one kernel; ms includes the launch that sums its partial slices")
    del ce_p, lse_p, du_k, di_k, du_p, di_p, du_2, di_2

    layers = model.history_encoder.attn_layers
    w = [torch.stack([getattr(getattr(l, p), a) for l in layers]).detach()
         for p, a in (("in_proj", "w"), ("in_proj", "b"), ("out_proj", "w"), ("out_proj", "b"))]
    pe = sinusoidal_positional_encoding(h, d, dev)
    x = model.item_id_table.detach()[batch.user_history].to(torch.bfloat16)
    res_k = fe.fused_history_encoder_res(x, pe, *w, nh)
    res_p = fe.fused_history_encoder_res_plain(x, pe, *w, nh)
    route = fe._enc_route(x.dtype, h, d, nh, nl)
    w_k = [fe._f32(t, dev) for t in w]
    fma5 = lambda: fe._launch_fwd_fma("fused_history_encoder_res", x, fe._pe(pe, x), *w_k, nh)
    ok5, err5 = enc_checks(
        torch, "encoder residual forward", res_k, fe.fused_history_encoder_res(x, pe, *w, nh),
        res_p, fe.fused_history_encoder_res_f64_sums(x, pe, *w, nh), fma5(),
        ("y", "xs", "ps", "p0"))
    w_bytes = sum(t.numel() for t in w) * 4 + pe.numel() * 4
    resid_bytes = (nl * b * h * d + (nl - 1) * b * nh * h * h + b * nh * h) * 2
    entry(
        "fused_history_encoder_res", "two_tower_models_tpu_torch/csrc/fused_encoder.cu",
        "two_tower_models_tpu/ops/pallas/fused_encoder.py:561", ok5 and route == "tc", err5,
        time_ms(torch, lambda: fe.fused_history_encoder_res(x, pe, *w, nh)),
        time_ms(torch, lambda: fe.fused_history_encoder_res_plain(x, pe, *w, nh)),
        b * h * d * 2 + w_bytes + b * 2 * d * 2 + resid_bytes, b * enc_flops(h, d, nl),
        BF16_FLOPS, None,
    )
    e5 = entries["fused_history_encoder_res"]
    e5["kernel_route"] = route
    x0 = (x.float() + pe).to(torch.bfloat16)
    enc_times(torch, e5, lambda: fe.fused_history_encoder_res(x, pe, *w, nh), fma5,
              lambda: b13_layers(x0, None, w, nh))
    print(enc_line(torch, smi, f"B5 at B={b}", e5), flush=True)
    e5["note"] = "kernel_route, device_ms, fma_* and b13x3_device_ms as fused_history_encoder's"
    del x0
    # B6 on the plain residuals, so it is held alone; the cotangent is
    # random at the size of a loss averaged over B (bf16, as autograd gives it)
    g_enc = (randn(b, 2, d) / b).to(torch.bfloat16)
    _, xs, ps, p0 = res_p
    bwd_args = (g_enc, xs, ps, p0, w[0], w[1], w[2], nh)
    route6 = fe._enc_bwd_route(x.dtype, h, d, nh, nl)
    inputs6, shapes6 = fe._res_bwd_inputs(*bwd_args), fe._grad_shapes(h, d, nl, True)

    def fma6():  # the FMA kernel on the same inputs, its outputs in the wrapper's order
        dx6 = torch.empty_like(x)
        dwi, dbi, dwo, dbo, dpe = fe._launch_bwd_fma("fused_history_encoder_bwd", inputs6, dx6,
                                                     shapes6, nh, nl)
        return dx6, dpe, dwi, dbi, dwo, dbo

    want = fe.fused_history_encoder_bwd_plain(*bwd_args)
    ok6, err6 = bwd_checks(
        torch, "encoder backward (B6)", fe.fused_history_encoder_bwd(*bwd_args),
        fe.fused_history_encoder_bwd(*bwd_args), want,
        fe.fused_history_encoder_bwd_f64_sums(*bwd_args), fma6(),
        ("dx", "dpe", "dW_in", "db_in", "dW_out", "db_out"))
    # and on the tensor-core kernel's residuals, against the plain backward
    # on the plain version's: the layouts agree, and the rounding flips
    # between the two forwards stay within the backward's tolerance
    on_tc = [close(a, e, 0.0, 3e-2 * float(e.float().abs().max())) for a, e in zip(
        fe.fused_history_encoder_bwd(g_enc, *res_k[1:], w[0], w[1], w[2], nh), want)]
    print(f"encoder backward (B6) on the tensor-core residuals vs plain: ok="
          f"{all(ok for ok, _ in on_tc)} max_abs_err {[float(f'{e:.3g}') for _, e in on_tc]} "
          f"(tol 3e-2 of scale)", flush=True)
    grads_bytes = sum(t.numel() for t in want[1:]) * 4
    entry(
        "fused_history_encoder_bwd", "two_tower_models_tpu_torch/csrc/fused_encoder_bwd.cu",
        "two_tower_models_tpu/ops/pallas/fused_encoder.py:618",
        ok6 and all(ok for ok, _ in on_tc) and route6 == "tc", err6,
        time_ms(torch, lambda: fe.fused_history_encoder_bwd(*bwd_args)),
        time_ms(torch, lambda: fe.fused_history_encoder_bwd_plain(*bwd_args)),
        b * 2 * d * 2 + resid_bytes + w_bytes + b * h * d * 2 + grads_bytes,
        b * resid_bwd_flops(h, d, nl), BF16_FLOPS, None,
    )
    e6 = entries["fused_history_encoder_bwd"]
    e6["kernel_route"] = route6
    bwd_times(torch, e6, lambda: fe.fused_history_encoder_bwd(*bwd_args), fma6,
              lambda: b14_layers(torch, xs[0], None, w, nh), b6_ptxas)
    print(bwd_line(torch, smi, f"B6 at B={b}", e6), flush=True)

    # -- phase 4c, first half: B7 on the same input, against its plain
    # version and against B6 on B5's residuals (one VJP, p rounded in B6) --
    rc_args = (g_enc, x, pe, *w, nh)
    got7 = fe.fused_history_encoder_bwd_recompute(*rc_args)
    want7 = fe.fused_history_encoder_bwd_recompute_plain(*rc_args)
    checks = [scaled_close(a, e, 3e-2) for a, e in zip(got7, want7)]
    b6 = fe.fused_history_encoder_bwd(g_enc, *res_k[1:], w[0], w[1], w[2], nh)
    vs_b6 = [scaled_close(a, e, 3e-2) for a, e in zip(got7, b6)]
    x32, g32 = x.float(), g_enc.float()
    ok_32 = all(scaled_close(a, e, 1e-4)[0] for a, e in zip(
        fe.fused_history_encoder_bwd_recompute(g32, x32, pe, *w, nh),
        fe.fused_history_encoder_bwd_recompute_plain(g32, x32, pe, *w, nh)))
    print(f"encoder recompute backward vs B6 (dx, dpe, dW_in, db_in, dW_out, db_out): "
          f"ok={all(ok for ok, _ in vs_b6)} max_abs_err "
          f"{[float(f'{err:.3g}') for _, err in vs_b6]} (tol 3e-2 of scale); f32 vs plain "
          f"ok={ok_32} (tol 1e-4 of scale)", flush=True)
    entry(
        "fused_history_encoder_bwd_recompute",
        "two_tower_models_tpu_torch/csrc/fused_encoder_bwd.cu",
        "two_tower_models_tpu/ops/pallas/fused_encoder.py:700",
        all(ok for ok, _ in checks + vs_b6) and ok_32, max(err for _, err in checks),
        time_ms(torch, lambda: fe.fused_history_encoder_bwd_recompute(*rc_args)),
        time_ms(torch, lambda: fe.fused_history_encoder_bwd_recompute_plain(*rc_args)),
        b * h * d * 2 + b * 2 * d * 2 + w_bytes + b * h * d * 2 + grads_bytes,
        b * vjp_flops(h, d, nl), BF16_FLOPS, None,
    )
    entries["fused_history_encoder_bwd_recompute"]["note"] = (
        "ms includes the second launch that sums the per-block weight grads")
    del res_k, res_p, want, xs, ps, p0, got7, want7, b6
    torch.cuda.empty_cache()

    # -- the training steps --
    step = make_train_step(cfg, train_cfg)
    state, metrics, _, _, _ = run_steps(torch, step, state, data, idx, 3)
    state, timed, ms_step, host_ms, counts = run_steps(torch, step, state, data, idx, TRAIN_STEPS)
    metrics += timed
    print(f"launches on the training path ({TRAIN_STEPS} steps): {json.dumps(counts)}", flush=True)
    expect = {"fused_history_encoder_res": 1, "fused_history_encoder_bwd": 1,
              "fused_history_encoder_bwd_reduce": 1, "fused_in_batch_ce": 1,
              "in_batch_ce_bwd": 1, "in_batch_ce_bwd_reduce": 1, "fused_history_encoder": 0,
              "fused_history_encoder_bwd_recompute": 0, "rows_scatter_add": 0, "rows_write": 0,
              **ENC_TC, "fused_history_encoder_res_tc": 1, "fused_history_encoder_bwd_tc": 1}
    check_launches(counts, expect, TRAIN_STEPS, failures, "train")
    e5["tc_launches"] = counts.get("fused_history_encoder_res_tc", 0)
    e6["tc_launches"] = counts.get("fused_history_encoder_bwd_tc", 0)
    for name, per in expect.items():
        if name in entries and per:
            entries[name]["launches"] = counts.get(name, 0)
    entries["fused_history_encoder_bwd"]["reduce_launches"] = counts.get(
        "fused_history_encoder_bwd_reduce", 0)
    entries["in_batch_ce_bwd"]["reduce_launches"] = counts.get("in_batch_ce_bwd_reduce", 0)
    first, last = metrics[0], metrics[-1]
    if not finite(torch, metrics):
        failures.append("train metrics not finite")
    kernel_ms = sum(entries[n]["ms"] for n in expect if n in entries and expect[n])
    print(
        f"train on {torch.cuda.get_device_name(0)} ({smi}): {TRAIN_STEPS} steps of B={b}: "
        f"ms/step {ms_step:.3f}, examples/s {b / ms_step * 1e3:.0f}; host wall "
        f"{host_ms:.3f} ms/step; loss first {float(first['loss']):.5f} "
        f"last {float(last['loss']):.5f}; softmax_ce first {float(first['softmax_ce']):.5f} "
        f"last {float(last['softmax_ce']):.5f}; the training kernels alone {kernel_ms:.3f} ms "
        f"({kernel_ms / ms_step * 100:.1f}% of the step)",
        flush=True,
    )

    # -- where a step's device time goes: a trace of three steps --
    state, _ = trace_steps(torch, step, state, data, idx, "train")

    # -- phase 4c, second half: the step with B1 + B7 (_RESIDUAL_BWD False)
    # beside the B5 + B6 step, in the order B6, B7, B7, B6 --
    b6_ms, b7_ms = [ms_step], []
    try:
        fe._RESIDUAL_BWD = False
        for i in range(2):
            state, m7, ms, _, counts = run_steps(torch, step, state, data, idx, TRAIN_STEPS)
            b7_ms.append(ms)
            if not finite(torch, m7):
                failures.append("train (B7) metrics not finite")
            if i == 0:
                print(f"launches on the B7 training path ({TRAIN_STEPS} steps): "
                      f"{json.dumps(counts)}", flush=True)
                check_launches(counts, {
                    "fused_history_encoder": 1, "fused_history_encoder_bwd_recompute": 1,
                    "fused_history_encoder_bwd_recompute_reduce": 1,
                    "fused_history_encoder_res": 0, "fused_history_encoder_bwd": 0,
                    **ENC_TC, "fused_history_encoder_tc": 1,
                }, TRAIN_STEPS, failures, "train (B7)")
                entries["fused_history_encoder_bwd_recompute"]["launches"] = counts.get(
                    "fused_history_encoder_bwd_recompute", 0)
                entries["fused_history_encoder_bwd_recompute"]["reduce_launches"] = counts.get(
                    "fused_history_encoder_bwd_recompute_reduce", 0)
    finally:
        fe._RESIDUAL_BWD = True
    state, _, ms, _, _ = run_steps(torch, step, state, data, idx, TRAIN_STEPS)
    b6_ms.append(ms)
    print(f"encoder backward in the step on {torch.cuda.get_device_name(0)} ({smi}), "
          f"{TRAIN_STEPS} steps each, order B6 B7 B7 B6: B5+B6 ms/step "
          f"{b6_ms[0]:.3f} {b6_ms[1]:.3f}; B1+B7 ms/step {b7_ms[0]:.3f} {b7_ms[1]:.3f}",
          flush=True)

    # -- train_loss and its gradients, card against a CPU copy --
    grads_vs_cpu(torch, model, cfg, data, idx, failures, "train")
    return cfg, train_cfg, b6_ms  # phase 4b trains the same configuration


def phase_train_varlen(torch, args, smi, dev, cfg, train_cfg, entry, entries, failures,
                       b9_ptxas: str) -> None:
    """Phase 4b: the flagship step on make_synthetic_data's variable-length
    histories; B9 on the step's own tensors (``b9_ptxas``: phase 1's report
    of its tensor-core instance there)."""
    from two_tower_models_tpu_torch.config import DataConfig
    from two_tower_models_tpu_torch.ops import fused_encoder as fe
    from two_tower_models_tpu_torch.training.data import gather_batch, make_synthetic_data
    from two_tower_models_tpu_torch.training.state import create_train_state
    from two_tower_models_tpu_torch.training.step import make_train_step

    b, d, nh, nl = TRAIN_BATCH, 64, 4, 3
    data = make_synthetic_data(DataConfig(
        num_samples=b, num_users=TRAIN_ROWS, num_items=TRAIN_ROWS, feature_dim=16,
        history_len=HIST, num_tasks=3, max_position=cfg.position_table_size,
        seed=args.seed, variable_history=True,
    ), device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed + 2)
    state = create_train_state(gen, cfg, train_cfg, device=dev)
    model = state.params
    idx = torch.arange(b, device=dev)
    batch = gather_batch(data, idx)
    layers = model.history_encoder.attn_layers
    w = [torch.stack([getattr(getattr(l, p), a) for l in layers]).detach()
         for p, a in (("in_proj", "w"), ("in_proj", "b"), ("out_proj", "w"), ("out_proj", "b"))]
    lens = batch.history_len
    x = stack_input(torch, model, batch.user_history, lens)
    xb = x.to(torch.bfloat16)
    g = torch.randn(b, d, generator=gen, device=dev) / b
    gb = g.to(torch.bfloat16)
    h = HIST
    route9 = fe._enc_bwd_route(xb.dtype, h, d, nh, nl)
    inputs9 = fe._recompute_bwd_inputs(gb, xb, fe._lens(lens, xb), *w, nh, enc=False)
    shapes9 = fe._grad_shapes(h, d, nl, False)

    def fma9():  # the FMA kernel on the same inputs
        dx9 = torch.empty_like(xb)
        return (dx9, *fe._launch_bwd_fma("fused_attn_stack_bwd", inputs9, dx9, shapes9, nh, nl,
                                         fe._res_floats(h, d, nh, nl)))

    got = fe.fused_attn_stack_bwd(gb, xb, lens, *w, nh)
    want = fe.fused_attn_stack_bwd_plain(gb, xb, lens, *w, nh)
    ok9, err9 = bwd_checks(
        torch, "attention stack backward (B9)", got, fe.fused_attn_stack_bwd(gb, xb, lens, *w, nh),
        want, fe.fused_attn_stack_bwd_f64_sums(gb, xb, lens, *w, nh), fma9(),
        ("dx", "dW_in", "db_in", "dW_out", "db_out"))
    ok_32 = all(scaled_close(a, e, 1e-4)[0] for a, e in zip(
        fe.fused_attn_stack_bwd(g, x, lens, *w, nh),
        fe.fused_attn_stack_bwd_plain(g, x, lens, *w, nh)))
    past = torch.arange(HIST, device=dev)[None, :] >= lens[:, None]
    zero_past = bool((got[0][past] == 0).all())
    print(f"attention stack backward: f32 ok={ok_32} (tol 1e-4 of scale); dx zero past each "
          f"length: {zero_past}", flush=True)
    n_valid = int(lens.sum())
    grads_bytes = sum(t.numel() for t in want[1:]) * 4
    entry(
        "fused_attn_stack_bwd", "two_tower_models_tpu_torch/csrc/fused_encoder_bwd.cu",
        "two_tower_models_tpu/ops/pallas/fused_encoder.py:893",
        ok9 and ok_32 and zero_past and route9 == "tc", err9,
        time_ms(torch, lambda: fe.fused_attn_stack_bwd(gb, xb, lens, *w, nh)),
        time_ms(torch, lambda: fe.fused_attn_stack_bwd_plain(gb, xb, lens, *w, nh)),
        n_valid * d * 2 + b * 4 + b * d * 2 + sum(t.numel() for t in w) * 4
        + b * HIST * d * 2 + grads_bytes,
        sum(vjp_flops(n, d, nl) for n in lens.tolist()), BF16_FLOPS, None,
    )
    e9 = entries["fused_attn_stack_bwd"]
    e9["kernel_route"] = route9
    bwd_times(torch, e9, lambda: fe.fused_attn_stack_bwd(gb, xb, lens, *w, nh), fma9,
              lambda: b14_layers(torch, xb, fe._lens(lens, xb), w, nh), b9_ptxas)
    e9["note"] += "; bytes and operations count each example's valid rows only"
    print(bwd_line(torch, smi, f"B9 at B={b}", e9), flush=True)
    # B8 at the training batch: the tensor cores, the FMA kernel, three B13
    e8 = entries["fused_attn_stack"]
    l32, w_k = fe._lens(lens, xb), [fe._f32(t, dev) for t in w]
    e8["train_ms"] = time_ms(torch, lambda: fe.fused_attn_stack_fwd(xb, lens, *w, nh))
    e8["train_bound_ms"] = bound(n_valid * d * 2 + b * 4 + sum(t.numel() for t in w) * 4
                                 + b * d * 2, sum(enc_flops(n, d, nl) for n in lens.tolist()),
                                 BF16_FLOPS)[0]
    enc_times(torch, e8, lambda: fe.fused_attn_stack_fwd(xb, lens, *w, nh),
              lambda: fe._launch_fwd_fma("fused_attn_stack", xb, l32, *w_k, nh),
              lambda: b13_layers(xb, l32, w, nh), "train_")
    print(enc_line(torch, smi, f"B8 at B={b}", e8, "train_")
          + f"; bound {e8['train_bound_ms']:.4f}", flush=True)
    del got, want, x, xb
    torch.cuda.empty_cache()

    step = make_train_step(cfg, train_cfg)
    state, metrics, _, _, _ = run_steps(torch, step, state, data, idx, 3)
    state, timed, ms_step, host_ms, counts = run_steps(torch, step, state, data, idx, TRAIN_STEPS)
    metrics += timed
    print(f"launches on the varlen training path ({TRAIN_STEPS} steps): {json.dumps(counts)}",
          flush=True)
    check_launches(counts, {
        "fused_attn_stack": 1, "fused_attn_stack_bwd": 1, "fused_attn_stack_bwd_reduce": 1,
        "fused_in_batch_ce": 1, "in_batch_ce_bwd": 1, "in_batch_ce_bwd_reduce": 1,
        "fused_history_encoder": 0, "fused_history_encoder_res": 0,
        "fused_history_encoder_bwd": 0, "fused_history_encoder_bwd_recompute": 0,
        "rows_scatter_add": 0, "rows_write": 0, **ENC_TC, "fused_attn_stack_tc": 1,
        "fused_attn_stack_bwd_tc": 1,
    }, TRAIN_STEPS, failures, "train varlen")
    entries["fused_attn_stack"]["train_tc_launches"] = counts.get("fused_attn_stack_tc", 0)
    entries["fused_attn_stack_bwd"]["launches"] = counts.get("fused_attn_stack_bwd", 0)
    entries["fused_attn_stack_bwd"]["tc_launches"] = counts.get("fused_attn_stack_bwd_tc", 0)
    entries["fused_attn_stack_bwd"]["reduce_launches"] = counts.get(
        "fused_attn_stack_bwd_reduce", 0)
    if not finite(torch, metrics):
        failures.append("train varlen metrics not finite")
    first, last = metrics[0], metrics[-1]
    print(
        f"train varlen on {torch.cuda.get_device_name(0)} ({smi}): {TRAIN_STEPS} steps of "
        f"B={b}, lengths uniform in [1, {HIST}] (mean {n_valid / b:.2f}): ms/step "
        f"{ms_step:.3f}, examples/s {b / ms_step * 1e3:.0f}; host wall {host_ms:.3f} ms/step; "
        f"loss first {float(first['loss']):.5f} last {float(last['loss']):.5f}",
        flush=True,
    )
    state, _ = trace_steps(torch, step, state, data, idx, "train varlen")
    grads_vs_cpu(torch, model, cfg, data, idx, failures, "train varlen")


def count_syncs(torch, step, state, data, idx):
    """One step under CUDA's sync debug mode: (state, the number of
    operations that made the host wait for the stream)."""
    import warnings

    with warnings.catch_warnings(record=True) as caught, torch.enable_grad():
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            state, _ = step(state, data, idx)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return state, sum("synchroniz" in str(w.message) for w in caught)


def table_leg(torch, label, step, state, data, idx, warm, expect, smi, failures):
    """``warm`` warm-up steps, then TABLE_STEPS timed steps with the launch
    counts zeroed around them (``expect``: launches per step), one step
    counting its host syncs, then three steps under the profiler.  Returns
    (state, ms/step, counts)."""
    torch.cuda.reset_peak_memory_stats()
    state, metrics, _, _, _ = run_steps(torch, step, state, data, idx, warm)
    state, timed, ms_step, host_ms, counts = run_steps(torch, step, state, data, idx, TABLE_STEPS)
    state, syncs = count_syncs(torch, step, state, data, idx)
    metrics += timed
    print(f"launches on the {label} path ({TABLE_STEPS} steps): {json.dumps(counts)}", flush=True)
    check_launches(counts, expect, TABLE_STEPS, failures, label)
    if not finite(torch, metrics):
        failures.append(f"{label} metrics not finite")
    b = idx.shape[0]
    print(
        f"{label} on {torch.cuda.get_device_name(0)} ({smi}): {TABLE_STEPS} steps of B={b}: "
        f"ms/step {ms_step:.3f}, examples/s {b / ms_step * 1e3:.0f}; host wall "
        f"{host_ms:.3f} ms/step; loss first {float(metrics[0]['loss']):.5f} last "
        f"{float(metrics[-1]['loss']):.5f}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; host syncs in a step {syncs}",
        flush=True,
    )
    return trace_steps(torch, step, state, data, idx, label)[0], ms_step, counts


def table_tensors(state):
    """{name: tensor} of the id tables and their Adam moments."""
    from two_tower_models_tpu_torch.training.sparse_tables import SPARSE_TABLE_KEYS

    opt = state.opt_state
    out = {}
    for name in SPARSE_TABLE_KEYS:
        out[name] = getattr(state.params, name).detach()
        for m in ("mu", "nu"):
            out[f"{m}.{name}"] = (opt.tables[m] if hasattr(opt, "tables") else getattr(opt, m))[name]
    return out


def route_check(torch, label, step, state, data, idx, failures):
    """One step from one state twice: through the kernels, and on the plain
    route (the scatter kernel disabled, B19 swapped for its plain version).
    The updated tables and moments agree at 1e-5 of each one's scale (the
    table gradients are f32 sums in other orders).  Returns the state."""
    from unittest import mock

    from two_tower_models_tpu_torch.nn.layers import disable_scatter_kernel
    from two_tower_models_tpu_torch.ops import _lib
    from two_tower_models_tpu_torch.ops import rows_write as rw
    from two_tower_models_tpu_torch.training import sparse_tables

    twin = copy.deepcopy(state)
    with torch.enable_grad():
        state, _ = step(state, data, idx)
        before = dict(_lib.launches)
        with disable_scatter_kernel(), mock.patch.object(
                sparse_tables, "rows_write_many", rw.rows_write_many_reference):
            twin, _ = step(twin, data, idx)
    plain_launches = sum(_lib.launches[k] - before.get(k, 0) for k in ("rows_scatter_add", "rows_write"))
    got, want = table_tensors(state), table_tensors(twin)
    worst = 0.0
    for name in got:
        ok, err = scaled_close(got[name], want[name], 1e-5)
        worst = max(worst, err)
        if not ok:
            failures.append(f"{label} kernel vs plain route: {name}")
    if plain_launches:
        failures.append(f"{label} plain route launched {plain_launches} kernels")
    print(f"{label}: one step through the kernels vs the plain route, tables and moments: "
          f"max_abs_err {worst:.3g} (tol 1e-5 of each one's scale); kernels launched on the "
          f"plain route: {plain_launches}", flush=True)
    del twin
    torch.cuda.empty_cache()
    return state


def row_write_check(torch, cfg, st_lazy, batch, randn, dev, entry, entries) -> None:
    """Phase 5a: B19 at the 4M-lazy write-back, on the step's own ids: the
    two rows_write_many launches of a step (one a table: the table and its
    two moments) and the six one-array launches, exactly against the plain
    version, timed with and without the host's dispatch beside index_copy_
    of the blended rows.  Its copies of the tables die with it."""
    from two_tower_models_tpu_torch.ops import rows_write as rw
    from two_tower_models_tpu_torch.training.sparse_tables import SPARSE_TABLE_KEYS, build_minibatch

    d = 64
    _, _, meta = build_minibatch(cfg, st_lazy.params, batch)
    arrays = table_tensors(st_lazy)
    writes, lib_args, exact, n_live = [], [], True, 0
    for name in SPARSE_TABLE_KEYS:  # one write-back a table: the table, mu and nu
        s, dup = meta[name]
        plan = rw.lane_block_plan(s, dup, 128 // d)
        dsts = [arrays[key].clone() for key in (name, f"mu.{name}", f"nu.{name}")]
        vals = [rw.merge_rows(plan, s, randn(s.numel(), d)) for _ in dsts]
        got = rw.rows_write_many([t.clone() for t in dsts], plan[0], plan[1], vals, d)
        for dst, v, g in zip(dsts, vals, got):
            exact &= torch.equal(g, rw.rows_write_reference(dst.clone(), plan[0], plan[1], v, d))
            exact &= torch.equal(rw.rows_write(dst.clone(), plan[0], plan[1], v, d), g)
        live = (plan[1] != 0).nonzero()[:, 0]
        m = ((plan[1][live][:, None] >> (torch.arange(128, device=dev) // d)) & 1).float()
        for dst, v in zip(dsts, vals):
            lib_args.append((dst, plan[0][live], dst[plan[0][live]] * (1 - m) + v[live] * m))
        n_live += 3 * live.numel()
        writes.append((dsts, plan[0], plan[1], vals))
    print(f"row write vs plain at the 4M-lazy write-back (2 tables x 3 arrays, {n_live} live "
          f"slots of {3 * sum(w[1].numel() for w in writes)}): exact={exact}", flush=True)
    two = lambda: [rw.rows_write_many(*w, d) for w in writes]
    six = lambda: [rw.rows_write(dst, pids, bits, v, d)
                   for dsts, pids, bits, vals in writes for dst, v in zip(dsts, vals)]
    entry(
        "rows_write", "two_tower_models_tpu_torch/csrc/rows_write.cu",
        "two_tower_models_tpu/ops/pallas/rows_write.py:150", exact, 0.0 if exact else float("nan"),
        time_ms(torch, two),
        time_ms(torch, lambda: [rw.rows_write_many_reference(*w, d) for w in writes], 3),
        # each live row read old and new and written, in 3 arrays; ids and bits once a table
        3 * n_live * 128 * 4 + sum(w[1].numel() * 12 for w in writes), 0, F32_FLOPS,
        None,
    )
    e19 = entries["rows_write"]
    e19["device_ms"] = call_device_ms(torch, two)
    e19["six_ms"] = time_ms(torch, six)
    e19["six_device_ms"] = call_device_ms(torch, six)
    e19["index_copy_ms"] = time_ms(torch, lambda: [t.index_copy_(0, i, v) for t, i, v in lib_args])
    e19["index_copy_device_ms"] = call_device_ms(
        torch, lambda: [t.index_copy_(0, i, v) for t, i, v in lib_args])
    e19["note"] = (
        "times are the write-backs of one 4M-lazy step: two rows_write_many launches (table, mu "
        "and nu of each table; ms with the host's dispatch, device_ms the kernels alone), six_* "
        "the six one-array launches; library_ms null: no one PyTorch call blends lanes and drops "
        "dead slots; index_copy_* copies the blended live rows (2/3 of the bytes, no blend)")
    print(f"row write: two launches {e19['ms']:.4f} ms (device {e19['device_ms']:.4f}); six "
          f"one-array launches {e19['six_ms']:.4f} (device {e19['six_device_ms']:.4f}); index_copy_ "
          f"of blended rows {e19['index_copy_ms']:.4f} (device {e19['index_copy_device_ms']:.4f}); "
          f"bound {e19['bound_ms']:.4f}", flush=True)


def phase_tables(torch, args, smi, dev, entry, entries, failures) -> None:
    """Phase 5: large tables, scripts/bench_tables.py's configuration."""
    import dataclasses

    from two_tower_models_tpu_torch.config import TrainConfig
    from two_tower_models_tpu_torch.nn.packed_table import is_packed
    from two_tower_models_tpu_torch.ops import _lib
    from two_tower_models_tpu_torch.ops import scatter_add as sa
    from two_tower_models_tpu_torch.training.data import gather_batch
    from two_tower_models_tpu_torch.training.sparse_tables import SPARSE_TABLE_KEYS
    from two_tower_models_tpu_torch.training.state import create_train_state
    from two_tower_models_tpu_torch.training.step import make_train_step

    b, d = TRAIN_BATCH, 64
    cfg = flagship_cfg(TABLE_ROWS)
    dense_cfg = TrainConfig(batch_size=b, learning_rate=1e-3, pack_tables_min_rows=PACK_MIN_ROWS)
    lazy_cfg = dataclasses.replace(dense_cfg, lazy_table_adam=True)
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed + 5)
    randn = lambda *shape: torch.randn(shape, generator=gen, device=dev)
    data = fixed_batch(torch, gen, dev, cfg, b)
    idx = torch.arange(b, device=dev)
    batch = gather_batch(data, idx)
    # one seed, one set of weights: the dense and the lazy states
    st_dense = create_train_state(args.seed + 6, cfg, dense_cfg, device=dev)
    st_lazy = create_train_state(args.seed + 6, cfg, lazy_cfg, device=dev)
    if not all(is_packed(getattr(st.params, n), d) for st in (st_dense, st_lazy)
               for n in SPARSE_TABLE_KEYS):
        failures.append("tables of 2^22 rows not packed")

    # -- 5a: B18 at the lookups of the packed and the 1M legs --
    lookups = {"user": batch.user_id.reshape(-1), "item": batch.item_id.reshape(-1),
               "history": batch.user_history.reshape(-1)}
    cot = {k: randn(ids.numel(), d) for k, ids in lookups.items()}
    errs, oks = [], []
    for rows in (TABLE_ROWS, TABLE_ROWS_1M):
        for k, ids in lookups.items():
            got = sa.rows_scatter_add(ids % rows, cot[k], rows)
            ok, err = close(got, sa.rows_scatter_add_reference(ids % rows, cot[k], rows), 1e-5, 1e-6)
            oks.append(ok)
            errs.append(err)
            del got
    # the variable-length cell's history stream: id 0 past each length,
    # about half of the ids; rows of small integers, whose sums are exact
    n_var = b * HIST
    lens = torch.randint(1, HIST + 1, (b,), generator=gen, device=dev)
    skew = torch.randint(0, TRAIN_ROWS, (b, HIST), generator=gen, device=dev)
    skew = torch.where(torch.arange(HIST, device=dev)[None, :] < lens[:, None], skew, 0).reshape(-1)
    grid = torch.randint(-2, 3, (n_var, d), generator=gen, device=dev).float()
    got = sa.rows_scatter_add(skew, grid, TRAIN_ROWS)
    exact = torch.equal(got, sa.rows_scatter_add_reference(skew, grid, TRAIN_ROWS))
    repeat = torch.equal(got, sa.rows_scatter_add(skew, grid, TRAIN_ROWS))
    print(f"scatter-add vs plain at the legs' lookups: max_abs_err {max(errs):.3g} (rtol 1e-5, "
          f"atol 1e-6); skewed stream (id 0 {float((skew == 0).float().mean()):.3f} of "
          f"{n_var}): exact={exact}, bit-equal on repeat={repeat}", flush=True)
    emb_bwd = lambda g, ids, rows: torch.ops.aten.embedding_dense_backward(g, ids, rows, -1, False)
    entry(
        "rows_scatter_add", "two_tower_models_tpu_torch/csrc/scatter_add.cu",
        "two_tower_models_tpu/ops/pallas/scatter_add.py:130", all(oks) and exact and repeat,
        max(errs),
        time_ms(torch, lambda: [sa.rows_scatter_add(i, cot[k], TABLE_ROWS) for k, i in lookups.items()]),
        time_ms(torch, lambda: [sa.rows_scatter_add_reference(i, cot[k], TABLE_ROWS)
                                for k, i in lookups.items()], 3),
        sum(TABLE_ROWS * d * 4 + i.numel() * (d * 4 + 8) for i in lookups.values()),
        sum(i.numel() * d for i in lookups.values()), F32_FLOPS,
        time_ms(torch, lambda: [emb_bwd(cot[k], i, TABLE_ROWS) for k, i in lookups.items()], 3),
    )
    ms_1m = time_ms(torch, lambda: [sa.rows_scatter_add(i % TABLE_ROWS_1M, cot[k], TABLE_ROWS_1M)
                                    for k, i in lookups.items()])
    sort_ms = time_ms(torch, lambda: sa.sort_stream(lookups["history"], TABLE_ROWS))
    # the kernel alone (chunk and fill launches) on streams sorted beforehand
    streams = {k: sa.sort_stream(i, TABLE_ROWS) for k, i in lookups.items()}
    kernel_ms = time_ms(torch, lambda: [sa.scatter_sorted(*streams[k], cot[k], TABLE_ROWS)
                                        for k in lookups])
    del streams
    print(f"scatter-add: the three lookups of a 1M-plain step {ms_1m:.4f} ms; the stable sort "
          f"of the history lookup's {lookups['history'].numel()} ids alone {sort_ms:.4f} ms; "
          f"the 4M-packed step's three launches alone on sorted streams {kernel_ms:.4f} ms "
          f"(bound {entries['rows_scatter_add']['bound_ms']:.4f} ms, the wrapper "
          f"{entries['rows_scatter_add']['ms']:.4f} ms)", flush=True)
    entries["rows_scatter_add"]["ms_1m_plain"] = ms_1m
    entries["rows_scatter_add"]["history_sort_ms"] = sort_ms
    entries["rows_scatter_add"]["kernel_ms"] = kernel_ms
    entries["rows_scatter_add"]["note"] = (
        "times are the three lookups of one 4M-packed step (user, item, history), the "
        "wrapper's stable sort included; kernel_ms is the chunk and fill launches alone "
        "on streams sorted beforehand; plain_ms is zeros + index_add_, library_ms "
        "aten.embedding_dense_backward")

    # B18 against F.embedding's gradient, over table sizes at the legs' N
    n_win = b * HIST + b  # the 4M-lazy item minitable: history and item ids
    window = {}
    for rows in WINDOW_ROWS:
        ids = torch.randint(0, rows, (n_win,), generator=gen, device=dev)
        g = randn(n_win, d)
        window[str(rows)] = {
            "b18_ms": time_ms(torch, lambda: sa.rows_scatter_add(ids, g, rows)),
            "embedding_backward_ms": time_ms(torch, lambda: emb_bwd(g, ids, rows)),
            "index_add_ms": time_ms(torch, lambda: sa.rows_scatter_add_reference(ids, g, rows)),
        }
    window["skewed"] = {
        "b18_ms": time_ms(torch, lambda: sa.rows_scatter_add(skew, grid, TRAIN_ROWS)),
        "embedding_backward_ms": time_ms(torch, lambda: emb_bwd(grid, skew, TRAIN_ROWS)),
        "index_add_ms": time_ms(torch, lambda: sa.rows_scatter_add_reference(skew, grid, TRAIN_ROWS)),
    }
    entries["rows_scatter_add"]["window_ms"] = window
    print(f"scatter-add window on {torch.cuda.get_device_name(0)} ({smi}), N={n_win} uniform "
          f"ids (skewed: N={n_var}, V={TRAIN_ROWS}), D={d}: {json.dumps(window)}", flush=True)
    del cot, got, grid
    torch.cuda.empty_cache()

    # -- 5a: B19 at the 4M-lazy write-back, on the step's own ids --
    row_write_check(torch, cfg, st_lazy, batch, randn, dev, entry, entries)
    torch.cuda.empty_cache()

    # -- first lazy step against the first dense step, from zero moments --
    step_dense, step_lazy = make_train_step(cfg, dense_cfg), make_train_step(cfg, lazy_cfg)
    with torch.enable_grad():
        st_dense, _ = step_dense(st_dense, data, idx)
        st_lazy, _ = step_lazy(st_lazy, data, idx)
    got, want = table_tensors(st_lazy), table_tensors(st_dense)
    got.update((n, p.detach()) for n, p in st_lazy.params.named_parameters())
    want.update((n, p.detach()) for n, p in st_dense.params.named_parameters())
    worst, bad = 0.0, []
    for name in want:
        ok, err = close(got[name], want[name], 1e-5, 1e-7)
        worst = max(worst, err)
        if not ok:
            bad.append(name)
    print(f"tables 4M: first lazy step vs first dense step, every parameter and table moment: "
          f"max_abs_err {worst:.3g} (rtol 1e-5, atol 1e-7); mismatched {bad}", flush=True)
    if bad:
        failures.append(f"first lazy step vs dense: {bad}")
    del got, want

    # -- 5b, 5c: the two 4M legs --
    five = {"fused_history_encoder_res": 1, "fused_history_encoder_bwd": 1, "fused_in_batch_ce": 1,
            "in_batch_ce_bwd": 1, "in_batch_ce_bwd_reduce": 1, **ENC_TC,
            "fused_history_encoder_res_tc": 1, "fused_history_encoder_bwd_tc": 1}
    st_dense, ms_packed, counts = table_leg(
        torch, "train-4M-packed", step_dense, st_dense, data, idx, 2,
        {**five, "rows_scatter_add": 3, "rows_write": 0, "fused_adam": 0}, smi, failures)
    entries["rows_scatter_add"]["launches"] = counts.get("rows_scatter_add", 0)
    b18 = entries["rows_scatter_add"]["ms"]
    print(f"train-4M-packed: B18's three launches alone {b18:.3f} ms ({b18 / ms_packed * 100:.1f}% "
          f"of the step)", flush=True)
    route_check(torch, "train-4M-packed", step_dense, st_dense, data, idx, failures)
    del st_dense
    torch.cuda.empty_cache()
    st_lazy, ms_lazy, counts = table_leg(
        torch, "train-4M-lazy", step_lazy, st_lazy, data, idx, 2,
        {**five, "rows_scatter_add": 0, "rows_write": 2}, smi, failures)
    entries["rows_write"]["launches"] = counts.get("rows_write", 0)
    b19 = entries["rows_write"]["device_ms"]
    print(f"train-4M-lazy: B19's two launches alone {b19:.3f} ms of device time "
          f"({b19 / ms_lazy * 100:.1f}% of the step)", flush=True)
    route_check(torch, "train-4M-lazy", step_lazy, st_lazy, data, idx, failures)
    del st_lazy
    torch.cuda.empty_cache()

    # -- 5d: 1M rows, plain storage, B18 inside the window --
    cfg1 = flagship_cfg(TABLE_ROWS_1M)
    st = create_train_state(args.seed + 7, cfg1, dense_cfg, device=dev)
    if any(is_packed(getattr(st.params, n), d) for n in SPARSE_TABLE_KEYS):
        failures.append("tables of 2^20 rows packed")
    data1 = fixed_batch(torch, gen, dev, cfg1, b)
    step1 = make_train_step(cfg1, dense_cfg)
    st, ms_1m_step, counts = table_leg(torch, "train-1M-plain", step1, st, data1, idx, 3,
                              {**five, "rows_scatter_add": 3, "rows_write": 0}, smi, failures)
    entries["rows_scatter_add"]["launches_1m_plain"] = counts.get("rows_scatter_add", 0)
    print(f"train-1M-plain: B18's three launches alone {ms_1m:.3f} ms ({ms_1m / ms_1m_step * 100:.1f}% "
          f"of the step)", flush=True)
    route_check(torch, "train-1M-plain", step1, st, data1, idx, failures)
    del st
    torch.cuda.empty_cache()

    # -- card against CPU at the window's lower edge, packed --
    cfg_c = flagship_cfg(CHECK_ROWS)
    st = create_train_state(args.seed + 8, cfg_c, dataclasses.replace(
        dense_cfg, pack_tables_min_rows=CHECK_ROWS), device=dev)
    if not is_packed(st.params.item_id_table, d):
        failures.append("tables of 2^18 rows not packed at pack_tables_min_rows 2^18")
    before = _lib.launches["rows_scatter_add"]
    grads_vs_cpu(torch, st.params, cfg_c, fixed_batch(torch, gen, dev, cfg_c, b), idx,
                 failures, "tables 2^18 packed")
    if _lib.launches["rows_scatter_add"] - before != 3:
        failures.append("tables 2^18 packed: B18 not launched three times on the card")
    del st
    torch.cuda.empty_cache()
    return ms_packed

def layer_flops(h: int, n: int, d: int) -> int:
    """Operations of one attention layer on one example of h rows of which
    the first n are valid keys: q and the output projection for every row,
    k and v for the valid rows, scores and P.V over the valid keys (the
    other keys' scores are masked and need not be computed)."""
    return 2 * h * d * d + 4 * n * d * d + 4 * h * n * d + 2 * h * d * d


def layer_vjp_flops(h: int, d: int) -> int:
    """What B14 must do on one example of h rows (all keys valid): the
    forward less its output projection (6hd^2 + 4h^2d), then dW_out and do
    (2hd^2 each), dp, dv, dq and dk (2h^2d each), dW_in and dx (6hd^2 each)."""
    return 6 * h * d * d + 4 * h * h * d + 16 * h * d * d + 8 * h * h * d


def layer_cfg(cfg):
    """``cfg`` with its history encoder on the per-layer tier."""
    import dataclasses

    return dataclasses.replace(cfg, history_encoder=dataclasses.replace(
        cfg.history_encoder, fused_kernel=True, fused_encoder=False))


def layer_input(torch, model, hist, lens):
    """Layer 0's input on the per-layer tier, in bf16: the embedded history
    plus the PE (zeroed and with the PE at each length under ``lens``)."""
    from two_tower_models_tpu_torch.models.history_encoder import (
        sinusoidal_positional_encoding,
    )

    if lens is not None:
        return stack_input(torch, model, hist, lens).to(torch.bfloat16)
    emb = model.item_id_table.detach()[hist]
    return (emb + sinusoidal_positional_encoding(HIST, emb.shape[-1], emb.device)).to(torch.bfloat16)


def mha_library(torch, x, lens, w, nh):
    """One PyTorch call computing the layer (``F.multi_head_attention_forward``,
    bf16, keys past each length masked), seq-first, and its inputs."""
    F = torch.nn.functional
    xs = x.transpose(0, 1).contiguous()
    wb = [w[0].T.contiguous().bfloat16(), w[1].bfloat16(), w[2].T.contiguous().bfloat16(),
          w[3].bfloat16()]
    kpm = None if lens is None else (
        torch.arange(x.shape[1], device=x.device)[None, :] >= lens[:, None])
    return lambda xq, ws: F.multi_head_attention_forward(
        xq, xq, xq, x.shape[2], nh, ws[0], ws[1], None, None, False, 0.0, ws[2], ws[3],
        training=False, key_padding_mask=kpm, need_weights=False)[0], xs, wb


def layer_checks(torch, label, x, lens, g, w, nh):
    """B13 (and, with a cotangent ``g``, B14) against their plain versions
    on one layer's tensors, bf16 and f32: (ok, max_abs_err of the bf16
    outputs, a line of what was measured).  B13's tensor-core kernel sums
    in f32 in another order than the plain version, so a bf16 rounding
    upstream of y can flip: y is held as B14's dx is (at most 0.5% of the
    values beyond one bf16 step, all within 1e-2 of scale), and against the
    layer with f64 sums it may have at most 1.5 times as many values beyond
    one step as the plain version has.  The FMA kernel sums in the plain
    version's order: within one step.  B14 (the tensor-core kernel for
    bf16) and its FMA kernel, launched through its launcher on the same
    inputs: dx as above, the weight grads within 3e-3 of scale; the
    tensor-core kernel's dx no more values beyond one step from the
    backward with f64 sums than 1.5 times the plain version's, each weight
    grad's RMS error from f64 sums at most 1.5 times the plain version's
    (or 1e-6 of scale), and bit-equal on repeat."""
    from two_tower_models_tpu_torch.ops import fused_mha as fm

    y, plain = fm.fused_mha_fwd(x, lens, *w, nh), fm.fused_mha_layer_plain(x, lens, *w, nh)
    route = fm._fwd_route(x.dtype, *x.shape[1:], nh)
    steps, far = bf16_ulps(torch, y, plain), bf16_far(torch, y, plain)
    ok_y, err = scaled_close(y, plain, 1e-2)
    ref = fm.fused_mha_layer_f64_sums(x, lens, *w, nh)
    far64 = [bf16_far(torch, t, ref) for t in (y, plain)]
    rep13 = torch.equal(y, fm.fused_mha_fwd(x, lens, *w, nh))
    fma_steps = bf16_ulps(torch, fm._launch_fwd_fma(*fm._fwd_inputs(x, lens, *w), nh), plain)
    ok32, _ = scaled_close(fm.fused_mha_fwd(x.float(), lens, *w, nh),
                           fm.fused_mha_layer_plain(x.float(), lens, *w, nh), 1e-4)
    ok = (route == "tc" and ok_y and far <= 5e-3 * y.numel() and far64[0] <= 1.5 * far64[1]
          and rep13 and 0 <= fma_steps <= 1 and ok32)
    line = (f"{label}: B13 bf16 ({route} route) vs plain: {far} of {y.numel()} values beyond "
            f"one bf16 step (tol 0.5%), most {steps} steps, max_abs_err {err:.3g} (tol 1e-2 of "
            f"scale); beyond one step from f64 sums: kernel {far64[0]}, plain {far64[1]} (tol "
            f"1.5x); bit-equal on repeat={rep13}; the FMA kernel {fma_steps} steps from plain; "
            f"f32 ok={ok32} (tol 1e-4 of scale)")
    if g is not None:
        got = fm.fused_mha_bwd(g, x, lens, *w, nh)
        want = fm.fused_mha_layer_bwd_plain(g, x, lens, *w, nh)
        again = fm.fused_mha_bwd(g, x, lens, *w, nh)
        route = fm._bwd_route(x.dtype, *x.shape[1:], nh)
        repeat = all(torch.equal(a, b) for a, b in zip(got, again))
        d = x.shape[2]
        dx_fma, flat = fm._launch_bwd_fma(*fm._bwd_inputs(g, x, lens, *w[:3]), nh)
        fma = (dx_fma, *(t.view_as(e) for t, e in zip(
            torch.split(flat, [d * 3 * d, 3 * d, d * d, d]), want[1:])))
        line += f"; B14 ({route} route)"
        for tag, t in (("", got), ("the FMA kernel ", fma)):
            far = bf16_far(torch, t[0], want[0]) / t[0].numel()
            ok_dx, err_dx = scaled_close(t[0], want[0], 1e-2)
            grads = [scaled_close(a, e, 3e-3) for a, e in zip(t[1:], want[1:])]
            ok = ok and ok_dx and far <= 5e-3 and all(k for k, _ in grads)
            line += (f"; {tag}dx: {far:.2e} of values beyond one bf16 step (tol 5e-3), "
                     f"max_abs_err {err_dx:.3g} (tol 1e-2 of scale); weight grads max_abs_err "
                     f"{[float(f'{e:.3g}') for _, e in grads]} (tol 3e-3 of scale)")
            if not tag:
                err = err_dx  # the entry's max_abs_err: B14's dx
        # against the backward with f64 sums: dx values beyond one bf16 step,
        # each weight grad's RMS error relative to its scale
        ref = fm.fused_mha_layer_bwd_f64_sums(g, x, lens, *w, nh)
        far64 = [bf16_far(torch, t[0], ref[0]) for t in (got, want)]
        rms = [[float((a.double() - e).pow(2).mean().sqrt() / e.abs().max())
                for a, e in zip(t[1:], ref[1:])] for t in (got, want)]
        ok64 = far64[0] <= 1.5 * far64[1] and all(
            k <= max(1.5 * p, 1e-6) for k, p in zip(*rms))
        ok32 = all(scaled_close(a, e, 1e-4)[0] for a, e in zip(
            fm.fused_mha_bwd(g.float(), x.float(), lens, *w, nh),
            fm.fused_mha_layer_bwd_plain(g.float(), x.float(), lens, *w, nh)))
        ok = ok and route == "tc" and repeat and ok64 and ok32
        line += (f"; beyond one step from f64 sums: kernel {far64[0]}, plain {far64[1]} (tol "
                 f"1.5x); weight grads' RMS error from f64 sums (of scale) kernel "
                 f"{[float(f'{v:.3g}') for v in rms[0]]}, plain "
                 f"{[float(f'{v:.3g}') for v in rms[1]]} (tol 1.5x or 1e-6); f32 ok={ok32} "
                 f"(tol 1e-4 of scale); bit-equal on repeat={repeat}")
    print(line, flush=True)
    return ok, err


def phase_layer(torch, args, smi, dev, entry, entries, failures, b56_ms, b14_ptxas) -> None:
    """Phase 6: the per-layer attention tier (HistoryEncoderConfig with
    fused_kernel=True, fused_encoder=False) at the cells' full width;
    ``b14_ptxas`` is phase 1's report of B14's tensor-core instance there."""
    from two_tower_models_tpu_torch.config import DataConfig, TrainConfig
    from two_tower_models_tpu_torch.models import two_tower as tt
    from two_tower_models_tpu_torch.ops import fused_mha as fm
    from two_tower_models_tpu_torch.serving import RetrievalEngine
    from two_tower_models_tpu_torch.training.data import gather_batch, make_synthetic_data
    from two_tower_models_tpu_torch.training.state import create_train_state
    from two_tower_models_tpu_torch.training.step import make_train_step

    nh, nl, d, b = 4, 3, 64, BATCH
    src = "two_tower_models_tpu_torch/csrc/fused_mha.cu"
    w_layer = lambda model: [getattr(getattr(model.history_encoder.attn_layers[0], p), a).detach()
                             for p, a in (("in_proj", "w"), ("in_proj", "b"), ("out_proj", "w"),
                                          ("out_proj", "b"))]
    w_bytes = (4 * d * d + 4 * d) * 4

    # -- 6a, 6b: serving.  phase 3's configuration and seed on the per-layer tier
    cfg = layer_cfg(serve_cfg())
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    model = tt.init_params(gen, cfg, device=dev)
    catalog_ids = torch.arange(CORPUS, device=dev)
    catalog_feats = torch.randn(CORPUS, 16, generator=gen, device=dev)
    engine = RetrievalEngine.from_params(model, cfg, catalog_ids, catalog_feats, device=dev)
    engine.warmup(BATCH)
    batches = [(torch.randint(0, cfg.user_id_hash_size, (b,), generator=gen, device=dev),
                torch.randn(b, 16, generator=gen, device=dev),
                torch.randint(0, CORPUS, (b, HIST), generator=gen, device=dev), None)
               for _ in range(args.batches)]
    engine.warmup(BATCH, variable_history=True)
    var_batches = []
    for _ in range(args.batches):
        lens = torch.randint(1, HIST + 1, (b,), generator=gen, device=dev)
        hist = torch.randint(0, CORPUS, (b, HIST), generator=gen, device=dev)
        hist = torch.where(torch.arange(HIST, device=dev)[None, :] < lens[:, None], hist, 0)
        var_batches.append((torch.randint(0, cfg.user_id_hash_size, (b,), generator=gen, device=dev),
                            torch.randn(b, 16, generator=gen, device=dev), hist, lens))
    w = w_layer(model)
    x = layer_input(torch, model, batches[0][2], None)
    ok, err = layer_checks(torch, "layer serve", x, None, None, w, nh)
    lens = var_batches[0][3]
    xv = layer_input(torch, model, var_batches[0][2], lens)
    ok_v, err_v = layer_checks(torch, "layer serve varlen", xv, lens, None, w, nh)
    lib, xs, wb = mha_library(torch, x, None, w, nh)
    lib_v, xs_v, _ = mha_library(torch, xv, lens, w, nh)
    entry(
        "fused_mha_fwd", src, "two_tower_models_tpu/ops/pallas/fused_mha.py:297", ok and ok_v,
        max(err, err_v),
        time_ms(torch, lambda: fm.fused_mha_fwd(x, None, *w, nh)),
        time_ms(torch, lambda: fm.fused_mha_layer_plain(x, None, *w, nh)),
        2 * b * HIST * d * 2 + w_bytes, b * layer_flops(HIST, HIST, d), BF16_FLOPS,
        time_ms(torch, lambda: lib(xs, wb)),
    )
    e13 = entries["fused_mha_fwd"]
    fma = lambda xx, ll: fm._launch_fwd_fma(*fm._fwd_inputs(xx, ll, *w), nh)
    e13["kernel_route"] = fm._fwd_route(x.dtype, HIST, d, nh)
    e13["fma_ms"] = time_ms(torch, lambda: fma(x, None))
    e13["fma_varlen_ms"] = time_ms(torch, lambda: fma(xv, lens))
    e13["varlen_ms"] = time_ms(torch, lambda: fm.fused_mha_fwd(xv, lens, *w, nh))
    e13["varlen_plain_ms"] = time_ms(torch, lambda: fm.fused_mha_layer_plain(xv, lens, *w, nh))
    e13["varlen_bound_ms"] = bound(2 * b * HIST * d * 2 + w_bytes + b * 4, sum(
        layer_flops(HIST, n, d) for n in lens.tolist()), BF16_FLOPS)[0]
    e13["varlen_library_ms"] = time_ms(torch, lambda: lib_v(xs_v, wb))
    for key, xx, ll in (("", x, None), ("varlen_", xv, lens)):
        e13[f"{key}device_ms"] = device_ms(torch, lambda: fm.fused_mha_fwd(xx, ll, *w, nh),
                                           "mha_fwd_tc_kernel")
        e13[f"fma_{key}device_ms"] = device_ms(torch, lambda: fma(xx, ll), "mha_fwd_kernel")
    print(f"B13 at B={b} on {torch.cuda.get_device_name(0)} ({smi}): route {e13['kernel_route']} "
          f"{e13['ms']:.4f} ms, with lengths {e13['varlen_ms']:.4f} (device time "
          f"{e13['device_ms']:.4f}, {e13['varlen_device_ms']:.4f}); the FMA kernel "
          f"{e13['fma_ms']:.4f}, {e13['fma_varlen_ms']:.4f} (device {e13['fma_device_ms']:.4f}, "
          f"{e13['fma_varlen_device_ms']:.4f}); library {e13['library_ms']:.4f}, "
          f"{e13['varlen_library_ms']:.4f}; bound {e13['bound_ms']:.4f}, "
          f"{e13['varlen_bound_ms']:.4f}", flush=True)
    del xs, xs_v
    cpu_model = copy.deepcopy(model).cpu()
    others = {"fused_history_encoder": 0, "fused_attn_stack": 0, "tile_max_scores": 1,
              **SELECT_ROUTE, "gather_rescore": 1, **ENC_TC}
    legs = {}
    for label, bts in (("serve-1M-exact-layer", batches), ("serve-1M-exact-layer-varlen", var_batches)):
        counts, legs[label] = serve_leg(torch, label, engine, model, cpu_model, cfg, bts,
                                        {"fused_mha_fwd": nl, "fused_mha_fwd_tc": nl, **others},
                                        [], entries, failures, smi)
        e13[f"launches_{label}"] = counts.get("fused_mha_fwd", 0)
        e13[f"launches_tc_{label}"] = counts.get("fused_mha_fwd_tc", 0)
    e13["launches"] = e13["launches_serve-1M-exact-layer"]
    del engine, model, cpu_model, batches, var_batches, catalog_feats
    torch.cuda.empty_cache()

    # -- 6a, 6c: training.  phase 4's configuration on the per-layer tier
    cfg = layer_cfg(flagship_cfg(TRAIN_ROWS))
    bt = TRAIN_BATCH
    train_cfg = TrainConfig(batch_size=bt, learning_rate=1e-3)
    gen.manual_seed(args.seed + 9)
    state = create_train_state(gen, cfg, train_cfg, device=dev)
    data = fixed_batch(torch, gen, dev, cfg, bt)
    idx = torch.arange(bt, device=dev)
    w = w_layer(state.params)
    x = layer_input(torch, state.params, gather_batch(data, idx).user_history, None)
    g = (torch.randn(bt, HIST, d, generator=gen, device=dev) / bt).to(torch.bfloat16)
    ok, err = layer_checks(torch, "layer train", x, None, g, w, nh)
    lib, xs, wb = mha_library(torch, x, None, w, nh)
    with torch.enable_grad():
        xl = xs.detach().requires_grad_()
        wl = [t.detach().requires_grad_() for t in wb]
        out = lib(xl, wl)
        gl = g.transpose(0, 1).contiguous()
        lib_bwd = lambda: torch.autograd.grad(out, [xl, *wl], gl, retain_graph=True)
        lib_bwd_ms = time_ms(torch, lib_bwd)
    del out, xl, wl
    grads_bytes = (4 * d * d + 4 * d) * 4
    e13["train_ms"] = time_ms(torch, lambda: fm.fused_mha_fwd(x, None, *w, nh))
    e13["train_plain_ms"] = time_ms(torch, lambda: fm.fused_mha_layer_plain(x, None, *w, nh))
    e13["train_bound_ms"] = bound(2 * bt * HIST * d * 2 + w_bytes,
                                  bt * layer_flops(HIST, HIST, d), BF16_FLOPS)[0]
    e13["train_library_ms"] = time_ms(torch, lambda: lib(xs, wb))
    e13["train_fma_ms"] = time_ms(torch, lambda: fma(x, None))
    e13["train_device_ms"] = device_ms(torch, lambda: fm.fused_mha_fwd(x, None, *w, nh),
                                       "mha_fwd_tc_kernel")
    e13["train_fma_device_ms"] = device_ms(torch, lambda: fma(x, None), "mha_fwd_kernel")
    print(f"B13 at B={bt} on {torch.cuda.get_device_name(0)} ({smi}): route "
          f"{fm._fwd_route(x.dtype, HIST, d, nh)} {e13['train_ms']:.4f} ms (device time "
          f"{e13['train_device_ms']:.4f}); the FMA kernel {e13['train_fma_ms']:.4f} (device "
          f"{e13['train_fma_device_ms']:.4f}); library {e13['train_library_ms']:.4f}; bound "
          f"{e13['train_bound_ms']:.4f}", flush=True)
    entry(
        "fused_mha_bwd", src, "two_tower_models_tpu/ops/pallas/fused_mha.py:369", ok, err,
        time_ms(torch, lambda: fm.fused_mha_bwd(g, x, None, *w, nh)),
        time_ms(torch, lambda: fm.fused_mha_layer_bwd_plain(g, x, None, *w, nh)),
        3 * bt * HIST * d * 2 + (4 * d * d + 3 * d) * 4 + grads_bytes,
        bt * layer_vjp_flops(HIST, d), BF16_FLOPS, lib_bwd_ms,
    )
    e14 = entries["fused_mha_bwd"]
    bwd = lambda: fm.fused_mha_bwd(g, x, None, *w, nh)
    fma14 = lambda: fm._launch_bwd_fma(*fm._bwd_inputs(g, x, None, *w[:3]), nh)
    e14["kernel_route"] = fm._bwd_route(x.dtype, HIST, d, nh)
    e14["device_ms"] = device_ms(torch, bwd, "mha_bwd_tc_kernel")
    e14["reduce_device_ms"] = device_ms(torch, bwd, "reduce_kernel")
    e14["fma_ms"] = time_ms(torch, fma14)
    e14["fma_device_ms"] = device_ms(torch, fma14, "mha_bwd_kernel")
    e14["ptxas"] = b14_ptxas
    e14["note"] = (
        "ms includes the second launch that sums the per-block weight grads and the host's "
        "dispatch; device_ms is mha_bwd_tc_kernel's launch alone and reduce_device_ms the "
        "reduce's (torch.profiler); fma_* the FMA kernel (mha_bwd_kernel) on the same inputs; "
        "library_ms is the autograd backward of F.multi_head_attention_forward (bf16)")
    print(f"B14 at B={bt} on {torch.cuda.get_device_name(0)} ({smi}): route {e14['kernel_route']} "
          f"{e14['ms']:.4f} ms (device time {e14['device_ms']:.4f}, its reduce "
          f"{e14['reduce_device_ms']:.4f}); the FMA kernel {e14['fma_ms']:.4f} (device "
          f"{e14['fma_device_ms']:.4f}); library {e14['library_ms']:.4f}; bound "
          f"{e14['bound_ms']:.4f} ({e14['bound_by']}); ptxas {b14_ptxas}", flush=True)
    e13["note"] = (
        "ms, plain_ms, bound_ms, library_ms at the serving batch (B=1024), varlen_* there "
        "with lengths (bound counting valid keys only), train_* at the training batch "
        "(B=4096); library_ms is F.multi_head_attention_forward (bf16); kernel_route is the kernel "
        "fused_mha_fwd takes there (tc: the tensor cores), *fma_ms the FMA kernel on the "
        "same inputs; *device_ms one launch's device time from torch.profiler")
    del xs, x, g
    torch.cuda.empty_cache()

    expect = {"fused_mha_fwd": nl, "fused_mha_fwd_tc": nl, "fused_mha_bwd": nl,
              "fused_mha_bwd_reduce": nl, "fused_mha_bwd_tc": nl,
              "fused_in_batch_ce": 1, "in_batch_ce_bwd": 1, "in_batch_ce_bwd_reduce": 1,
              "fused_history_encoder": 0, "fused_history_encoder_res": 0,
              "fused_history_encoder_bwd": 0, "fused_history_encoder_bwd_recompute": 0,
              "fused_attn_stack": 0, "fused_attn_stack_bwd": 0, "rows_scatter_add": 0,
              "rows_write": 0, **ENC_TC}
    var_data = make_synthetic_data(DataConfig(
        num_samples=bt, num_users=TRAIN_ROWS, num_items=TRAIN_ROWS, feature_dim=16,
        history_len=HIST, num_tasks=3, max_position=cfg.position_table_size,
        seed=args.seed, variable_history=True,
    ), device=dev)
    step = make_train_step(cfg, train_cfg)
    for label, dat in (("train-65k-layer", data), ("train-65k-layer-varlen", var_data)):
        state, metrics, _, _, _ = run_steps(torch, step, state, dat, idx, 3)
        state, timed, ms_step, host_ms, counts = run_steps(torch, step, state, dat, idx,
                                                           TRAIN_STEPS)
        metrics += timed
        legs[label] = ms_step
        print(f"launches on the {label} path ({TRAIN_STEPS} steps): {json.dumps(counts)}",
              flush=True)
        check_launches(counts, expect, TRAIN_STEPS, failures, label)
        for name in ("fused_mha_fwd", "fused_mha_bwd"):
            entries[name][f"launches_{label}"] = counts.get(name, 0)
        e13[f"launches_tc_{label}"] = counts.get("fused_mha_fwd_tc", 0)
        e14[f"launches_tc_{label}"] = counts.get("fused_mha_bwd_tc", 0)
        e14[f"reduce_launches_{label}"] = counts.get("fused_mha_bwd_reduce", 0)
        if not finite(torch, metrics):
            failures.append(f"{label} metrics not finite")
        kern = nl * (e13["train_ms"] + e14["ms"])
        print(
            f"{label} on {torch.cuda.get_device_name(0)} ({smi}): {TRAIN_STEPS} steps of B={bt}: "
            f"ms/step {ms_step:.3f}, examples/s {bt / ms_step * 1e3:.0f}; host wall "
            f"{host_ms:.3f} ms/step; loss first {float(metrics[0]['loss']):.5f} last "
            f"{float(metrics[-1]['loss']):.5f}; three B13 and three B14 alone {kern:.3f} ms "
            f"({kern / ms_step * 100:.1f}% of the step)", flush=True)
        state, busy = trace_steps(torch, step, state, dat, idx, label)
        print(f"{label} step on {torch.cuda.get_device_name(0)} ({smi}): ms/step {ms_step:.3f}, "
              f"host wall {host_ms:.3f} ms/step, device busy "
              + (f"{busy:.3f} ms/step (the trace's three steps)" if busy else "not measured"),
              flush=True)
        e14[f"busy_ms_{label}"] = busy
        grads_vs_cpu(torch, state.params, cfg, dat, idx, failures, label)
    e14["launches"] = e14["launches_train-65k-layer"]
    print(f"per-layer tier on {torch.cuda.get_device_name(0)} ({smi}): "
          + "; ".join(f"{k} {v:.3f} ms" for k, v in legs.items())
          + f"; phase 4's B5+B6 step {b56_ms[0]:.3f}, {b56_ms[1]:.3f} ms: the per-layer step "
          f"{legs['train-65k-layer'] / b56_ms[0]:.2f}x", flush=True)
    return legs


def blockwise_cfg(cfg):
    """``cfg`` with its history encoder on the blockwise tier."""
    import dataclasses

    return dataclasses.replace(cfg, history_encoder=dataclasses.replace(
        cfg.history_encoder, blockwise_kernel=True, fused_encoder=False))


def folded_qkv(torch, model, hist, lens, nh, cd):
    """Layer 0's q, k, v on the blockwise tier as mha_apply hands them to
    blockwise_self_attention: the embedded history plus the PE (zeroed past
    each length, the PE at each length, under ``lens``), projected in the
    compute dtype to f32 and folded to [B * nh, H, hd], n = b * nh + head;
    and the lengths repeated per head."""
    from two_tower_models_tpu_torch.models.history_encoder import (
        sinusoidal_positional_encoding,
    )
    from two_tower_models_tpu_torch.nn.layers import linear_apply

    if lens is None:
        emb = model.item_id_table.detach()[hist]
        x = emb + sinusoidal_positional_encoding(HIST, emb.shape[-1], emb.device)
    else:
        x = stack_input(torch, model, hist, lens)
    b, h, d = x.shape
    qkv = linear_apply(model.history_encoder.attn_layers[0].in_proj, x, cd)
    fold = [t.reshape(b, h, nh, d // nh).transpose(1, 2).reshape(b * nh, h, d // nh).contiguous()
            for t in qkv.split(d, dim=-1)]
    return fold, None if lens is None else lens.repeat_interleave(nh).int()


def attn_counts(n, h, dh, lens):
    """(bytes of one [N, H, Dh] f32 tensor, bytes of one [N, H] one,
    multiply-adds of one [H, valid keys, Dh] product) for the blockwise
    kernels' bounds: B15 does two such products (q kᵀ and P·V), B16 three
    and B17 four, at two operations a multiply-add."""
    keys = n * h if lens is None else int(lens.sum())
    return n * h * dh * 4, n * h * 4, h * keys * dh


def attn_lib(torch, q, k, v, lens):
    """F.scaled_dot_product_attention in f32 with a boolean key mask: the
    one PyTorch call computing B15's output (a yardstick; the port never
    calls it)."""
    F = torch.nn.functional
    mask = None if lens is None else (
        torch.arange(q.shape[1], device=q.device)[None, None, :] < lens[:, None, None])
    return lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask)


def attn_checks(torch, label, q, k, v, lens, g):
    """B15 (and, with a cotangent ``g``, B16 and B17, twice) against their
    plain versions: out and lse within rtol 1e-4 and atol 1e-5 of each
    output's scale, the grads within 1e-4 of each one's scale or of one
    |do| |v| term; masked keys' dk and dv exactly 0.  Returns (ok,
    max_abs_err of out, of the grads)."""
    from two_tower_models_tpu_torch.ops import history_attention as ha

    n, h, _ = q.shape
    lk = torch.full((n,), h, dtype=torch.int32, device=q.device) if lens is None else lens
    out, lse = ha.blockwise_attn_fwd(q, k, v, lk)
    want = ha.blockwise_attn_fwd_plain(q, k, v, lk)
    checks = [close(a, e, 1e-4, 1e-5 * float(e.abs().max())) for a, e in zip((out, lse), want)]
    ok, err, gerr = all(c for c, _ in checks), checks[0][1], 0.0
    line = f"{label}: B15 out, lse max_abs_err {[float(f'{e:.3g}') for _, e in checks]}"
    if g is not None:
        delta = (g * want[0]).sum(-1)
        args = (q, k, v, g, want[1], delta, lk)
        runs = [(ha.blockwise_attn_dq(*args), *ha.blockwise_attn_dkv(*args)) for _ in range(2)]
        repeat = all(torch.equal(a, b) for a, b in zip(*runs))
        term = float(g.abs().max() * v.abs().max())
        gchecks = [close(a, e, 0.0, 1e-4 * max(float(e.abs().max()), term))
                   for a, e in zip(runs[0], ha.blockwise_attn_bwd_plain(*args))]
        masked = torch.arange(h, device=q.device)[None, :] >= lk[:, None]
        zero = bool((runs[0][1][masked] == 0).all()) and bool((runs[0][2][masked] == 0).all())
        gerr = max(e for _, e in gchecks)
        ok = ok and repeat and zero and all(c for c, _ in gchecks)
        line += (f"; B16, B17 dq, dk, dv max_abs_err {[float(f'{e:.3g}') for _, e in gchecks]} "
                 f"(tol 1e-4 of scale); masked keys zero={zero}; bit-equal on repeat={repeat}")
    print(line + f"; ok={ok}", flush=True)
    return ok, err, gerr


def attn_memory(torch, q, k, v, lens, g):
    """Peak device memory above the inputs of forward + backward through
    autograd: the blockwise tier (B15, B16, B17) and the plain dense
    version ([N, H, H] scores and probabilities kept for the backward)."""
    from two_tower_models_tpu_torch.ops import history_attention as ha

    peaks = []
    for fn in (lambda a, b, c: ha.blockwise_self_attention(a, b, c, lengths=lens),
               lambda a, b, c: ha.blockwise_attn_fwd_plain(a, b, c, lens)[0]):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        with torch.enable_grad():
            torch.autograd.grad(fn(*leaves), leaves, g)
        torch.cuda.synchronize()
        peaks.append(torch.cuda.max_memory_allocated() - base)
        del leaves
    return peaks


def phase_blockwise(torch, args, smi, dev, entry, entries, failures, b56_ms, layer_legs) -> None:
    """Phase 7: the blockwise attention tier (HistoryEncoderConfig with
    blockwise_kernel=True, fused_encoder=False) at the cells' full width,
    and the long-history leg of its kernels."""
    from two_tower_models_tpu_torch.config import DataConfig, TrainConfig
    from two_tower_models_tpu_torch.models import two_tower as tt
    from two_tower_models_tpu_torch.ops import history_attention as ha
    from two_tower_models_tpu_torch.serving import RetrievalEngine
    from two_tower_models_tpu_torch.training.data import gather_batch, make_synthetic_data
    from two_tower_models_tpu_torch.training.state import create_train_state
    from two_tower_models_tpu_torch.training.step import make_train_step

    nh, nl, d, b = 4, 3, 64, BATCH
    dh = d // nh
    src = "two_tower_models_tpu_torch/csrc/history_attention.cu"
    rep = "two_tower_models_tpu/ops/pallas/history_attention.py:"
    cd = torch.bfloat16

    # -- 7a, 7b: serving.  phase 3's configuration and seed on the blockwise tier
    cfg = blockwise_cfg(serve_cfg())
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    model = tt.init_params(gen, cfg, device=dev)
    catalog_ids = torch.arange(CORPUS, device=dev)
    catalog_feats = torch.randn(CORPUS, 16, generator=gen, device=dev)
    engine = RetrievalEngine.from_params(model, cfg, catalog_ids, catalog_feats, device=dev)
    engine.warmup(BATCH)
    batches = [(torch.randint(0, cfg.user_id_hash_size, (b,), generator=gen, device=dev),
                torch.randn(b, 16, generator=gen, device=dev),
                torch.randint(0, CORPUS, (b, HIST), generator=gen, device=dev), None)
               for _ in range(args.batches)]
    engine.warmup(BATCH, variable_history=True)
    var_batches = []
    for _ in range(args.batches):
        lens = torch.randint(1, HIST + 1, (b,), generator=gen, device=dev)
        hist = torch.randint(0, CORPUS, (b, HIST), generator=gen, device=dev)
        hist = torch.where(torch.arange(HIST, device=dev)[None, :] < lens[:, None], hist, 0)
        var_batches.append((torch.randint(0, cfg.user_id_hash_size, (b,), generator=gen, device=dev),
                            torch.randn(b, 16, generator=gen, device=dev), hist, lens))
    (q, k, v), _ = folded_qkv(torch, model, batches[0][2], None, nh, cd)
    (qv, kv, vv), lv = folded_qkv(torch, model, var_batches[0][2], var_batches[0][3], nh, cd)
    ok, err, _ = attn_checks(torch, "blockwise serve", q, k, v, None, None)
    ok_v, err_v, _ = attn_checks(torch, "blockwise serve varlen", qv, kv, vv, lv, None)
    full = torch.full((q.shape[0],), HIST, dtype=torch.int32, device=dev)
    row_b, lse_b, fl = attn_counts(q.shape[0], HIST, dh, None)
    entry(
        "blockwise_attn_fwd", src, rep + "144", ok and ok_v, max(err, err_v),
        time_ms(torch, lambda: ha.blockwise_attn_fwd(q, k, v, full)),
        time_ms(torch, lambda: ha.blockwise_attn_fwd_plain(q, k, v, full)),
        4 * row_b + lse_b, 4 * fl, F32_FLOPS, time_ms(torch, attn_lib(torch, q, k, v, None)),
    )
    e15 = entries["blockwise_attn_fwd"]
    row_b, lse_b, fl = attn_counts(qv.shape[0], HIST, dh, lv)
    e15["varlen_ms"] = time_ms(torch, lambda: ha.blockwise_attn_fwd(qv, kv, vv, lv))
    e15["varlen_plain_ms"] = time_ms(torch, lambda: ha.blockwise_attn_fwd_plain(qv, kv, vv, lv))
    e15["varlen_bound_ms"] = bound(4 * row_b + lse_b + lv.numel() * 4, 4 * fl, F32_FLOPS)[0]
    e15["varlen_library_ms"] = time_ms(torch, attn_lib(torch, qv, kv, vv, lv))
    del q, k, v, qv, kv, vv
    cpu_model = copy.deepcopy(model).cpu()
    others = {"fused_history_encoder": 0, "fused_attn_stack": 0, "fused_mha_fwd": 0,
              "tile_max_scores": 1, **SELECT_ROUTE, "gather_rescore": 1, **ENC_TC}
    legs = {}
    for label, bts in (("serve-1M-exact-blockwise", batches),
                       ("serve-1M-exact-blockwise-varlen", var_batches)):
        counts, legs[label] = serve_leg(torch, label, engine, model, cpu_model, cfg, bts,
                                        {"blockwise_attn_fwd": nl, **others}, [], entries,
                                        failures, smi)
        e15[f"launches_{label}"] = counts.get("blockwise_attn_fwd", 0)
    e15["launches"] = e15["launches_serve-1M-exact-blockwise"]
    del engine, model, cpu_model, batches, var_batches, catalog_feats
    torch.cuda.empty_cache()

    # -- 7a: the training batch's layer 0, and the long-history leg --
    cfg = blockwise_cfg(flagship_cfg(TRAIN_ROWS))
    bt = TRAIN_BATCH
    train_cfg = TrainConfig(batch_size=bt, learning_rate=1e-3)
    gen.manual_seed(args.seed + 10)
    state = create_train_state(gen, cfg, train_cfg, device=dev)
    data = fixed_batch(torch, gen, dev, cfg, bt)
    idx = torch.arange(bt, device=dev)
    (q, k, v), _ = folded_qkv(torch, state.params, gather_batch(data, idx).user_history, None,
                              nh, cd)
    g = torch.randn(q.shape, generator=gen, device=dev) / bt
    ok, err, gerr = attn_checks(torch, "blockwise train", q, k, v, None, g)
    full = torch.full((q.shape[0],), HIST, dtype=torch.int32, device=dev)
    out, lse = ha.blockwise_attn_fwd(q, k, v, full)
    delta = (g * out).sum(-1)
    bargs = (q, k, v, g, lse, delta, full)
    lib = attn_lib(torch, q, k, v, None)
    with torch.enable_grad():
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        lib_out = attn_lib(torch, *leaves, None)()
        lib_bwd_ms = time_ms(torch, lambda: torch.autograd.grad(lib_out, leaves, g, retain_graph=True))
    del lib_out, leaves
    row_b, lse_b, fl = attn_counts(q.shape[0], HIST, dh, None)
    e15["train_ms"] = time_ms(torch, lambda: ha.blockwise_attn_fwd(q, k, v, full))
    e15["train_plain_ms"] = time_ms(torch, lambda: ha.blockwise_attn_fwd_plain(q, k, v, full))
    e15["train_bound_ms"] = bound(4 * row_b + lse_b, 4 * fl, F32_FLOPS)[0]
    e15["train_library_ms"] = time_ms(torch, lib)
    plain_bwd_ms = time_ms(torch, lambda: ha.blockwise_attn_bwd_plain(*bargs))
    entry("blockwise_attn_dq", src, rep + "277", ok, gerr,
          time_ms(torch, lambda: ha.blockwise_attn_dq(*bargs)), plain_bwd_ms,
          5 * row_b + 2 * lse_b, 6 * fl, F32_FLOPS, lib_bwd_ms)
    entry("blockwise_attn_dkv", src, rep + "295", ok, gerr,
          time_ms(torch, lambda: ha.blockwise_attn_dkv(*bargs)), plain_bwd_ms,
          6 * row_b + 2 * lse_b, 8 * fl, F32_FLOPS, lib_bwd_ms)
    for name in ("blockwise_attn_dq", "blockwise_attn_dkv"):
        entries[name]["note"] = (
            "at the training batch's layer 0 (N=16384, H=32, Dh=16); plain_ms is the plain "
            "backward (dq, dk and dv together); library_ms the autograd backward of "
            "F.scaled_dot_product_attention (f32), for B16 and B17 together; long_* at N=4, "
            "H=4096")
    e15["note"] = (
        "ms, plain_ms, bound_ms, library_ms at the serving batch's layer 0 (N=4096, H=32, "
        "Dh=16), varlen_* there with lengths (bound counting valid keys only), train_* at the "
        "training batch (N=16384), long_* at N=4, H=4096 (long_varlen_*: lengths uniform in "
        "[1, 4096]); library_ms is F.scaled_dot_product_attention (f32, boolean key mask)")
    del q, k, v, g, out, lse, delta, bargs, lib
    torch.cuda.empty_cache()

    long_ok, mem = True, {}
    for tag, lens in (("long", None),
                      ("long_varlen", torch.randint(1, LONG_H + 1, (LONG_N,), generator=gen,
                                                    device=dev, dtype=torch.int32))):
        q, k, v, g = (torch.randn(LONG_N, LONG_H, dh, generator=gen, device=dev) for _ in range(4))
        ok_l, _, _ = attn_checks(torch, f"blockwise {tag} (N={LONG_N}, H={LONG_H})", q, k, v,
                                 lens, g)
        lk = torch.full((LONG_N,), LONG_H, dtype=torch.int32, device=dev) if lens is None else lens
        out, lse = ha.blockwise_attn_fwd(q, k, v, lk)
        bargs = (q, k, v, g, lse, (g * out).sum(-1), lk)
        row_b, lse_b, fl = attn_counts(LONG_N, LONG_H, dh, lens)
        lib = attn_lib(torch, q, k, v, lens)
        for name, fn, plain, nbytes, nfl in (
            ("blockwise_attn_fwd", lambda: ha.blockwise_attn_fwd(q, k, v, lk),
             lambda: ha.blockwise_attn_fwd_plain(q, k, v, lk), 4 * row_b + lse_b, 4 * fl),
            ("blockwise_attn_dq", lambda: ha.blockwise_attn_dq(*bargs),
             lambda: ha.blockwise_attn_bwd_plain(*bargs), 5 * row_b + 2 * lse_b, 6 * fl),
            ("blockwise_attn_dkv", lambda: ha.blockwise_attn_dkv(*bargs),
             lambda: ha.blockwise_attn_bwd_plain(*bargs), 6 * row_b + 2 * lse_b, 8 * fl),
        ):
            e = entries[name]
            e[f"{tag}_ms"] = time_ms(torch, fn)
            e[f"{tag}_plain_ms"] = time_ms(torch, plain, 3)
            e[f"{tag}_bound_ms"], e[f"{tag}_bound_by"] = bound(nbytes, nfl, F32_FLOPS)
        e15[f"{tag}_library_ms"] = time_ms(torch, lib, 3)
        with torch.enable_grad():
            leaves = [t.clone().requires_grad_() for t in (q, k, v)]
            lib_out = attn_lib(torch, *leaves, lens)()
            lib_bwd = time_ms(torch, lambda: torch.autograd.grad(lib_out, leaves, g,
                                                                 retain_graph=True), 3)
        del lib_out, leaves
        for name in ("blockwise_attn_dq", "blockwise_attn_dkv"):
            entries[name][f"{tag}_library_ms"] = lib_bwd
        peaks = attn_memory(torch, q, k, v, lk, g)
        mem[tag] = peaks
        long_ok &= ok_l and peaks[0] < peaks[1] / 4
        print(f"blockwise {tag}: peak memory of forward + backward above the inputs: blockwise "
              f"{peaks[0] / 2**20:.2f} MiB, plain dense {peaks[1] / 2**20:.2f} MiB "
              f"({peaks[0] / peaks[1]:.4f}, needs < 0.25); B15 {e15[f'{tag}_ms']:.4f} ms, "
              f"B16 {entries['blockwise_attn_dq'][f'{tag}_ms']:.4f} ms, B17 "
              f"{entries['blockwise_attn_dkv'][f'{tag}_ms']:.4f} ms", flush=True)
        del q, k, v, g, out, lse, bargs, lib
        torch.cuda.empty_cache()
    e15["long_memory_bytes"] = mem
    if not long_ok:
        failures.append("blockwise long history")

    # -- 7c: training.  phase 4's configuration on the blockwise tier
    expect = {"blockwise_attn_fwd": nl, "blockwise_attn_dq": nl, "blockwise_attn_dkv": nl,
              "fused_in_batch_ce": 1, "in_batch_ce_bwd": 1, "in_batch_ce_bwd_reduce": 1,
              "fused_history_encoder": 0, "fused_history_encoder_res": 0,
              "fused_history_encoder_bwd": 0, "fused_history_encoder_bwd_recompute": 0,
              "fused_attn_stack": 0, "fused_attn_stack_bwd": 0, "fused_mha_fwd": 0,
              "fused_mha_bwd": 0, "fused_mha_bwd_tc": 0, "rows_scatter_add": 0, "rows_write": 0,
              "fused_adam": 0, **ENC_TC}
    var_data = make_synthetic_data(DataConfig(
        num_samples=bt, num_users=TRAIN_ROWS, num_items=TRAIN_ROWS, feature_dim=16,
        history_len=HIST, num_tasks=3, max_position=cfg.position_table_size,
        seed=args.seed, variable_history=True,
    ), device=dev)
    step = make_train_step(cfg, train_cfg)
    for label, dat in (("train-65k-blockwise", data), ("train-65k-blockwise-varlen", var_data)):
        state, metrics, _, _, _ = run_steps(torch, step, state, dat, idx, 3)
        state, timed, ms_step, host_ms, counts = run_steps(torch, step, state, dat, idx,
                                                           TRAIN_STEPS)
        state, syncs = count_syncs(torch, step, state, dat, idx)
        metrics += timed
        legs[label] = ms_step
        print(f"launches on the {label} path ({TRAIN_STEPS} steps): {json.dumps(counts)}",
              flush=True)
        check_launches(counts, expect, TRAIN_STEPS, failures, label)
        for name in ("blockwise_attn_fwd", "blockwise_attn_dq", "blockwise_attn_dkv"):
            entries[name][f"launches_{label}"] = counts.get(name, 0)
        if not finite(torch, metrics):
            failures.append(f"{label} metrics not finite")
        kern = nl * (e15["train_ms"] + entries["blockwise_attn_dq"]["ms"]
                     + entries["blockwise_attn_dkv"]["ms"])
        print(
            f"{label} on {torch.cuda.get_device_name(0)} ({smi}): {TRAIN_STEPS} steps of B={bt}: "
            f"ms/step {ms_step:.3f}, examples/s {bt / ms_step * 1e3:.0f}; host wall "
            f"{host_ms:.3f} ms/step; loss first {float(metrics[0]['loss']):.5f} last "
            f"{float(metrics[-1]['loss']):.5f}; three each of B15, B16, B17 alone {kern:.3f} ms "
            f"({kern / ms_step * 100:.1f}% of the step); host syncs in a step {syncs}", flush=True)
        state, _ = trace_steps(torch, step, state, dat, idx, label)
        grads_vs_cpu(torch, state.params, cfg, dat, idx, failures, label)
    for name in ("blockwise_attn_dq", "blockwise_attn_dkv"):
        entries[name]["launches"] = entries[name]["launches_train-65k-blockwise"]
    print(f"blockwise tier on {torch.cuda.get_device_name(0)} ({smi}): "
          + "; ".join(f"{k} {v:.3f} ms" for k, v in legs.items())
          + f"; phase 4's B5+B6 step {b56_ms[0]:.3f}, {b56_ms[1]:.3f} ms; phase 6: "
          + "; ".join(f"{k} {v:.3f} ms" for k, v in layer_legs.items()), flush=True)
    del state, data, var_data
    torch.cuda.empty_cache()


def phase_fused_adam(torch, args, smi, dev, entry, entries, failures, ms_packed) -> None:
    """Phase 8: one-pass fused Adam (B20) on scripts/bench_tables.py's
    configuration (train-4M-packed with TrainConfig(fused_adam=True))."""
    import dataclasses

    from two_tower_models_tpu_torch.config import TrainConfig
    from two_tower_models_tpu_torch.ops import fused_adam as fa
    from two_tower_models_tpu_torch.training.state import create_train_state
    from two_tower_models_tpu_torch.training.step import make_train_step

    b = TRAIN_BATCH
    cfg = flagship_cfg(TABLE_ROWS)
    dense_cfg = TrainConfig(batch_size=b, learning_rate=1e-3, pack_tables_min_rows=PACK_MIN_ROWS)
    fused_cfg = dataclasses.replace(dense_cfg, fused_adam=True)
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed + 11)
    data = fixed_batch(torch, gen, dev, cfg, b)
    idx = torch.arange(b, device=dev)
    st_fused = create_train_state(args.seed + 12, cfg, fused_cfg, device=dev)
    big = [(n, p) for n, p in st_fused.params.named_parameters()
           if p.numel() >= fa._MIN_KERNEL_ELEMS]
    print(f"fused Adam: leaves of >= {fa._MIN_KERNEL_ELEMS} elements (one B20 launch a step "
          f"each): {[(n, tuple(p.shape)) for n, p in big]}", flush=True)

    # -- 8a: B20 against its plain version on the real leaves, 3 steps --
    exact, err, bytes_, elems = True, 0.0, 0, 0
    for name, p in big:
        g = torch.randn(p.shape, generator=gen, device=dev) * 1e-2
        m0 = torch.randn(p.shape, generator=gen, device=dev) * 1e-3
        v0 = m0.square() * 2
        runs = [[p.detach().clone(), m0.clone(), v0.clone()] for _ in range(2)]
        for t in (1, 2, 3):
            c = fa.bias_corrections(torch.tensor(t, dtype=torch.int32, device=dev))
            fa.fused_adam_leaf(*runs[0], g, c, 1e-3)
            fa.fused_adam_leaf_plain(*runs[1], g, c, 1e-3)
        for a, e in zip(*runs):
            exact &= torch.equal(a, e)
            err = max(err, close(a, e, 0.0, 0.0)[1])
        elems += p.numel()
        bytes_ += p.numel() * (2 * p.element_size() + 4 * 4 + g.element_size())
        del runs, g, m0, v0
        torch.cuda.empty_cache()
    print(f"fused Adam vs plain on the 4M-packed leaves, 3 steps: p, m, v bit-equal={exact}",
          flush=True)
    c = fa.bias_corrections(torch.tensor(4, dtype=torch.int32, device=dev))
    leaves = [(p.detach().clone(), torch.zeros_like(p), torch.zeros_like(p),
               torch.randn(p.shape, generator=gen, device=dev) * 1e-2) for _, p in big]
    one_pass = lambda: [fa.fused_adam_leaf(pp, m, v, g, c, 1e-3) for pp, m, v, g in leaves]
    tp = [torch.nn.Parameter(pp.clone()) for pp, _, _, _ in leaves]
    for t, (_, _, _, g) in zip(tp, leaves):
        t.grad = g
    lib_opt = torch.optim.Adam(tp, lr=1e-3, fused=True)
    entry(
        "fused_adam", "two_tower_models_tpu_torch/csrc/fused_adam.cu",
        "two_tower_models_tpu/ops/pallas/fused_adam.py:84", exact, err,
        time_ms(torch, one_pass),
        time_ms(torch, lambda: [fa.fused_adam_leaf_plain(pp, m, v, g, c, 1e-3)
                                for pp, m, v, g in leaves], 3),
        bytes_, 14 * elems, F32_FLOPS, time_ms(torch, lib_opt.step, 3),
    )
    entries["fused_adam"]["note"] = (
        "times are one step's launches over the leaves of >= 2^16 elements of a 4M-packed state "
        "(the two packed id tables); library_ms is torch.optim.Adam(fused=True).step() on "
        "copies of them")
    del leaves, tp, lib_opt
    torch.cuda.empty_cache()

    # -- 8b: one step from one state through B20 and through Adam --
    st_adam = create_train_state(args.seed + 12, cfg, dense_cfg, device=dev)
    with torch.enable_grad():
        st_fused, _ = make_train_step(cfg, fused_cfg)(st_fused, data, idx)
        st_adam, _ = make_train_step(cfg, dense_cfg)(st_adam, data, idx)
    got, want = table_tensors(st_fused), table_tensors(st_adam)
    worst, bad = 0.0, []
    for name in want:
        ok, e = scaled_close(got[name], want[name], 1e-6)
        worst = max(worst, e)
        if not ok:
            bad.append(name)
    print(f"train-4M-packed: one step through B20 vs through Adam from one state, tables and "
          f"moments: max_abs_err {worst:.3g} (tol 1e-6 of each one's scale); mismatched {bad}",
          flush=True)
    if bad:
        failures.append(f"fused Adam step vs Adam: {bad}")
    del st_adam, got, want
    torch.cuda.empty_cache()

    # -- 8c: the leg --
    five = {"fused_history_encoder_res": 1, "fused_history_encoder_bwd": 1, "fused_in_batch_ce": 1,
            "in_batch_ce_bwd": 1, "in_batch_ce_bwd_reduce": 1, **ENC_TC,
            "fused_history_encoder_res_tc": 1, "fused_history_encoder_bwd_tc": 1}
    step = make_train_step(cfg, fused_cfg)
    st_fused, ms, counts = table_leg(
        torch, "train-4M-packed-fusedadam", step, st_fused, data, idx, 2,
        {**five, "rows_scatter_add": 3, "rows_write": 0, "fused_adam": len(big)}, smi, failures)
    entries["fused_adam"]["launches"] = counts.get("fused_adam", 0)
    b20 = entries["fused_adam"]["ms"]
    print(f"train-4M-packed-fusedadam on {torch.cuda.get_device_name(0)} ({smi}): {ms:.3f} "
          f"ms/step against train-4M-packed's {ms_packed:.3f} (phase 5, this run); B20's "
          f"{len(big)} launches alone {b20:.3f} ms ({b20 / ms * 100:.1f}% of the step)", flush=True)
    del st_fused
    torch.cuda.empty_cache()


def nonfinite_check(torch, dev) -> bool:
    """Phase 2's input for the tile max's total order: an integer-grid
    corpus (every finite score exact) with rows that score +-inf and NaN
    (+inf in a column half the queries zero, so 0 * inf; -inf rows; a -NaN
    row and a +NaN row).  B2 must equal its plain version bit for bit (as
    int32 keys), and the exact pipeline's indices topk_ordered on the dense
    scores."""
    from two_tower_models_tpu_torch.ops import mips_topk as mt
    from two_tower_models_tpu_torch.retrieval.mips import mips_topk_exact, topk_ordered

    b, c, d = 256, 1 << 18, 64
    gen = torch.Generator(device=dev)
    gen.manual_seed(1234)
    corpus = torch.randint(-2, 3, (c, d), generator=gen, device=dev).float()
    query = torch.randint(-2, 3, (b, d), generator=gen, device=dev).float()
    query[: b // 2, 0] = 0
    corpus[torch.arange(0, 300, device=dev) * mt.TILE + 5, 0] = float("inf")
    corpus[torch.arange(300, 400, device=dev) * mt.TILE + 7, 1] = float("-inf")
    bits = corpus.view(torch.int32)
    bits[3, 2] = -(1 << 22)  # 0xFFC00000, a negative NaN
    bits[77_777, 5] = 0x7FC00000  # a positive NaN
    got = mt.tile_max_scores(query, corpus, mt.TILE, c)
    tile_exact = torch.equal(mt.f32_keys(got), mt.f32_keys(mt.tile_max_scores_plain(
        query, corpus, mt.TILE, c)))
    scores = query @ corpus.T
    idx, _, _ = mips_topk_exact(corpus, query, TOPK)
    pipe_exact = torch.equal(idx, topk_ordered(scores, TOPK)[1])
    print(f"tile max on non-finite scores ({int(scores.isnan().sum())} NaN, "
          f"{int(scores.isinf().sum())} inf of {scores.numel()}): B2 vs plain bit-equal="
          f"{tile_exact}; pipeline indices vs topk_ordered on the dense scores equal={pipe_exact}",
          flush=True)
    return tile_exact and pipe_exact


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
        from two_tower_models_tpu_torch.models import two_tower as tt
        from two_tower_models_tpu_torch.models.history_encoder import (
            sinusoidal_positional_encoding,
        )
        from two_tower_models_tpu_torch.ops import _lib
        from two_tower_models_tpu_torch.ops import fused_encoder as fe
        from two_tower_models_tpu_torch.ops import mips_topk as mt
        from two_tower_models_tpu_torch.retrieval.mips import mips_topk_exact
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
    _lib.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    ptxas = [subprocess.Popen(  # beside the build, which they do not slow by much
        [_lib._nvcc(), *_lib.NVCC_FLAGS, "-Xptxas", "-v", "-c", str(_lib.CSRC / f"{src}.cu"),
         "-o", str(_lib.BUILD_DIR / f"ptxas_{src}.o")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for src in ("fused_softmax", "fused_mha", "select_topk", "rows_write", "fused_encoder",
                    "fused_encoder_bwd")]
    _lib.library()
    ptxas_log = "\n".join(p.communicate(timeout=600)[0] for p in ptxas)
    print(smi, flush=True)
    print(
        f"env: torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()} "
        f"kernel build {_lib.build_seconds if _lib.build_seconds is not None else 0.0:.1f} s "
        f"(load {time.perf_counter() - t0:.1f} s)",
        flush=True,
    )
    from two_tower_models_tpu_torch.ops import fused_mha as fm

    ept = fm._fwd_tc_tile(HIST, 64)
    enc_smem = fe._enc_tc_plan(TRAIN_BATCH, HIST, 64, 3, 1)[2]
    bwd_smem = fe._enc_bwd_tc_plan(TRAIN_BATCH, HIST, 64, 3, 1)[2]
    spills, ptxas_lines = ptxas_report(
        ptxas_log, ["ce_bwd_kernel", "ce_bwd_reduce", "mha_fwd_tc_kernel", "mha_bwd_tc_kernel",
                    "select_radix_kernel", "select_topk_kernel", "rows_write_kernel",
                    "encoder_tc_kernel", "encoder_bwd_tc_kernel"], {
            # bwd::SMEM_FLOATS in csrc/fused_softmax.cu
            "ce_bwd_kernel": 4 * (128 * 68 + 2 * 64 * 68 + 128 * 72 + 2 * 128),
            "ce_bwd_reduce": 0,
            # the instances of the cells' H = 32 (two key bands), D = 64
            f"mha_fwd_tc_kernel<{HIST // 16}>": fm._fwd_tc_smem_bytes(HIST, 64, ept),
            f"mha_bwd_tc_kernel<{HIST // 16}, 64>": fm._bwd_tc_plan(TRAIN_BATCH, HIST, 64, 1)[2],
            # B1, B5 and B8 (<RES, STACK, Hp / 16>) at the cells' three layers
            **{f"encoder_tc_kernel<{res}, {stack}, {HIST // 16}>": enc_smem
               for res, stack in ((0, 0), (1, 0), (0, 1))},
            # B6 and B9 (<MODE, Hp / 16, D>: MODE 0 from the stored residuals, 2 the stack)
            **{f"encoder_bwd_tc_kernel<{mode}, {HIST // 16}, 64>": bwd_smem for mode in (0, 2)},
        })
    dev = torch.device(DEVICE)

    # ---- set-up: full-width model, catalog, engine ---------------------
    cfg = serve_cfg()
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
    entries, failures = {}, [f"ptxas: {n} spills or gave no report" for n in spills]

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

    # kernel 1: whole encoder (main path: bf16, on the tensor cores); f32 checked too
    enc_args = lambda x: (x, pe, *w, nh)
    route = fe._enc_route(torch.bfloat16, HIST, d, nh, nl)
    w_k = [fe._f32(t, dev) for t in w]
    fma1 = lambda: fe._launch_fwd_fma("fused_history_encoder", x_bf16, fe._pe(pe, x_bf16), *w_k, nh)
    ok_bf, err_bf = enc_checks(
        torch, "encoder", (fe.fused_history_encoder(*enc_args(x_bf16)),),
        (fe.fused_history_encoder(*enc_args(x_bf16)),),
        (fe.fused_history_encoder_plain(*enc_args(x_bf16)),),
        (fe.fused_history_encoder_f64_sums(*enc_args(x_bf16)),), (fma1(),), ("y",))
    ok_32, err_32 = close(fe.fused_history_encoder(*enc_args(x_f32)),
                          fe.fused_history_encoder_plain(*enc_args(x_f32)), 1e-4, 1e-4)
    print(f"encoder route {route}; f32: ok={ok_32} max_abs_err={err_32:.3g} (tol 1e-4)", flush=True)
    entry(
        "fused_history_encoder", "two_tower_models_tpu_torch/csrc/fused_encoder.cu",
        "two_tower_models_tpu/ops/pallas/fused_encoder.py:506",
        ok_bf and ok_32 and route == "tc", err_bf,
        time_ms(torch, lambda: fe.fused_history_encoder(*enc_args(x_bf16))),
        time_ms(torch, lambda: fe.fused_history_encoder_plain(*enc_args(x_bf16))),
        b * HIST * d * 2 + HIST * d * 4 + sum(t.numel() for t in w) * 4 + b * 2 * d * 2,
        b * enc_flops(HIST, d, nl), BF16_FLOPS, None,
    )
    e1 = entries["fused_history_encoder"]
    e1["kernel_route"] = route
    x0 = (x_f32 + pe).to(torch.bfloat16)
    enc_times(torch, e1, lambda: fe.fused_history_encoder(*enc_args(x_bf16)), fma1,
              lambda: b13_layers(x0, None, w, nh))
    print(enc_line(torch, smi, f"B1 at B={b}", e1), flush=True)
    e1["note"] = ("kernel_route is the kernel fused_history_encoder takes (tc: the tensor cores); "
                  "device_ms that kernel's device time from torch.profiler; fma_* the FMA "
                  "kernel (encoder_kernel) on the same inputs; b13x3_device_ms three B13 "
                  "launches (full layers) on x + PE")
    del x0

    # kernel 2: tile maxes
    mk = mt.tile_max_scores(q, corpus, mt.TILE, c)
    mp = mt.tile_max_scores_plain(q, corpus, mt.TILE, c)
    scale = float(mp.abs().max())
    ok, err = close(mk, mp, 1e-5, 1e-5 * scale)
    ok = nonfinite_check(torch, dev) and ok
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
    # the tournament (k > K_MAX's route) at the same shapes, launched alone
    tour = lambda x: mt._launch_select(x, TOPK, True, "tournament")
    ok_tour = all(torch.equal(a, e) for x, want in ((mk, (kp, ip)), (ck, (cp4, ip4)))
                  for a, e in zip(tour(x), want))
    passes = (mk, ck)
    sel = {
        "ms": [time_ms(torch, lambda: mt.select_rows(x, TOPK)) for x in passes],
        "device_ms": [call_device_ms(torch, lambda: mt.select_rows(x, TOPK)) for x in passes],
        "plain_ms": [time_ms(torch, lambda: mt.select_keys_plain(
            mt.f32_keys(x).clamp_min(-(1 << 31) + 1), TOPK), 3) for x in passes],
        "library_ms": [time_ms(torch, lambda: torch.topk(x, TOPK), 3) for x in passes],
        "library_device_ms": [call_device_ms(torch, lambda: torch.topk(x, TOPK)) for x in passes],
        "tournament_ms": [time_ms(torch, lambda: tour(x)) for x in passes],
        "tournament_device_ms": [call_device_ms(torch, lambda: tour(x)) for x in passes],
    }
    print(f"select pass2 exact={ok2} ms={sel['ms'][0]:.4f} (device {sel['device_ms'][0]:.4f}); "
          f"pass4 exact={ok4} ms={sel['ms'][1]:.4f} (device {sel['device_ms'][1]:.4f}); index "
          f"mismatches {idx_mismatch}; torch.topk device {sel['library_device_ms'][0]:.4f}, "
          f"{sel['library_device_ms'][1]:.4f}; the tournament exact={ok_tour} device "
          f"{sel['tournament_device_ms'][0]:.4f}, {sel['tournament_device_ms'][1]:.4f}", flush=True)
    entry(
        "select_topk_radix", "two_tower_models_tpu_torch/csrc/select_topk.cu",
        "two_tower_models_tpu/ops/pallas/mips_topk.py:319", ok2 and ok4 and ok_tour, sel_err,
        sum(sel["ms"]), sum(sel["plain_ms"]),
        (b * nt * 4 + b * TOPK * 8) + (b * TOPK * mt.TILE * 4 + b * TOPK * 8), 0, F32_FLOPS,
        sum(sel["library_ms"]),
    )
    e3 = entries["select_topk_radix"]
    e3.update({f"{key}_by_pass": v for key, v in sel.items()})
    e3["device_ms"] = sum(sel["device_ms"])
    e3["library_device_ms"] = sum(sel["library_device_ms"])
    e3["tournament_device_ms"] = sum(sel["tournament_device_ms"])
    e3["note"] = ("times are pass 2 + pass 4 of one query batch (_by_pass: each); ms with the "
                  "host's dispatch (CUDA events), device_ms the kernels alone (torch.profiler); "
                  "library is torch.topk, which keeps no tie order; tournament_* the kernel "
                  "that takes k > K_MAX, at these shapes")
    e3["index_mismatches"] = idx_mismatch
    del mp, cp, tiles_lib
    torch.cuda.empty_cache()

    # ---- phase 3: serve ------------------------------------------------
    cpu_model = copy.deepcopy(model).cpu()
    counts, _ = serve_leg(
        torch, "serve", engine, model, cpu_model, cfg, [(*bt, None) for bt in batches],
        {"fused_history_encoder": 1, "tile_max_scores": 1, **SELECT_ROUTE,
         "gather_rescore": 1, **ENC_TC, "fused_history_encoder_tc": 1},
        ["fused_history_encoder", "tile_max_scores", "select_topk_radix", "gather_rescore"],
        entries, failures, smi,
    )
    e1["tc_launches"] = counts.get("fused_history_encoder_tc", 0)

    # where a batch's time goes: the user tower and the MIPS, each alone
    u, f, h = batches[0]
    with torch.inference_mode():
        tower_ms = time_ms(torch, lambda: tt.compute_user_embedding(model, cfg, u, f, h))
        q_serve, _ = tt.compute_user_embedding(model, cfg, u, f, h)
        mips_ms = time_ms(torch, lambda: mips_topk_exact(corpus, q_serve, TOPK))
    print(f"stages: user tower {tower_ms:.4f} ms, exact MIPS {mips_ms:.4f} ms "
          f"per B={BATCH} batch", flush=True)

    # ---- phase 2b: serve variable-length histories ----------------------
    phase_serve_varlen(torch, args, gen, smi, dev, cfg, model, cpu_model, engine, w,
                       entry, entries, failures)
    del engine, corpus, batches, model, cpu_model
    torch.cuda.empty_cache()

    # ---- phase 4 (and 4c): train; phase 4b: train variable lengths -------
    bwd_ptxas = ["; ".join(ptxas_lines.get(f"encoder_bwd_tc_kernel<{mode}, {HIST // 16}, 64>", []))
                 for mode in (0, 2)]
    train_cfg4, train_cfg, b56_ms = phase_train(torch, args, smi, dev, entry, entries, failures,
                                                bwd_ptxas[0])
    torch.cuda.empty_cache()
    phase_train_varlen(torch, args, smi, dev, train_cfg4, train_cfg, entry, entries, failures,
                       bwd_ptxas[1])
    torch.cuda.empty_cache()

    # ---- phase 5: large tables -------------------------------------------
    ms_packed = phase_tables(torch, args, smi, dev, entry, entries, failures)
    torch.cuda.empty_cache()

    # ---- phase 6: the per-layer attention tier ---------------------------
    layer_legs = phase_layer(torch, args, smi, dev, entry, entries, failures, b56_ms,
                             "; ".join(ptxas_lines.get(f"mha_bwd_tc_kernel<{HIST // 16}, 64>", [])))
    torch.cuda.empty_cache()

    # ---- phase 7: the blockwise attention tier ---------------------------
    phase_blockwise(torch, args, smi, dev, entry, entries, failures, b56_ms, layer_legs)

    # ---- phase 8: fused Adam ---------------------------------------------
    phase_fused_adam(torch, args, smi, dev, entry, entries, failures, ms_packed)
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
