#!/usr/bin/env python3
"""N1's two kernels (csrc/approx_scan.cu) on one card: checks and device times.

    python3 scripts/torch_approx_scan_times.py [--only-n1] [--iters 10]

--only-n1 builds csrc/approx_scan.cu alone into the git-ignored _build/
(nvcc -Xptxas -v, whose report of each instance's registers, spills and
shared memory it prints) in place of the whole kernel library, so a check
of N1 waits for no other kernel's build.  Then, on the card:

  1. each route against the plain version: integer grids bit for bit at the
     card tests' shapes (f32, int8 and bf16 rows on the tensor cores, f32
     and int8 rows on the FMA kernel), the non-finite grid (+-inf rows,
     0 * inf, a NaN of each sign, valid_count inside the corpus) on every
     instance, and normal rows within 1e-5 of each query's scale with equal
     rows wherever a bin's best two differ by more;
  2. device times, CUDA events over --iters launches in the order fma, tc,
     tc, fma, at the serving width (B = 1024, C = 2^20, D = 64 normal rows):
     f32 and int8 rows at M = 2048 and 8192, bf16 rows at 2048, beside the
     bounds (2xTF32 or 3xTF32 at 495 TFLOP/s, f32 FMA at 67).

Prints the card's name and power limit first and one JSON line last; exits
non-zero on a failed check or without a card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

TF32_FLOPS, F32_FLOPS = 495e12, 67e12
SHAPES = [(100, 5000, 64, 256, None), (64, 4096, 16, 128, 3000), (130, 20000, 128, 2048, None),
          (1, 300, 64, 300, None), (65, 10000, 64, 1000, 9990), (200, 70000, 16, 8192, 60000)]


def build_n1_only(lib_mod) -> str:
    """csrc/approx_scan.cu alone into a library bound as the kernel
    library's N1 entries; returns ptxas's report."""
    out = lib_mod.BUILD_DIR / "n1_only"
    out.mkdir(parents=True, exist_ok=True)
    so = out / "libn1.so"
    t0 = time.perf_counter()
    res = subprocess.run([lib_mod._nvcc(), *lib_mod.NVCC_FLAGS, "-Xptxas", "-v", "-shared",
                          str(lib_mod.CSRC / "approx_scan.cu"), "-o", str(so)],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    print(f"nvcc approx_scan.cu: rc {res.returncode} in {time.perf_counter() - t0:.1f} s",
          flush=True)
    if res.returncode != 0:
        print(res.stdout, flush=True)
        raise SystemExit(1)
    lib = ctypes.CDLL(str(so))
    for name in ("tt_approx_scan", "tt_approx_scan_tc"):
        fn = getattr(lib, name)
        fn.argtypes = lib_mod._SIGNATURES[name]
        fn.restype = ctypes.c_int
    lib_mod._lib = lib
    return res.stdout


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--only-n1", action="store_true")
    ap.add_argument("--iters", type=int, default=10)
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    from two_tower_models_tpu_torch.ops import _lib
    from two_tower_models_tpu_torch.ops import approx_topk as at
    from two_tower_models_tpu_torch.ops import mips_topk as mt

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    if args.only_n1:
        for line in build_n1_only(_lib).splitlines():
            if any(s in line for s in ("Compiling entry", "Used", "spill", "C75", "arning")):
                print("ptxas", line.strip(), flush=True)
    else:
        _lib.library()
    fails, out = [], {"device": smi, "checks": {}, "times": {}}

    def equal(got, want):
        same = torch.equal(got[1], want[1]) and torch.equal(mt.f32_keys(got[0]),
                                                           mt.f32_keys(want[0]))
        if not same:
            bad = ((got[1] != want[1]) | (mt.f32_keys(got[0]) != mt.f32_keys(want[0]))).nonzero()
            for b, j in bad[:4].tolist():
                g, w = got[0][b, j].view(torch.int32), want[0][b, j].view(torch.int32)
                print(f"  [{b}, {j}] got {int(g) & 0xFFFFFFFF:#010x} row {int(got[1][b, j])}, "
                      f"want {int(w) & 0xFFFFFFFF:#010x} row {int(want[1][b, j])} "
                      f"({len(bad)} differ)", flush=True)
        return same

    def grid_inputs(seed, b, c, d, kind):
        r = np.random.default_rng(seed)
        q = torch.from_numpy(r.integers(-2, 3, (b, d)).astype(np.float32)).to(dev)
        if kind == "int8":
            rows = torch.from_numpy(r.integers(-127, 128, (c, d)).astype(np.int8)).to(dev)
            scale = r.uniform(0.01, 0.1, c).astype(np.float32)
            scale[::7] = 0.5
            return q, rows, torch.from_numpy(scale).to(dev)
        rows = torch.from_numpy(r.integers(-2, 3, (c, d)).astype(np.float32)).to(dev)
        return q, rows.to(torch.bfloat16) if kind == "bf16" else rows, None

    # 1a. integer grids
    for route, kinds in (("tc", ("f32", "int8", "bf16")), ("fma", ("f32", "int8"))):
        for kind in kinds:
            for b, c, d, m, valid in SHAPES:
                q, rows, sc = grid_inputs(30, b, c, d, kind)
                before = dict(_lib.launches)
                got = at.approx_scan(q, rows, m, valid, sc, force=route)
                torch.cuda.synchronize()
                tc_n = _lib.launches["approx_scan_tc"] - before.get("approx_scan_tc", 0)
                ok = equal(got, at.approx_scan_plain(q, rows, m, valid, sc)) and \
                    tc_n == (route == "tc")
                out["checks"][f"grid {route} {kind} {b}x{c}x{d} M={m}"] = ok
                print(f"grid {route} {kind} B={b} C={c} D={d} M={m} valid={valid}: "
                      f"{'ok' if ok else 'FAIL'}", flush=True)
                if not ok:
                    fails.append(f"grid {route} {kind} {b}x{c}x{d}")

    # 1b. the non-finite grid (chip_smoke.py approx_nonfinite_check's rows)
    b, c, d, m = 256, 1 << 18, 64, 2048
    gen = torch.Generator(device=dev)
    gen.manual_seed(4321)
    corpus = torch.randint(-2, 3, (c, d), generator=gen, device=dev).float()
    query = torch.randint(-2, 3, (b, d), generator=gen, device=dev).float()
    query[: b // 2, 0] = 0
    inf_rows = torch.arange(0, 300, device=dev) * 128 + 5
    ninf_rows = torch.arange(300, 400, device=dev) * 128 + 7
    corpus[inf_rows, 0] = float("inf")
    corpus[ninf_rows, 1] = float("-inf")
    corpus.view(torch.int32)[3, 2] = -(1 << 22)
    corpus.view(torch.int32)[77_777, 5] = 0x7FC00000
    rows8 = torch.randint(-127, 128, (c, d), generator=gen, device=dev).to(torch.int8)
    scale = torch.rand(c, generator=gen, device=dev) * 0.09 + 0.01
    scale[inf_rows] = float("inf")
    scale[ninf_rows] = float("-inf")
    scale.view(torch.int32)[3] = -(1 << 22)
    scale.view(torch.int32)[77_777] = 0x7FC00000
    plain_nan = at.approx_scan_plain(query, corpus, m)[0]
    nan_bits = sorted({int(v) & 0xFFFFFFFF for v in
                       plain_nan[plain_nan.isnan()].view(torch.int32).unique().tolist()})
    print(f"the plain version's NaN bits on the card: {[hex(v) for v in nan_bits]}", flush=True)
    out["plain_nan_bits"] = [hex(v) for v in nan_bits]
    for route, label, rows, sc in (("tc", "f32", corpus, None), ("tc", "int8", rows8, scale),
                                   ("tc", "bf16", corpus.to(torch.bfloat16), None),
                                   ("fma", "f32", corpus, None), ("fma", "int8", rows8, scale)):
        for valid in (c, c - 3000):
            got = at.approx_scan(query, rows, m, valid, sc, force=route)
            ok = equal(got, at.approx_scan_plain(query, rows, m, valid, sc))
            out["checks"][f"nonfinite {route} {label} valid={valid}"] = ok
            print(f"non-finite grid {route} {label} valid={valid}: {'ok' if ok else 'FAIL'}",
                  flush=True)
            if not ok:
                fails.append(f"nonfinite {route} {label} {valid}")
    del corpus, rows8, scale, query

    # 1c and 2: normal rows at the serving width
    b, c, d = 1024, 1 << 20, 64
    g2 = torch.Generator(device=dev)
    g2.manual_seed(7)
    q = torch.randn(b, d, generator=g2, device=dev)
    corpus = torch.randn(c, d, generator=g2, device=dev)
    qs = corpus.abs().amax(-1) / 127.0
    q8 = torch.round(corpus / qs[:, None]).to(torch.int8)
    cb = corpus.to(torch.bfloat16)
    cases = [("f32", 2048, corpus, None), ("f32", 8192, corpus, None), ("int8", 2048, q8, qs),
             ("int8", 8192, q8, qs), ("bf16", 2048, cb, None)]
    for kind, m, rows, sc in cases:
        want = at.approx_scan_plain(q, rows, m, None, sc)
        tol = 1e-5 * want[0].abs().amax(dim=1, keepdim=True)
        s2 = []
        for b0 in range(0, b, 128):
            s = q[b0:b0 + 128] @ rows.float().T * (1 if sc is None else sc[None, :])
            s2.append(torch.topk(s.view(s.shape[0], c // m, m), 2, dim=1).values)
        top2 = torch.cat(s2)
        clear = (top2[:, 0] - top2[:, 1]) > tol
        res = {}
        for route in ("tc", "fma"):
            got = at.approx_scan(q, rows, m, None, sc, force=route)
            err = float((got[0] - want[0]).abs().max())
            bad = int(((got[1] != want[1]) & clear).sum())
            ok = bool(((got[0] - want[0]).abs() <= tol).all()) and bad == 0
            res[route] = {"max_abs_err": err, "rows_mismatched": bad, "ok": ok}
            if not ok:
                fails.append(f"normal {route} {kind} M={m}")
        fns = {r: (lambda r=r: at.approx_scan(q, rows, m, None, sc, force=r)) for r in ("tc", "fma")}
        times = {"fma": [], "tc": []}
        for r in ("fma", "tc", "tc", "fma"):
            fns[r]()
            torch.cuda.synchronize()
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            for _ in range(args.iters):
                fns[r]()
            e1.record()
            torch.cuda.synchronize()
            times[r].append(e0.elapsed_time(e1) / args.iters)
        n_products = 3 if kind == "f32" else 2
        res.update(ms=times, bound_tc_ms=n_products * 2 * b * c * d / TF32_FLOPS * 1e3,
                   bound_fma_ms=2 * b * c * d / F32_FLOPS * 1e3,
                   tc_plan=at.tc_plan(b, d, kind), left_out=int((~clear).sum()))
        out["times"][f"{kind}_M{m}"] = res
        print(f"{kind} rows M={m} on {smi}: tc {times['tc']} ms, fma {times['fma']} ms "
              f"(speed-up {min(times['fma']) / max(times['tc']):.2f}x to "
              f"{max(times['fma']) / min(times['tc']):.2f}x); bounds {n_products}xTF32 "
              f"{res['bound_tc_ms']:.3f}, f32 FMA {res['bound_fma_ms']:.3f}; tc max_abs_err "
              f"{res['tc']['max_abs_err']:.3g} rows off {res['tc']['rows_mismatched']}, fma "
              f"{res['fma']['max_abs_err']:.3g} rows off {res['fma']['rows_mismatched']} "
              f"({res['left_out']} pairs left out); plan {res['tc_plan']}", flush=True)
    out["fails"] = fails
    print(json.dumps(out), flush=True)
    return 1 if fails else 0


if __name__ == "__main__":
    sys.exit(main())
