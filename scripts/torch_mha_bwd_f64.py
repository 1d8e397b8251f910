"""B14's kernels against the backward with f64 sums, seed by seed.

For each layer shape and kind of lengths below and each seed, on 2^23
values of bf16 x (at least one example), from the tensor-core kernel
(``fused_mha_bwd`` on its route), the plain version and the FMA kernel
(``_launch_bwd_fma``):

- ``dx_far``: values of dx more than one bf16 step from
  ``fused_mha_layer_bwd_f64_sums``'s;
- ``rms``: each weight grad's (dW_in, db_in, dW_out, db_out) RMS error
  against the f64 sums, relative to that grad's largest magnitude.

Inputs as ``tests/test_torch_cuda_kernels.py:_mha_case`` makes them;
lengths "none", "mix" (uniform in [1, H]) or "ones" (every length 1).

    python3 scripts/torch_mha_bwd_f64.py

Prints the card's name and power limit, then one JSON line.  Needs a GPU.
"""

import json
import math
import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.getcwd())

import chip_smoke as cs  # noqa: E402
from two_tower_models_tpu_torch.ops import fused_mha as fm  # noqa: E402

CASES = [(12, 32, 2, "ones"), (12, 64, 4, "ones"), (32, 64, 4, "ones"), (12, 32, 2, "none"),
         (32, 64, 4, "none"), (32, 64, 4, "mix")]
SEEDS = range(3)


def case(b, h, d, nh, seed, lens_kind, dev):
    r = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(a.astype(np.float32)).to(dev)  # noqa: E731
    lim_in, lim_out = math.sqrt(6.0 / (4 * d)), math.sqrt(6.0 / (2 * d))
    x = t(r.normal(size=(b, h, d))).bfloat16()
    w = (t(r.uniform(-lim_in, lim_in, (d, 3 * d))), t(r.uniform(-0.1, 0.1, 3 * d)),
         t(r.uniform(-lim_out, lim_out, (d, d))), t(r.uniform(-0.1, 0.1, d)))
    lens = {"none": None, "mix": r.integers(1, h + 1, size=b), "ones": np.ones(b)}[lens_kind]
    lens = None if lens is None else torch.from_numpy(lens.astype(np.int32)).to(dev)
    g = t(r.normal(size=(b, h, d)) * 0.1).bfloat16()
    return x, lens, w, g


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    dev = torch.device("cuda")
    out = {"device": torch.cuda.get_device_name(0), "smi": smi, "cases": []}
    for h, d, nh, lens_kind in CASES:
        b = -(-(1 << 23) // (h * d))
        for seed in SEEDS:
            x, lens, w, g = case(b, h, d, nh, 100 + seed, lens_kind, dev)
            ref = fm.fused_mha_layer_bwd_f64_sums(g, x, lens, *w, nh)
            plain = fm.fused_mha_layer_bwd_plain(g, x, lens, *w, nh)
            dx, flat = fm._launch_bwd_fma(*fm._bwd_inputs(g, x, lens, *w[:3]), nh)
            fma = (dx, *(t.view_as(e) for t, e in zip(
                torch.split(flat, [d * 3 * d, 3 * d, d * d, d]), plain[1:])))
            row = {"h": h, "d": d, "nh": nh, "lens": lens_kind, "seed": seed, "b": b,
                   "route": fm._bwd_route(x.dtype, h, d, nh)}
            for name, got in (("kernel", fm.fused_mha_bwd(g, x, lens, *w, nh)),
                              ("plain", plain), ("fma", fma)):
                row[name] = {"dx_far": cs.bf16_far(torch, got[0], ref[0]), "rms": [
                    float((a.double() - e).pow(2).mean().sqrt() / e.abs().max())
                    for a, e in zip(got[1:], ref[1:])]}
            out["cases"].append(row)
            print(json.dumps(row), file=sys.stderr, flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
