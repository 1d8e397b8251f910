"""B6's, B7's and B9's kernels against the backward with f64 sums, seed by seed.

For each shape below, each backward (B6 from the residuals B5 stores, B7
recomputing the forward from x and the PE, B9 the length-masked stack with
lengths uniform in [1, H]) and each seed, on
at least 2^23 values of dx, from the tensor-core kernel (the wrapper on its
route), the plain version and, where it takes the shape, the FMA kernel
(``_launch_bwd_fma``):

- ``dx_far``: values of dx more than one bf16 step from the f64 sums'
  (``fused_history_encoder_bwd_f64_sums``,
  ``fused_history_encoder_bwd_recompute_f64_sums``,
  ``fused_attn_stack_bwd_f64_sums``);
- ``rms``: each grad's RMS error against the f64 sums, relative to that
  grad's largest magnitude (B6 and B7: dPE, dW_in, db_in, dW_out, db_out;
  B9 without dPE);
- ``db_out_by_layer``: db_out's RMS error layer by layer, relative to the
  same largest magnitude.

Inputs as ``tests/test_torch_cuda_kernels.py:_encoder_inputs`` and
``_stack_case`` make them.

    python3 scripts/torch_encoder_bwd_f64.py [--shapes H,D,NH,L ...] [--seeds N]

(default: the shapes below, five seeds).  Prints the card's name and
power limit, then one JSON line.  Needs a GPU.
"""

import argparse
import json
import math
import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.getcwd())

import chip_smoke as cs  # noqa: E402
from two_tower_models_tpu_torch.ops import fused_encoder as fe  # noqa: E402

# (H, D, heads, layers): the cells' shape, H = 40 (Hp = 48), 48 and 64
CASES = [(32, 64, 4, 3), (40, 64, 4, 3), (48, 64, 4, 3), (64, 64, 4, 2)]
SEEDS = [61, 0, 1, 2, 3]


def inputs(b, h, d, nh, nl, seed, dev):
    """x, the PE and stacked weights and the encoder's cotangent [B, 2, D]
    from ``seed``; lengths in [1, H] (the first two H and 1), x zeroed past
    them and the stack's cotangent [B, D] from ``seed + 1``, in the card
    tests' order."""
    r = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(dev)  # noqa: E731
    lim_in, lim_out = math.sqrt(6.0 / (4 * d)), math.sqrt(6.0 / (2 * d))
    x = t(r.normal(size=(b, h, d))).bfloat16()
    w = [t(r.normal(size=(h, d)) * 0.5), t(r.uniform(-lim_in, lim_in, (nl, d, 3 * d))),
         t(r.uniform(-0.1, 0.1, (nl, 3 * d))), t(r.uniform(-lim_out, lim_out, (nl, d, d))),
         t(r.uniform(-0.1, 0.1, (nl, d)))]
    g_enc = t(r.normal(size=(b, 2, d)) * 0.1).bfloat16()
    r = np.random.default_rng(seed + 1)
    lens = r.integers(1, h + 1, size=b)
    lens[:2] = [h, 1]
    lens = torch.from_numpy(lens.astype(np.int32)).to(dev)
    xm = torch.where((torch.arange(h, device=dev)[None, :] < lens[:, None])[..., None], x, 0)
    g_stack = t(r.normal(size=(b, d)) * 0.1).bfloat16()
    return x, w, g_enc, lens, xm, g_stack


def measure(got, ref):
    """dx's count beyond one bf16 step, each grad's RMS error and db_out's
    by layer, all against ``ref``."""
    scale = lambda e: e.abs().max().clamp_min(1e-300)  # noqa: E731
    dbo, ref_dbo = got[-1].double(), ref[-1]
    return {"dx_far": cs.bf16_far(torch, got[0], ref[0]),
            "rms": [float((a.double() - e).pow(2).mean().sqrt() / scale(e))
                    for a, e in zip(got[1:], ref[1:])],
            "db_out_by_layer": [float((dbo[l] - ref_dbo[l]).pow(2).mean().sqrt() / scale(ref_dbo))
                                for l in range(ref_dbo.shape[0])]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--shapes", nargs="*", default=[",".join(map(str, c)) for c in CASES])
    ap.add_argument("--seeds", type=int, default=len(SEEDS))
    args = ap.parse_args()
    cases = [tuple(int(v) for v in c.split(",")) for c in args.shapes]
    seeds = (SEEDS + list(range(4, 4 + args.seeds)))[:args.seeds]
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    dev = torch.device("cuda")
    out = {"device": torch.cuda.get_device_name(0), "smi": smi, "cases": []}
    for h, d, nh, nl in cases:
        b = -(-(1 << 23) // (h * d))
        fits = fe._bwd_smem_bytes(h, d, nh) <= fe._SMEM_LIMIT
        for seed in seeds:
            x, w, g_enc, lens, xm, g_stack = inputs(b, h, d, nh, nl, seed, dev)
            _, xs, ps, p0 = fe.fused_history_encoder_res(x, *w, nh)
            b6 = (g_enc, xs, ps, p0, w[1], w[2], w[3], nh)
            b7 = (g_enc, x, *w, nh)
            b9 = (g_stack, xm, lens, *w[1:], nh)
            for kind, args, kernel, plain, ref in (
                ("B6", b6, fe.fused_history_encoder_bwd, fe.fused_history_encoder_bwd_plain,
                 fe.fused_history_encoder_bwd_f64_sums),
                ("B7", b7, fe.fused_history_encoder_bwd_recompute,
                 fe.fused_history_encoder_bwd_recompute_plain,
                 fe.fused_history_encoder_bwd_recompute_f64_sums),
                ("B9", b9, fe.fused_attn_stack_bwd, fe.fused_attn_stack_bwd_plain,
                 fe.fused_attn_stack_bwd_f64_sums),
            ):
                row = {"kind": kind, "h": h, "d": d, "nh": nh, "nl": nl, "seed": seed, "b": b,
                       "route": fe._enc_bwd_route(x.dtype, h, d, nh, nl)}
                r = ref(*args)
                row["kernel"], row["plain"] = measure(kernel(*args), r), measure(plain(*args), r)
                if fits:
                    dx = torch.empty_like(x)
                    if kind == "B6":  # the wrapper's order: dx, dPE, then the four grads
                        grads = fe._launch_bwd_fma("fused_history_encoder_bwd",
                                                   fe._res_bwd_inputs(*args), dx,
                                                   fe._grad_shapes(h, d, nl, True), nh, nl)
                        fma = (dx, grads[-1], *grads[:-1])
                    elif kind == "B7":
                        grads = fe._launch_bwd_fma(
                            "fused_history_encoder_bwd_recompute",
                            fe._recompute_bwd_inputs(g_enc, x, fe._pe(w[0], x), *w[1:], nh,
                                                     enc=True),
                            dx, fe._grad_shapes(h, d, nl, True), nh, nl,
                            fe._res_floats(h, d, nh, nl))
                        fma = (dx, grads[-1], *grads[:-1])
                    else:
                        fma = (dx, *fe._launch_bwd_fma(
                            "fused_attn_stack_bwd",
                            fe._recompute_bwd_inputs(g_stack, xm, fe._lens(lens, xm), *w[1:], nh,
                                                     enc=False),
                            dx, fe._grad_shapes(h, d, nl, False), nh, nl,
                            fe._res_floats(h, d, nh, nl)))
                    row["fma"] = measure(fma, r)
                out["cases"].append(row)
                print(json.dumps(row), file=sys.stderr, flush=True)
            torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
