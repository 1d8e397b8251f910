"""B7 on the tensor cores: two ways to give its backward layer 0's input.

``encoder_bwd_tc_kernel<MODE_ENC>`` (csrc/fused_encoder_bwd.cu) rebuilds
layer 0's input, round(x + PE), from x where it needs it: in the first
pass over the layers and again in the backward's layer 0, a pass over the
tile in shared memory each time, so its scratch of rebuilt layer inputs is
B9's, [L-1, B, H, D] bf16 ("recompute", the kernel as committed).  The
other way writes round(x + PE) into the scratch in the first pass, as its
first layer ([L, B, H, D]), and reads it back at the backward's layer 0
("stored").  This script builds the second variant from the checkout's
sources, changed in four places (below), into a library of its own under
the package's ``_build/``, and on the cells' shape (B = 4096, H = 32, D =
64, four heads, three layers, bf16, inputs from a numpy seed) checks that
both give the same bits (dx and the per-block partial grads) and times the
kernel's launch alone by CUDA events, in turns: recompute, stored, stored,
recompute, ``--iters`` launches each.

    python3 scripts/torch_b7_layer0.py [--iters 50]

Prints the card's name and power limit, then one JSON line.  Needs a GPU
and nvcc.
"""

import argparse
import ctypes
import json
import os
import shutil
import subprocess
import sys

import numpy as np

sys.path.insert(0, os.getcwd())

import torch  # noqa: E402

# (the committed text, the stored variant's) in csrc/fused_encoder_bwd.cu:
# the first pass also stores layer 0's input and shifts the layers after
# it by one, where it writes and reads them; the backward reads every layer
# from the scratch, with no PE pass at layer 0
_EDITS = [
    ("""          add_pe(Xc, tile);
          __syncthreads();  // layer 0's input complete
        }""",
     """          add_pe(Xc, tile);
          __syncthreads();  // layer 0's input complete
          store_rows<THREADS>(xr, Xc, tile, E, Hp, H, D, B);
        }"""),
    ("const bf16* src = l == 0 ? x : xr + (size_t)(l - 1) * lsz;",
     "const bf16* src = l == 0 ? x : xr + (size_t)(l - 1 + (MODE == MODE_ENC)) * lsz;"),
    ("store_rows<THREADS>(xr + (size_t)l * lsz, Xc, tile, E, Hp, H, D, B);",
     "store_rows<THREADS>(xr + (size_t)(l + (MODE == MODE_ENC)) * lsz, Xc, tile, E, Hp, H, D, B);"),
    ("const bf16* src = !RECOMPUTE ? x + (size_t)l * lsz : l == 0 ? x : xr + (size_t)(l - 1) * lsz;",
     "const bf16* src = !RECOMPUTE ? x + (size_t)l * lsz : MODE == MODE_ENC ? xr + (size_t)l * lsz "
     ": l == 0 ? x : xr + (size_t)(l - 1) * lsz;"),
    ("""      if (MODE == MODE_ENC && l == 0) {
        add_pe(X, tile);""",
     """      if (false) {
        add_pe(X, tile);"""),
]


def build_stored(lib_mod) -> ctypes.CDLL:
    """The stored variant's library: the checkout's csrc/ copied, edited and
    compiled (fused_encoder_bwd.cu alone) under _build/b7_layer0/."""
    out = lib_mod.BUILD_DIR / "b7_layer0"
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(lib_mod.CSRC, out)
    src = out / "fused_encoder_bwd.cu"
    text = src.read_text()
    for old, new in _EDITS:
        if text.count(old) != 1:
            raise RuntimeError(f"the source no longer holds: {old[:60]!r}")
        text = text.replace(old, new)
    src.write_text(text)
    so = out / "libb7_layer0.so"
    subprocess.run([lib_mod._nvcc(), *lib_mod.NVCC_FLAGS, "-shared", str(src), "-o", str(so)],
                   check=True)
    lib = ctypes.CDLL(str(so))
    lib.tt_fused_history_encoder_bwd_recompute_tc.argtypes = \
        lib_mod._SIGNATURES["tt_fused_history_encoder_bwd_recompute_tc"]
    return lib


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--iters", type=int, default=50)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    from two_tower_models_tpu_torch.ops import _lib
    from two_tower_models_tpu_torch.ops import fused_encoder as fe

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    dev = torch.device("cuda")
    b, h, d, nh, nl = 4096, 32, 64, 4, 3
    r = np.random.default_rng(0)
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(dev)  # noqa: E731
    lim_in, lim_out = np.sqrt(6.0 / (4 * d)), np.sqrt(6.0 / (2 * d))
    x = t(r.normal(size=(b, h, d))).to(torch.bfloat16)
    pe = t(r.normal(size=(h, d)) * 0.5)
    w = [t(r.uniform(-lim_in, lim_in, (nl, d, 3 * d))), t(r.uniform(-0.1, 0.1, (nl, 3 * d))),
         t(r.uniform(-lim_out, lim_out, (nl, d, d))), t(r.uniform(-0.1, 0.1, (nl, d)))]
    g = t(r.normal(size=(b, 2, d)) * 0.1).to(torch.bfloat16)
    inputs = fe._recompute_bwd_inputs(g, x, fe._pe(pe, x), *w, nh, enc=True)
    ept, _, _, grid = fe._enc_bwd_tc_plan(b, h, d, nl, _lib.sm_count(dev.index))
    n_ws = sum(int(np.prod(s)) for s in fe._grad_shapes(h, d, nl, True))
    variants = {"recompute": (_lib.library(), nl - 1), "stored": (build_stored(_lib), nl)}
    outs = {}
    for name, (lib, layers) in variants.items():
        dx = torch.empty_like(x)
        xr = torch.empty((layers, b, h, d), dtype=x.dtype, device=dev)
        dy = torch.empty((b, h, d), dtype=torch.float32, device=dev)
        ws = torch.empty((grid, n_ws), dtype=torch.float32, device=dev)
        ptrs = [p.data_ptr() for p in inputs]
        call = lambda lib=lib, dx=dx, xr=xr, dy=dy, ws=ws: _lib.check(  # noqa: E731
            lib.tt_fused_history_encoder_bwd_recompute_tc(
                *ptrs, dx.data_ptr(), xr.data_ptr(), dy.data_ptr(), ws.data_ptr(), b, h, d, nh,
                nl, ept, grid, _lib.stream_ptr(x)), name)
        call()
        torch.cuda.synchronize()
        outs[name] = (call, dx, ws)
    same = all(torch.equal(a, e) for a, e in zip(outs["recompute"][1:], outs["stored"][1:]))

    def events_ms(fn) -> float:
        fn()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(args.iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / args.iters

    order = ["recompute", "stored", "stored", "recompute"]
    times = {k: [] for k in variants}
    for name in order:
        times[name].append(events_ms(outs[name][0]))
    print(smi, flush=True)
    print(json.dumps({"device": torch.cuda.get_device_name(0), "smi": smi, "shape": [b, h, d, nh, nl],
                      "bit_equal": same, "order": order, "ms": times,
                      "scratch_bytes": {k: v[1] * b * h * d * 2 for k, v in variants.items()}}),
          flush=True)
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
