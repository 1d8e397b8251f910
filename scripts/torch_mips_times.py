"""Times of the exact-MIPS kernels B2 (tile max) and B4 (gather-rescore) of
the PyTorch port, for the checkout it is run from, so that one copy of this
script compares two commits on the same card:

    python3 scripts/torch_mips_times.py
    (cd ../other_checkout && python3 /abs/path/scripts/torch_mips_times.py)

At the serving cell's shape (chip_smoke.py phase 2's: B = 1024 normal
queries, a 2^20-row D = 64 corpus of normal rows, ``valid`` inside the last
tile, k = 100; data from a numpy seed): ``tile_max_scores``;
``gather_rescore`` on the tiles the pipeline selects from B2's output
(sorted, as ``mips_topk_exact_tiled`` passes them) and on a skewed
selection (every query on the same 100 tiles); and the whole exact MIPS
(``mips_topk_exact_tiled``: B2, two selects, B4).  For each: ``ms``, CUDA
events over 20 calls back to back (the host's dispatch included),
``device_ms``, the device time of every kernel and memset of one call from
torch.profiler (mean of 20), and ``kernels``, that device time by kernel
name.

Prints the card's name and power limit, then one JSON line.  Needs a GPU.
"""

import json
import os
import subprocess
import sys

import numpy as np

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
    """Mean device time of one call (every kernel and memset it launches,
    from torch.profiler) and its split by kernel name."""
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


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    from two_tower_models_tpu_torch.ops import mips_topk as mt

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    torch.set_grad_enabled(False)
    dev = torch.device("cuda")
    b, c, d, k = 1024, 1 << 20, 64, 100
    r = np.random.default_rng(0)
    q = torch.from_numpy(r.normal(size=(b, d)).astype(np.float32)).to(dev)
    corpus = torch.from_numpy(r.normal(size=(c, d)).astype(np.float32)).to(dev)
    valid = c - 77
    m = mt.tile_max_scores(q, corpus, mt.TILE, valid)
    tiles = torch.sort(mt.select_rows(m, k)[1], dim=1).values
    skew = torch.from_numpy(np.sort(r.choice(c // mt.TILE, k, replace=False)).astype(np.int32))
    skew = skew.to(dev)[None, :].expand(b, k).contiguous()
    legs = {
        "tile_max": lambda: mt.tile_max_scores(q, corpus, mt.TILE, valid),
        "gather_rescore": lambda: mt.gather_rescore(q, corpus, tiles, mt.TILE),
        "gather_rescore_skewed": lambda: mt.gather_rescore(q, corpus, skew, mt.TILE),
        "exact_mips": lambda: mt.mips_topk_exact_tiled(corpus, q, k, valid_count=valid),
    }
    out = {"checkout": os.getcwd(), "distinct_tiles": int(torch.unique(tiles).numel())}
    for name, fn in legs.items():
        ms = events_ms(fn)
        dms, kernels = device_times(fn)
        out[name] = {"ms": ms, "device_ms": dms, "kernels": kernels}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
