"""Times of the top-k select (B3) and the lazy-Adam write-back (B19) of the
PyTorch port, for the checkout it is run from, so that one copy of this
script compares two commits on the same card:

    python3 scripts/torch_select_write_times.py
    (cd ../other_checkout && python3 /abs/path/scripts/torch_select_write_times.py)

B3 at the serving batch's two passes (chip_smoke.py phase 2's shapes, data
from a seed): pass 2 over the tile maxes [1024, 8192] of a 2^20-row D = 64
corpus of normal rows and normal queries, pass 4 over the 12,800
candidates of each query, k = 100.  For ``select_rows`` and for
``torch.topk`` (no tie order) at each pass: ``ms``, CUDA events over 20
calls back to back (the host's dispatch included), and ``device_ms``, the
device time of every kernel of one call from torch.profiler (mean of 20).

B19 at the 4M-lazy step's write-back (chip_smoke.py phase 5's shape): two
packed [2^21, 128] f32 tables with their Adam moments, the sorted logical
ids of a B = 4096 batch (user: 4096 ids; item: 4096 x 32 history ids and
4096 item ids) uniform over 2^22 rows, merged by ``lane_block_plan`` and
``merge_rows``.  The write-back as this checkout's lazy step makes it
(``rows_write_many`` once a table where it exists, else ``rows_write``
once an array), and ``index_copy_`` of the blended live rows (2/3 of
B19's bytes, no blend): ``ms`` and ``device_ms`` as above.  Each result
is first checked exactly against ``rows_write_reference``.

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


def device_ms(fn, iters: int = ITERS) -> float:
    """Mean device time of one call: every kernel and copy it launches,
    from torch.profiler."""
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


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    from two_tower_models_tpu_torch.ops import _lib
    from two_tower_models_tpu_torch.ops import mips_topk as mt
    from two_tower_models_tpu_torch.ops import rows_write as rw

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    torch.set_grad_enabled(False)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    out = {"device": torch.cuda.get_device_name(0), "smi": smi}

    # -- B3: the two passes of one serving batch --
    b, c, d, k = 1024, 1 << 20, 64, 100
    corpus = torch.randn(c, d, generator=gen, device=dev)
    q = torch.randn(b, d, generator=gen, device=dev)
    m = mt.tile_max_scores(q, corpus, mt.TILE, c)
    _, tiles = mt.select_rows(m, k)
    cand = mt.gather_rescore(q, corpus, torch.sort(tiles, dim=1).values, mt.TILE)
    del corpus
    sel = {}
    for name, x in (("pass2", m), ("pass4", cand)):
        keys = mt.f32_keys(x).clamp_min(-(1 << 31) + 1)
        got, want = mt.select_rows(x, k), mt.select_keys_plain(keys, k)
        _lib.reset_launch_counts()
        mt.select_rows(x, k)
        sel[name] = {
            "shape": list(x.shape), "exact": all(map(torch.equal, got, want)),
            "launches": dict(_lib.launches),
            "ms": events_ms(lambda: mt.select_rows(x, k)),
            "device_ms": device_ms(lambda: mt.select_rows(x, k)),
            "topk_ms": events_ms(lambda: torch.topk(x, k)),
            "topk_device_ms": device_ms(lambda: torch.topk(x, k)),
        }
    out["select"] = sel
    del m, cand

    # -- B19: the 4M-lazy write-back --
    rows, pack, bt, h = 1 << 22, 2, 4096, 32
    dl = 128 // pack
    tables = []
    for n in (bt, bt * h + bt):  # user, item
        ids = torch.sort(torch.randint(0, rows, (n,), generator=gen, device=dev)).values
        dup = torch.cat([torch.zeros(1, dtype=torch.bool, device=dev), ids[1:] == ids[:-1]])
        plan = rw.lane_block_plan(ids, dup, pack)
        dsts = [torch.randn(rows // pack, 128, generator=gen, device=dev) for _ in range(3)]
        vals = [rw.merge_rows(plan, ids, torch.randn(n, dl, generator=gen, device=dev))
                for _ in range(3)]
        tables.append((dsts, plan[0], plan[1], vals))
    many = hasattr(rw, "rows_write_many")

    def write_back():
        for dsts, pids, bits, vals in tables:
            if many:
                rw.rows_write_many(dsts, pids, bits, vals, dl)
            else:
                for dst, v in zip(dsts, vals):
                    rw.rows_write(dst, pids, bits, v, dl)

    exact = True
    for dsts, pids, bits, vals in tables:
        want = [rw.rows_write_reference(a.clone(), pids, bits, v, dl) for a, v in zip(dsts, vals)]
        if many:
            got = rw.rows_write_many([a.clone() for a in dsts], pids, bits, vals, dl)
        else:
            got = [rw.rows_write(a.clone(), pids, bits, v, dl) for a, v in zip(dsts, vals)]
        exact &= all(map(torch.equal, got, want))
    lib_args, n_live = [], 0
    for dsts, pids, bits, vals in tables:
        live = (bits != 0).nonzero()[:, 0]
        mask = ((bits[live][:, None] >> (torch.arange(128, device=dev) // dl)) & 1).float()
        n_live += live.numel()
        for dst, v in zip(dsts, vals):
            lib_args.append((dst, pids[live], dst[pids[live]] * (1 - mask) + v[live] * mask))
    _lib.reset_launch_counts()
    write_back()
    out["write_back"] = {
        "route": "rows_write_many" if many else "rows_write x3", "exact": exact,
        "live_slots_a_table_array": n_live, "launches": dict(_lib.launches),
        "ms": events_ms(write_back), "device_ms": device_ms(write_back),
        "index_copy_ms": events_ms(lambda: [a.index_copy_(0, i, v) for a, i, v in lib_args]),
        "index_copy_device_ms": device_ms(lambda: [a.index_copy_(0, i, v) for a, i, v in lib_args]),
        "bound_ms": (3 * 3 * n_live * 128 * 4 + sum(t[1].numel() * 12 for t in tables)) / 3.35e12 * 1e3,
    }
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
