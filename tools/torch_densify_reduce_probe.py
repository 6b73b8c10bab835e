"""Where kernels 7 and 7L (densify-reduce) spend their time on the GPU.

    python tools/torch_densify_reduce_probe.py

Builds the committed body (muscle_tpu_torch/csrc/densify_reduce.cuh) and
a few variants of it, each made by one textual edit of the header into
build/densify_reduce_probe/, and times each (CUDA events around 20
launches, median of 5) beside one torch.index_add of the same slots:

* on phase 2's n = 200 refine half of chip_smoke.py (100 x 100 grid,
  L 512, k2 24, cc 768, a random store of 1-8 valid slots a row);
* on the main path's own launches, captured while `super5` aligns
  chip_smoke.py's synthetic-1000 (the first two kernel-7 launches of
  each Super4 cluster's device refine, all of PProg's kernel-7L joins)
  and while `align` aligns its synthetic n = 200 family (the first two
  kernel-7 launches of the device refine), each kind summed.

Variants: "committed"; diagnostics that change the result ("no walk":
the tile's zero fill and F's write alone; "store in L2": every entry
reads the first entry's store row, so the store's rows come from L2;
"no bank gather": the slot's position taken as its column); and design
alternatives, each required equal to the plain version ("8 lanes": 4
rows a warp, one 32-byte sector a step; "16 ahead": 16 entries' loads
in flight; "values behind slots": a value loaded only behind a valid
slot, one round trip later; "lockstep": the block's warps take each
group of entries together, a block barrier a group; "16 warps": blocks
of up to 16 warps, so up to 32 tile rows). Prints ptxas's registers and
spills of each. Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import ctypes
import os
import re
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

FIRST_STEP = """          pos[u] = __ldg(a.cols + o);
          v[u] = __ldg(a.vals + o);"""
BANK = """          col[u] = __ldg(a.bank + (size_t)et[b + u] * a.L + pos[u]) - c0;"""
LOCKSTEP = ("for (int b = 0; warp_ok && b < n; b += kAhead) {",
            "for (int b = 0; b < n; b += kAhead) {\n"
            "      __syncthreads();\n      if (!warp_ok) continue;")
WIDE = ("constexpr int kMaxThreads = 256;", "constexpr int kMaxThreads = 512;")
# variant: (edits, equal to the plain version, rows a warp, most warps)
VARIANTS = {
    "committed": ([], True, 2, 8),
    "no walk": ([("for (int b = 0; warp_ok && b < n; b += kAhead) {",
                  "for (int b = 0; warp_ok && b < 0; b += kAhead) {")],
                False, 2, 8),
    "store in L2": ([("const size_t o = ep[b + u] * stride + row_off + k;",
                      "const size_t o = ep[0] * stride + row_off + k;")],
                    False, 2, 8),
    "no bank gather": ([(BANK, "          col[u] = pos[u] - c0;")], False, 2,
                       8),
    "8 lanes": ([("constexpr int kLanes = 16;", "constexpr int kLanes = 8;"),
                 ("0xffffu << (lane & ~(kLanes - 1))",
                  "0xffu << (lane & ~(kLanes - 1))")], True, 4, 8),
    "16 ahead": ([("constexpr int kAhead = 8;", "constexpr int kAhead = 16;")],
                 True, 2, 8),
    "values behind slots": ([(FIRST_STEP, """          pos[u] = __ldg(a.cols + o);
          vp[u] = a.vals + o;"""),
                             ("      float v[kAhead];",
                              "      float v[kAhead];\n"
                              "      const float* vp[kAhead];"),
                             ("        if (pos[u] >= 0 && pos[u] < a.L)\n"
                              + BANK, "        if (pos[u] >= 0 && pos[u] < a.L) {\n"
                              + BANK + "\n          v[u] = __ldg(vp[u]);\n"
                              "        }")], True, 2, 8),
    "lockstep": ([LOCKSTEP], True, 2, 8),
    "16 warps": ([WIDE], True, 2, 16),
    "16 warps lockstep": ([WIDE, LOCKSTEP], True, 2, 16),
}
ENTRIES = ("densify_reduce", "densify_reduce_list")


def build_variants():
    """{(variant, entry): C function}, printing each build's ptxas line."""
    from muscle_tpu_torch.utils.build import CUDA_FLAGS, nvcc
    csrc = os.path.join(ROOT, "muscle_tpu_torch", "csrc")
    with open(os.path.join(csrc, "densify_reduce.cuh")) as fh:
        header = fh.read()
    procs = []
    for i, (name, (edits, _, _, _)) in enumerate(VARIANTS.items()):
        text = header
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"variant {name!r}: its edit no longer "
                                   "applies to densify_reduce.cuh")
            text = text.replace(old, new)
        d = os.path.join(ROOT, "build", "densify_reduce_probe", str(i))
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, "densify_reduce.cuh"), "w") as fh:
            fh.write(text)
        for entry in ENTRIES:
            with open(os.path.join(csrc, f"{entry}.cu")) as fh, \
                    open(os.path.join(d, f"{entry}.cu"), "w") as out:
                out.write(fh.read())
            lib = os.path.join(d, f"lib{entry}.so")
            procs.append((name, entry, lib, subprocess.Popen(
                [nvcc(), *CUDA_FLAGS, "-o", lib, os.path.join(d, f"{entry}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fns = {}
    for name, entry, lib, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{name} {entry}: nvcc failed\n{log}")
        regs = re.findall(r"Used (\d+) registers", log)
        spill = re.findall(r"(\d+) bytes spill stores", log)
        print(f"ptxas {name} / {entry}: {regs[0]} registers, spill stores "
              f"{spill[0] if spill else 0} B", flush=True)
        fn = getattr(ctypes.CDLL(lib), entry)
        fn.restype = ci
        fn.argtypes = ([vp, vp] + [ci] * 4 + [vp] + [ci] * 2 + [vp] + [ci] * 4
                       + [vp, vp] if entry == "densify_reduce" else
                       [vp, vp] + [ci] * 4 + [vp, ci] + [vp] * 3 + [ci] * 5
                       + [vp, vp])
        fns[(name, entry)] = fn
    return fns


def time_batched(fn, per: int = 20, reps: int = 5) -> float:
    """Median ms of one call, over `reps` runs of `per` calls between two
    CUDA events, after one warm-up."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(per):
            fn()
        e.record()
        torch.cuda.synchronize()
        times.append(s.elapsed_time(e) / per)
    return statistics.median(times)


def variant_call(fn, rows_per_warp, max_warps, args, out):
    """A launch of one variant's C entry on kernel-7 (7 args) or kernel-7L
    (9 args) inputs, with _geometry's rule at that variant's rows a warp
    and most warps a block."""
    import torch
    from muscle_tpu_torch.ops import devjoin_cuda as djc
    cc = args[-1]
    warps = max(1, min(max_warps,
                       djc._DR_TILE_AIM // (4 * rows_per_warp * cc)))
    tr = rows_per_warp * warps
    room = djc._DR_TILE_AIM // 4 - 8
    tc = cc if tr * cc <= room else room // tr // 4 * 4
    st = torch.cuda.current_stream().cuda_stream
    vals, cols, k2 = args[:3]
    head = (vals.data_ptr(), cols.data_ptr(), *vals.shape, k2)
    if len(args) == 7:
        _, _, _, pid, bank, dump, _ = args
        tail = (pid.data_ptr(), *pid.shape, bank.data_ptr(), dump, cc)
    else:
        _, _, _, rp, pid, co, bank, dump, _ = args
        tail = (rp.data_ptr(), rp.numel() - 1, pid.data_ptr(), co.data_ptr(),
                bank.data_ptr(), bank.shape[0], dump, cc)

    def go():
        rc = fn(*head, *tail, tr, tc, out.data_ptr(), st)
        if rc:
            raise RuntimeError(f"launch failed: {rc}")
    return go


def index_add_call(args):
    """One torch.index_add of the launch's valid slots at their flat
    (owner, l, col) indices onto a zero F (chip_smoke.py's yardstick)."""
    import torch
    vals, cols, k2 = args[:3]
    dev, l, cc = vals.device, vals.shape[1], args[-1]
    if len(args) == 7:
        _, _, _, pid, bank, dump, _ = args
        n_o = pid.shape[0]
        own, t = torch.nonzero(pid != dump, as_tuple=True)
        p = pid[own, t].long()
    else:
        _, _, _, rp, pid, co, bank, dump, _ = args
        n_o = rp.numel() - 1
        own = torch.repeat_interleave(torch.arange(n_o, device=dev),
                                      (rp[1:] - rp[:-1]).long())
        p, t = pid[int(rp[0]):int(rp[-1])].long(), co[int(rp[0]):int(rp[-1])].long()
    c = cols[p, :, :k2].long()
    col = bank.long()[t[:, None, None], c.clamp(min=0)]
    ok = (c >= 0) & (col >= 0) & (col < cc) & (p != dump)[:, None, None]
    flat = ((own[:, None, None] * l + torch.arange(l, device=dev)[:, None])
            * cc + col)[ok]
    vsel = vals[p, :, :k2][ok]
    f = torch.zeros(n_o * l * cc, device=dev)
    return lambda: torch.index_add(f, 0, flat, vsel)


def measure(label, launches, fns):
    """Time the committed wrapper, index_add and every variant on each
    launch of `launches` (one kind); print the sums."""
    import torch
    from muscle_tpu_torch.ops import devjoin_cuda as djc
    entry = "densify_reduce" if len(launches[0]) == 7 else "densify_reduce_list"
    wrapper = getattr(djc, entry)
    plain = getattr(djc, entry + "_plain")
    sums = {}
    for args in launches:
        want = plain(*args)
        row = {"wrapper": time_batched(lambda: wrapper(*args)),
               "index_add": time_batched(index_add_call(args))}
        for name, (_, exact, rpw, most) in VARIANTS.items():
            out = torch.empty_like(want)
            go = variant_call(fns[(name, entry)], rpw, most, args, out)
            go()
            torch.cuda.synchronize()
            if exact and not torch.equal(out, want):
                raise RuntimeError(f"variant {name!r} differs from the plain "
                                   f"version on {label}")
            row[name] = time_batched(go)
        for k, v in row.items():
            sums[k] = sums.get(k, 0.0) + v
    print(f"{label} ({len(launches)} launches, ms summed): "
          + ", ".join(f"{k} {v:.4f}" for k, v in sums.items()), flush=True)


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from muscle_tpu_torch import align, super5
    from muscle_tpu_torch.ops import consistency as cons
    from muscle_tpu_torch.pipeline import devjoin
    from muscle_tpu_torch.pipeline.posteriors import store_rows
    from muscle_tpu_torch.utils.build import build_all

    print(cs.card_line(), flush=True)
    build_all()
    fns = build_variants()
    dev = torch.device("cuda")

    # phase 2's n = 200 half
    n, l, k, cc = 200, 512, 24, 768
    p1 = store_rows(n * (n - 1) // 2)
    vals, cols = cs.synthetic_store(dev, p1, l, k, seed=200)
    rng = np.random.default_rng(7)
    order = rng.permutation(n)
    rows, cols_of = np.sort(order[:100]), np.sort(order[100:])
    pm = np.full((n, n), p1 - 1, np.int32)
    for x in range(n):
        for y in range(x + 1, n):
            pm[x, y] = cons.pair_index(x, y, n)
    pid = torch.as_tensor(pm[np.ix_(rows, cols_of)], device=dev)
    bank = torch.as_tensor(np.stack([np.sort(rng.choice(cc, l, replace=False))
                                     for _ in cols_of]).astype(np.int32),
                           device=dev)
    measure("n = 200 refine half, random store",
            [(vals, cols, k, pid, bank, p1 - 1, cc)], fns)
    del vals, cols
    torch.cuda.empty_cache()

    # the main path's own launches, captured (cloned) while super5 runs
    grid, lists, left = [], [], [0]
    g_fn, l_fn = devjoin.densify_reduce, devjoin.densify_reduce_list
    init = devjoin.DeviceJoiner.__init__

    def keep(args):
        return tuple(a.clone() if torch.is_tensor(a) else a for a in args)

    def cap_grid(*args):
        if left[0] > 0:
            left[0] -= 1
            grid.append(keep(args))
        return g_fn(*args)

    def cap_list(*args):
        lists.append(keep(args))
        return l_fn(*args)

    def held_init(joiner, *args, **kwargs):
        left[0] = 2
        init(joiner, *args, **kwargs)
    devjoin.densify_reduce, devjoin.densify_reduce_list = cap_grid, cap_list
    devjoin.DeviceJoiner.__init__ = held_init
    try:
        super5(cs.super5_set(), device=dev)
    finally:
        devjoin.densify_reduce, devjoin.densify_reduce_list = g_fn, l_fn
        devjoin.DeviceJoiner.__init__ = init
    measure("synthetic-1000's Super4 refines, kernel 7", grid, fns)
    del grid[:]
    devjoin.densify_reduce = cap_grid
    devjoin.DeviceJoiner.__init__ = held_init
    try:
        align(cs.synthetic_family(200, 400, 512, seed=200), device=dev)
    finally:
        devjoin.densify_reduce = g_fn
        devjoin.DeviceJoiner.__init__ = init
    measure("synthetic n = 200's device refine, kernel 7", grid, fns)
    measure("synthetic-1000's PProg joins, kernel 7L", lists, fns)
    return 0


if __name__ == "__main__":
    sys.exit(main())
