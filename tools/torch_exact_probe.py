#!/usr/bin/env python3
"""Probe of the reference-order kernels (pairhmm_fwd_exact,
pairhmm_bwd_exact; csrc/pairhmm_exact.cu) on the card, under
MUSCLE_TPU_EXACT_ASSOC=1 (set here before the port is imported).

    python tools/torch_exact_probe.py [--time] [--families] [--sass FILE]
        [--grid [--parent DIR]] [--lone [--diagnose]]
        [--variants]

Always: build the kernels, print ptxas's registers and spills, hold each
kernel to its plain version on chip_smoke.exact_kernel_checks' inputs
(max |d| = 0 required).
--time:     chip_smoke.exact_kernel_times: both kernels at 512 ragged
            amino pairs at 512 x 512 (CUDA events, steady), their plain
            versions, bounds and floor, and kernels A / B at the same
            shape in the same process.
--families: every in-repo family under the flag on the card, its
            column-identity to its golden and Q printed (chip_smoke.py's
            phase_exact requires identity).
--sass:     cuobjdump -sass of the built library into FILE; per kernel
            instance its instruction count and its f64 and 64-bit
            conversion instructions (DADD, DMUL, DFMA, DSETP, DMNMX, F2F
            / I2F / F2I with an F64 operand), which must be none.
--grid:     both kernels timed at GRID (512 ragged amino pairs at 512^2,
            64 at 2048^2, one 8300 x 2000 pair, 8 mega-128 lattice pairs
            at 384, 8 seeded lattice pairs of mega-long's lengths at
            mega-long's chunk, 12288^2): steady (20 launches first, 5
            between the events, median of 5) where a launch is short,
            else one launch first and the median of 3. With --parent
            DIR also the kernels of the package unpacked in DIR (its
            csrc/pairhmm_exact.cu and headers, built into
            build/muscle_tpu_torch/parent_exact; the C interface as at
            2b9aecc: T threads a block, a (B, 2, 5, Ly + 1) link), in
            turns (parent, this, this, parent), each parent output
            required equal bit for bit to this build's on the real
            cells.
--lone:     one pair of 8192 columns and 32, 128, 160 or 512 rows (one
            band alone; 4 bands handing rows on in shared memory; 5, the
            last through device memory; 16): ns a band step, the
            launch's time over its ly + 32 + 40 (bands - 1) steps (each
            band ~40 steps behind the one above); with --diagnose also
            copies that leave one part of a step out (DIAGNOSTICS, timed
            only: their outputs are wrong).
--variants: copies of the kernels' source with other constants or code
            (VARIANTS: what was tried and measured slower), built beside
            this build and timed in turns with it in --grid (each output
            required equal to this build's) and in --lone.
Prints the card (nvidia-smi name and power limit) first; exits non-zero
without a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import re
import shutil
import statistics
import subprocess
import sys

os.environ["MUSCLE_TPU_EXACT_ASSOC"] = "1"
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402

import chip_smoke as cs  # noqa: E402

# copies of csrc/pairhmm_exact.cu with other constants (text replacements)
VARIANTS = {
    # a wait on the band above spins instead of napping
    "spin": {"      __nanosleep(mw::SLEEP_NS);\n      if (lane < n) {":
             "      if (lane < n) {"},
    "runs-of-4": {"constexpr int HC = 8;": "constexpr int HC = 4;"},
    # the cubic's coefficients chosen by selects on constants, not read
    # from the shared-memory table
    "select-cubic": {"  const float4 c = cubic[cubic_row(d)];": (
        "  const bool s1 = d <= 1.0f, s2 = d <= 2.5f, s3 = d <= 4.5f;\n"
        "  const float4 k0 = make_float4(CUBIC0), k1 = make_float4(CUBIC1),\n"
        "               k2 = make_float4(CUBIC2), k3 = make_float4(CUBIC3);\n"
        "  const float4 c = make_float4(\n"
        "      s2 ? (s1 ? k0.x : k1.x) : (s3 ? k2.x : k3.x),\n"
        "      s2 ? (s1 ? k0.y : k1.y) : (s3 ? k2.y : k3.y),\n"
        "      s2 ? (s1 ? k0.z : k1.z) : (s3 ? k2.z : k3.z),\n"
        "      s2 ? (s1 ? k0.w : k1.w) : (s3 ? k2.w : k3.w));")},
    # all four segments' cubics evaluated (coefficients as constants) and
    # the segment's result selected: no load on a LOG_ADD's chain, ~11
    # more instructions a LOG_ADD
    "speculative-cubic": {
        "  const float4 c = cubic[cubic_row(d)];\n"
        "  const float r =\n"
        "      __fmaf_rn(__fmaf_rn(__fmaf_rn(c.x, d, c.y), d, c.z), d, c.w);": (
            "  const float4 k0 = make_float4(CUBIC0), k1 = make_float4(CUBIC1),\n"
            "               k2 = make_float4(CUBIC2), k3 = make_float4(CUBIC3);\n"
            "  auto horner = [&](float4 k) {\n"
            "    return __fmaf_rn(__fmaf_rn(__fmaf_rn(k.x, d, k.y), d, k.z), d,\n"
            "                     k.w);\n"
            "  };\n"
            "  const float q0 = horner(k0), q1 = horner(k1), q2 = horner(k2),\n"
            "              q3 = horner(k3);\n"
            "  const float r = d <= 2.5f ? (d <= 1.0f ? q0 : q1)\n"
            "                            : (d <= 4.5f ? q2 : q3);")},
    # no shared-memory floor (5 blocks an SM), or room for 4
    "no-smem-floor": {"constexpr size_t SMEM_FLOOR = 58 * 1024;":
                      "constexpr size_t SMEM_FLOOR = 0;"},
    "4-blocks": {"constexpr size_t SMEM_FLOOR = 58 * 1024;":
                 "constexpr size_t SMEM_FLOOR = 45 * 1024;"},
    # tickets in pair-major order (the rounds of a pair one after
    # another): a round's block comes right after the round above's
    "pair-major": {
        "  const int b = t % B;": (
            "  const int R_ = ((Lx + 31) / 32 + (int)(blockDim.x >> 5) - 1) /\n"
            "                 (int)(blockDim.x >> 5);\n"
            "  const int b = t / R_;"),
        "if (!bd.init(smem, t, B, Ly,": "if (!bd.init(smem, t, R_, Ly,",
        "    r = t / B;": "    r = t % B;",
        "lin = links + (link_in ? (size_t)(t - B) * row : 0);":
        "lin = links + (link_in ? (size_t)(t - 1) * row : 0);"},
}

# Diagnostic copies (`--lone --diagnose`: timed only, their outputs are
# wrong): each leaves one part of a step out
DIAGNOSTICS = {
    "no-shuffles": {
        "const float a = __shfl_up_sync(FULL, lf[k], 1);":
        "const float a = lf[k];",
        "const float a = __shfl_up_sync(FULL, cur[k], 1);":
        "const float a = cur[k];",
        "__uint_as_float(__shfl_sync(FULL, (unsigned)hcol[k], kk))":
        "__uint_as_float((unsigned)hcol[k])"},
    "no-emission-loads": {"const int tg = src.tag(jc);":
                          "const int tg = jc & 15;",
                          "const int tg = src.tag(yc);":
                          "const int tg = yc & 15;"},
    "no-cubic-loads": {"  const float4 c = cubic[cubic_row(d)];":
                       "  const float4 c = cubic[0];"},
    "no-stores": {"tile[lane * MC + ((j - 1) & (MC - 1))] = c[SM];": "",
                  "tile[lane * MC + (v & (MC - 1))] = c[BM];": "",
                  "    if (p && ring_out) {": "    if (false) {",
                  "    if (p && link_out) {": "    if (false) {"},
}
# f64 arithmetic and conversions to or from 64-bit types in SASS
F64_OPS = re.compile(r"\b(DADD|DMUL|DFMA|DSETP|DMNMX|DMMA|(?:F2F|I2F|F2I)"
                     r"[.\w]*64[.\w]*)\b")


def sass(lib_path, out_path):
    """Per kernel instance (name, instructions, f64 / 64-bit conversion
    instructions) of the library's SASS, which goes to out_path."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "-sass", lib_path], capture_output=True,
                          text=True, check=True).stdout
    with open(out_path, "w") as f:
        f.write(text)
    rows, name, n, f64 = [], None, 0, 0
    for line in text.splitlines() + ["Function : <end>"]:
        m = re.search(r"Function : (\S+)", line)
        if m:
            if name:
                rows.append((name, n, f64))
            name, n, f64 = m.group(1), 0, 0
        elif re.match(r"\s+/\*[0-9a-f]{4,}\*/\s+\S", line):
            n += 1
            f64 += bool(F64_OPS.search(line))
    return rows


def built(tag, csrc, edits):
    """This build's pairhmm_exact library from the sources in `csrc`
    (copied, pairhmm_exact.cu with text replacements `edits`) into
    build/muscle_tpu_torch/<tag>: a ctypes CDLL."""
    from muscle_tpu_torch.utils.build import CUDA_FLAGS, build_dir, nvcc
    out = os.path.join(build_dir(), tag)
    os.makedirs(out, exist_ok=True)
    for f in os.listdir(csrc):
        if f.endswith((".cuh", ".cu")):
            shutil.copy(os.path.join(csrc, f), out)
    path = os.path.join(out, "pairhmm_exact.cu")
    with open(path) as f:
        text = f.read()
    for a, b in edits.items():
        if a not in text:
            raise RuntimeError(f"{tag}: {a!r} not in pairhmm_exact.cu")
        text = text.replace(a, b)
    with open(path, "w") as f:
        f.write(text)
    so = os.path.join(out, "libpairhmm_exact.so")
    r = subprocess.run([nvcc(), *CUDA_FLAGS, "-o", so, path],
                       capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError(f"{tag}: {r.stdout}{r.stderr}")
    for line in (r.stdout + r.stderr).splitlines():
        if "registers" in line or "spill" in line:
            print(f"{tag} ptxas: {line.strip()}", flush=True)
    return ctypes.CDLL(so)


def parent_runner(parent_dir):
    """(fwd, bwd) of the parent's build: f(src, lxb, lyb, params) ->
    (lattice, ends) through its C interface (T = min(512, Lx rounded up
    to 32) threads a block, link (B, 2, 5, Ly + 1))."""
    import torch
    from muscle_tpu_torch.ops import pairhmm_exact_cuda as pec
    lib = built("parent_exact", os.path.join(parent_dir, "muscle_tpu_torch",
                                             "csrc"), {})
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fns = {}
    for name in pec.LAUNCHES:
        fn = getattr(lib, name)
        fn.restype = ci
        fn.argtypes = ([ci] + [vp] * 4 + [ci] * 2 + [vp] * 6 + [ci] * 5
                       + [vp] * 4)
        fns[name] = fn

    def runner(name):
        def run(src, lxb, lyb, params):
            b, lx, ly = pec._check(src, lxb, lyb, params)
            dev = lxb.device
            lat = torch.empty((b, lx, ly), device=dev)
            ends = torch.empty((b, 5), device=dev)
            link = torch.empty((b, 2, 5, ly + 1), device=dev)
            rc = fns[name](*_source(src), pec._ptr(lxb), pec._ptr(lyb),
                           pec._ptr(params), int(params.dim() == 2), b, lx,
                           ly, min(512, -(-lx // 32) * 32), pec._ptr(link),
                           pec._ptr(lat), pec._ptr(ends), pec._stream(lxb))
            if rc:
                raise RuntimeError(f"parent {name}: error {rc}")
            return lat, ends
        return run
    return runner("pairhmm_fwd_exact"), runner("pairhmm_bwd_exact")


def variant_runner(tag, edits):
    """(fwd, bwd) of a copy of this build with `edits`, called through
    the module's wrapper (the same C interface)."""
    from muscle_tpu_torch.ops import pairhmm_exact_cuda as pec
    lib = built(tag, os.path.join(ROOT, "muscle_tpu_torch", "csrc"), edits)
    for name in pec.LAUNCHES:
        getattr(lib, name).restype = getattr(pec._lib(), name).restype
        getattr(lib, name).argtypes = getattr(pec._lib(), name).argtypes
    lib.pairhmm_error_string.restype = ctypes.c_char_p

    def runner(name):
        def run(src, lxb, lyb, params):
            saved = pec._lib_cache["lib"]
            pec._lib_cache["lib"] = lib
            try:
                return getattr(pec, name)(src, lxb, lyb, params)
            finally:
                pec._lib_cache["lib"] = saved
        return run
    return runner("pairhmm_fwd_exact"), runner("pairhmm_bwd_exact")


def _source(src):
    from muscle_tpu_torch.ops import pairhmm_exact_cuda as pec
    null = ctypes.c_void_p(0)
    if isinstance(src, pec.Letters):
        return (0, pec._ptr(src.xb), pec._ptr(src.yb), pec._ptr(src.match),
                pec._ptr(src.insert), src.insert.shape[-1],
                int(src.match.dim() == 3), null, null, null)
    return (1, null, null, null, null, 0, 0, pec._ptr(src.e),
            pec._ptr(src.ins_x), pec._ptr(src.ins_y))


def grid_cases(dev):
    """[(label, src, lxb, lyb, params, long)] of GRID on the card."""
    import torch
    from muscle_tpu_torch.hmm.params import HMMParams
    from muscle_tpu_torch.ops import pairhmm_cuda as pc
    from muscle_tpu_torch.ops import pairhmm_exact_cuda as pec
    match, insert, params = pc.tables(
        HMMParams.from_defaults(nucleo=False).to_scores(), dev)
    out = []

    def letters(label, arrays, long):
        t = [torch.from_numpy(a).to(dev) for a in arrays]
        out.append((label, pec.Letters(t[0], t[1], match, insert), t[2],
                    t[3], params, long))
    letters("512 ragged pairs at 512^2",
            cs.ragged_batch(512, 170, 512, 512, seed=20261016), False)
    letters("64 ragged pairs at 2048^2",
            cs.ragged_batch(64, 682, 2048, 2048, seed=2048), False)
    letters("one 8300 x 2000 pair",
            cs.batch_of([8300], [2000], 8320, 2048, 20, seed=8300), True)
    ms128 = cs.mega_set(*cs.MEGA_128)[0]
    n128 = len(ms128.labels)
    pairs = [(x, y) for x in range(n128) for y in range(x + 1, n128)][:8]
    e, ix, iy, lx, ly = cs.mega_batch(ms128, pairs, cs.MEGA_128_PAD, dev)
    out.append(("8 mega-128 lattice pairs at 384", pec.Lattice(e, ix, iy),
                lx, ly, params, False))
    g = torch.Generator(device=dev).manual_seed(12288)
    w = cs.MEGA_LONG_PAD
    rng = np.random.default_rng(12288)
    lens = rng.integers(cs.MEGA_LONG[1], cs.MEGA_LONG[2] + 1, (2, 8))
    e = torch.randn((8, w, w), generator=g, device=dev) * 1.5 - 0.5
    ix = torch.randn((8, w), generator=g, device=dev) * 0.3 - 1.0
    iy = torch.randn((8, w), generator=g, device=dev) * 0.3 - 1.0
    out.append((f"8 lattice pairs of {cs.MEGA_LONG[1]}-{cs.MEGA_LONG[2]} "
                f"rows at {w}^2", pec.Lattice(e, ix, iy),
                torch.as_tensor(lens[0].astype(np.int32), device=dev),
                torch.as_tensor(lens[1].astype(np.int32), device=dev),
                params, True))
    return out


def timed(fn, long):
    """ms of one launch: steady for short launches, else one launch
    first and the median of 3 single launches."""
    import torch
    if not long:
        return cs.steady_ms(fn)
    fn()
    torch.cuda.synchronize()
    times = [cs.timed_once(fn)[1] for _ in range(3)]
    return statistics.median(times)


def held(name, a, b, lx, ly):
    """Raise unless two (lattice, ends) of kernel `name` are equal on the
    real cells."""
    bwd = name == "pairhmm_bwd_exact"
    same = (bool((cs.exact_inside(a[0], lx, ly, bwd)
                  == cs.exact_inside(b[0], lx, ly, bwd)).all())
            and bool((a[1] == b[1]).all()))
    if not same:
        raise RuntimeError(f"{name}: outputs differ from this build's")


def grid(dev, parent_dir, variants):
    import torch
    from muscle_tpu_torch.ops import pairhmm_exact_cuda as pec
    from muscle_tpu_torch.ops import wavefront
    others = {}
    if parent_dir:
        others["parent"] = parent_runner(parent_dir)
    for tag in variants:
        others[tag] = variant_runner(tag, VARIANTS[tag])
    clock = cs.max_sm_clock_hz()
    for label, src, lxb, lyb, params, long in grid_cases(dev):
        lx_h, ly_h = lxb.cpu().numpy(), lyb.cpu().numpy()
        lx_pad = (src.xb if isinstance(src, pec.Letters) else src.e).shape[1]
        for k, name in enumerate(cs.EXACT_KERNELS):
            this = getattr(pec, name)
            mine = this(src, lxb, lyb, params)
            floor = cs.exact_floor_ms(name, lx_h, ly_h, clock)
            line = [f"{name} at {label}: blocks of "
                    f"{pec.exact_geometry(lx_pad)[0]} bands"]
            for tag, fns in others.items():
                other = fns[k]
                held(name, mine, other(src, lxb, lyb, params), lxb, lyb)
                t = [timed(lambda: other(src, lxb, lyb, params), long),
                     timed(lambda: this(src, lxb, lyb, params), long),
                     timed(lambda: this(src, lxb, lyb, params), long),
                     timed(lambda: other(src, lxb, lyb, params), long)]
                line.append(f"this {t[1]:.4f} / {t[2]:.4f} ms vs {tag} "
                            f"{t[0]:.4f} / {t[3]:.4f} ms (equal)")
            if not others:
                ms = timed(lambda: this(src, lxb, lyb, params), long)
                line.append(f"{ms:.4f} ms")
            line.append(f"floor {floor:.4f} ms")
            print("; ".join(line), flush=True)
            del mine
            wavefront.check_waits(dev)
        del src
        torch.cuda.empty_cache()


def lone(dev, variants, diagnostics=()):
    """Time a band's step alone and with its hand-overs (--lone), this
    build, the variants and the diagnostic copies."""
    import torch
    from muscle_tpu_torch.hmm.params import HMMParams
    from muscle_tpu_torch.ops import pairhmm_cuda as pc
    from muscle_tpu_torch.ops import pairhmm_exact_cuda as pec
    match, insert, params = pc.tables(
        HMMParams.from_defaults(nucleo=False).to_scores(), dev)
    builds = {"this": (pec.pairhmm_fwd_exact, pec.pairhmm_bwd_exact)}
    for tag in variants:
        builds[tag] = variant_runner(tag, VARIANTS[tag])
    for tag in diagnostics:
        builds[tag] = variant_runner(tag, DIAGNOSTICS[tag])
    ly = 8192
    for lx in (32, 128, 160, 512):
        arr = cs.batch_of([lx], [ly], lx, ly, 20, seed=lx)
        t = [torch.from_numpy(a).to(dev) for a in arr]
        src = pec.Letters(t[0], t[1], match, insert)
        steps = ly + 32 + 40 * (-(-lx // 32) - 1)
        line = [f"lone pair {lx} x {ly} ({-(-lx // 32)} bands, ~{steps} "
                "steps):"]
        for tag, fns in builds.items():
            for k, fn in zip(("fwd", "bwd"), fns):
                ms = timed(lambda: fn(src, t[2], t[3], params), True)
                line.append(f"{tag} {k} {ms:.3f} ms = {ms * 1e6 / steps:.0f}"
                            " ns a step")
        print("; ".join(line), flush=True)


def main() -> int:
    import torch
    ap = argparse.ArgumentParser()
    ap.add_argument("--time", action="store_true")
    ap.add_argument("--families", action="store_true")
    ap.add_argument("--sass", metavar="FILE")
    ap.add_argument("--grid", action="store_true")
    ap.add_argument("--parent")
    ap.add_argument("--variants", action="store_true")
    ap.add_argument("--lone", action="store_true")
    ap.add_argument("--diagnose", action="store_true")
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_exact_probe: no CUDA device", file=sys.stderr)
        return 1
    from muscle_tpu_torch import MultiSequence
    from muscle_tpu_torch.ops import pairhmm_exact_cuda as pec
    from muscle_tpu_torch.utils.build import ensure_built
    print(cs.card_line(), flush=True)
    lib = ensure_built(pec.kernel_specs())["pairhmm_exact"]
    dev = torch.device("cuda")
    if a.sass:
        os.makedirs(os.path.dirname(os.path.abspath(a.sass)), exist_ok=True)
        for name, n, f64 in sass(lib, a.sass):
            print(f"sass {name}: {n} instructions, {f64} f64 / 64-bit "
                  "conversion", flush=True)
    cs.exact_kernel_checks(dev)
    if a.time:
        cs.exact_kernel_times(dev)
    if a.grid:
        grid(dev, a.parent, list(VARIANTS) if a.variants else [])
    if a.lone:
        lone(dev, list(VARIANTS) if a.variants else [],
             list(DIAGNOSTICS) if a.diagnose else [])
    if a.families:
        for name, inp, strip, golden in cs.FAMILIES:
            seqs = MultiSequence.from_fasta(os.path.join(ROOT, inp),
                                            strip_gaps=strip)
            gold = MultiSequence.from_fasta(os.path.join(ROOT, golden))
            msa, wall, got = cs.exact_run(name, seqs, dev, cs.EXACT_KERNELS)
            same = ({s.label: s.text() for s in msa}
                    == {s.label: s.text() for s in gold})
            print(f"exact family {name}: column-identical={same} "
                  f"Q={cs.q_score(msa, gold):.4f} wall={wall:.2f}s",
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
