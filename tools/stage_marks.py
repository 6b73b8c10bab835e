"""Stage marks for the pair-HMM kernels' row loops (tools/ probes).

`variant_library(name, tag, edits)` builds a copy of kernel library
`name` (csrc/<name>.cu) beside the kernels, in
build/muscle_tpu_torch/variants/<tag>/<name>/, under source edits;
`mark(loop_head)` is the edit that puts a clock64() mark at the top of
the row loop at `loop_head` and after every block barrier inside it
(in the header or .cu that holds the loop). Block 0's
thread 0 sums the cycles between consecutive marks; `stage_cycles(lib,
rows)` reads them back as the mean cycles a row of each stage (the
stage that ends at each barrier, as the slowest warp of block 0 sees
it; index 0 is the stretch from the loop's last barrier to the top of
the next row). The marks themselves cost cycles: compare stages of one
build, not a marked build with an unmarked one.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess

_PROF_HEAD = """
#ifndef STAGE_MARKS_DEFINED
#define STAGE_MARKS_DEFINED
__device__ long long g_stage_cycles[8];
#define STAGE_MARK(k)                                       \\
  if (threadIdx.x == 0 && blockIdx.x == 0) {                \\
    const long long t_ = clock64();                         \\
    if (stage_last) stage_acc[k] += t_ - stage_last;        \\
    stage_last = t_;                                        \\
  }
extern "C" int stage_cycles(long long* out) {
  return (int)cudaMemcpyFromSymbol(out, g_stage_cycles,
                                   sizeof(g_stage_cycles));
}
#endif
"""


def instrument(src: str, loop_head: str) -> str:
    """`src` with marks in the row loop that starts at `loop_head` (a
    kernel's only loop with that text): its kernel's accumulators after
    the kernel's `extern __shared__` line, a mark at the loop's top and
    after each `__syncthreads();` to the kernel's end (a `}` in column
    0), and block 0's sums stored at that end."""
    at = src.index(loop_head)
    smem = src.rindex("extern __shared__ float smem[];", 0, at)
    end = src.index("\n}\n", at)
    head, body, tail = src[:at], src[at:end], src[end:]
    k = 1
    out = []
    for piece in body.split("__syncthreads();\n"):
        out.append(piece)
        if k <= 7:
            out.append(f"__syncthreads(); STAGE_MARK({k});\n")
        else:
            out.append("__syncthreads();\n")
        k += 1
    loop = "".join(out[:-1])
    loop = loop.replace(loop_head, loop_head + " STAGE_MARK(0);", 1)
    dump = ("\n  if (threadIdx.x == 0 && blockIdx.x == 0)\n"
            "    for (int k_ = 0; k_ < 8; ++k_) "
            "g_stage_cycles[k_] = stage_acc[k_];")
    line_end = head.index("\n", smem) + 1
    head = (head[:line_end]
            + "  long long stage_acc[8] = {0}, stage_last = 0;\n"
            + head[line_end:])
    return head + loop + dump + tail


def mark(loop_head: str):
    """An edit for `variant_library`: marks in the loop at `loop_head`."""
    def edit(src: str) -> str:
        src = instrument(src, loop_head)
        first = src.index("#include")
        return src[:first] + src[first:].replace("\n", "\n" + _PROF_HEAD, 1)
    return edit


def variant_library(name: str, tag: str, edits: dict) -> ctypes.CDLL:
    """Build csrc/<name>.cu from a copy of csrc in
    build/muscle_tpu_torch/variants/<tag>/<name>/, each file of `edits`
    ({file in csrc: [src -> src, ...]}) edited in turn, and load it. The
    caller sets the kernel function's argtypes as the kernels'."""
    from muscle_tpu_torch.utils.build import (CUDA_FLAGS, build_dir, nvcc,
                                              package_path)
    out = os.path.join(build_dir(), "variants", tag, name)
    os.makedirs(out, exist_ok=True)
    csrc = package_path("csrc")
    for f in os.listdir(csrc):
        if f.endswith((".cuh", ".cu")):
            shutil.copy(os.path.join(csrc, f), out)
    for f, fns in edits.items():
        path = os.path.join(out, f)
        with open(path) as fh:
            src = fh.read()
        for fn in fns:
            src = fn(src)
        with open(path, "w") as fh:
            fh.write(src)
    so = os.path.join(out, f"lib{name}.so")
    subprocess.run([nvcc(), *CUDA_FLAGS, "-o", so,
                    os.path.join(out, f"{name}.cu")], check=True,
                   capture_output=True)
    lib = ctypes.CDLL(so)
    if hasattr(lib, "stage_cycles"):
        lib.stage_cycles.argtypes = [ctypes.c_void_p]
    lib.pairhmm_error_string.restype = ctypes.c_char_p
    lib.pairhmm_error_string.argtypes = [ctypes.c_int]
    return lib


def stage_cycles(lib, rows: int) -> list[float]:
    """Mean cycles a row of each stage of the last marked launch."""
    buf = (ctypes.c_longlong * 8)()
    lib.stage_cycles(ctypes.cast(buf, ctypes.c_void_p))
    return [round(v / rows, 1) for v in buf if v]
