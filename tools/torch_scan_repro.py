"""Run-to-run reproducibility of muscle_tpu_torch's CPU pair-HMM scan.

Starts N fresh Python processes. Each one computes, once:

* `torch.exp` of a fixed vector of log-space posterior scores (its
  first call in the process, split over torch's thread pool);
* `ops.logspace.exp_f32`, the exp the scan uses, on the same vector;
* `ops.pairhmm.batch_posteriors` on a fixed ragged batch;

and prints a hash of each. The parent counts, per column, the processes
whose result differs from the majority. On a loaded host, torch's CPU
exp (MKL's vector math) now and then returns one worker thread's chunk
at ~1e-4 relative error on its first call; `exp_f32` and the scan
should never differ.

    python tools/torch_scan_repro.py --procs 384 --parallel 8

Imports neither jax nor muscle_tpu; runs on the CPU.
"""

from __future__ import annotations

import argparse
import collections
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CHILD = r"""
import hashlib, sys
import numpy as np, torch
sys.path.insert(0, sys.argv[1])
from muscle_tpu_torch.hmm.params import HMMParams
from muscle_tpu_torch.ops import pairhmm
from muscle_tpu_torch.ops.logspace import exp_f32
h = lambda t: hashlib.md5(t.numpy().tobytes()).hexdigest()[:8]
rng = np.random.default_rng(0)
s = torch.from_numpy((np.log(0.01) * rng.random(8 * 96 * 96)).astype(np.float32))
out = [h(torch.exp(s)), h(exp_f32(s))]
b, lmax = 8, 96
lx = rng.integers(32, lmax + 1, size=b).astype(np.int32)
ly = rng.integers(32, lmax + 1, size=b).astype(np.int32)
lx[0] = ly[0] = lmax
xb = np.full((b, lmax), 20, np.int32)
yb = np.full((b, lmax), 20, np.int32)
for i in range(b):
    xb[i, :lx[i]] = rng.integers(0, 21, size=lx[i])
    yb[i, :ly[i]] = rng.integers(0, 21, size=ly[i])
post, _ = pairhmm.batch_posteriors(
    *(torch.from_numpy(a) for a in (xb, yb, lx, ly)),
    *pairhmm.score_args(HMMParams.from_defaults().to_scores()))
print(*out, h(post))
"""

COLUMNS = ("torch.exp", "exp_f32", "batch_posteriors")


def one(_) -> list[str]:
    out = subprocess.run([sys.executable, "-c", CHILD, ROOT],
                         capture_output=True, text=True, check=True,
                         timeout=600)
    return out.stdout.split()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--procs", type=int, default=384)
    ap.add_argument("--parallel", type=int, default=8)
    args = ap.parse_args()
    with ThreadPoolExecutor(args.parallel) as ex:
        results = list(ex.map(one, range(args.procs)))
    print(f"{args.procs} processes, {args.parallel} at a time, torch's "
          f"default threads:")
    for k, name in enumerate(COLUMNS):
        counts = collections.Counter(r[k] for r in results)
        minority = args.procs - counts.most_common(1)[0][1]
        print(f"  {name}: {len(counts)} distinct results, {minority} "
              f"process(es) differ from the majority")
    return 0


if __name__ == "__main__":
    sys.exit(main())
