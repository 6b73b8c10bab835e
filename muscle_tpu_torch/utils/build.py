"""Build native sources into shared libraries at first use.

Every library goes into one build directory outside the package,
``build/muscle_tpu_torch`` beside the package directory, named by a hash of its
source files and command, so an edited source is rebuilt and a stale
library is never loaded. A build writes to a temporary name and is
renamed into place, so concurrent processes never load a half-written
file. `ensure_built` starts every missing build at once and waits for
all of them.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
from dataclasses import dataclass

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def build_dir() -> str:
    d = os.path.join(os.path.dirname(_PKG), "build", "muscle_tpu_torch")
    os.makedirs(d, exist_ok=True)
    return d


def package_path(*parts: str) -> str:
    return os.path.join(_PKG, *parts)


@dataclass(frozen=True)
class LibSpec:
    """A shared library built from `sources` by `compiler` + `flags`;
    `deps` are extra files (headers) whose content keys the build."""
    name: str
    compiler: str
    flags: tuple[str, ...]
    sources: tuple[str, ...]
    deps: tuple[str, ...] = ()

    def path(self) -> str:
        h = hashlib.sha256(" ".join((self.compiler,) + self.flags).encode())
        for f in self.sources + self.deps:
            with open(f, "rb") as fh:
                h.update(fh.read())
        return os.path.join(build_dir(),
                            f"lib{self.name}_{h.hexdigest()[:16]}.so")


def nvcc() -> str:
    """Path of the CUDA compiler (PATH, $CUDA_HOME, /usr/local/cuda)."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                       "the CUDA toolkit is installed")


def ensure_built(specs) -> dict[str, str]:
    """Build every spec whose library is missing, all in parallel.
    Returns {name: library path}; raises RuntimeError naming each
    failed build with its compiler output."""
    out, running = {}, []
    for spec in specs:
        path = spec.path()
        out[spec.name] = path
        if os.path.exists(path):
            continue
        tmp = f"{path}.{os.getpid()}.tmp"
        cmd = [spec.compiler, *spec.flags, "-o", tmp, *spec.sources]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        running.append((spec, proc, tmp, path))
    errors = []
    for spec, proc, tmp, path in running:
        log, _ = proc.communicate()
        if proc.returncode == 0:
            with open(f"{path}.log", "w") as fh:
                fh.write(log)
            os.replace(tmp, path)
        else:
            if os.path.exists(tmp):
                os.remove(tmp)
            errors.append(f"{spec.name}: exit {proc.returncode}\n{log}")
    if errors:
        raise RuntimeError("build failed:\n" + "\n".join(errors))
    return out


# nvcc flags of every kernel library: Hopper's sm_90a, IEEE arithmetic
# (no fast math, no FMA contraction: kernels and plain versions claim
# bit equality), a plain C interface loaded with ctypes; ptxas reports
# each kernel's registers and spills into the build log
CUDA_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")


def build_log(name: str, specs) -> str:
    """The compiler output kept beside the built library `name`."""
    spec = next(s for s in specs if s.name == name)
    with open(f"{spec.path()}.log") as fh:
        return fh.read()


def cuda_spec(name: str, deps: tuple[str, ...] = ()) -> LibSpec:
    """Library `name` built from csrc/<name>.cu, keyed on `deps` (the
    headers it includes) too."""
    return LibSpec(name=name, compiler=nvcc(), flags=CUDA_FLAGS,
                   sources=(package_path("csrc", f"{name}.cu"),), deps=deps)


def load_kernel(spec: LibSpec, argtypes):
    """(fn, error_string) of a one-kernel library: `fn` is the C function
    named like the library, returning a cudaError_t as an int, and
    `error_string(code)` the C function `<name>_error_string`."""
    import ctypes
    lib = ctypes.CDLL(ensure_built([spec])[spec.name])
    fn = getattr(lib, spec.name)
    fn.restype = ctypes.c_int
    fn.argtypes = argtypes
    err = getattr(lib, f"{spec.name}_error_string")
    err.restype = ctypes.c_char_p
    err.argtypes = [ctypes.c_int]
    return fn, err


def build_all() -> dict[str, str]:
    """Build the CUDA kernels and the native host library together."""
    from ..native import native_spec
    from ..ops import (densify_cuda, devjoin_cuda, dp_cuda, pairhmm_cuda,
                       pairhmm_emis_cuda, pairhmm_exact_cuda, pairhmm_striped,
                       sparse)
    return ensure_built(list(pairhmm_cuda.kernel_specs())
                        + pairhmm_emis_cuda.kernel_specs()
                        + pairhmm_exact_cuda.kernel_specs()
                        + pairhmm_striped.kernel_specs()
                        + densify_cuda.kernel_specs()
                        + devjoin_cuda.kernel_specs()
                        + dp_cuda.kernel_specs() + sparse.kernel_specs()
                        + [native_spec()])
