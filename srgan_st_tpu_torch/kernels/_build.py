"""Build and load the hand-written CUDA kernels.

Each `csrc/<name>.cu` exposes a plain C interface and is compiled on its
own with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -o <build dir>/lib<name>-<hash>.so csrc/<name>.cu

at first use, then loaded with ctypes: a build of seconds, since no
PyTorch header is included. The library name carries a hash of the
sources, so an edited kernel is rebuilt. The build directory is
`build/kernels` at the repository root (listed in .gitignore). `build()`
starts one nvcc per source, all at once, and waits for them.

Nothing here runs at import: this module is imported on machines without
a CUDA toolkit.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
KERNELS = ("coarse_conv", "serving_tail", "packed_trunk", "fused_trunk", "buddy_select",
           "eval_trunk", "rrdb_dense", "rrdb_hr")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

_LIBS: dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def build_dir() -> str:
    return os.path.join(os.path.dirname(_PKG), "build", "kernels")


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        path = os.path.join(CUDA_HOME, "bin", "nvcc")
        if os.path.exists(path):
            return path
    path = shutil.which("nvcc")
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to "
                           "build the port's kernels")
    return path


def _sources_hash(name: str) -> str:
    h = hashlib.sha256()
    for fname in sorted(os.listdir(CSRC)):
        if fname == f"{name}.cu" or fname.endswith(".cuh"):
            with open(os.path.join(CSRC, fname), "rb") as f:
                h.update(fname.encode() + f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def library_path(name: str) -> str:
    return os.path.join(build_dir(), f"lib{name}-{_sources_hash(name)}.so")


def build(names=KERNELS, ptxas_verbose: bool = False) -> dict[str, dict]:
    """Compile the named kernels that are not built yet, one nvcc process
    per source, all started together. Returns {name: {"seconds", "log"}}
    for each compiled source; raises with nvcc's output if one fails."""
    os.makedirs(build_dir(), exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        out = library_path(name)
        if os.path.exists(out):
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, *(["-Xptxas", "-v"] if ptxas_verbose else []),
               "-o", tmp, os.path.join(CSRC, f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    done = {}
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed for csrc/{name}.cu:\n{log}")
            continue
        os.replace(tmp, out)
        done[name] = {"seconds": time.perf_counter() - t0, "log": log}
    if failed:
        raise RuntimeError("\n".join(failed))
    return done


def load(name: str, signatures: dict[str, list]) -> ctypes.CDLL:
    """The kernel library `name`, built if needed, with `signatures`
    ({c function: argtypes}) applied; every function returns an int
    (a cudaError_t)."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            path = library_path(name)
            if not os.path.exists(path):
                build([name])
            lib = ctypes.CDLL(path)
            lib.typed = set()
            _LIBS[name] = lib
        for fn_name in signatures.keys() - lib.typed:
            fn = getattr(lib, fn_name)
            fn.argtypes = signatures[fn_name]
            fn.restype = ctypes.c_int
            lib.typed.add(fn_name)
        return lib


def check(err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t {err}")
