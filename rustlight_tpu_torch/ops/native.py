"""Build and load the port's native code, and count the rays its kernels trace.

CUDA: every `csrc/*.cu` is compiled for sm_90a by its own nvcc process, all
started together, and the objects are linked into one shared library with a
plain C interface, loaded with ctypes. Host C++ (the BVH builder) is
compiled with g++. Both land in build/kernels/ under the checkout, keyed by
the hash of their sources and flags, at first use; a failed compile raises.

The walk's kernels are built for one cluster size K (triangles per
cluster, csrc/tri_test_mma.cuh: RL_KC): the production library at 384, and
`load_cuda(k)` at any other K a library of the walk sources alone
(WALK_SOURCES) built with -DRL_KC=<k>, keyed by those flags beside it.
`check_lib_k` holds a library's K (its `rl_kc()`) to the tables'.

`counting_rays()` sums, on the device, the lanes with tfar > 0 handed to any
trace kernel of ops/ (the rays actually traced); it and `count_rays`, which
the wrappers call, are the recorder's (utils/tracing.py). The build keeps ptxas's
report (registers, shared memory, spills per kernel) beside the library;
`ptxas_usage()` reads it.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path
from typing import Sequence

import torch

from ..utils.tracing import count_rays, counting_rays  # noqa: F401

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
_NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-Xcompiler", "-fPIC"]
_GXX_FLAGS = ["-O2", "-shared", "-fPIC"]
# the production K (ops/walk_trace.py:K, RL_KC's default in csrc/)
PRODUCTION_K = 384
# the sources of a library built at another K: every walk kernel's
WALK_SOURCES = ("walk_trace.cu", "walk_hier.cu", "walk_sub.cu",
                "walk_sparse.cu", "pair_trace.cu", "walk_lab.cu")
_CUDA_LIBS = {}
# launches of walk kernels over tables of another K than the production
# one, by "<LAUNCHES name>@K<k>" (the wrappers count them in their own
# LAUNCHES too)
K_LAUNCHES = {}
def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    cands = [os.path.join(cuda_home, "bin", "nvcc")] if cuda_home else []
    cands += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")


def _tag(paths: Sequence[Path], flags: Sequence[str]) -> str:
    h = hashlib.sha1(" ".join(flags).encode())
    for p in paths:
        h.update(p.name.encode() + b"\0" + p.read_bytes())
    return h.hexdigest()[:12]


def _run(cmd) -> str:
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"{cmd[0]} failed ({res.returncode}):\n{res.stderr}")
    return res.stderr


def build(verbose: bool = False, defines: Sequence[str] = (),
          sources: Sequence[str] = None) -> Path:
    """Compile csrc/*.cu for sm_90a into one library unless this set of
    sources has been built; returns the library path. `defines` (macro
    names) build another library beside it: RL_LAB_FORMS, the candidate
    forms of K6 and of K3/K4's split tensor-core visit
    (tools/perf/sub_forms.py), and of K7 and K3w (tools/perf/
    split_forms.py); `sources` (file names in csrc/) builds such a library
    of those sources alone."""
    srcs = sorted(p for p in CSRC.glob("*.cu")
                  if sources is None or p.name in sources)
    flags = [*_NVCC_FLAGS, *(f"-D{x}" for x in defines)]
    tag = _tag(srcs + sorted(CSRC.glob("*.cuh")), flags)
    out = BUILD_DIR / f"libkernels_{tag}.so"
    if out.exists():
        return out
    work = BUILD_DIR / f"obj_{tag}.{os.getpid()}"
    work.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    objs = [work / (s.stem + ".o") for s in srcs]
    procs = [subprocess.Popen([nvcc, *flags, "-Xptxas", "-v", "-c",
                               "-o", str(obj), str(src)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True)
             for src, obj in zip(srcs, objs)]
    logs, failed = [], []
    for src, p in zip(srcs, procs):
        _, err = p.communicate()
        logs.append(err.strip())
        if p.returncode != 0:
            failed.append(f"{src.name} ({p.returncode}):\n{err}")
    if failed:
        raise RuntimeError("nvcc failed: " + "\n".join(failed))
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    logs.append(_run([nvcc, *flags, "-shared", "-o", str(tmp),
                      *map(str, objs)]).strip())
    if verbose:
        print("\n".join(x for x in logs if x))
    report = out.with_suffix(f".{os.getpid()}.ptxas")
    report.write_text("\n".join(logs))
    os.replace(report, out.with_suffix(".ptxas"))
    os.replace(tmp, out)   # atomic: a concurrent build never sees half a file
    shutil.rmtree(work, ignore_errors=True)
    return out


def ptxas_usage(lib: Path = None) -> dict:
    """ptxas's report of the built library (`build()`'s by default): {mangled
    kernel name: (registers, static shared-memory bytes, spill-store
    bytes)}."""
    text = (lib or build()).with_suffix(".ptxas").read_text()
    usage, name, spill = {}, None, 0
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name, spill = m.group(1), 0
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            spill = int(m.group(1))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            sm = re.search(r"(\d+) bytes smem", line)
            usage[name] = (int(m.group(1)), int(sm.group(1)) if sm else 0,
                           spill)
            name = None
    return usage


def build_k(k: int, verbose: bool = False) -> Path:
    """The library whose walk kernels take K = k: the production one at 384,
    else WALK_SOURCES built with -DRL_KC=<k> (ValueError for a K that
    ops/walk_trace.py:check_k refuses)."""
    from .walk_trace import check_k
    check_k(k)
    if int(k) == PRODUCTION_K:
        return build(verbose)
    return build(verbose, defines=(f"RL_KC={int(k)}",), sources=WALK_SOURCES)


def load_cuda(k: int = PRODUCTION_K) -> ctypes.CDLL:
    """The loaded library for walk tables of K = k (build_k), one a K."""
    k = int(k)
    if k not in _CUDA_LIBS:
        lib = ctypes.CDLL(str(build_k(k)))
        lib.rl_kc.argtypes, lib.rl_kc.restype = [], ctypes.c_int
        _CUDA_LIBS[k] = lib
    return _CUDA_LIBS[k]


def count_k(name: str, k: int) -> None:
    """One launch of kernel `name` over tables of K = k (K_LAUNCHES)."""
    if int(k) != PRODUCTION_K:
        key = f"{name}@K{int(k)}"
        K_LAUNCHES[key] = K_LAUNCHES.get(key, 0) + 1


def check_lib_k(lib, k: int, what: str) -> None:
    """Raises ValueError unless library `lib` was built for K = k: a kernel
    never walks tables of another K than its own."""
    built = int(lib.rl_kc())
    if built != int(k):
        raise ValueError(f"{what}: walk tables of K = {int(k)} handed to a "
                         f"library built for K = {built}")


def build_host(src: Path) -> Path:
    """Compile one host C++ source into a shared library with g++ unless
    this source has been built; returns the library path."""
    out = BUILD_DIR / f"lib{src.stem}_{_tag([src], _GXX_FLAGS)}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    _run(["g++", *_GXX_FLAGS, "-o", str(tmp), str(src)])
    os.replace(tmp, out)
    return out
