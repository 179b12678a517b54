"""Lazy ``nvcc`` build of the CUDA sources in ``csrc/`` and their ``ctypes``
bindings.

Each ``csrc/<name>.cu`` is compiled on first use into its own shared
library with a plain C interface::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o <build>/<name>-<hash>.so csrc/<name>.cu

The file name carries a hash of the source, the headers and the flags, so
an edited source is rebuilt and a stale library is never loaded. The build
directory is ``kernels/_build/`` beside this file (listed in .gitignore),
or ``$REPRO_TORCH_BUILD_DIR``; delete it to force a rebuild. Nothing here
runs at import time: the CPU tests import every module and have no nvcc.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).parent / "csrc"
KERNELS = ("gather_segment_reduce", "segment_softmax", "fused_transform_reduce",
           "segment_reduce", "sddmm", "segment_matmul")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}

# C signatures of the entry points (every pointer and the stream is a
# c_void_p, or ctypes would cut it to 32 bits); each returns cudaError_t
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
SIGNATURES = {
    "gather_segment_reduce": {
        # dtype, reduce, weighted, h, gidx, seg, w, row_ptr, part, out,
        # num_rows, feat, num_segments, run_rows, stream
        "gsr_launch": [_I, _I, _I, _P, _P, _P, _P, _P, _P, _P,
                       _L, _I, _I, _I, _P],
    },
    "segment_softmax": {
        # dtype, x, seg, row_ptr, part, out, num_rows, heads, num_segments,
        # run_rows, stream
        "ssm_launch": [_I, _P, _P, _P, _P, _P, _L, _I, _I, _I, _P],
    },
    "fused_transform_reduce": {
        # dtype, mean, weighted, h, wm, gidx, wt, row_ptr, out, d_in,
        # d_out, num_segments, tile_segments, stream
        "ftr_launch": [_I, _I, _I, _P, _P, _P, _P, _P, _P,
                       _I, _I, _I, _I, _P],
    },
    "segment_reduce": {
        # dtype, reduce, x, seg, row_ptr, part, out, num_rows, feat,
        # num_segments, run_rows, stream
        "srd_launch": [_I, _I, _P, _P, _P, _P, _P, _L, _I, _I, _I, _P],
    },
    "sddmm": {
        # dtype, a, b, row, col, out, m, n, stream
        "sddmm_launch": [_I, _P, _P, _P, _P, _P, _L, _I, _P],
    },
    "segment_matmul": {
        # dtype, x, w, offsets, first_group, group_count, out, num_rows,
        # k_dim, n_dim, num_groups, m_b, stream
        "smm_launch": [_I, _P, _P, _P, _P, _P, _P, _L, _I, _I, _I, _I, _P],
    },
}


def build_dir() -> Path:
    return Path(os.environ.get("REPRO_TORCH_BUILD_DIR",
                               Path(__file__).parent / "_build"))


def nvcc() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH,
    else the toolkit's default install location."""
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels of repro_torch are "
                       "built on first use and need the CUDA toolkit "
                       "(set CUDA_HOME)")


def _library_path(name: str) -> Path:
    h = hashlib.sha256()
    for path in [CSRC / f"{name}.cu"] + sorted(CSRC.glob("*.cuh")):
        h.update(path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return build_dir() / f"{name}-{h.hexdigest()[:16]}.so"


def _compile_cmd(name: str, out: Path) -> list:
    return [nvcc(), *NVCC_FLAGS, "-o", str(out), str(CSRC / f"{name}.cu")]


def build(names: Iterable[str] = KERNELS) -> Dict[str, Path]:
    """Compile every named library that is not built yet, one ``nvcc``
    process per source, all started together. Returns name → library path.
    Raises with the compiler's output if any build fails."""
    paths = {n: _library_path(n) for n in names}
    todo = {n: p for n, p in paths.items() if not p.exists()}
    if todo:
        build_dir().mkdir(parents=True, exist_ok=True)
        procs = {}
        for n, p in todo.items():
            tmp = p.with_suffix(f".tmp{os.getpid()}")
            procs[n] = (tmp, subprocess.Popen(
                _compile_cmd(n, tmp), stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True))
        failures = []
        for n, (tmp, proc) in procs.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                failures.append(f"--- nvcc {n}.cu (exit {proc.returncode})\n{log}")
                tmp.unlink(missing_ok=True)
            else:
                os.replace(tmp, todo[n])     # atomic: never a half-written .so
        if failures:
            raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failures))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build([name])[name]))
            for fn, argtypes in SIGNATURES[name].items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            _LIBS[name] = lib
        return lib


def check(err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error (a launch refused for
    its shape or shared memory never runs, and a later synchronize would
    not report it)."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream_of(t) -> ctypes.c_void_p:
    import torch
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)
