"""Lazy ``nvcc`` build of the CUDA sources in ``csrc/`` and their ``ctypes``
bindings.

Each ``csrc/<name>.cu`` is compiled on first use into its own shared
library with a plain C interface::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o <build>/<name>-<hash>.so csrc/<name>.cu

The gather, segment_reduce and the fused kernel are built once for every
value of their config axis (the run length M_b, the tile S_b), each value
into a library of its own, compiled from a two-line wrapper in the build
directory that narrows the source's list of instances (``FOR_RUN_LENGTHS``,
``FOR_TILES``) to that value and includes it: the instances compile in
parallel, and a launch loads the library of its config's value
(:data:`INSTANCES`).

The file name carries a hash of the source, the headers, the flags and
the wrapper, so an edited source is rebuilt and a stale library is never
loaded. The build
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
from typing import Dict, Iterable, Optional, Tuple

from repro_torch.core.config_space import (DEFAULT_M_B, DEFAULT_S_B,
                                           RUN_LENGTHS, TILE_SIZES)

CSRC = Path(__file__).parent / "csrc"
KERNELS = ("gather_segment_reduce", "segment_softmax", "fused_transform_reduce",
           "segment_reduce", "sddmm", "segment_matmul")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

# kernel -> (the source's macro listing its instances, the values built,
# the default): one library a value
INSTANCES = {
    "gather_segment_reduce": ("FOR_RUN_LENGTHS", RUN_LENGTHS, DEFAULT_M_B),
    "segment_reduce": ("FOR_RUN_LENGTHS", RUN_LENGTHS, DEFAULT_M_B),
    "fused_transform_reduce": ("FOR_TILES", TILE_SIZES, DEFAULT_S_B),
}

Unit = Tuple[str, Optional[int]]        # (kernel, instance or None)

_LOCK = threading.Lock()
_LIBS: Dict[Unit, ctypes.CDLL] = {}

# C signatures of the entry points (every pointer and the stream is a
# c_void_p, or ctypes would cut it to 32 bits); each returns cudaError_t
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
SIGNATURES = {
    "gather_segment_reduce": {
        # dtype, reduce, weighted, h, gidx, seg, w, row_ptr, part, out,
        # num_rows, feat, num_segments, run_rows, stream
        "gsr_launch": [_I, _I, _I, _P, _P, _P, _P, _P, _P, _P,
                       _L, _I, _I, _I, _P],
        # dtype, reduce, weighted, h, gidx, seg, w, out, num_rows, feat,
        # num_segments, stream (the owner path: no row offsets, no scratch)
        "gsr_owner_launch": [_I, _I, _I, _P, _P, _P, _P, _P, _L, _I, _I, _P],
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
        # dtype of A (and the output), dtype of B, a, b, row, col, out, m,
        # n, stream (the wide-row path)
        "sddmm_wide_launch": [_I, _I, _P, _P, _P, _P, _P, _L, _I, _P],
    },
    "segment_matmul": {
        # dtype, x, w, offsets, first_group, group_count, out, num_rows,
        # k_dim, n_dim, num_groups, m_b, stream
        "smm_launch": [_I, _P, _P, _P, _P, _P, _P, _L, _I, _I, _I, _I, _P],
        # x, w, offsets, out, num_rows, k_dim, n_dim, num_groups, w_kn,
        # stream (the bf16 wgmma path)
        "smm_tc_launch": [_P, _P, _P, _P, _L, _I, _I, _I, _I, _P],
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


def units(names: Iterable[str] = KERNELS) -> list:
    """The libraries of the named kernels: one a built value of a kernel
    with :data:`INSTANCES`, else one."""
    return [(n, v) for n in names
            for v in (INSTANCES[n][1] if n in INSTANCES else (None,))]


def _wrapper(unit: Unit) -> Optional[str]:
    """The source of an instance's wrapper: the instance list narrowed to
    its value, then the kernel's source."""
    name, value = unit
    if value is None:
        return None
    return (f"#define {INSTANCES[name][0]}(X) X({value})\n"
            f'#include "{CSRC / f"{name}.cu"}"\n')


def _library_path(unit: Unit) -> Path:
    name, value = unit
    h = hashlib.sha256()
    for path in [CSRC / f"{name}.cu"] + sorted(CSRC.glob("*.cuh")):
        h.update(path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    h.update((_wrapper(unit) or "").encode())
    stem = name if value is None else f"{name}-{value}"
    return build_dir() / f"{stem}-{h.hexdigest()[:16]}.so"


def _compile_cmd(unit: Unit, out: Path) -> list:
    src = CSRC / f"{unit[0]}.cu"
    wrapper = _wrapper(unit)
    if wrapper is not None:
        src = out.with_suffix(".cu")
        src.write_text(wrapper)
    return [nvcc(), *NVCC_FLAGS, "-o", str(out), str(src)]


def build(names: Iterable[str] = KERNELS, only: Optional[Iterable[Unit]] = None
          ) -> Dict[Unit, Path]:
    """Compile every library of the named kernels (or the ``only`` units)
    that is not built yet, one ``nvcc`` process each, all started together.
    Returns (kernel, instance) → library path. Raises with the compiler's
    output if any build fails."""
    paths = {u: _library_path(u) for u in (units(names) if only is None
                                           else only)}
    todo = {u: p for u, p in paths.items() if not p.exists()}
    if todo:
        build_dir().mkdir(parents=True, exist_ok=True)
        procs = {}
        for u, p in todo.items():
            tmp = p.with_suffix(f".tmp{os.getpid()}")
            procs[u] = (tmp, subprocess.Popen(
                _compile_cmd(u, tmp), stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True))
        failures = []
        for u, (tmp, proc) in procs.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                failures.append(f"--- nvcc {u[0]}.cu {u[1] or ''} "
                                f"(exit {proc.returncode})\n{log}")
                tmp.unlink(missing_ok=True)
            else:
                os.replace(tmp, todo[u])     # atomic: never a half-written .so
        if failures:
            raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failures))
    return paths


def load(name: str, instance: Optional[int] = None) -> ctypes.CDLL:
    """The loaded library of kernel ``name`` (for a kernel with
    :data:`INSTANCES`, of its ``instance``: the default value if None),
    built first if needed."""
    if name in INSTANCES:
        macro, values, default = INSTANCES[name]
        instance = default if instance is None else int(instance)
        if instance not in values:
            raise ValueError(f"{name}: no instance is built for {instance}; "
                             f"built: {values}")
    unit = (name, instance)
    with _LOCK:
        lib = _LIBS.get(unit)
        if lib is None:
            lib = ctypes.CDLL(str(build(only=[unit])[unit]))
            for fn, argtypes in SIGNATURES[name].items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            _LIBS[unit] = lib
        return lib


def check(err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error (a launch refused for
    its shape or shared memory never runs, and a later synchronize would
    not report it)."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def is_fake(t) -> bool:
    """Whether ``t`` is a fake tensor (shapes without data, as a dry run
    traces): no data to read, and no kernel to launch."""
    from torch._subclasses.fake_tensor import FakeTensor
    return isinstance(t, FakeTensor)


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream_of(t) -> ctypes.c_void_p:
    import torch
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)
