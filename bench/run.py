"""Run one cell of the port's benchmark on the card and print its result.

    python bench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout. Loads the cell's configuration and traffic
(``BENCHMARK.json``, ``bench/``), makes its inputs and weights on the card
from ``--seed``, sets up the program (``src/repro_torch``), warms it up,
then measures for ``--seconds`` (``--trace 0``: the end-to-end metrics) or
traces the traffic's ``trace_units`` units (``--trace 1``: the per-layer
metrics), checks what the timed path produced against the plain reference
(``bench/reference``) and prints one JSON line last on standard output:
``correct``, ``attempted``, ``failed``, ``metrics``, ``device``, in a
traced run ``breakdown``, and ``checks`` (each compared number with its
limit, also printed last on standard error). Exits 2 without a result
when the card is missing, and 1 when the program is.

The kernels' build and every cache of the program stay inside the
checkout, at fixed paths under ``bench/.cache`` (git-ignored): only a
checkout's first run builds.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
CACHE = BENCH / ".cache"


def environment() -> None:
    """Fixed cache paths inside the checkout; nothing of the program's
    telemetry written to disk; no library loads JAX by itself."""
    os.environ["REPRO_TORCH_BUILD_DIR"] = str(CACHE / "kernels")
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    # an empty PerfDB: the generated rules pick every kernel config
    os.environ["REPRO_PERFDB_PATH"] = str(CACHE / "perfdb" / "perfdb.json")
    for name in ("REPRO_AUTOTUNE", "REPRO_METRICS_PATH", "REPRO_TRACE_PATH"):
        os.environ.pop(name, None)
    os.environ["USE_FLAX"] = "0"
    # cuBLAS sums in a fixed order only with a fixed workspace
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    # the script's own folder is no package root: its modules are bench.*
    sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != BENCH]
    for p in (str(ROOT / "src"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    environment()
    import torch

    from bench import harness
    cell = harness.Cell.load(args.workload)
    chips = int(cell.entry["chips"])
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < chips:
        print(f"bench: {args.workload} needs {chips} CUDA card(s); found "
              f"{found}", file=sys.stderr)
        return 2
    out = harness.run_cell(torch, cell, args.seed, args.seconds,
                           bool(args.trace), torch.device("cuda", 0),
                           T_START)
    bad = harness.forbidden_modules(sys.modules)
    if bad:
        print(f"bench: the run loaded {bad} (JAX or the JAX package)",
              file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
