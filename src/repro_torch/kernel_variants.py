"""Build-time variants of the redesigned CUDA kernels, timed on one card.

    python -m repro_torch.kernel_variants [--rounds 3] [--kernels a,b]

Compiles copies of ``kernels/csrc/gather_segment_reduce.cu`` and
``segment_reduce.cu`` with their run length ``RUN`` set to 64, 128 and 256
rows, of ``segment_softmax.cu`` with ``RUN`` = 64, 128, 256 and 512, and of
``segment_matmul.cu`` with its ring of ``STAGES`` = 2, 3 and 4 X stages,
each into a library of its own (nvcc with the flags of
``kernels/_build.py``, all started together, into the build directory), and
times each through its C entry point at the shapes ``chip_smoke.py`` uses:

  * gather: the weighted sum at the ogbn-arxiv bucket (fp32 F=64, 32 and
    3, bf16 F=64), and the mean of the (E, F) typed messages gathered by
    ``inv_type_perm`` into the nodes of the AM-scale typed graph (fp32 F=64
    and 32, bf16 F=64);
  * segment_reduce: sum, mean and max fp32 F=64, sum fp32 F=32 and bf16
    F=64 on the ogbn-arxiv destinations;
  * segment_softmax: fp32 and bf16 (E, 4) and fp32 (E,) at the ogbn-arxiv
    bucket, fp32 (E, 2) over the AM typed rows;
  * segment_matmul: fp32 and bf16 64->64 and 64->128 over the AM typed rows.

``--kernels`` names the kernels to build and time (all by default).

Each variant's result is held against the plain version (fp32 rtol 1e-4,
bf16 2e-2, atol the same times the largest magnitude). The variants of one
configuration are timed in turns, ``--rounds`` rounds of the median of 20
CUDA-event timings after 3 warm-ups, each behind a busy-wait kernel so host
launch time stays out; the median over the rounds is printed, with the
card's name and power limit. The shipped values are RUN = 64 (the gather,
segment_reduce), RUN = 128 (the softmax) and STAGES = 2.
Needs one CUDA device; exits non-zero without one.
"""
from __future__ import annotations

import argparse
import ctypes
import statistics
import subprocess
import sys

import torch

FEAT, HIDDEN, SEED = 32, 64, 0
# the AM graph of the R-GCN paper (Schlichtkrull et al. 2018, Table 1)
AM_NODES, AM_EDGES, AM_RELATIONS = 1_666_764, 5_988_321, 133

# the source line each variant rewrites, and the values it takes
VARIANTS = {"gather_segment_reduce": ("constexpr int RUN = {};", (64, 128, 256)),
            "segment_reduce": ("constexpr int RUN = {};", (64, 128, 256)),
            "segment_softmax": ("constexpr int RUN = {};", (64, 128, 256, 512)),
            "segment_matmul": ("constexpr int STAGES = {};", (2, 3, 4))}


def build_variants(_build, names):
    """{(kernel, value): loaded library}, compiled in parallel."""
    out_dir = _build.build_dir() / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        line, values = VARIANTS[name]
        src = (_build.CSRC / f"{name}.cu").read_text()
        shipped = [v for v in values if line.format(v) in src]
        if len(shipped) != 1:
            sys.exit(f"kernel_variants: {name}.cu has no line "
                     f"{line.format('N')!r} with one of {values}")
        for v in values:
            cu = out_dir / f"{name}_{v}.cu"
            cu.write_text(src.replace(line.format(shipped[0]), line.format(v)))
            so = out_dir / f"{name}_{v}.so"
            cmd = [_build.nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
                   "-o", str(so), str(cu)]
            procs[(name, v)] = (so, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
    libs = {}
    for (name, v), (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            sys.exit(f"kernel_variants: nvcc {name} {v} failed:\n{log}")
        lib = ctypes.CDLL(str(so))
        for fn, argtypes in _build.SIGNATURES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        libs[(name, v)] = lib
    return libs


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median device time of one call, CUDA events around each call."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def check(what, got, want, dtype) -> None:
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    want = want.float()
    scale = float(want[torch.isfinite(want)].abs().max())
    try:
        torch.testing.assert_close(got.float(), want, rtol=tol,
                                   atol=tol * max(scale, 1e-30),
                                   equal_nan=True)
    except AssertionError as e:
        sys.exit(f"kernel_variants: {what} disagrees with the plain "
                 f"version: {e}")


def main() -> None:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.kernel_variants",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--kernels", default=",".join(VARIANTS),
                    help="comma-separated kernels of " + ", ".join(VARIANTS))
    args = ap.parse_args()
    names = [k for k in args.kernels.split(",") if k]
    if not names or any(k not in VARIANTS for k in names):
        ap.error(f"--kernels: each of {list(VARIANTS)}")
    if not torch.cuda.is_available():
        sys.exit("kernel_variants: needs a CUDA device")
    from repro_torch.core.config_space import default_config
    from repro_torch.core.plan import make_plan
    from repro_torch.data.graphs import dataset, synth_typed_graph
    from repro_torch.kernels import _build
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels.gather_segment_reduce import DTYPE_CODE, REDUCES
    from repro_torch.serve import pad_to_bucket
    from repro_torch.serve.plan_cache import BucketEntry

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    libs = build_variants(_build, names)
    print(f"built {len(libs)} variants", flush=True)
    ptr, stream = _build.ptr, _build.stream_of
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def timed(what, calls, want, dtype):
        """Checks every variant against `want`, then times them in turns."""
        for v, fn in calls.items():
            got = fn()
            torch.cuda.synchronize()
            check(f"{what} variant {v}", got, want, dtype)
        rounds = {v: [] for v in calls}
        for _ in range(args.rounds):
            for v, fn in calls.items():
                rounds[v].append(time_ms(fn))
        cells = " ".join(f"{v}={statistics.median(ms):.4f}"
                         for v, ms in rounds.items())
        print(f"  {what}: {cells} (ms, median of {args.rounds} rounds)",
              flush=True)

    def gather(run, h, gidx, seg, num_segments, weight, reduce_code,
               row_ptr):
        lib = libs[("gather_segment_reduce", run)]
        num_rows, feat = int(seg.numel()), int(h.shape[1])
        out = torch.empty((num_segments, feat), dtype=h.dtype, device=dev)
        part = torch.empty((2 * -(-num_rows // run), feat),
                           dtype=torch.float32, device=dev)
        _build.check(lib.gsr_launch(
            DTYPE_CODE[h.dtype], reduce_code, int(weight is not None),
            ptr(h), ptr(gidx), ptr(seg), ptr(h if weight is None else weight),
            ptr(row_ptr), ptr(part), ptr(out), num_rows, feat, num_segments,
            run, stream(h)), f"gather variant {run}")
        return out

    def smm(stages, x, w, rplan):
        lib = libs[("segment_matmul", stages)]
        m, k = (int(d) for d in x.shape)
        g, n = int(w.shape[0]), int(w.shape[2])
        out = torch.empty((m, n), dtype=x.dtype, device=dev)
        _build.check(lib.smm_launch(
            DTYPE_CODE[x.dtype], ptr(x), ptr(w), ptr(rplan.offsets),
            ptr(rplan.first_group), ptr(rplan.group_count), ptr(out), m, k,
            n, g, rplan.config.m_b, stream(x)), f"segment_matmul variant "
            f"{stages}")
        return out

    def srd(run, x, seg, num_segments, reduce_code, row_ptr):
        lib = libs[("segment_reduce", run)]
        num_rows, feat = (int(d) for d in x.shape)
        out = torch.empty((num_segments, feat), dtype=x.dtype, device=dev)
        part = torch.empty((2 * -(-num_rows // run), feat),
                           dtype=torch.float32, device=dev)
        _build.check(lib.srd_launch(
            DTYPE_CODE[x.dtype], reduce_code, ptr(x), ptr(seg), ptr(row_ptr),
            ptr(part), ptr(out), num_rows, feat, num_segments, run,
            stream(x)), f"segment_reduce variant {run}")
        return out

    def ssm(run, x, seg, num_segments, row_ptr):
        lib = libs[("segment_softmax", run)]
        num_rows = int(x.shape[0])
        heads = 1 if x.dim() == 1 else int(x.shape[1])
        out = torch.empty_like(x)
        part = torch.empty((-(-num_rows // run), 2, 2, heads),
                           dtype=torch.float32, device=dev)
        _build.check(lib.ssm_launch(
            DTYPE_CODE[x.dtype], ptr(x), ptr(seg), ptr(row_ptr), ptr(part),
            ptr(out), num_rows, heads, num_segments, run, stream(x)),
            f"segment_softmax variant {run}")
        return out

    g = dataset("ogbn-arxiv", feat=FEAT, seed=SEED)
    padded, bucket = pad_to_bucket(g)
    v = bucket.num_nodes
    src = torch.from_numpy(padded.edge_index[0]).to(dev).int().contiguous()
    dst = torch.from_numpy(padded.edge_index[1]).to(dev).int().contiguous()
    plan = BucketEntry(bucket, HIDDEN, default_config(HIDDEN)).stamp(dst)
    if "gather_segment_reduce" in names:
        runs = VARIANTS["gather_segment_reduce"][1]
        wts = torch.rand(dst.numel(), generator=gen, device=dev)
        print(f"gather, RUN = {runs}:", flush=True)
        for feat, dtype in ((HIDDEN, torch.float32), (FEAT, torch.float32),
                            (HIDDEN, torch.bfloat16), (3, torch.float32)):
            h = torch.randn(v, feat, generator=gen, device=dev).to(dtype)
            w = wts.to(dtype)
            timed(f"weighted sum {str(dtype)[6:]} F={feat} at {bucket}",
                  {r: (lambda r=r: gather(r, h, src, dst, v, w, 0,
                                          plan.row_ptr)) for r in runs},
                  kops.gather_segment_reduce(h.float(), src, dst, v,
                                             w.float(), "sum", impl="ref"),
                  dtype)
        del h, w, wts
    if "segment_softmax" in names:
        runs = VARIANTS["segment_softmax"][1]
        print(f"segment_softmax, RUN = {runs}:", flush=True)
        logits = torch.randn(dst.numel(), 4, generator=gen, device=dev) * 5
        for x in (logits, logits.bfloat16(), logits[:, 0].contiguous()):
            timed(f"{str(x.dtype)[6:]} {tuple(x.shape)} at {bucket}",
                  {r: (lambda r=r: ssm(r, x, dst, v, plan.row_ptr))
                   for r in runs},
                  kops.segment_softmax(x.float(), dst, v, impl="ref"),
                  x.dtype)
        del logits, x
    if "segment_reduce" in names:
        runs = VARIANTS["segment_reduce"][1]
        a_dst = torch.from_numpy(g.edge_index[1]).to(dev).int().contiguous()
        a_plan = make_plan(a_dst, g.num_nodes, feat=HIDDEN, device=dev)
        print(f"segment_reduce on the ogbn-arxiv destinations, RUN = {runs}:",
              flush=True)
        for feat, dtype, reduces in (
                (HIDDEN, torch.float32, ("sum", "mean", "max")),
                (FEAT, torch.float32, ("sum",)),
                (HIDDEN, torch.bfloat16, ("sum",))):
            x = torch.randn(a_dst.numel(), feat, generator=gen,
                            device=dev).to(dtype)
            for reduce in reduces:
                code = REDUCES.index(reduce)
                timed(f"{reduce} {str(dtype)[6:]} F={feat}",
                      {r: (lambda r=r: srd(r, x, a_dst, g.num_nodes, code,
                                           a_plan.row_ptr)) for r in runs},
                      kops.segment_reduce(x.float(), a_dst, g.num_nodes,
                                          reduce, impl="ref"), dtype)
        del x, a_dst, a_plan
    del plan, src, dst

    typed = {"gather_segment_reduce", "segment_softmax", "segment_matmul"}
    if typed.isdisjoint(names):
        print(card, flush=True)
        return
    am = synth_typed_graph("am", AM_NODES, AM_EDGES,
                           num_relations=AM_RELATIONS, feat=FEAT, seed=SEED)
    m = am.num_edges
    am_dst = torch.from_numpy(am.edge_index[1]).to(dev).int().contiguous()
    am_plan = am.make_plan(feat=HIDDEN, device=dev)
    if "gather_segment_reduce" in names:
        runs = VARIANTS["gather_segment_reduce"][1]
        am_inv = torch.from_numpy(am.inv_type_perm).to(dev).int().contiguous()
        for feat, dtype in ((HIDDEN, torch.float32), (FEAT, torch.float32),
                            (HIDDEN, torch.bfloat16)):
            msg = torch.randn(m, feat, generator=gen, device=dev).to(dtype)
            timed(f"typed mean {str(dtype)[6:]} F={feat}, H=({m}, {feat}) "
                  "by inv_type_perm",
                  {r: (lambda r=r: gather(r, msg, am_inv, am_dst,
                                          am.num_nodes, None, 1,
                                          am_plan.row_ptr)) for r in runs},
                  kops.gather_segment_reduce(msg.float(), am_inv, am_dst,
                                             am.num_nodes, None, "mean",
                                             impl="ref"), dtype)
            del msg
    if "segment_softmax" in names:
        runs = VARIANTS["segment_softmax"][1]
        x = torch.randn(m, 2, generator=gen, device=dev) * 5
        timed(f"typed softmax float32 (E={m}, 2) into {am.num_nodes} rows",
              {r: (lambda r=r: ssm(r, x, am_dst, am.num_nodes,
                                   am_plan.row_ptr)) for r in runs},
              kops.segment_softmax(x, am_dst, am.num_nodes, impl="ref"),
              torch.float32)
        del x
    if "segment_matmul" in names:
        stages = VARIANTS["segment_matmul"][1]
        sizes = torch.from_numpy(am.type_counts).to(dev)
        rplan = am.make_relation_plan(feat=HIDDEN, device=dev)
        print(f"segment_matmul over M={m} rows in {AM_RELATIONS} groups, "
              f"STAGES = {stages}:", flush=True)
        for k, n in ((HIDDEN, HIDDEN), (HIDDEN, 2 * HIDDEN)):
            x32 = torch.randn(m, k, generator=gen, device=dev)
            w32 = torch.randn(AM_RELATIONS, k, n, generator=gen,
                              device=dev) / k ** 0.5
            for dtype in (torch.float32, torch.bfloat16):
                x, w = x32.to(dtype), w32.to(dtype)
                timed(f"{k}->{n} {str(dtype)[6:]}",
                      {s: (lambda s=s: smm(s, x, w, rplan)) for s in stages},
                      kops.segment_matmul(x.float(), sizes, w.float(),
                                          impl="ref"), dtype)
                del x, w
            del x32, w32
    print(card, flush=True)


if __name__ == "__main__":
    main()
