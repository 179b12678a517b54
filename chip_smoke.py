#!/usr/bin/env python3
"""Smoke test and first measurement of the PyTorch/CUDA port on one NVIDIA
GPU (written for an H100).

    python3 chip_smoke.py

Phases (any failure exits non-zero before the result line):

1. Card and build: prints the card's name and power limit, builds the three
   CUDA kernels from ``src/repro_torch/kernels/csrc`` with nvcc (one process
   per source, all started together) and prints the build time. TF32 is
   off for matmuls and cuDNN.
2. Kernels against their plain PyTorch versions on the card, at the served
   ogbn-arxiv bucket (V = 262,144, E = 2,097,152 padded edges): every
   reduce and weighting of gather_segment_reduce at F = 32 and 64, the
   4-head softmax, the fused kernel at the GCN/SAGE layer widths, in fp32
   and bf16, plus an empty graph and num_segments % s_b != 0. Tolerances:
   fp32 rtol = 1e-4, atol = 1e-4·max|plain| (hub segments are summed in
   another order); bf16 rtol = 2e-2, atol = 2e-2·max|plain| against the
   fp32 plain version of the same upcast inputs. Each configuration prints
   kernel_ms and plain_ms (CUDA events, median of 20 runs after 3 warm-up
   runs; a busy-wait kernel queued first keeps host launch time out of the
   window; L2 is not flushed, as a served layer finds its input there).
   Library yardsticks, timed the same way and never called by the port:
   ``torch.sparse.mm`` of a CSR for the weighted sum, ``torch.sparse.softmax``
   of a COO for the softmax.
3. Serving, the main path: for gcn, gin, sage and gat (4 heads), a 3-layer
   model (feat 32, hidden 64, 16 classes) with seeded random weights behind
   ``GNNServer`` on the card serves one full ogbn-arxiv request (twice: cold
   and warm), one cora + citeseer + pubmed micro-batch, and for gcn one full
   reddit2 request. Every result is held against the same model run with
   ``impl="ref"`` on the card (fp32 tolerance above), and each kernel of a
   family's path must have launched. Launch counters are zeroed just before
   this phase and read just after it.
4. A ``{"kernels": [...]}`` line: per kernel its launches on the main path,
   the max abs error and times of its representative configuration, and
   ``bound_ms``, the least time the card could take for that work: the
   larger of (bytes it must move) / 3.35 TB/s and (flops) / 67 TFLOP/s
   (fp32 outside the tensor cores, where these kernels compute). The bytes
   count the real edges' indices, H's distinct source rows and every
   output row.
5. The last line: ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
FP32_FLOPS = 67e12             # H100 SXM fp32 outside the tensor cores
FEAT, HIDDEN, CLASSES = 32, 64, 16
SEED = 0


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def time_ms(torch, fn, reps: int = 20, warmup: int = 3) -> float:
    """Median device time of one call, CUDA events around each call; a
    busy-wait kernel queued first lets the host enqueue the call before the
    device reaches it, so launch overhead stays out of the window."""
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


def compare(torch, what: str, got, want, dtype) -> float:
    """Max abs error of ``got`` against the plain ``want``; fails outside
    the tolerance of ``dtype`` (see the module docstring)."""
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    got, want = got.float(), want.float()
    if got.shape != want.shape:
        fail(f"{what}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    if not torch.equal(torch.isneginf(got), torch.isneginf(want)):
        fail(f"{what}: -inf (empty max) rows disagree")
    fin = torch.isfinite(want)
    if not torch.equal(torch.isfinite(got), fin):
        fail(f"{what}: non-finite values where the plain version is finite")
    if not fin.any():
        return 0.0
    g, w = got[fin], want[fin]
    err = (g - w).abs()
    scale = float(w.abs().max())
    bad = err > tol * max(scale, 1e-30) + tol * w.abs()
    if bool(bad.any()):
        fail(f"{what}: {int(bad.sum())} values outside rtol={tol}, "
             f"atol={tol}*{scale:.3g}; max abs err {float(err.max()):.3g}")
    return float(err.max())


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device; this script runs the port on the card")
    try:
        from repro_torch.core.config_space import KernelConfig, default_config
        from repro_torch.core.plan import make_plan
        from repro_torch.data.graphs import dataset
        from repro_torch.kernels import _build
        from repro_torch.kernels import ops as kops
        from repro_torch.models import gnn
        from repro_torch.serve import GNNServer, pad_to_bucket
        from repro_torch.serve.plan_cache import BucketEntry
    except ImportError as e:
        fail(f"repro_torch is not importable next to this script ({e})")

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # -- 1. card and build ----------------------------------------------------
    card = card_line()
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"devices {torch.cuda.device_count()}", flush=True)
    t0 = time.perf_counter()
    _build.build()
    for name in _build.KERNELS:
        _build.load(name)
    print(f"build: {time.perf_counter() - t0:.1f} s for {len(_build.KERNELS)} "
          f"kernels (sm_90a)", flush=True)

    # -- 2. kernels against their plain versions ------------------------------
    t_phase = time.perf_counter()
    g = dataset("ogbn-arxiv", feat=FEAT, seed=SEED)
    padded, bucket = pad_to_bucket(g)
    v, e = bucket.num_nodes, bucket.num_edges
    config = default_config(HIDDEN)
    src = torch.from_numpy(padded.edge_index[0]).to(dev)
    dst = torch.from_numpy(padded.edge_index[1]).to(dev)
    plan = BucketEntry(bucket, HIDDEN, config).stamp(dst)
    e_real = g.num_edges
    out_blocks = plan.chunk_first.numel()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    wts = torch.rand(e, generator=gen, device=dev)
    print(f"kernel shapes: bucket {bucket} (real V={g.num_nodes}, "
          f"E={e_real}), config {config}", flush=True)

    def run(fn, plain, what, dtype, upcast_plain):
        got = fn()
        torch.cuda.synchronize()
        err = compare(torch, what, got, upcast_plain(), dtype)
        k_ms, p_ms = time_ms(torch, fn), time_ms(torch, plain)
        print(f"  {what}: max_abs_err={err:.3g} kernel_ms={k_ms:.4f} "
              f"plain_ms={p_ms:.4f}", flush=True)
        return err, k_ms, p_ms

    results = {}
    for feat in (FEAT, HIDDEN):
        h32 = torch.randn(v, feat, generator=gen, device=dev)
        for dtype in (torch.float32, torch.bfloat16):
            h = h32.to(dtype)
            for reduce in ("sum", "mean", "max"):
                for weighted in (False, True):
                    w = wts.to(dtype) if weighted else None
                    what = (f"gather_segment_reduce {reduce}"
                            f"{' weighted' if weighted else ''} F={feat} "
                            f"{str(dtype)[6:]}")
                    res = run(
                        lambda: kops.gather_segment_reduce(
                            h, src, dst, v, w, reduce, plan=plan, impl="cuda"),
                        lambda: kops.gather_segment_reduce(
                            h, src, dst, v, w, reduce, impl="ref"),
                        what, dtype,
                        lambda: kops.gather_segment_reduce(
                            h.float(), src, dst, v,
                            None if w is None else w.float(), reduce,
                            impl="ref"))
                    results[(feat, dtype, reduce, weighted)] = res

    heads = 4
    logits32 = torch.randn(e, heads, generator=gen, device=dev) * 5
    for dtype in (torch.float32, torch.bfloat16):
        x = logits32.to(dtype)
        results[("softmax", dtype)] = run(
            lambda: kops.segment_softmax(x, dst, v, plan=plan, impl="cuda"),
            lambda: kops.segment_softmax(x, dst, v, impl="ref"),
            f"segment_softmax heads={heads} {str(dtype)[6:]}", dtype,
            lambda: kops.segment_softmax(x.float(), dst, v, impl="ref"))
    x1 = logits32[:, 0].contiguous()
    run(lambda: kops.segment_softmax(x1, dst, v, plan=plan, impl="cuda"),
        lambda: kops.segment_softmax(x1, dst, v, impl="ref"),
        "segment_softmax (E,) float32", torch.float32,
        lambda: kops.segment_softmax(x1, dst, v, impl="ref"))

    for d_in, d_out in ((FEAT, HIDDEN), (HIDDEN, HIDDEN), (HIDDEN, CLASSES)):
        h32 = torch.randn(v, d_in, generator=gen, device=dev)
        wm32 = torch.randn(d_in, d_out, generator=gen, device=dev) / d_in ** 0.5
        for dtype in (torch.float32, torch.bfloat16):
            h, wm = h32.to(dtype), wm32.to(dtype)
            for reduce, weighted in (("sum", True), ("mean", False)):
                w = wts.to(dtype) if weighted else None
                results[("fused", d_in, d_out, dtype, reduce)] = run(
                    lambda: kops.fused_transform_reduce(
                        h, wm, src, dst, v, w, reduce, plan=plan, impl="cuda"),
                    lambda: kops.fused_transform_reduce(
                        h, wm, src, dst, v, w, reduce, impl="ref"),
                    f"fused_transform_reduce {reduce}"
                    f"{' weighted' if weighted else ''} {d_in}->{d_out} "
                    f"{str(dtype)[6:]}", dtype,
                    lambda: kops.fused_transform_reduce(
                        h.float(), wm.float(), src, dst, v,
                        None if w is None else w.float(), reduce, impl="ref"))

    # edge cases: an empty graph, and num_segments % s_b != 0 with padding rows
    none = torch.zeros(0, dtype=torch.int32, device=dev)
    hx = torch.randn(1000, HIDDEN, generator=gen, device=dev)
    wm = torch.randn(HIDDEN, CLASSES, generator=gen, device=dev)
    for reduce in ("sum", "mean", "max"):
        compare(torch, f"empty graph {reduce}",
                kops.gather_segment_reduce(hx, none, none, 1000, None, reduce,
                                           impl="cuda"),
                kops.gather_segment_reduce(hx, none, none, 1000, None, reduce,
                                           impl="ref"), torch.float32)
    compare(torch, "empty graph fused",
            kops.fused_transform_reduce(hx, wm, none, none, 1000, impl="cuda"),
            torch.zeros(1000, CLASSES, device=dev), torch.float32)
    compare(torch, "empty graph softmax",
            kops.segment_softmax(torch.zeros(0, 4, device=dev), none, 1000,
                                 impl="cuda"),
            torch.zeros(0, 4, device=dev), torch.float32)
    s_odd = 1001
    rng_idx = torch.randint(0, s_odd, (9000,), generator=gen, device=dev)
    d_odd = torch.cat([rng_idx.sort().values,
                       torch.full((37,), s_odd, device=dev)]).int()
    s_src = torch.randint(0, s_odd, (d_odd.numel(),), generator=gen,
                          device=dev).int()
    odd_cfg = KernelConfig("SR", 32, 64, 16, 1)
    odd_plan = make_plan(d_odd, s_odd, config=odd_cfg).to(dev)
    hx = torch.randn(s_odd, HIDDEN, generator=gen, device=dev)
    w_odd = torch.rand(d_odd.numel(), generator=gen, device=dev)
    for reduce in ("sum", "mean", "max"):
        compare(torch, f"S%s_b!=0 {reduce}",
                kops.gather_segment_reduce(hx, s_src, d_odd, s_odd, w_odd,
                                           reduce, plan=odd_plan, impl="cuda"),
                kops.gather_segment_reduce(hx, s_src, d_odd, s_odd, w_odd,
                                           reduce, impl="ref"), torch.float32)
    x_odd = torch.randn(d_odd.numel(), heads, generator=gen, device=dev)
    compare(torch, "S%s_b!=0 softmax",
            kops.segment_softmax(x_odd, d_odd, s_odd, plan=odd_plan,
                                 impl="cuda"),
            kops.segment_softmax(x_odd, d_odd, s_odd, impl="ref"),
            torch.float32)
    compare(torch, "S%s_b!=0 fused",
            kops.fused_transform_reduce(hx, wm, s_src, d_odd, s_odd, w_odd,
                                        "mean", plan=odd_plan, impl="cuda"),
            kops.fused_transform_reduce(hx, wm, s_src, d_odd, s_odd, w_odd,
                                        "mean", impl="ref"), torch.float32)
    torch.cuda.synchronize()
    print(f"kernel checks passed ({time.perf_counter() - t_phase:.1f} s)",
          flush=True)

    # library yardstick for the weighted sum: one torch.sparse.mm of a CSR
    # built from the real edges (timed only; the port never calls it)
    h64 = torch.randn(v, HIDDEN, generator=gen, device=dev)
    csr = torch.sparse_coo_tensor(
        torch.stack([dst[:e_real].long(), src[:e_real].long()]),
        wts[:e_real], (v, v)).coalesce().to_sparse_csr()
    lib_sum = torch.sparse.mm(csr, h64)
    compare(torch, "torch.sparse.mm yardstick", lib_sum,
            kops.gather_segment_reduce(h64, src, dst, v, wts, "sum",
                                       impl="ref"), torch.float32)
    library_gather_ms = time_ms(torch, lambda: torch.sparse.mm(csr, h64))
    del csr, lib_sum

    # library yardstick for the softmax: one torch.sparse.softmax over dim 1
    # of a (V, E, heads) COO whose row i holds the logits of the edges into
    # node i; absent entries count as -inf (timed only; never in the port)
    x_real = logits32[:e_real]
    coo = torch.sparse_coo_tensor(
        torch.stack([dst[:e_real].long(),
                     torch.arange(e_real, device=dev)]),
        x_real, (v, e_real, heads)).coalesce()
    lib_soft = torch.sparse.softmax(coo, 1)
    if not torch.equal(lib_soft.indices(), coo.indices()):
        fail("torch.sparse.softmax yardstick reordered its entries")
    compare(torch, "torch.sparse.softmax yardstick", lib_soft.values(),
            kops.segment_softmax(x_real, dst[:e_real], v, impl="ref"),
            torch.float32)
    library_softmax_ms = time_ms(torch, lambda: torch.sparse.softmax(coo, 1))
    del coo, lib_soft
    # the gather reads each distinct source row of H once (padded edges
    # stop the walk before any load, so no padded row is read)
    h_rows = int(torch.unique(src[:e_real]).numel())

    # -- 3. serving: the main path --------------------------------------------
    t_phase = time.perf_counter()
    graphs = {name: dataset(name, feat=FEAT, seed=SEED)
              for name in ("ogbn-arxiv", "cora", "citeseer", "pubmed")}
    graphs["reddit2"] = dataset("reddit2", feat=FEAT, seed=SEED)
    print(f"graphs built on the host ({time.perf_counter() - t_phase:.1f} s)",
          flush=True)

    def plain_forward(model, gr):
        with torch.inference_mode():
            return model(torch.from_numpy(gr.x).to(dev),
                         torch.from_numpy(gr.edge_index).to(dev),
                         gr.num_nodes,
                         torch.from_numpy(gr.deg_inv_sqrt).to(dev),
                         impl="ref").float().cpu()

    path_kernels = {"gcn": ["fused_transform_reduce"],
                    "gin": ["gather_segment_reduce"],
                    "sage": ["fused_transform_reduce"],
                    "gat": ["segment_softmax", "gather_segment_reduce"]}
    serving = []
    kops.reset_launch_counts()
    for family in gnn.MODELS:
        before = kops.launch_counts()
        model = gnn.init(family, FEAT, HIDDEN, CLASSES,
                         heads=4 if family == "gat" else 1, seed=SEED)
        srv = GNNServer(model, family, max_batch_nodes=1 << 22,
                        max_batch_graphs=8)
        steps = [["ogbn-arxiv"], ["ogbn-arxiv"], ["cora", "citeseer", "pubmed"]]
        if family == "gcn":
            steps.append(["reddit2"])
        for names in steps:
            for name in names:
                srv.submit(graphs[name])
            served = srv.step(flush=True)
            if len(served) != len(names):
                fail(f"{family}: served {len(served)} of {len(names)}")
            for name, res in zip(names, served):
                gr = graphs[name]
                if res.logits.shape != (gr.num_nodes, CLASSES):
                    fail(f"{family} {name}: logits {res.logits.shape}")
                want = plain_forward(srv.model, gr)
                err = compare(torch, f"served {family} {name}",
                              torch.from_numpy(res.logits), want,
                              torch.float32)
                serving.append({"family": family, "graph": name,
                                "batch": "+".join(names),
                                "serve_ms": round(res.serve_s * 1e3, 3),
                                "cache_hit": res.cache_hit,
                                "max_abs_err": err})
                print(f"  served {family} {name} in batch {'+'.join(names)}: "
                      f"serve_ms={res.serve_s * 1e3:.3f} "
                      f"cache_hit={res.cache_hit} max_abs_err={err:.3g} "
                      f"launched={sorted(res.fusion)}", flush=True)
        after = kops.launch_counts()
        launched = {k: after[k] - before[k] for k in after}
        print(f"  {family} launches: {launched}", flush=True)
        for k in path_kernels[family]:
            if launched[k] == 0:
                fail(f"{family}: kernel {k} of its path was never launched")
        del srv, model
    launches = kops.launch_counts()
    print(f"serving passed ({time.perf_counter() - t_phase:.1f} s); "
          f"launches on the main path: {launches}", flush=True)

    # -- 4. the kernels line ----------------------------------------------------
    def bound(nbytes, flops):
        t_b, t_o = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS
        print(f"  bound: {nbytes} bytes, {flops} flops", flush=True)
        return (max(t_b, t_o) * 1e3, "bytes" if t_b >= t_o else "operations")

    print(f"bounds over {e_real} real edges, {h_rows} distinct source rows, "
          f"{v} output rows (gather, softmax, fused):", flush=True)

    meta = 2 * out_blocks * 4
    idx_bytes = e_real * (4 + 4 + 4)          # gather idx, segment, fp32 weight
    g_err, g_ms, g_plain = results[(HIDDEN, torch.float32, "sum", True)]
    g_bound = bound(idx_bytes + h_rows * HIDDEN * 4 + v * HIDDEN * 4 + meta,
                    2 * e_real * HIDDEN)
    s_err, s_ms, s_plain = results[("softmax", torch.float32)]
    s_bound = bound(e_real * (4 + heads * 4) + e * heads * 4 + meta,
                    4 * e_real * heads)
    f_err, f_ms, f_plain = results[("fused", FEAT, HIDDEN, torch.float32, "sum")]
    f_bound = bound(idx_bytes + h_rows * FEAT * 4 + FEAT * HIDDEN * 4
                    + v * HIDDEN * 4 + meta,
                    2 * e_real * FEAT + 2 * v * FEAT * HIDDEN)
    csrc = "src/repro_torch/kernels/csrc"
    kernels = [
        {"name": "gather_segment_reduce", "route": "cuda",
         "source": f"{csrc}/gather_segment_reduce.cu",
         "replaces": "src/repro/kernels/gather_segment_reduce.py:277",
         "launches": launches["gather_segment_reduce"],
         "max_abs_err": g_err, "ms": g_ms, "plain_ms": g_plain,
         "bound_ms": g_bound[0], "bound_by": g_bound[1],
         "library_ms": library_gather_ms,
         "config": f"weighted sum fp32 F={HIDDEN} at {bucket}"},
        {"name": "segment_softmax", "route": "cuda",
         "source": f"{csrc}/segment_softmax.cu",
         "replaces": "src/repro/kernels/segment_softmax.py:202",
         "launches": launches["segment_softmax"],
         "max_abs_err": s_err, "ms": s_ms, "plain_ms": s_plain,
         "bound_ms": s_bound[0], "bound_by": s_bound[1],
         "library_ms": library_softmax_ms,
         "config": f"fp32 (E, {heads}) at {bucket}"},
        {"name": "fused_transform_reduce", "route": "cuda",
         "source": f"{csrc}/fused_transform_reduce.cu",
         "replaces": "src/repro/kernels/fused_transform_reduce.py:171",
         "launches": launches["fused_transform_reduce"],
         "max_abs_err": f_err, "ms": f_ms, "plain_ms": f_plain,
         "bound_ms": f_bound[0], "bound_by": f_bound[1], "library_ms": None,
         "config": f"weighted sum fp32 {FEAT}->{HIDDEN} at {bucket}"},
    ]
    print(json.dumps({"serving": serving}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
