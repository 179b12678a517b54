#!/usr/bin/env python3
"""Smoke test and first measurement of the PyTorch/CUDA port on one NVIDIA
GPU (written for an H100).

    python3 chip_smoke.py

Phases (any failure exits non-zero before the result line):

1. Card and build: prints the card's name and power limit, builds the six
   CUDA kernels from ``src/repro_torch/kernels/csrc`` with nvcc (one process
   per source, all started together) and prints the build time. TF32 is
   off for matmuls and cuDNN.
2. Kernels against their plain PyTorch versions on the card. Tolerances:
   fp32 rtol = 1e-4, atol = 1e-4·max|plain| (sums are taken in another
   order); bf16 rtol = 2e-2, atol = 2e-2·max|plain| against the fp32 plain
   version of the same upcast inputs. Each configuration prints kernel_ms
   and plain_ms (CUDA events, median of 20 runs after 3 warm-up runs; a
   busy-wait kernel queued first keeps host launch time out of the window;
   L2 is not flushed, as a served layer finds its input there).

   a. The serving kernels at the served ogbn-arxiv bucket (V = 262,144,
      E = 2,097,152 padded edges): every reduce and weighting of
      gather_segment_reduce at F = 32 and 64, the 4-head softmax, the fused
      kernel at the GCN/SAGE layer widths, in fp32 and bf16, plus an empty
      graph and num_segments % s_b != 0. Yardsticks: ``torch.sparse.mm`` of
      a CSR for the weighted sum, ``torch.sparse.softmax`` of a COO.
   b. segment_matmul at the typed rows of the AM graph (M = 5,988,321
      edges in 133 zipf-skewed relation groups) at K->N = 64->64, 32->128
      and 64->128, plus empty groups, a single group and rows past the
      groups; the gather kernel with H = the (E, 64) typed messages and the
      inverse type permutation as its gather index, as ``mp_typed`` runs it;
      segment_reduce (sum, mean, max at F = 32 and 64) on the ogbn-arxiv
      destinations (M = 1,166,243 rows, S = 169,343 segments); sddmm on
      arxiv's (dst, src) pairs at F = 64. Yardsticks:
      ``torch.segment_reduce`` with lengths, ``torch.sparse.sampled_addmm``
      on the CSR of the coalesced (dst, src) pattern (duplicate pairs are
      merged there, so it computes each distinct pair once), and
      ``torch._grouped_mm`` with the group offsets.
3. The main paths, each with the launch counters zeroed just before it and
   read just after it:

   a. Serving: for gcn, gin, sage and gat (4 heads), a 3-layer model (feat
      32, hidden 64, 16 classes) with seeded random weights behind
      ``GNNServer`` on the card serves one full ogbn-arxiv request (twice:
      cold and warm), one cora + citeseer + pubmed micro-batch, and for gcn
      one full reddit2 request. Every result is held against the same model
      run with ``impl="ref"`` on the card (fp32 tolerance above), and each
      kernel of a family's path must have launched.
   b. Typed inference: rgcn and rgat (2 heads), 3 layers, feat 32, hidden
      64, 16 classes, seeded weights, on the AM-scale typed graph
      (``synth_typed_graph``: 1,666,764 nodes, 5,988,321 edges, 133
      relations), with both plans built on the card. Held against the same
      model at ``impl="ref"`` on the card; every layer must launch
      segment_matmul exactly once and the gather kernel, every rgat layer
      the softmax, and no op may take a plain version. Prints each
      family's warm forward time (CUDA events, median of 3) and one
      forward under ``torch.profiler``: device-busy time, idle share and
      the ops that take the most device time.
   c. The public ops: ``segment_reduce`` (sum, mean, max) and ``sddmm`` on
      arxiv's card tensors, as ``examples/quickstart.py`` calls them.
4. A ``{"kernels": [...]}`` line: per kernel its launches on the main paths
   (and per path), the max abs error and times of its representative
   configuration, and ``bound_ms``, the least time the card could take for
   that work: the larger of (bytes it must move) / 3.35 TB/s and (flops) /
   67 TFLOP/s (fp32 outside the tensor cores, where these kernels compute).
   The bytes count each input read once (a gathered operand at its
   distinct rows) and each output row written once.
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
# the AM graph of the R-GCN paper (Schlichtkrull et al. 2018, Table 1)
AM_NODES, AM_EDGES, AM_RELATIONS = 1_666_764, 5_988_321, 133
RGAT_HEADS = 2


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


def library(what: str, call):
    """(result, None) of one library call, or (None, reason) when this
    PyTorch build lacks or refuses it. A library call is a yardstick that is
    timed only, never part of the port, so its failure is printed and the
    run goes on."""
    try:
        return call(), None
    except (RuntimeError, NotImplementedError, AttributeError) as e:
        reason = str(e).splitlines()[0][:200]
        print(f"  {what} yardstick did not run: {reason}", flush=True)
        return None, reason


def profiled(torch, fn):
    """(wall ms, device-busy ms, top device ops) of one call of ``fn`` under
    ``torch.profiler``: device events only (kernels and copies), so a host
    op's attributed device time is not counted twice."""
    from torch.autograd import DeviceType
    act = [torch.profiler.ProfilerActivity.CPU,
           torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=act) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CUDA:
            continue
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = evt.self_cuda_time_total
        if us > 0:
            rows.append((evt.key, us / 1e3))
    rows.sort(key=lambda r: -r[1])
    return wall_ms, sum(ms for _, ms in rows), rows[:8]


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
        import repro_torch as rt
        from repro_torch.core.config_space import KernelConfig, default_config
        from repro_torch.core.plan import make_plan
        from repro_torch.data.graphs import dataset, synth_typed_graph
        from repro_torch.kernels import _build
        from repro_torch.kernels import ops as kops
        from repro_torch.kernels.sddmm import sddmm_launch
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

    # -- 2b. the kernels of the typed path and of the public ops ---------------
    t_phase = time.perf_counter()
    am = synth_typed_graph("am", AM_NODES, AM_EDGES,
                           num_relations=AM_RELATIONS, feat=FEAT, seed=SEED)
    print(f"AM-scale typed graph built on the host "
          f"({time.perf_counter() - t_phase:.1f} s): |V|={am.num_nodes} "
          f"|E|={am.num_edges} R={am.num_relations}, "
          f"{int((am.type_counts == 0).sum())} empty relations, largest "
          f"{int(am.type_counts.max())} rows", flush=True)
    m_typed = am.num_edges
    sizes = torch.from_numpy(am.type_counts).to(dev)
    rplan = am.make_relation_plan(feat=HIDDEN, device=dev)
    offs = rplan.offsets[1:].contiguous()          # cumulative group ends
    library_smm = {}
    for k_dim, n_dim in ((HIDDEN, HIDDEN), (FEAT, 2 * HIDDEN),
                         (HIDDEN, 2 * HIDDEN)):
        x32 = torch.randn(m_typed, k_dim, generator=gen, device=dev)
        w32 = torch.randn(AM_RELATIONS, k_dim, n_dim, generator=gen,
                          device=dev) / k_dim ** 0.5
        for dtype in (torch.float32, torch.bfloat16):
            x, w = x32.to(dtype), w32.to(dtype)
            results[("smm", k_dim, n_dim, dtype)] = run(
                lambda: kops.segment_matmul(x, sizes, w, plan=rplan,
                                            impl="cuda"),
                lambda: kops.segment_matmul(x, sizes, w, impl="ref"),
                f"segment_matmul {k_dim}->{n_dim} M={m_typed} "
                f"G={AM_RELATIONS} {str(dtype)[6:]}", dtype,
                lambda: kops.segment_matmul(x.float(), sizes, w.float(),
                                            impl="ref"))
            # yardstick: one torch._grouped_mm with the group offsets
            # (timed only)
            out, reason = library(
                f"torch._grouped_mm {k_dim}->{n_dim} {str(dtype)[6:]}",
                lambda: torch._grouped_mm(x, w, offs=offs))
            if out is not None:
                compare(torch, f"torch._grouped_mm yardstick {k_dim}->{n_dim}",
                        out, kops.segment_matmul(x.float(), sizes, w.float(),
                                                 impl="ref"), dtype)
                lib_ms = time_ms(torch, lambda: torch._grouped_mm(
                    x, w, offs=offs))
                print(f"  torch._grouped_mm {k_dim}->{n_dim} "
                      f"{str(dtype)[6:]}: library_ms={lib_ms:.4f}", flush=True)
                library_smm[(k_dim, n_dim, dtype)] = lib_ms
            else:
                library_smm[(k_dim, n_dim, dtype)] = reason
            del x, w, out
        del x32, w32

    # the gather kernel as mp_typed runs it: H = the (E, F) typed messages,
    # gathered back through the inverse type permutation, mean into nodes
    am_dst = torch.from_numpy(am.edge_index[1]).to(dev)
    am_inv = torch.from_numpy(am.inv_type_perm).to(dev)
    am_plan = am.make_plan(feat=HIDDEN, device=dev)
    msg = torch.randn(m_typed, HIDDEN, generator=gen, device=dev)
    results["gather typed"] = run(
        lambda: kops.gather_segment_reduce(msg, am_inv, am_dst, am.num_nodes,
                                           None, "mean", plan=am_plan,
                                           impl="cuda"),
        lambda: kops.gather_segment_reduce(msg, am_inv, am_dst, am.num_nodes,
                                           None, "mean", impl="ref"),
        f"gather_segment_reduce mean F={HIDDEN} H=(E={m_typed}, F) gathered "
        f"by inv_type_perm", torch.float32,
        lambda: kops.gather_segment_reduce(msg, am_inv, am_dst, am.num_nodes,
                                           None, "mean", impl="ref"))
    del msg

    # edge cases: empty groups, a single group, rows past the groups
    for label, gs, pad in (("empty groups", [0, 300, 0, 0, 77, 0, 1000, 0], 0),
                           ("single group", [4096], 0),
                           ("rows past the groups", [0, 513, 64, 0, 3], 200),
                           ("no rows in any group", [0, 0, 0], 129)):
        gs_t = torch.tensor(gs, dtype=torch.int32, device=dev)
        m_e = sum(gs) + pad
        xe = torch.randn(m_e, HIDDEN, generator=gen, device=dev)
        we = torch.randn(len(gs), HIDDEN, 2 * HIDDEN, generator=gen,
                         device=dev)
        got = kops.segment_matmul(xe, gs_t, we, impl="cuda")
        compare(torch, f"segment_matmul {label}", got,
                kops.segment_matmul(xe, gs_t, we, impl="ref"), torch.float32)
        if pad and not bool((got[m_e - pad:] == 0).all()):
            fail(f"segment_matmul {label}: rows past the groups are not 0")

    # segment_reduce on the ogbn-arxiv destinations (unpadded), and sddmm on
    # its (dst, src) pairs
    a_src = torch.from_numpy(g.edge_index[0]).to(dev)
    a_dst = torch.from_numpy(g.edge_index[1]).to(dev)
    a_v, a_e = g.num_nodes, g.num_edges
    for feat in (FEAT, HIDDEN):
        a_plan = make_plan(a_dst, a_v, feat=feat, device=dev)
        x32 = torch.randn(a_e, feat, generator=gen, device=dev)
        for dtype in (torch.float32, torch.bfloat16):
            x = x32.to(dtype)
            for reduce in ("sum", "mean", "max"):
                results[("srd", feat, dtype, reduce)] = run(
                    lambda: kops.segment_reduce(x, a_dst, a_v, reduce,
                                                plan=a_plan, impl="cuda"),
                    lambda: kops.segment_reduce(x, a_dst, a_v, reduce,
                                                impl="ref"),
                    f"segment_reduce {reduce} F={feat} M={a_e} S={a_v} "
                    f"{str(dtype)[6:]}", dtype,
                    lambda: kops.segment_reduce(x.float(), a_dst, a_v, reduce,
                                                impl="ref"))
    # yardstick: torch.segment_reduce with per-segment lengths (sum, F=64)
    lengths = torch.bincount(a_dst.long(), minlength=a_v)
    compare(torch, "torch.segment_reduce yardstick",
            torch.segment_reduce(x32, "sum", lengths=lengths),
            kops.segment_reduce(x32, a_dst, a_v, "sum", impl="ref"),
            torch.float32)
    library_srd_ms = time_ms(torch, lambda: torch.segment_reduce(
        x32, "sum", lengths=lengths))
    srd_plan_bytes = a_plan.chunk_first.numel() * 8
    del x32, x

    sd_a32 = torch.randn(a_v, HIDDEN, generator=gen, device=dev)
    sd_b32 = torch.randn(a_v, HIDDEN, generator=gen, device=dev)
    for dtype in (torch.float32, torch.bfloat16):
        sa, sb = sd_a32.to(dtype), sd_b32.to(dtype)
        results[("sddmm", dtype)] = run(
            lambda: sddmm_launch(sa, sb, a_dst, a_src),
            lambda: kops.sddmm(sa, sb, a_dst, a_src, impl="ref"),
            f"sddmm F={HIDDEN} M={a_e} pairs (dst, src) {str(dtype)[6:]}",
            dtype, lambda: kops.sddmm(sa.float(), sb.float(), a_dst, a_src,
                                      impl="ref"))
    compare(torch, "sddmm through its checked wrapper",
            kops.sddmm(sd_a32, sd_b32, a_dst, a_src, impl="cuda"),
            kops.sddmm(sd_a32, sd_b32, a_dst, a_src, impl="ref"),
            torch.float32)
    # yardstick: torch.sparse.sampled_addmm on the CSR of the (dst, src)
    # pattern; coalescing merges duplicate pairs, so it computes each
    # distinct pair once (timed only)
    mask = torch.sparse_coo_tensor(
        torch.stack([a_dst.long(), a_src.long()]),
        torch.ones(a_e, device=dev), (a_v, a_v)).coalesce().to_sparse_csr()
    sd_pairs = int(mask.values().numel())
    lib, reason = library("torch.sparse.sampled_addmm",
                          lambda: torch.sparse.sampled_addmm(
                              mask, sd_a32, sd_b32.t(), beta=0.0))
    if lib is not None:
        rows = torch.repeat_interleave(
            torch.arange(a_v, device=dev), mask.crow_indices().diff())
        compare(torch, "torch.sparse.sampled_addmm yardstick", lib.values(),
                kops.sddmm(sd_a32, sd_b32, rows, mask.col_indices(),
                           impl="ref"), torch.float32)
        library_sddmm = time_ms(torch, lambda: torch.sparse.sampled_addmm(
            mask, sd_a32, sd_b32.t(), beta=0.0))
        print(f"  torch.sparse.sampled_addmm ({sd_pairs} distinct pairs of "
              f"{a_e}): library_ms={library_sddmm:.4f}", flush=True)
        del rows
    else:
        library_sddmm = reason
    del mask, lib
    sd_rows = (int(torch.unique(a_dst).numel())
               + int(torch.unique(a_src).numel()))
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    print(f"typed-path and op kernel checks passed "
          f"({time.perf_counter() - t_phase:.1f} s)", flush=True)

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
    launches_serving = kops.launch_counts()
    print(f"serving passed ({time.perf_counter() - t_phase:.1f} s); "
          f"launches on the serving path: {launches_serving}", flush=True)

    # -- 3b. typed inference: rgcn and rgat on the AM-scale typed graph --------
    t_phase = time.perf_counter()
    am_x = torch.from_numpy(am.x).to(dev)
    am_ei = torch.from_numpy(am.edge_index).to(dev)
    am_typed = dict(edge_type=torch.from_numpy(am.edge_type).to(dev),
                    type_perm=torch.from_numpy(am.type_perm).to(dev),
                    inv_type_perm=am_inv, type_counts=sizes)
    am_rplan = am.make_relation_plan(feat=RGAT_HEADS * HIDDEN, device=dev)
    typed = []
    kops.reset_launch_counts()
    for family in gnn.TYPED_MODELS:
        n_heads = RGAT_HEADS if family == "rgat" else 1
        model = gnn.init(family, FEAT, HIDDEN, CLASSES, heads=n_heads,
                         num_relations=AM_RELATIONS, seed=SEED)

        def forward(impl=None):
            with torch.inference_mode():
                return rt.gnn_forward(model, am_x, am_ei, am.num_nodes,
                                      impl=impl, plan=am_plan, rplan=am_rplan,
                                      **am_typed)
        torch.cuda.reset_peak_memory_stats()
        before = kops.launch_counts()
        with kops.fusion_scope() as fusion:
            got = forward()
            torch.cuda.synchronize()
        after = kops.launch_counts()
        launched = {k: after[k] - before[k] for k in after}
        layers = len(model.layers)
        print(f"  {family} one forward launched {launched}; ops "
              f"{dict(fusion)}", flush=True)
        if any(not k.startswith("fused:") for k in fusion):
            fail(f"{family}: an op of the typed path took its plain version: "
                 f"{sorted(fusion)}")
        if launched["segment_matmul"] != layers:
            fail(f"{family}: {launched['segment_matmul']} segment_matmul "
                 f"launches for {layers} layers, expected one each")
        if launched["gather_segment_reduce"] < layers:
            fail(f"{family}: the gather kernel missed a layer")
        if family == "rgat" and launched["segment_softmax"] != layers:
            fail(f"{family}: {launched['segment_softmax']} softmax launches "
                 f"for {layers} layers")
        if got.shape != (am.num_nodes, CLASSES):
            fail(f"{family}: logits {tuple(got.shape)}")
        err = compare(torch, f"typed {family} on AM", got, forward("ref"),
                      torch.float32)
        fwd_ms = time_ms(torch, forward, reps=3, warmup=1)
        peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
        wall_ms, busy_ms, top = profiled(torch, forward)
        typed.append({"family": family, "heads": n_heads, "layers": layers,
                      "forward_ms": fwd_ms, "max_abs_err": err,
                      "peak_alloc_gib": peak_gb, "profiled_wall_ms": wall_ms,
                      "device_busy_ms": busy_ms or None})
        print(f"  typed {family} (heads={n_heads}) on AM: forward_ms="
              f"{fwd_ms:.3f} max_abs_err={err:.3g} peak_alloc_gib="
              f"{peak_gb:.2f}", flush=True)
        if busy_ms:
            print(f"  profiled {family} forward: wall_ms={wall_ms:.3f} "
                  f"device_busy_ms={busy_ms:.3f} idle_share="
                  f"{1 - busy_ms / wall_ms:.3f}; top device ops:", flush=True)
            for key, ms in top:
                print(f"    {ms:9.3f} ms  {key[:90]}", flush=True)
        else:
            print(f"  profiled {family} forward: device time not measured "
                  "(the profiler recorded no device events)", flush=True)
        del model, got
        torch.cuda.empty_cache()
    launches_typed = kops.launch_counts()
    print(f"typed inference passed ({time.perf_counter() - t_phase:.1f} s); "
          f"launches on the typed path: {launches_typed}", flush=True)
    print(json.dumps({"typed": typed}))
    del am_x, am_ei, am_typed

    # -- 3c. the public ops on card tensors ------------------------------------
    kops.reset_launch_counts()
    xo = torch.randn(a_e, HIDDEN, generator=gen, device=dev)
    for reduce in ("sum", "mean", "max"):
        compare(torch, f"rt.segment_reduce {reduce}",
                rt.segment_reduce(xo, a_dst, a_v, reduce),
                kops.segment_reduce(xo, a_dst, a_v, reduce, impl="ref"),
                torch.float32)
    compare(torch, "rt.sddmm", rt.sddmm(sd_a32, sd_b32, a_dst, a_src),
            kops.sddmm(sd_a32, sd_b32, a_dst, a_src, impl="ref"),
            torch.float32)
    launches_ops = kops.launch_counts()
    if launches_ops["segment_reduce"] != 3 or launches_ops["sddmm"] != 1:
        fail(f"the public ops missed their kernels: {launches_ops}")
    print(f"public ops passed; launches on the op path: {launches_ops}",
          flush=True)
    del xo

    # -- 4. the kernels line ----------------------------------------------------
    def bound(nbytes, flops):
        t_b, t_o = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS
        print(f"  bound: {nbytes} bytes, {flops} flops", flush=True)
        return (max(t_b, t_o) * 1e3, "bytes" if t_b >= t_o else "operations")

    print(f"bounds over {e_real} real edges, {h_rows} distinct source rows, "
          f"{v} output rows (gather, softmax, fused):", flush=True)

    meta = 2 * out_blocks * 4
    idx_bytes = e_real * (4 + 4 + 4)          # gather idx, segment, fp32 weight
    g_bound = bound(idx_bytes + h_rows * HIDDEN * 4 + v * HIDDEN * 4 + meta,
                    2 * e_real * HIDDEN)
    s_bound = bound(e_real * (4 + heads * 4) + e * heads * 4 + meta,
                    4 * e_real * heads)
    f_bound = bound(idx_bytes + h_rows * FEAT * 4 + FEAT * HIDDEN * 4
                    + v * HIDDEN * 4 + meta,
                    2 * e_real * FEAT + 2 * v * FEAT * HIDDEN)
    print(f"bounds of segment_matmul over M={m_typed} typed rows, "
          f"G={AM_RELATIONS} groups, {HIDDEN}->{HIDDEN}; segment_reduce over "
          f"M={a_e} rows into S={a_v}, F={HIDDEN}; sddmm over {a_e} pairs "
          f"reading {sd_rows} distinct rows of A and B, F={HIDDEN}:",
          flush=True)
    smm_meta = rplan.offsets.numel() * 4 + rplan.first_group.numel() * 8
    m_bound = bound(m_typed * HIDDEN * 4 * 2 + AM_RELATIONS * HIDDEN * HIDDEN
                    * 4 + smm_meta, 2 * m_typed * HIDDEN * HIDDEN)
    r_bound = bound(a_e * 4 + a_e * HIDDEN * 4 + a_v * HIDDEN * 4
                    + srd_plan_bytes, a_e * HIDDEN)
    d_bound = bound(a_e * 8 + sd_rows * HIDDEN * 4 + a_e * 4,
                    2 * a_e * HIDDEN)

    paths = {"serving": launches_serving, "typed": launches_typed,
             "ops": launches_ops}
    csrc = "src/repro_torch/kernels/csrc"

    def entry(name, replaces, res, bnd, library_ms, config, note=None):
        err, k_ms, p_ms = res
        out = {"name": name, "route": "cuda", "source": f"{csrc}/{name}.cu",
               "replaces": f"src/repro/kernels/{replaces}",
               "launches": sum(p[name] for p in paths.values()),
               "launches_by_path": {k: p[name] for k, p in paths.items()},
               "max_abs_err": err, "ms": k_ms, "kernel_ms": k_ms,
               "plain_ms": p_ms, "bound_ms": bnd[0], "bound_by": bnd[1],
               "library_ms": (library_ms if isinstance(library_ms, float)
                              else None), "config": config}
        if note or not isinstance(library_ms, float):
            out["library_note"] = note or library_ms
        return out

    smm_lib = library_smm[(HIDDEN, HIDDEN, torch.float32)]
    kernels = [
        entry("gather_segment_reduce", "gather_segment_reduce.py:277",
              results[(HIDDEN, torch.float32, "sum", True)], g_bound,
              library_gather_ms, f"weighted sum fp32 F={HIDDEN} at {bucket}",
              "torch.sparse.mm of the CSR of the real edges"),
        entry("segment_softmax", "segment_softmax.py:202",
              results[("softmax", torch.float32)], s_bound,
              library_softmax_ms, f"fp32 (E, {heads}) at {bucket}",
              "torch.sparse.softmax of a (V, E, heads) COO over dim 1"),
        entry("fused_transform_reduce", "fused_transform_reduce.py:171",
              results[("fused", FEAT, HIDDEN, torch.float32, "sum")],
              f_bound, None, f"weighted sum fp32 {FEAT}->{HIDDEN} at {bucket}",
              "no single PyTorch call: SpMM then GEMM is two calls"),
        entry("segment_matmul", "segment_matmul.py:149",
              results[("smm", HIDDEN, HIDDEN, torch.float32)], m_bound,
              smm_lib, f"fp32 {HIDDEN}->{HIDDEN}, M={m_typed} rows in "
              f"{AM_RELATIONS} groups (AM typed graph)",
              "torch._grouped_mm with the group offsets, same fp32 inputs"
              if isinstance(smm_lib, float) else None),
        entry("segment_reduce", "segment_reduce.py:266",
              results[("srd", HIDDEN, torch.float32, "sum")], r_bound,
              library_srd_ms, f"sum fp32 F={HIDDEN}, M={a_e} rows into "
              f"S={a_v} (ogbn-arxiv destinations)",
              "torch.segment_reduce with per-segment lengths"),
        entry("sddmm", "sddmm.py:98", results[("sddmm", torch.float32)],
              d_bound, library_sddmm, f"fp32 F={HIDDEN}, {a_e} (dst, src) "
              f"pairs of ogbn-arxiv",
              f"torch.sparse.sampled_addmm on the CSR of the pattern: "
              f"{sd_pairs} distinct pairs (duplicates merged)"
              if isinstance(library_sddmm, float) else None),
    ]
    print(json.dumps({"serving": serving}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
