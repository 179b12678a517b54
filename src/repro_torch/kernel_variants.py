"""Build-time variants of the redesigned CUDA kernels, timed on one card.

    python -m repro_torch.kernel_variants [--rounds 3] [--kernels a,b]

Compiles copies of ``kernels/csrc/segment_softmax.cu`` with ``RUN`` = 64,
128, 256 and 512, of ``segment_matmul.cu`` with its mma_sync path's ring
of ``STAGES`` = 2, 3 and 4 X stages and its wgmma path's tile width
``TC_BN`` = 64, 128 and 256, depth ``TC_BK`` = 64 and 128 and ring of
``TC_STAGES`` = 3, 4 and 5 stages, of ``fused_transform_reduce.cu`` with ``U`` = 2, 4
and 8 rows of H in flight a lane group (its product is the tensor-core one
only; it runs at the default tile, S_b = 64), of ``sddmm.cu`` with runs of
``RUN`` = 16, 32 and 64 pairs and ``LPR`` = 4, 8 and 16 lanes a row, and its
wide-row path's ``WIDE_PAIRS`` = 2, 4 and 8 pairs a warp and
``WIDE_LOADS`` = 1, 2 and 4 vectors of a row in flight a pair, and of ``gather_segment_reduce.cu``'s owner path
with ``OWN_ROWS`` = 4, 8 and 16 rows in flight a lane and
``OWN_VEC_BYTES`` = 4, 8 and 16 bytes of a row a lane owns (each
constant swept with the others at their shipped values; a variant is
named ``CONST=value``), each into a library of its own (nvcc with the
flags of ``kernels/_build.py``, all started together, into the build
directory), and times each through its C entry point at the shapes
``chip_smoke.py`` uses:

  * segment_softmax: fp32 and bf16 (E, 4) and fp32 (E,) at the ogbn-arxiv
    bucket, fp32 (E, 2) over the AM typed rows;
  * segment_matmul: the mma_sync path (STAGES) at fp32 and bf16 64->64 and
    64->128 over the AM typed rows; the wgmma path (TC_*) at bf16 64->64
    over the AM typed rows and at the MoE products of qwen3-moe-30b-a3b
    (2048->768 and 768->2048, 128 experts): 64 rows in 47 experts (a
    decode step), 16,384 rows (a training step) and 32,768 (a 4096-token
    prefill), W as (G, K, N) and, for the dX, as (G, N, K); and both
    paths at their shipped values in bf16 over the AM typed rows, at the
    typed widths (32->128, 64->16, 64->32, 64->64, 64->128) and at K =
    128 and 256 (which path the rule should give them);
  * fused_transform_reduce: weighted sum fp32 and bf16 32->64, fp32 64->64
    and 64->16, and mean fp32 32->64 at the ogbn-arxiv bucket, weighted
    sum fp32 32->64 at gcn's reddit2 request;
  * sddmm: the runs path (RUN, LPR) at fp32 and bf16 F=64 on arxiv's
    dst-sorted (dst, src) pairs, fp32 F=64 on the same pairs shuffled; the
    wide path (WIDE_*) at the MoE combine's router-weight gradient of
    qwen3-moe-30b-a3b's training step (2048 tokens, top-8: 16,384 pairs of
    F = 2048, rows token-sorted, columns a permutation) with A and B fp32,
    A fp32 and B bf16, both bf16; and both paths at their shipped values
    at widths 64 to 2048 on those pairs, and 64 to 512 on arxiv's, in fp32
    and bf16 (where the rule's WIDE_MIN_BYTES should lie);
  * gather_segment_reduce: the owner path (OWN_*) at the MoE combine of a
    decode step (64 bf16 rows of F = 2048 into 8 tokens, weighted sum)
    and at a hub of OWNER_MAX_ROWS rows; and both paths at their shipped
    values (the runs path with the row offsets it builds, and alone) at
    64 to 4096 rows, eight to a segment or all in one, at bf16 F = 2048
    and fp32 F = 64 (where the rule's OWNER_MAX_ROWS should lie).

Beside sddmm, and beside the fused kernel's fp32 32->64 at arxiv and
reddit2, it times the read probe ``csrc/probes/row_reads.cu`` at U = 1,
2, 4 and 8 rows in flight: a bare read of the same rows (sddmm's B rows
alone, and its A and B rows; the fused kernel's H rows of the real
edges) in the same order with the same 16-byte vectors, in runs of 32.
Its fastest time, printed beside, is what the card's L2 delivers for that
access pattern.

``--kernels`` names the kernels to build and time (all by default).

Each variant's result is held against the plain version (fp32 rtol 1e-4,
bf16 2e-2, atol the same times the largest magnitude). The variants of one
configuration are timed in turns, ``--rounds`` rounds of the median of 20
CUDA-event timings after 3 warm-ups, each behind a busy-wait kernel so host
launch time stays out; the median over the rounds is printed, with the
card's name and power limit. A variant that does not fit (a wgmma
ring above the 227 KB of shared memory) is reported and left out. The
shipped values are RUN = 128 (the softmax), RUN = 32 and LPR = 8,
WIDE_PAIRS = 4 and WIDE_LOADS = 1 (sddmm), STAGES = 2, TC_BN = 128,
TC_BK = 64, TC_STAGES = 5, U = 4 (the fused kernel), and OWN_ROWS = 8 and
OWN_VEC_BYTES = 16 (the gather's owner path). The gather's and
segment_reduce's run length and the fused
kernel's tile are no longer build-time variants: each is built for every
value of its config axis and picked at run time, and
:func:`repro_torch.core.autotune.tune` sweeps them (``chip_smoke.py``
phase 3f).
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

# for each kernel, the source lines a variant rewrites and the values each
# takes; each line is swept with the others at their shipped values. The
# fused kernel's U is its H rows in flight a lane group; sddmm's LPR its
# lanes a row (4: four 16-byte vectors a lane at F = 64 fp32, one pair's
# loads at a time; 16: one vector, four pairs')
VARIANTS = {
    "segment_softmax": [("constexpr int RUN = {};", (64, 128, 256, 512))],
    "segment_matmul": [("constexpr int STAGES = {};", (2, 3, 4)),
                       ("constexpr int TC_BN = {};", (64, 128, 256)),
                       ("constexpr int TC_BK = {};", (64, 128)),
                       ("constexpr int TC_STAGES = {};", (3, 4, 5))],
    "fused_transform_reduce": [("constexpr int U = {};", (2, 4, 8))],
    "sddmm": [("constexpr int RUN = {};", (16, 32, 64)),
              ("constexpr int LPR = {};", (4, 8, 16)),
              ("constexpr int WIDE_PAIRS = {};", (2, 4, 8)),
              ("constexpr int WIDE_LOADS = {};", (1, 2, 4))],
    "gather_segment_reduce": [("constexpr int OWN_ROWS = {};", (4, 8, 16)),
                              ("constexpr int OWN_VEC_BYTES = {};",
                               (4, 8, 16))]}
# prepended to a variant's source: the gather's variants time the owner path
# alone, so they build no run length of the runs path
PREAMBLE = {"gather_segment_reduce": "#define FOR_RUN_LENGTHS(X)\n"}
# the MoE combine of qwen3-moe-30b-a3b: a training step's 2048 tokens and a
# decode step's 8, top-8, d_model 2048
MOE_TOKENS, MOE_DECODE_TOKENS, MOE_TOP_K, MOE_D = 2048, 8, 8, 2048
# where the shape rules' thresholds are swept: sddmm's row widths, the
# gather's row counts
SDDMM_WIDTHS = (64, 128, 192, 256, 384, 512, 1024, 2048)
GATHER_ROWS = (64, 128, 256, 512, 1024, 2048, 4096)
# rows in flight of the read probe (csrc/probes/row_reads.cu), and the
# rows of a lane group's run (sddmm's RUN)
PROBE_U, PROBE_RUN = (1, 2, 4, 8), 32
# dtype, a, row, b, col, out, m, n, run, u, stream
PROBE_SIGNATURE = {"rows_launch": [ctypes.c_int, *[ctypes.c_void_p] * 5,
                                   ctypes.c_int64, ctypes.c_int, ctypes.c_int,
                                   ctypes.c_int, ctypes.c_void_p]}


def _const(line: str) -> str:
    return line.split()[2]


def variant_keys(name):
    """The keys "CONST=value" of ``name``'s variants, in order."""
    return [f"{_const(line)}={v}" for line, values in VARIANTS[name]
            for v in values]


def _nvcc(_build, cu, so):
    cmd = [_build.nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o",
           str(so), str(cu)]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def shipped_values(_build, name) -> dict:
    """{CONST: value} of every line swept for ``name``, as its source has
    them."""
    src = (_build.CSRC / f"{name}.cu").read_text()
    shipped = {}
    for line, values in VARIANTS[name]:
        found = [v for v in values if line.format(v) in src]
        if len(found) != 1:
            sys.exit(f"kernel_variants: {name}.cu has no line "
                     f"{line.format('N')!r} with one of {values}")
        shipped[_const(line)] = found[0]
    return shipped


def build_variants(_build, names, probe=False):
    """{(name, "CONST=value"): (loaded library, {CONST: value} of every
    line swept for ``name``)}, compiled in parallel; with ``probe``, also
    the read probe under ("probe", "")."""
    out_dir = _build.build_dir() / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        src = (_build.CSRC / f"{name}.cu").read_text()
        shipped = shipped_values(_build, name)
        for line, values in VARIANTS[name]:
            const = _const(line)
            for v in values:
                stem = f"{name}_{const}{v}"
                cu = out_dir / f"{stem}.cu"
                cu.write_text(PREAMBLE.get(name, "") + src.replace(
                    line.format(shipped[const]), line.format(v)))
                so = out_dir / f"{stem}.so"
                procs[(name, f"{const}={v}")] = (
                    so, {**shipped, const: v}, _nvcc(_build, cu, so))
    if probe:
        so = out_dir / "row_reads.so"
        procs[("probe", "")] = (so, {}, _nvcc(
            _build, _build.CSRC / "probes" / "row_reads.cu", so))
    libs = {}
    for (name, key), (so, setting, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            sys.exit(f"kernel_variants: nvcc {name} {key} failed:\n{log}")
        lib = ctypes.CDLL(str(so))
        sigs = PROBE_SIGNATURE if name == "probe" else _build.SIGNATURES[name]
        for fn, argtypes in sigs.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        libs[(name, key)] = (lib, setting)
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
    from repro_torch.core.config_space import DEFAULT_S_B, default_config
    from repro_torch.data.graphs import dataset, synth_typed_graph
    from repro_torch.kernels import _build
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels.gather_segment_reduce import DTYPE_CODE
    from repro_torch.serve import pad_to_bucket
    from repro_torch.serve.plan_cache import BucketEntry

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    libs = build_variants(_build, names, probe=not {
        "fused_transform_reduce", "sddmm"}.isdisjoint(names))
    print(f"built {len(libs)} variants", flush=True)
    ptr, stream = _build.ptr, _build.stream_of
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def timed(what, calls, want, dtype, beside=None):
        """Checks every variant against `want`, then times them in turns,
        and the calls of `beside` (checked by their maker) with them."""
        for v, fn in calls.items():
            got = fn()
            torch.cuda.synchronize()
            check(f"{what} variant {v}", got, want, dtype)
        calls = {**calls, **(beside or {})}
        rounds = {v: [] for v in calls}
        for _ in range(args.rounds):
            for v, fn in calls.items():
                rounds[v].append(time_ms(fn))
        ms = {v: statistics.median(t) for v, t in rounds.items()}
        cells = " ".join(f"{v}={t:.4f}" for v, t in ms.items())
        print(f"  {what}: {cells} (ms, median of {args.rounds} rounds)",
              flush=True)
        return ms

    def reads(u, a, row, b, col, out):
        lib, _ = libs[("probe", "")]
        _build.check(lib.rows_launch(
            DTYPE_CODE[b.dtype], None if a is None else ptr(a),
            None if row is None else ptr(row), ptr(b), ptr(col), ptr(out),
            int(col.numel()), int(b.shape[1]), PROBE_RUN, u, stream(b)),
            f"read probe U={u}")
        return out

    def probe_calls(label, b, col, a=None, row=None):
        """The read probe of the rows b[col] (and a[row]) at each U, named
        "label U=u", checked: the words it writes sum to the sum of the B
        rows (of the products of A and B rows) it reads."""
        m = int(col.numel())
        out = torch.empty(-(-m // PROBE_RUN) * (b.shape[1] * b.element_size()
                                                 // 16),
                          dtype=torch.float32, device=dev)
        terms = b.float().index_select(0, col.long())
        if a is not None:
            terms *= a.float().index_select(0, row.long())
        want, scale = float(terms.double().sum()), float(terms.abs().sum())
        del terms
        calls = {}
        for u in PROBE_U:
            got = float(reads(u, a, row, b, col, out).double().sum())
            if abs(got - want) > 1e-5 * scale:
                sys.exit(f"kernel_variants: the read probe {label} U={u} "
                         f"summed {got}, its rows sum to {want}")
            calls[f"{label} U={u}"] = (lambda u=u: reads(u, a, row, b, col,
                                                         out))
        return calls

    def ceiling(ms, label, b=None, col=None):
        """Prints the fastest read probe `label` of `ms`, and the rate of
        the rows b[col] it read."""
        u, t = min(((k, t) for k, t in ms.items() if k.startswith(label)),
                   key=lambda kt: kt[1])
        rate = ""
        if b is not None:
            nbytes = int(col.numel()) * b.shape[1] * b.element_size()
            rate = f", {nbytes} B at {nbytes / t / 1e9:.2f} TB/s"
        print(f"    {label} alone: {u} {t:.4f} ms{rate}", flush=True)

    def smm_tc(key, x, w, off, n, w_kn):
        """The wgmma path of variant `key`; None where its launch is
        refused (a ring that does not fit)."""
        lib, _ = libs[("segment_matmul", key)]
        out = torch.empty((int(x.shape[0]), n), dtype=x.dtype, device=dev)
        err = lib.smm_tc_launch(ptr(x), ptr(w), ptr(off), ptr(out),
                                int(x.shape[0]), int(x.shape[1]), n,
                                int(w.shape[0]), w_kn, stream(x))
        return None if err else out

    def timed_tc(what, keys, x, w, off, n, w_kn, want):
        """`timed` over the wgmma variants of `keys` that launch and agree
        with `want` (each one left out is reported)."""
        calls = {}
        for key in keys:
            got = smm_tc(key, x, w, off, n, w_kn)
            torch.cuda.synchronize()
            if got is None:
                print(f"  {what}: {key} refused at launch (shared memory)",
                      flush=True)
                continue
            err = float((got.float() - want).abs().max())
            if not err <= 2e-2 * max(float(want.abs().max()), 1e-30):
                print(f"  {what}: {key} disagrees with the plain version "
                      f"(max abs error {err:.4g}); left out", flush=True)
                continue
            calls[key] = (lambda key=key: smm_tc(key, x, w, off, n, w_kn))
        return timed(what, calls, want, x.dtype)

    def smm(key, x, w, rplan):
        lib, _ = libs[("segment_matmul", key)]
        m, k = (int(d) for d in x.shape)
        g, n = int(w.shape[0]), int(w.shape[2])
        out = torch.empty((m, n), dtype=x.dtype, device=dev)
        _build.check(lib.smm_launch(
            DTYPE_CODE[x.dtype], ptr(x), ptr(w), ptr(rplan.offsets),
            ptr(rplan.first_group), ptr(rplan.group_count), ptr(out), m, k,
            n, g, rplan.config.m_b, stream(x)), f"segment_matmul variant "
            f"{key}")
        return out

    def ssm(key, x, seg, num_segments, row_ptr):
        lib, cfg = libs[("segment_softmax", key)]
        run = cfg["RUN"]
        num_rows = int(x.shape[0])
        heads = 1 if x.dim() == 1 else int(x.shape[1])
        out = torch.empty_like(x)
        part = torch.empty((-(-num_rows // run), 2, 2, heads),
                           dtype=torch.float32, device=dev)
        _build.check(lib.ssm_launch(
            DTYPE_CODE[x.dtype], ptr(x), ptr(seg), ptr(row_ptr), ptr(part),
            ptr(out), num_rows, heads, num_segments, run, stream(x)),
            f"segment_softmax variant {key}")
        return out

    def ftr(key, h, wm, gidx, seg, num_segments, weight, mean, row_ptr):
        lib, _ = libs[("fused_transform_reduce", key)]
        out = torch.empty((num_segments, int(wm.shape[1])), dtype=h.dtype,
                          device=dev)
        _build.check(lib.ftr_launch(
            DTYPE_CODE[h.dtype], int(mean), int(weight is not None), ptr(h),
            ptr(wm), ptr(gidx), ptr(h if weight is None else weight),
            ptr(row_ptr), ptr(out), int(h.shape[1]), int(wm.shape[1]),
            num_segments, DEFAULT_S_B, stream(h)), f"fused variant {key}")
        return out

    def sdd(key, a, b, row, col):
        lib, _ = libs[("sddmm", key)]
        out = torch.empty(int(row.numel()), dtype=a.dtype, device=dev)
        _build.check(lib.sddmm_launch(
            DTYPE_CODE[a.dtype], ptr(a), ptr(b), ptr(row), ptr(col), ptr(out),
            int(row.numel()), int(a.shape[1]), stream(a)),
            f"sddmm variant {key}")
        return out

    g = dataset("ogbn-arxiv", feat=FEAT, seed=SEED)
    padded, bucket = pad_to_bucket(g)
    v = bucket.num_nodes
    src = torch.from_numpy(padded.edge_index[0]).to(dev).int().contiguous()
    dst = torch.from_numpy(padded.edge_index[1]).to(dev).int().contiguous()
    plan = BucketEntry(bucket, HIDDEN, default_config(HIDDEN)).stamp(dst)
    if "segment_softmax" in names:
        runs = variant_keys("segment_softmax")
        print(f"segment_softmax, variants {runs}:", flush=True)
        logits = torch.randn(dst.numel(), 4, generator=gen, device=dev) * 5
        for x in (logits, logits.bfloat16(), logits[:, 0].contiguous()):
            timed(f"{str(x.dtype)[6:]} {tuple(x.shape)} at {bucket}",
                  {r: (lambda r=r: ssm(r, x, dst, v, plan.row_ptr))
                   for r in runs},
                  kops.segment_softmax(x.float(), dst, v, impl="ref"),
                  x.dtype)
        del logits, x
    if "fused_transform_reduce" in names:
        tiles = variant_keys("fused_transform_reduce")
        wts = torch.rand(dst.numel(), generator=gen, device=dev)
        e_real = int(plan.row_ptr[-1])
        print(f"fused_transform_reduce at {bucket}, variants {tiles}:",
              flush=True)
        for d_in, d_out, dtype, mean in (
                (FEAT, HIDDEN, torch.float32, False),
                (FEAT, HIDDEN, torch.bfloat16, False),
                (HIDDEN, HIDDEN, torch.float32, False),
                (HIDDEN, 16, torch.float32, False),
                (FEAT, HIDDEN, torch.float32, True)):
            h = torch.randn(v, d_in, generator=gen, device=dev).to(dtype)
            wm = (torch.randn(d_in, d_out, generator=gen, device=dev)
                  / d_in ** 0.5).to(dtype)
            w = None if mean else wts.to(dtype)
            reduce = "mean" if mean else "sum"
            # beside the first: the H rows of the real edges alone
            first = (d_in, d_out, dtype, mean) == (FEAT, HIDDEN,
                                                   torch.float32, False)
            ms = timed(f"{reduce}{'' if mean else ' weighted'} "
                       f"{str(dtype)[6:]} {d_in}->{d_out}",
                       {t: (lambda t=t: ftr(t, h, wm, src, dst, v, w, mean,
                                            plan.row_ptr)) for t in tiles},
                       kops.fused_transform_reduce(
                           h.float(), wm.float(), src, dst, v,
                           None if w is None else w.float(), reduce,
                           impl="ref"),
                       dtype,
                       probe_calls("H rows", h, src[:e_real]) if first
                       else None)
            if first:
                ceiling(ms, "H rows", h, src[:e_real])
        del h, wm, w, wts
        # gcn's reddit2 request: the largest fused launch of the serving path
        r2 = dataset("reddit2", feat=FEAT, seed=SEED)
        r2_pad, r2_bucket = pad_to_bucket(r2)
        r2_v = r2_bucket.num_nodes
        r2_src = torch.from_numpy(r2_pad.edge_index[0]).to(dev).int()
        r2_dst = torch.from_numpy(r2_pad.edge_index[1]).to(dev).int()
        r2_plan = BucketEntry(r2_bucket, HIDDEN,
                              default_config(HIDDEN)).stamp(r2_dst)
        r2_w = torch.rand(r2_dst.numel(), generator=gen, device=dev)
        h = torch.randn(r2_v, FEAT, generator=gen, device=dev)
        wm = torch.randn(FEAT, HIDDEN, generator=gen, device=dev) / FEAT ** 0.5
        r2_real = r2_src[:r2.num_edges]
        ms = timed(f"sum weighted float32 {FEAT}->{HIDDEN} reddit2 at "
                   f"{r2_bucket}",
                   {t: (lambda t=t: ftr(t, h, wm, r2_src, r2_dst, r2_v, r2_w,
                                        False, r2_plan.row_ptr))
                    for t in tiles},
                   kops.fused_transform_reduce(h, wm, r2_src, r2_dst, r2_v,
                                               r2_w, "sum", impl="ref"),
                   torch.float32, probe_calls("H rows", h, r2_real))
        ceiling(ms, "H rows", h, r2_real)
        del r2, r2_pad, r2_src, r2_dst, r2_plan, r2_w, h, wm, r2_real
    if "sddmm" in names:
        a_dst = torch.from_numpy(g.edge_index[1]).to(dev).int().contiguous()
        a_src = torch.from_numpy(g.edge_index[0]).to(dev).int().contiguous()
    if "sddmm" in names:
        runs = [k for k in variant_keys("sddmm") if not k.startswith("WIDE")]
        print(f"sddmm on arxiv's (dst, src) pairs, variants {runs}:",
              flush=True)
        perm = torch.randperm(a_dst.numel(), generator=gen, device=dev)
        sa = torch.randn(g.num_nodes, HIDDEN, generator=gen, device=dev)
        sb = torch.randn(g.num_nodes, HIDDEN, generator=gen, device=dev)
        for dtype, order in ((torch.float32, "dst-sorted"),
                             (torch.bfloat16, "dst-sorted"),
                             (torch.float32, "shuffled")):
            rows, cols = ((a_dst, a_src) if order == "dst-sorted" else
                          (a_dst[perm].contiguous(), a_src[perm].contiguous()))
            a, b = sa.to(dtype), sb.to(dtype)
            # beside them: the B rows of the pairs alone, and the A and B
            # rows (an A row where it changes within a run, as sddmm)
            ms = timed(f"{str(dtype)[6:]} F={HIDDEN} {order}",
                       {r: (lambda r=r: sdd(r, a, b, rows, cols))
                        for r in runs},
                       kops.sddmm(a.float(), b.float(), rows, cols,
                                  impl="ref"),
                       dtype, {**probe_calls("B rows", b, cols),
                               **probe_calls("A+B rows", b, cols, a, rows)})
            ceiling(ms, "B rows", b, cols)
            ceiling(ms, "A+B rows")
        del perm, sa, sb, a, b, rows, cols
        sddmm_wide(libs, timed, gen, dev, (g.num_nodes, a_dst, a_src))
    if "gather_segment_reduce" in names:
        gather_owner(libs, timed, gen, dev)
    del plan, src, dst

    typed = {"segment_softmax", "segment_matmul"}
    if typed.isdisjoint(names):
        print(card, flush=True)
        return
    am = synth_typed_graph("am", AM_NODES, AM_EDGES,
                           num_relations=AM_RELATIONS, feat=FEAT, seed=SEED)
    m = am.num_edges
    am_dst = torch.from_numpy(am.edge_index[1]).to(dev).int().contiguous()
    am_plan = am.make_plan(feat=HIDDEN, device=dev)
    if "segment_softmax" in names:
        runs = variant_keys("segment_softmax")
        x = torch.randn(m, 2, generator=gen, device=dev) * 5
        timed(f"typed softmax float32 (E={m}, 2) into {am.num_nodes} rows",
              {r: (lambda r=r: ssm(r, x, am_dst, am.num_nodes,
                                   am_plan.row_ptr)) for r in runs},
              kops.segment_softmax(x, am_dst, am.num_nodes, impl="ref"),
              torch.float32)
        del x
    if "segment_matmul" in names:
        keys = variant_keys("segment_matmul")
        stages = [k for k in keys if k.startswith("STAGES=")]
        tc_keys = [k for k in keys if k.startswith("TC_")]
        sizes = torch.from_numpy(am.type_counts).to(dev)
        rplan = am.make_relation_plan(feat=HIDDEN, device=dev)
        print(f"segment_matmul over M={m} rows in {AM_RELATIONS} groups, "
              f"mma_sync variants {stages}:", flush=True)
        for k, n in ((HIDDEN, HIDDEN), (HIDDEN, 2 * HIDDEN)):
            x32 = torch.randn(m, k, generator=gen, device=dev)
            w32 = torch.randn(AM_RELATIONS, k, n, generator=gen,
                              device=dev) / k ** 0.5
            for dtype in (torch.float32, torch.bfloat16):
                x, w = x32.to(dtype), w32.to(dtype)
                want = kops.segment_matmul(x.float(), sizes, w.float(),
                                           impl="ref")
                timed(f"{k}->{n} {str(dtype)[6:]}",
                      {s: (lambda s=s: smm(s, x, w, rplan)) for s in stages},
                      want, dtype)
                if dtype == torch.bfloat16 and n == HIDDEN:
                    timed_tc(f"{k}->{n} bf16 on the wgmma path", tc_keys, x,
                             w, rplan.offsets, n, 1, want)
                del x, w, want
            del x32, w32
        # where the rule should send bf16 (segment_matmul.TC_MIN_N): both
        # paths at their shipped values
        shipped = shipped_values(_build, "segment_matmul")
        ship = {p: next(v for v in keys if v.startswith(p) and
                        libs[("segment_matmul", v)][1] == shipped)
                for p in ("STAGES", "TC")}
        print(f"segment_matmul bf16 over M={m} rows, mma_sync "
              f"({ship['STAGES']}) against wgmma ({ship['TC']}), shipped "
              f"values, at the typed widths and deeper K:", flush=True)
        for k, n in ((32, 128), (64, 16), (64, 32), (64, 64), (64, 128),
                     (128, 64), (256, 64)):
            x = torch.randn(m, k, generator=gen, device=dev).bfloat16()
            w = (torch.randn(AM_RELATIONS, k, n, generator=gen,
                             device=dev) / k ** 0.5).bfloat16()
            want = kops.segment_matmul(x.float(), sizes, w.float(),
                                       impl="ref")
            timed(f"{k}->{n} bf16",
                  {"mma_sync": lambda: smm(ship["STAGES"], x, w, rplan),
                   "wgmma": lambda: smm_tc(ship["TC"], x, w, rplan.offsets,
                                           n, 1)}, want, torch.bfloat16)
            del x, w, want
        smm_moe(tc_keys, smm_tc, timed_tc, gen, dev)
    print(card, flush=True)


def moe_pairs(gen, tokens, dev):
    """The MoE combine's (token, row) pairs: tokens sorted, MOE_TOP_K to a
    token; the rows of the expert outputs a permutation (their order
    sorted by expert), int32 on ``dev``."""
    tok = torch.arange(tokens, dtype=torch.int32, device=dev
                       ).repeat_interleave(MOE_TOP_K)
    inv = torch.randperm(tok.numel(), generator=gen, device=dev)
    return tok, inv.to(torch.int32)


def _dt(t) -> str:
    return str(t.dtype)[6:]


def sddmm_wide(libs, timed, gen, dev, arxiv):
    """sddmm's wide-path variants at the combine's router-weight gradient,
    then both paths at their shipped values across row widths. ``arxiv``:
    (rows, dst, src) of its pairs."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import sddmm as sdd

    keys = [k for k in variant_keys("sddmm") if k.startswith("WIDE")]
    tok, inv = moe_pairs(gen, MOE_TOKENS, dev)
    print(f"sddmm wide path at the MoE combine's router-weight gradient "
          f"({tok.numel()} pairs of F={MOE_D}, token-sorted rows), variants "
          f"{keys}:", flush=True)
    g32 = torch.randn(MOE_TOKENS, MOE_D, generator=gen, device=dev)
    ys = torch.randn(tok.numel(), MOE_D, generator=gen, device=dev)
    for a, b in ((g32, ys), (g32, ys.bfloat16()),
                 (g32.bfloat16(), ys.bfloat16())):
        timed(f"A {_dt(a)} B {_dt(b)}",
              {k: (lambda k=k: sdd.c_entry("wide", a, b, tok, inv,
                                           libs[("sddmm", k)][0]))
               for k in keys},
              sdd.sddmm_ref(a.float(), b.float(), tok, inv), a.dtype)
    del g32, ys, a, b
    lib = _build.load("sddmm")
    print("sddmm runs path against wide path, shipped values, by row width "
          f"(the rule: wide above {sdd.WIDE_MIN_BYTES} bytes a row):",
          flush=True)
    rows, a_dst, a_src = arxiv
    for label, rows_a, row, rows_b, col, widths in (
            ("MoE combine pairs", MOE_TOKENS, tok, int(tok.numel()), inv,
             SDDMM_WIDTHS),
            ("arxiv (dst, src) pairs", rows, a_dst, rows, a_src,
             [f for f in SDDMM_WIDTHS if f <= 512])):
        for f in widths:
            for dtype in (torch.float32, torch.bfloat16):
                a = torch.randn(rows_a, f, generator=gen, device=dev).to(dtype)
                b = torch.randn(rows_b, f, generator=gen, device=dev).to(dtype)
                timed(f"{label} F={f} {_dt(a)} (rule: "
                      f"{sdd.path(f, dtype)})",
                      {p: (lambda p=p: sdd.c_entry(p, a, b, row, col, lib))
                       for p in ("runs", "wide")},
                      sdd.sddmm_ref(a.float(), b.float(), row, col), dtype)
                del a, b


def gather_owner(libs, timed, gen, dev):
    """The gather's owner-path variants at the decode combine and at a hub
    of OWNER_MAX_ROWS rows, then both paths at their shipped values across
    row counts: the owner path, the runs path with the row offsets it
    builds without a plan (as the op runs it), and the runs kernel alone
    on offsets given (a plan's)."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import gather_segment_reduce as gsr

    def owner(lib, h, gidx, seg, s, w):
        return gsr.c_entry("owner", h, gidx, seg, s, w, lib=lib)

    def runs(h, gidx, seg, s, w, row_ptr=None):
        rp = gsr.row_offsets(seg, s) if row_ptr is None else row_ptr
        return gsr.c_entry("runs", h, gidx, seg, s, w, row_ptr=rp)

    def case(n, f, dtype, hub):
        """n rows of F = f into n / 8 segments (at least one), eight to a
        segment or, ``hub``, all in the first; a permutation gathers them."""
        s = max(n // MOE_TOP_K, 1)
        seg = (torch.zeros(n, dtype=torch.int32, device=dev) if hub else
               torch.arange(s, dtype=torch.int32, device=dev
                            ).repeat_interleave(MOE_TOP_K)[:n])
        gidx = torch.randperm(n, generator=gen, device=dev).to(torch.int32)
        h = torch.randn(n, f, generator=gen, device=dev).to(dtype)
        w = torch.rand(n, generator=gen, device=dev).to(dtype)
        want = gsr.gather_segment_reduce_ref(h.float(), gidx, seg, s,
                                             w.float())
        return h, gidx, seg, s, w, want

    keys = variant_keys("gather_segment_reduce")
    print(f"gather_segment_reduce owner path, variants {keys}:", flush=True)
    tok, inv = moe_pairs(gen, MOE_DECODE_TOKENS, dev)
    n = int(tok.numel())
    ys = torch.randn(n, MOE_D, generator=gen, device=dev).bfloat16()
    w = torch.rand(n, generator=gen, device=dev).bfloat16()
    timed(f"decode combine: {n} bf16 rows of F={MOE_D} into "
          f"{MOE_DECODE_TOKENS} tokens, weighted sum",
          {k: (lambda k=k: owner(libs[("gather_segment_reduce", k)][0], ys,
                                 inv, tok, MOE_DECODE_TOKENS, w))
           for k in keys},
          gsr.gather_segment_reduce_ref(ys.float(), inv, tok,
                                        MOE_DECODE_TOKENS, w.float()),
          torch.bfloat16)
    h, gidx, seg, s, w, want = case(gsr.OWNER_MAX_ROWS, MOE_D,
                                    torch.bfloat16, True)
    timed(f"a hub of {gsr.OWNER_MAX_ROWS} bf16 rows of F={MOE_D}, weighted "
          "sum",
          {k: (lambda k=k: owner(libs[("gather_segment_reduce", k)][0], h,
                                 gidx, seg, s, w)) for k in keys},
          want, torch.bfloat16)
    lib = _build.load("gather_segment_reduce")
    print("gather_segment_reduce owner path against the runs path, shipped "
          f"values, by rows (the rule: owner up to {gsr.OWNER_MAX_ROWS}):",
          flush=True)
    for f, dtype in ((MOE_D, torch.bfloat16), (64, torch.float32)):
        for n in GATHER_ROWS:
            for hub in (False, True):
                h, gidx, seg, s, w, want = case(n, f, dtype, hub)
                rp = gsr.row_offsets(seg, s)
                timed(f"{n} {_dt(h)} rows of F={f} "
                      f"{'in one segment' if hub else 'eight to a segment'} "
                      f"(rule: {gsr.path(n)})",
                      {"owner": lambda: owner(lib, h, gidx, seg, s, w),
                       "runs with offsets": lambda: runs(h, gidx, seg, s, w),
                       "runs kernel": lambda: runs(h, gidx, seg, s, w, rp)},
                      want, dtype)


def moe_sizes(gen, rows, groups, active, dev):
    """``rows`` rows routed over ``active`` of ``groups`` experts (each at
    least one), drawn from ``gen``: int32 sizes on ``dev``."""
    pick = torch.randperm(groups, generator=gen, device=dev)[:active]
    extra = torch.multinomial(torch.ones(active, device=dev), rows - active,
                              replacement=True, generator=gen)
    sizes = torch.zeros(groups, dtype=torch.int64, device=dev)
    sizes[pick] = 1 + torch.bincount(extra, minlength=active)
    return sizes.to(torch.int32)


def smm_moe(tc_keys, smm_tc, timed_tc, gen, dev):
    """The wgmma variants at qwen3-moe-30b-a3b's products (128 experts,
    d_model 2048, d_ff 768): a decode step's 64 rows in 47 experts, a
    training step's 16,384 rows and a 4096-token prefill's 32,768 in all,
    W as (G, K, N) and as (G, N, K)."""
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels.segment_matmul import group_metadata
    print(f"segment_matmul at the MoE products, wgmma variants {tc_keys}:",
          flush=True)
    for rows, active in ((64, 47), (16384, 128), (32768, 128)):
        sizes = moe_sizes(gen, rows, 128, active, dev)
        off = group_metadata(sizes, rows, 64)[0]
        for k, n in ((2048, 768), (768, 2048)):
            x = torch.randn(rows, k, generator=gen, device=dev).bfloat16()
            w = (torch.randn(128, k, n, generator=gen, device=dev)
                 / k ** 0.5).bfloat16()
            want = kops.segment_matmul(x.float(), sizes, w.float(),
                                       impl="ref")
            timed_tc(f"{rows} rows in {active} experts {k}->{n} W (G, K, N)",
                     tc_keys, x, w, off, n, 1, want)
            wt = w.transpose(1, 2).contiguous()
            timed_tc(f"{rows} rows in {active} experts {k}->{n} W (G, N, K)",
                     tc_keys, x, wt, off, n, 0, want)
            del x, w, wt, want


if __name__ == "__main__":
    main()
