"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs an NVIDIA GPU with the CUDA toolkit (the kernels are
built with nvcc on first use) and skips elsewhere. Run them on the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: fp32 ``rtol=1e-4, atol=1e-4·max|plain|`` (the kernel sums each
segment in row order, the plain version in index_add_'s order); bf16
``rtol=2e-2, atol=2e-2·max|plain|`` against the fp32 plain version of the
same upcast inputs (the output is rounded to 8 mantissa bits).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch as rt  # noqa: E402
from repro_torch.core.config_space import KernelConfig  # noqa: E402
from repro_torch.core.plan import make_plan  # noqa: E402
from repro_torch.data.graphs import dataset  # noqa: E402
from repro_torch.kernels import gather_segment_reduce as gsr  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.kernels.fused_transform_reduce import fusable  # noqa: E402
from repro_torch.models import gnn  # noqa: E402

pytestmark = pytest.mark.cuda

DTYPES = [torch.float32, torch.bfloat16]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels run only on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _close(got, want, dtype):
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    want = want.float()
    finite = want[torch.isfinite(want)]
    scale = float(finite.abs().max()) if finite.numel() else 0.0
    torch.testing.assert_close(got.float(), want, rtol=tol,
                               atol=tol * max(scale, 1.0), equal_nan=True)


def _graph(dev, v, e, f, seed, gapped=False, pad=0, hub=0):
    """Sorted dst (optionally gapped), src, x (v, f), w (e,), plus ``hub``
    extra rows into segment v // 2 and ``pad`` drop-id rows (dst = v) at
    the end."""
    rng = np.random.default_rng(seed)
    dst = np.sort(np.concatenate([rng.integers(0, v, e),
                                  np.full(hub, v // 2)]))
    if gapped:
        dst = dst - dst % 3
    dst = np.concatenate([dst, np.full(pad, v)]).astype(np.int32)
    e += hub
    src = rng.integers(0, v, e + pad).astype(np.int32)
    x = rng.standard_normal((v, f)).astype(np.float32)
    w = rng.standard_normal(e + pad).astype(np.float32)
    t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    return t(src), t(dst), t(x), t(w)


# each built run length (the config's m_b) runs on some shape
SHAPES = [
    dict(v=700, e=3400, f=12, cfg=KernelConfig("SR", 64, 128, 64, 1)),
    dict(v=5000, e=40000, f=64, cfg=KernelConfig("SR", 32, 256, 128, 1)),
    # num_segments % s_b != 0, gapped ids, padding rows, F above one block
    dict(v=1001, e=6000, f=300, cfg=KernelConfig("SR", 32, 128, 256, 1),
         gapped=True, pad=77),
    # a hub of 100,000 rows (1,563 runs of 64) amid short segments
    dict(v=3000, e=20000, f=16, cfg=KernelConfig("SR", 32, 128, 64, 1),
         hub=100_000),
    # widths that are not a multiple of the 16-byte vector
    dict(v=2000, e=15000, f=40, cfg=KernelConfig("SR", 32, 128, 128, 1),
         gapped=True, pad=50),
    dict(v=2000, e=15000, f=3, cfg=KernelConfig("SR", 32, 128, 256, 1),
         pad=5),
    # rows the whole-row schedule walks in one go (row_runs.cuh): SAGE's
    # classes on Reddit2 (41) and ogbn-products (47) with gapped ids,
    # padding rows and a hub, PPI's 121 (32 lanes of 4 scalars), 66 (8-byte
    # fp32 and 4-byte bf16 vectors); 132 takes 8-byte bf16 vectors whole
    # and 16-byte fp32 ones in two tiles
    dict(v=2000, e=15000, f=41, cfg=KernelConfig("SR", 32, 128, 64, 1),
         gapped=True, pad=50, hub=20_000),
    dict(v=2000, e=15000, f=47, cfg=KernelConfig("SR", 32, 128, 128, 1),
         gapped=True, pad=33, hub=20_000),
    dict(v=1500, e=12000, f=121, cfg=KernelConfig("SR", 32, 128, 256, 1),
         pad=7),
    dict(v=1500, e=12000, f=66, cfg=KernelConfig("SR", 32, 128, 64, 1),
         gapped=True, hub=3000),
    dict(v=1500, e=12000, f=132, cfg=KernelConfig("SR", 32, 128, 128, 1),
         pad=11),
]


@pytest.mark.parametrize("shape", range(len(SHAPES)))
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("reduce", ["sum", "mean", "max"])
@pytest.mark.parametrize("weighted", [False, True])
def test_gather_segment_reduce_kernel(dev, shape, dtype, reduce, weighted):
    s = SHAPES[shape]
    src, dst, x, w = _graph(dev, s["v"], s["e"], s["f"], seed=shape,
                            gapped=s.get("gapped", False), pad=s.get("pad", 0),
                            hub=s.get("hub", 0))
    plan = make_plan(dst, s["v"], config=s["cfg"])
    xi = x.to(dtype)
    wi = w.to(dtype) if weighted else None
    before = kops.launch_counts()["gather_segment_reduce"]
    walks = kops.schedule_launch_counts()["gather_segment_reduce"]
    got = kops.gather_segment_reduce(xi, src, dst, s["v"], weight=wi,
                                     reduce=reduce, plan=plan, impl="cuda")
    torch.cuda.synchronize()
    assert kops.launch_counts()["gather_segment_reduce"] == before + 1
    took = gsr.schedule(s["f"], dtype, gsr.alignment(xi, got))
    assert kops.schedule_launch_counts()["gather_segment_reduce"] == {
        **walks, took: walks[took] + 1}
    assert got.dtype == dtype and got.shape == (s["v"], s["f"])
    want = kops.gather_segment_reduce(
        xi.float(), src, dst, s["v"], weight=None if wi is None else wi.float(),
        reduce=reduce, impl="ref")
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("reduce", ["sum", "mean", "max"])
def test_gather_segment_reduce_deterministic(dev, dtype, reduce):
    """Two launches on the hub graph give the same bits: cut segments are
    folded in run order, with no atomics."""
    src, dst, x, w = _graph(dev, 3000, 20000, 64, seed=11, hub=100_000,
                            pad=9)
    plan = make_plan(dst, 3000, config=KernelConfig("SR", 32, 128, 64, 1))
    xi, wi = x.to(dtype), w.to(dtype)
    first = kops.gather_segment_reduce(xi, src, dst, 3000, wi, reduce,
                                       plan=plan, impl="cuda")
    again = kops.gather_segment_reduce(xi, src, dst, 3000, wi, reduce,
                                       plan=plan, impl="cuda")
    assert torch.equal(first, again)


@pytest.mark.parametrize("f", [41, 47, 121, 66])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("reduce", ["sum", "mean", "max"])
@pytest.mark.parametrize("weighted", [False, True])
def test_whole_row_schedule_is_bitwise_the_column_tiles(dev, f, dtype, reduce,
                                                        weighted):
    """Where the rule walks rows whole, the output is bitwise the column
    tiles' (gsr_tiled_launch) on the same inputs: each column combines the
    same rows in the same order, the partials fold in run order. Gapped
    ids, padding rows and a hub of 20,000 rows cut segments across runs."""
    src, dst, x, w = _graph(dev, 2000, 15000, f, seed=f, gapped=True,
                            pad=50, hub=20_000)
    xi = x.to(dtype)
    wi = w.to(dtype) if weighted else None
    row_ptr = gsr.row_offsets(dst, 2000)
    whole = gsr.c_entry("runs", xi, src, dst, 2000, wi, reduce,
                        row_ptr=row_ptr)
    tiled = gsr.c_entry("tiled", xi, src, dst, 2000, wi, reduce,
                        row_ptr=row_ptr)
    torch.cuda.synchronize()
    assert gsr.schedule(f, dtype, gsr.alignment(xi, whole)) == "whole_row"
    assert torch.equal(whole, tiled)
    _close(whole, kops.gather_segment_reduce(
        xi.float(), src, dst, 2000, weight=None if wi is None else wi.float(),
        reduce=reduce, impl="ref"), dtype)


def test_schedule_counts_sum_to_the_row_run_launches(dev):
    """A SAGE forward with 41 classes on the card: the row-run kernels'
    launches by schedule sum to the gather's runs-path launches and
    segment_reduce's, and its class-wide gathers walk whole rows."""
    src, dst, x, _ = _graph(dev, 3000, 40000, 64, seed=5)
    model = gnn.init("sage", 64, 64, 41, device=dev)
    plan = make_plan(dst, 3000)
    kops.reset_launch_counts()
    with torch.no_grad():
        gnn.forward(model, x, torch.stack([src, dst]), 3000, plan=plan)
    torch.cuda.synchronize()
    sched = kops.schedule_launch_counts()
    assert sum(sched["gather_segment_reduce"].values()) == \
        kops.path_launch_counts()["gather_segment_reduce"]["runs"]
    assert sum(sched["segment_reduce"].values()) == \
        kops.launch_counts()["segment_reduce"]
    kops.reset_launch_counts()
    got = kops.gather_segment_reduce(x[:, :41].contiguous(), src, dst, 3000,
                                     reduce="mean", plan=plan, impl="cuda")
    assert kops.schedule_launch_counts()["gather_segment_reduce"] == {
        "tiled": 0, "whole_row": 1}
    assert got.shape == (3000, 41)


def _owner_case(dev, case):
    """(h, gather ids, sorted segment ids, segments) of an owner-path
    input: the MoE combine at decode (64 bf16 rows of F = 2048 into 8
    tokens, gathered through a permutation), the same at F = 2050 (4-byte
    vectors), a hub of OWNER_MAX_ROWS rows into one of 40 segments beside
    empty ones, short segments with dropped rows, every row dropped, and
    no rows."""
    from repro_torch.kernels import gather_segment_reduce as gsr
    rng = np.random.default_rng(len(case))
    t = lambda a: torch.from_numpy(np.asarray(a, np.int32)).to(dev)  # noqa: E731
    if case in ("decode_combine", "decode_2050"):
        f = 2048 if case == "decode_combine" else 2050
        seg, s = np.repeat(np.arange(8), 8), 8
        gidx, dtype = rng.permutation(64), torch.bfloat16
    elif case == "hub":
        n, s, f, dtype = gsr.OWNER_MAX_ROWS, 40, 300, torch.float32
        seg, gidx = np.full(n, 17), rng.integers(0, n, n)
    elif case == "dropped":
        n = gsr.OWNER_MAX_ROWS
        seg = np.concatenate([np.sort(rng.integers(0, 30, n - n // 4)),
                              np.full(n // 4, 30)])
        s, f, dtype = 30, 40, torch.float32
        gidx = rng.integers(0, n, n)
    else:
        n = 0 if case == "no_rows" else 50
        seg, s, f, dtype = np.full(n, 12), 12, 24, torch.float32
        gidx = rng.integers(0, 50, n)
    h = torch.randn(max(len(gidx), 1), f, device=dev).to(dtype)
    return h, t(gidx), t(seg), s


@pytest.mark.parametrize("case", ["decode_combine", "decode_2050", "hub",
                                  "dropped", "all_dropped", "no_rows"])
@pytest.mark.parametrize("reduce", ["sum", "mean", "max"])
@pytest.mark.parametrize("weighted", [False, True])
def test_gather_owner_path(dev, monkeypatch, case, reduce, weighted):
    """Inputs of at most OWNER_MAX_ROWS rows take the owner path, one launch
    that builds no row offsets (the op would call row_offsets for the runs
    path), against the fp32 plain version and bitwise over two calls."""
    from repro_torch.kernels import gather_segment_reduce as gsr
    h, gidx, seg, s = _owner_case(dev, case)
    w = torch.rand(gidx.numel(), device=dev).to(h.dtype) if weighted \
        else None

    def no_offsets(*args):
        raise AssertionError("the owner path built row offsets")
    monkeypatch.setattr(gsr, "row_offsets", no_offsets)
    kops.reset_launch_counts()
    got = kops.gather_segment_reduce(h, gidx, seg, s, weight=w, reduce=reduce,
                                     impl="cuda")
    again = kops.gather_segment_reduce(h, gidx, seg, s, weight=w,
                                       reduce=reduce, impl="cuda")
    torch.cuda.synchronize()
    assert kops.path_launch_counts()["gather_segment_reduce"] == {
        "runs": 0, "owner": 2}
    assert got.dtype == h.dtype and got.shape == (s, h.shape[1])
    assert torch.equal(got, again)
    monkeypatch.undo()
    want = kops.gather_segment_reduce(
        h.float(), gidx, seg, s, weight=None if w is None else w.float(),
        reduce=reduce, impl="ref")
    _close(got, want, h.dtype)
    if case in ("all_dropped", "no_rows"):
        assert bool((got == (float("-inf") if reduce == "max" else 0)).all())


def test_gather_segment_reduce_empty_graph(dev):
    src = dst = torch.zeros(0, dtype=torch.int32, device=dev)
    x = torch.randn(50, 8, device=dev)
    for reduce, empty in (("sum", 0.0), ("mean", 0.0), ("max", float("-inf"))):
        got = kops.gather_segment_reduce(x, src, dst, 50, reduce=reduce,
                                         impl="cuda")
        assert bool((got == empty).all())


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("heads", [0, 4, 40])
def test_segment_softmax_kernel(dev, dtype, heads):
    src, dst, _, _ = _graph(dev, 900, 7000, 1, seed=7, gapped=True, pad=33)
    rng = np.random.default_rng(heads)
    shape = (dst.shape[0],) if heads == 0 else (dst.shape[0], heads)
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32) * 5
                         ).to(dev, dtype)
    plan = make_plan(dst, 900, config=KernelConfig("SR", 32, 128, 64, 1))
    got = kops.segment_softmax(x, dst, 900, plan=plan, impl="cuda")
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == x.shape
    want = kops.segment_softmax(x.float(), dst, 900, impl="ref")
    _close(got, want, dtype)
    assert bool((got[-33:] == 0).all()), "dropped rows must be exactly 0"


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("heads", [0, 2, 4])
def test_segment_softmax_hub(dev, dtype, heads):
    """A hub of 100,000 rows (782 runs of 128) amid short segments, and
    padding rows: the hub's partials fold in run order."""
    _, dst, _, _ = _graph(dev, 3000, 20000, 1, seed=13, hub=100_000, pad=41)
    shape = (dst.shape[0],) if heads == 0 else (dst.shape[0], heads)
    x = (torch.randn(shape, device=dev) * 5).to(dtype)
    plan = make_plan(dst, 3000)
    for p in (plan, None):
        got = kops.segment_softmax(x, dst, 3000, plan=p, impl="cuda")
        torch.cuda.synchronize()
        _close(got, kops.segment_softmax(x.float(), dst, 3000, impl="ref"),
               dtype)
        assert bool((got[-41:] == 0).all()), "dropped rows must be exactly 0"


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("heads", [0, 4])
def test_segment_softmax_deterministic(dev, dtype, heads):
    """Two launches on the hub graph give the same bits: cut segments are
    folded in run order, with no atomics."""
    _, dst, _, _ = _graph(dev, 3000, 20000, 1, seed=14, hub=100_000, pad=9)
    shape = (dst.shape[0],) if heads == 0 else (dst.shape[0], heads)
    x = (torch.randn(shape, device=dev) * 5).to(dtype)
    plan = make_plan(dst, 3000)
    before = kops.launch_counts()["segment_softmax"]
    first = kops.segment_softmax(x, dst, 3000, plan=plan, impl="cuda")
    again = kops.segment_softmax(x, dst, 3000, plan=plan, impl="cuda")
    assert kops.launch_counts()["segment_softmax"] == before + 2
    assert torch.equal(first, again)


@pytest.mark.parametrize("heads", [0, 2])
def test_segment_softmax_all_neg_inf_segment(dev, heads):
    """A segment whose logits are all -inf comes out 0 (a max that is not
    finite counts as 0, as in the plain version and the JAX impl="ref"),
    whether it lies inside one run or is the hub that spans many."""
    _, dst, _, _ = _graph(dev, 3000, 20000, 1, seed=15, hub=5000, pad=3)
    shape = (dst.shape[0],) if heads == 0 else (dst.shape[0], heads)
    x = torch.randn(shape, device=dev) * 5
    short = int(dst[7])
    for s in (short, 1500):                     # 1500: the hub
        x[dst == s] = float("-inf")
    got = kops.segment_softmax(x, dst, 3000, impl="cuda")
    torch.cuda.synchronize()
    for s in (short, 1500):
        assert bool((got[dst == s] == 0).all())
    assert bool(torch.isfinite(got).all())
    _close(got, kops.segment_softmax(x, dst, 3000, impl="ref"), torch.float32)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("reduce", ["sum", "mean"])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("dims", [(32, 64, 32), (100, 48, 128), (256, 128, 64),
                                  (40, 24, 32), (3, 16, 128)])
def test_fused_transform_reduce_kernel(dev, dtype, reduce, weighted, dims):
    d_in, d_out, s_b = dims
    cfg = KernelConfig("SR", s_b, 128, 64, 1)
    assert fusable(d_in, d_out, dtype, cfg)
    src, dst, x, w = _graph(dev, 3001, 20000, d_in, seed=d_in, pad=5)
    wm = torch.randn(d_in, d_out, device=dev) / d_in ** 0.5
    plan = make_plan(dst, 3001, config=cfg)
    xi, wmi = x.to(dtype), wm.to(dtype)
    wi = w.to(dtype) if weighted else None
    got = kops.fused_transform_reduce(xi, wmi, src, dst, 3001, weight=wi,
                                      reduce=reduce, plan=plan, impl="cuda")
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == (3001, d_out)
    want = kops.fused_transform_reduce(
        xi.float(), wmi.float(), src, dst, 3001,
        weight=None if wi is None else wi.float(), reduce=reduce, impl="ref")
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("dims", [(32, 64), (40, 24), (3, 16), (64, 200)])
def test_fused_transform_reduce_matches_blocked_and_is_deterministic(
        dev, dtype, dims):
    """The kernel against its blocked mirror (the same tiles, runs and fold
    order) and bitwise equal to itself over two launches; a hub of 5,000
    rows, gapped ids (empty tiles) and padding rows."""
    d_in, d_out = dims
    src, dst, x, w = _graph(dev, 1500, 6000, d_in, seed=d_in + 1,
                            gapped=True, pad=11, hub=5000)
    dst = torch.where(dst < 1500, dst + (dst >= 300) * (dst < 600) * 300, dst)
    dst = dst.sort().values
    wm = (torch.randn(d_in, d_out, device=dev) / d_in ** 0.5).to(dtype)
    xi, wi = x.to(dtype), w.to(dtype)
    plan = make_plan(dst, 1500, device=dev)
    rp = plan.row_ptr.cpu()
    assert bool((rp[320:384] == rp[320]).all()), "a tile with no rows"

    def launch():
        return kops.fused_transform_reduce(xi, wm, src, dst, 1500, wi, "sum",
                                           plan=plan, impl="cuda")
    got, again = launch(), launch()
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    blocked = kops.fused_transform_reduce(xi, wm, src, dst, 1500, wi, "sum",
                                          plan=plan, impl="blocked")
    assert bool(torch.isfinite(blocked).all())
    _close(got, blocked, dtype)
    _close(got, kops.fused_transform_reduce(
        xi.float(), wm.float(), src, dst, 1500, wi.float(), "sum",
        impl="ref"), dtype)


# widths on either side of the 232,448 B of shared memory a block may use:
# W resident and the aggregate grow with d_in, the output stage with d_out
# past one pass of BN = 64 columns, bf16 pads K to 16
SMEM_EDGE = [(torch.float32, 256, 128), (torch.float32, 256, 136),
             (torch.float32, 256, 137), (torch.float32, 256, 192),
             (torch.float32, 384, 72), (torch.float32, 384, 73),
             (torch.float32, 200, 168), (torch.float32, 200, 169),
             (torch.bfloat16, 256, 128), (torch.bfloat16, 256, 192),
             (torch.bfloat16, 256, 336), (torch.bfloat16, 256, 337),
             (torch.bfloat16, 300, 256), (torch.bfloat16, 300, 257),
             (torch.bfloat16, 384, 208), (torch.bfloat16, 384, 209)]


@pytest.mark.parametrize("dtype,d_in,d_out", SMEM_EDGE)
def test_fused_kernel_launches_exactly_where_fusable(dev, dtype, d_in, d_out):
    """fusable's Python copy of the kernel's shared-memory layout against
    the kernel itself: the C entry point, called past the wrapper's check,
    launches exactly where fusable says the block fits, and then agrees
    with the plain version."""
    from repro_torch.kernels import _build
    from repro_torch.core.config_space import DEFAULT_S_B
    from repro_torch.kernels.fused_transform_reduce import DTYPE_CODE
    src, dst, x, w = _graph(dev, 300, 2000, d_in, seed=d_in + d_out, pad=3)
    xi, wi = x.to(dtype), w.to(dtype)
    wm = (torch.randn(d_in, d_out, device=dev) / d_in ** 0.5).to(dtype)
    plan = make_plan(dst, 300, device=dev)
    out = torch.zeros((300, d_out), dtype=dtype, device=dev)
    err = _build.load("fused_transform_reduce").ftr_launch(
        DTYPE_CODE[dtype], 0, 1, _build.ptr(xi), _build.ptr(wm),
        _build.ptr(src), _build.ptr(wi), _build.ptr(plan.row_ptr),
        _build.ptr(out), d_in, d_out, 300, DEFAULT_S_B,
        _build.stream_of(xi))
    torch.cuda.synchronize()
    assert (err == 0) == fusable(d_in, d_out, dtype), err
    if err == 0:
        _close(out, kops.fused_transform_reduce(
            xi.float(), wm.float(), src, dst, 300, wi.float(), "sum",
            impl="ref"), dtype)


@pytest.mark.parametrize("family", gnn.MODELS)
def test_model_forward_kernels_match_plain(dev, family):
    g = dataset("cora", feat=32)
    model = gnn.init(family, 32, 64, 16, heads=4 if family == "gat" else 1,
                     device=dev)
    x = torch.from_numpy(g.x).to(dev)
    ei = torch.from_numpy(g.edge_index).to(dev)
    dis = torch.from_numpy(g.deg_inv_sqrt).to(dev)
    plan = g.make_plan(feat=64)
    with torch.inference_mode():
        with kops.fusion_scope() as fusion:
            got = model(x, ei, g.num_nodes, dis, plan=plan)
        want = model(x, ei, g.num_nodes, dis, impl="ref")
    assert fusion and all(k.startswith("fused:") for k in fusion)
    _close(got, want, torch.float32)


def test_bucket_stamp_on_device_matches_host(dev):
    from repro_torch.serve import pad_to_bucket
    from repro_torch.serve.plan_cache import BucketEntry
    padded, bucket = pad_to_bucket(dataset("pubmed", feat=8))
    entry = BucketEntry(bucket, 64, KernelConfig("SR", 32, 64, 64, 1))
    host = entry.stamp(padded.edge_index[1])
    card = entry.stamp(torch.from_numpy(padded.edge_index[1]).to(dev))
    assert card.row_ptr.is_cuda
    assert torch.equal(card.row_ptr.cpu(), host.row_ptr)


# ---------------------------------------------------------------------------
# the kernels of the typed path and of the public ops
# ---------------------------------------------------------------------------

SMM_CASES = {
    # zipf-skewed relations with many empty groups, K and N off the tiles
    "zipf": dict(sizes=lambda rng: rng.zipf(1.3, 40).clip(max=4000) *
                 (rng.random(40) < 0.6), pad=0, k=40, n=72),
    # rows past the last group, groups straddling every row block
    "padded": dict(sizes=lambda rng: rng.integers(0, 9, 300), pad=100, k=64,
                   n=64),
    "single": dict(sizes=lambda rng: np.array([5000]), pad=0, k=32, n=128),
    "all_empty": dict(sizes=lambda rng: np.zeros(7, np.int64), pad=300, k=16,
                      n=16),
    # the narrow output widths of the typed layers
    "n16": dict(sizes=lambda rng: rng.integers(0, 3000, 20), pad=17, k=64,
                n=16),
    "n32": dict(sizes=lambda rng: rng.integers(0, 3000, 20), pad=0, k=32,
                n=32),
    # groups of 1-3 rows: every 128-row tile overlaps some 60 groups
    "tiny_groups": dict(sizes=lambda rng: rng.integers(1, 4, 2000), pad=40,
                        k=64, n=64),
    # a row of an odd number of elements (no 4-byte copies in bf16)
    "odd_k": dict(sizes=lambda rng: rng.integers(0, 500, 9), pad=3, k=7,
                  n=24),
    # K deeper than shared memory holds in one pass: taken in chunks of K
    # (fp32 already at 160 with N = 128)
    "deep_k": dict(sizes=lambda rng: rng.integers(0, 2000, 10), pad=5,
                   k=160, n=128),
    "k512": dict(sizes=lambda rng: rng.integers(0, 700, 12), pad=9, k=512,
                 n=128),
    "k1024": dict(sizes=lambda rng: rng.integers(0, 300, 8), pad=3, k=1024,
                  n=16),
    # a deep odd K: a short last chunk, and 2-byte copies in bf16
    "k1001": dict(sizes=lambda rng: rng.integers(0, 300, 6), pad=0, k=1001,
                  n=40),
    # the MoE shapes of qwen3-moe-30b-a3b (bf16 on the wgmma path): a
    # decode step's 64 rows in 47 of 128 experts, up and down
    "moe_decode": dict(sizes=lambda rng: _moe_sizes(rng, 64, 128, 47),
                       pad=0, k=2048, n=768),
    "moe_down": dict(sizes=lambda rng: _moe_sizes(rng, 64, 128, 47), pad=0,
                     k=768, n=2048),
    # a training step's 16,384 rows in 128 experts
    "moe_16k": dict(sizes=lambda rng: _moe_sizes(rng, 16384, 128, 128),
                    pad=0, k=2048, n=768),
    # the dropless static tail: half of a rank's rows past its 64 experts
    "dropless_tail": dict(sizes=lambda rng: _moe_sizes(rng, 8192, 64, 64),
                          pad=8192, k=768, n=2048),
    # a group of one row among empty ones
    "one_row": dict(sizes=lambda rng: np.array([0, 1, 0, 0]), pad=0,
                    k=2048, n=768),
}


def _moe_sizes(rng, rows, groups, active):
    """``rows`` routed rows over ``active`` of ``groups`` experts, each
    active expert at least one row."""
    sizes = np.zeros(groups, np.int64)
    idx = rng.choice(groups, active, replace=False)
    sizes[idx] = 1 + rng.multinomial(rows - active,
                                      np.full(active, 1.0 / active))
    return sizes


@pytest.mark.parametrize("case", list(SMM_CASES))
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("with_plan", [False, True])
@pytest.mark.parametrize("w_transposed", [False, True])
def test_segment_matmul_kernel(dev, case, dtype, with_plan, w_transposed):
    """Each case against the fp32 plain version, with W read as (G, K, N)
    or, transposed, as (G, N, K); the launch took the path the rule
    names."""
    from repro_torch.core.plan import make_relation_plan
    from repro_torch.kernels import segment_matmul as smm
    c = SMM_CASES[case]
    rng = np.random.default_rng(len(case))
    sizes = torch.from_numpy(c["sizes"](rng).astype(np.int32)).to(dev)
    m = int(sizes.sum()) + c["pad"]
    x = torch.randn(m, c["k"], device=dev).to(dtype)
    w = (torch.randn(sizes.numel(), c["k"], c["n"], device=dev)
         / c["k"] ** 0.5).to(dtype)
    wc = w.transpose(1, 2).contiguous() if w_transposed else w
    plan = make_relation_plan(sizes, num_rows=m, feat=c["n"]) \
        if with_plan else None
    before = kops.launch_counts()["segment_matmul"]
    paths = kops.path_launch_counts()["segment_matmul"]
    got = kops.segment_matmul(x, sizes, wc, plan=plan, impl="cuda",
                              w_transposed=w_transposed)
    torch.cuda.synchronize()
    assert kops.launch_counts()["segment_matmul"] == before + 1
    took = {k: v - paths[k] for k, v in
            kops.path_launch_counts()["segment_matmul"].items()}
    want_path = smm.path(dtype, m, c["k"], c["n"], sizes.numel())
    assert took == {p: int(p == want_path) for p in took}
    assert got.dtype == dtype and got.shape == (m, c["n"])
    _close(got, kops.segment_matmul(x.float(), sizes, w.float(), impl="ref"),
           dtype)
    if c["pad"]:
        assert bool((got[m - c["pad"]:] == 0).all()), "rows of no group"


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("k,n", [(64, 16), (64, 64), (64, 128), (2048, 768)])
def test_segment_matmul_deterministic(dev, dtype, k, n):
    """Two launches give the same bits: the typed widths, and the MoE up
    product at 16,384 rows in 128 experts (bf16: the wgmma path)."""
    from repro_torch.core.plan import make_relation_plan
    rng = np.random.default_rng(n)
    sizes = (_moe_sizes(rng, 16384, 128, 128) if k == 2048
             else rng.integers(0, 5000, 40))
    sizes = torch.from_numpy(sizes.astype(np.int32)).to(dev)
    m = int(sizes.sum()) + 33
    x = torch.randn(m, k, device=dev).to(dtype)
    w = (torch.randn(sizes.numel(), k, n, device=dev) / k ** 0.5).to(dtype)
    plan = make_relation_plan(sizes, num_rows=m, feat=n)
    first = kops.segment_matmul(x, sizes, w, plan=plan, impl="cuda")
    again = kops.segment_matmul(x, sizes, w, plan=plan, impl="cuda")
    assert torch.equal(first, again)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("reduce", ["sum", "mean", "max"])
@pytest.mark.parametrize("shape", range(len(SHAPES)))
def test_segment_reduce_kernel(dev, dtype, reduce, shape):
    s = SHAPES[shape]
    _, dst, _, _ = _graph(dev, s["v"], s["e"], 1, seed=shape,
                          gapped=s.get("gapped", False), pad=s.get("pad", 0),
                          hub=s.get("hub", 0))
    x = torch.randn(dst.numel(), s["f"], device=dev).to(dtype)
    plan = make_plan(dst, s["v"], config=s["cfg"])
    for p in (plan, None):
        walks = kops.schedule_launch_counts()["segment_reduce"]
        got = kops.segment_reduce(x, dst, s["v"], reduce, plan=p, impl="cuda")
        torch.cuda.synchronize()
        took = gsr.schedule(s["f"], dtype, gsr.alignment(x, got))
        assert kops.schedule_launch_counts()["segment_reduce"] == {
            **walks, took: walks[took] + 1}
        assert got.dtype == dtype and got.shape == (s["v"], s["f"])
        _close(got, kops.segment_reduce(x.float(), dst, s["v"], reduce,
                                        impl="ref"), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("reduce", ["sum", "mean", "max"])
def test_segment_reduce_deterministic(dev, dtype, reduce):
    """Two launches on the hub graph give the same bits."""
    _, dst, _, _ = _graph(dev, 3000, 20000, 1, seed=16, hub=100_000, pad=9)
    x = torch.randn(dst.numel(), 64, device=dev).to(dtype)
    plan = make_plan(dst, 3000)
    before = kops.launch_counts()["segment_reduce"]
    first = kops.segment_reduce(x, dst, 3000, reduce, plan=plan, impl="cuda")
    again = kops.segment_reduce(x, dst, 3000, reduce, plan=plan, impl="cuda")
    assert kops.launch_counts()["segment_reduce"] == before + 2
    assert torch.equal(first, again)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", [3, 40, 64])
@pytest.mark.parametrize("order", ["dst_sorted", "shuffled", "one_row"])
def test_sddmm_pairs(dev, dtype, n, order):
    """Runs of pairs with A-row reuse: dst-sorted pairs (rows repeat in
    runs), the same pairs shuffled, and every pair on one row of A."""
    a = torch.randn(900, n, device=dev).to(dtype)
    b = torch.randn(700, n, device=dev).to(dtype)
    row = torch.randint(0, 900, (20011,), device=dev).sort().values
    if order == "shuffled":
        row = row[torch.randperm(row.numel(), device=dev)]
    elif order == "one_row":
        row = torch.full_like(row, 17)
    row = row.int().contiguous()
    col = torch.randint(0, 700, (20011,), device=dev, dtype=torch.int32)
    got = kops.sddmm(a, b, row, col, impl="cuda")
    again = kops.sddmm(a, b, row, col, impl="cuda")
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == (20011,)
    assert torch.equal(got, again)
    _close(got, kops.sddmm(a.float(), b.float(), row, col, impl="ref"), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", [8, 64, 96, 97, 192, 193, 300, 2048, 2050])
def test_sddmm_kernel(dev, dtype, n):
    """Random pairs on the path the rule names (the runs kernel up to 384
    bytes a row, the wide path past it: the fp32 and bf16 borders, the
    combine's F = 2048, and 2050, which takes 8-byte vectors), against the
    fp32 plain version and bitwise over two calls."""
    from repro_torch.kernels import sddmm as sdd
    a = torch.randn(900, n, device=dev).to(dtype)
    b = torch.randn(700, n, device=dev).to(dtype)
    row = torch.randint(0, 900, (20000,), device=dev, dtype=torch.int32)
    col = torch.randint(0, 700, (20000,), device=dev, dtype=torch.int32)
    kops.reset_launch_counts()
    got = kops.sddmm(a, b, row, col, impl="cuda")
    torch.cuda.synchronize()
    want_path = sdd.path(n, dtype)
    assert kops.path_launch_counts()["sddmm"] == {
        p: int(p == want_path) for p in ("runs", "wide")}
    assert got.dtype == dtype and got.shape == (20000,)
    _close(got, kops.sddmm(a.float(), b.float(), row, col, impl="ref"), dtype)
    assert torch.equal(got, kops.sddmm(a, b, row, col, impl="cuda"))
    with pytest.raises(ValueError, match="sddmm"):
        kops.sddmm(a, b, row, col.clone().fill_(700), impl="cuda")


@pytest.mark.parametrize("b_dtype", DTYPES)
@pytest.mark.parametrize("n", [64, 2048, 2050])
def test_sddmm_rows_reads_b_in_its_own_dtype(dev, b_dtype, n):
    """The combine's router-weight gradient as the backward runs it: an
    fp32 A (the cotangent, a row a token, eight pairs to a token in order)
    and B (the expert outputs, gathered through a permutation) in fp32 or
    bf16. A bf16 B is read as it is on the wide path and widened first on
    the runs path; either way the products are an fp32 copy's, so the
    result equals the call on B.float() bit for bit."""
    from repro_torch.kernels import sddmm as sdd
    t, k = 512, 8
    a = torch.randn(t, n, device=dev)
    b = torch.randn(t * k, n, device=dev).to(b_dtype)
    row = torch.arange(t, dtype=torch.int32, device=dev).repeat_interleave(k)
    col = torch.randperm(t * k, device=dev).to(torch.int32)
    kops.reset_launch_counts()
    got = kops.sddmm_rows(a, b, row, col, impl="cuda")
    torch.cuda.synchronize()
    want_path = sdd.path(n, torch.float32)
    assert kops.path_launch_counts()["sddmm"][want_path] == 1
    assert got.dtype == torch.float32
    assert torch.equal(got, kops.sddmm_rows(a, b.float(), row, col,
                                            impl="cuda"))
    _close(got, kops.sddmm_rows(a, b, row, col, impl="ref"), torch.float32)
    assert torch.equal(got, kops.sddmm_rows(a, b, row, col, impl="cuda"))
    with pytest.raises(TypeError, match="one dtype"):
        kops.sddmm(a, b.bfloat16(), row, col, impl="cuda")


def test_plan_on_the_host_is_refused_for_card_data(dev):
    _, dst, _, _ = _graph(dev, 500, 3000, 8, seed=3)
    host_plan = make_plan(dst, 500, device="cpu")
    with pytest.raises(ValueError, match="lies on cpu"):
        kops.segment_reduce(torch.randn(3000, 8, device=dev), dst, 500,
                            plan=host_plan, impl="cuda")
    card_plan = make_plan(dst, 500)
    assert card_plan.row_ptr.is_cuda and host_plan.to(dev).row_ptr.is_cuda


@pytest.mark.parametrize("family", ["rgcn", "rgat"])
def test_typed_model_forward_kernels_match_plain(dev, family):
    from repro_torch.data.graphs import synth_typed_graph
    g = synth_typed_graph("t", 3000, 30000, num_relations=133, feat=32)
    model = gnn.init(family, 32, 64, 16, heads=2 if family == "rgat" else 1,
                     num_relations=133, device=dev)
    t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    typed = dict(edge_type=t(g.edge_type), type_perm=t(g.type_perm),
                 inv_type_perm=t(g.inv_type_perm),
                 type_counts=t(g.type_counts))
    x, ei = t(g.x), t(g.edge_index)
    with torch.inference_mode():
        kops.reset_launch_counts()
        with kops.fusion_scope() as fusion:
            got = model(x, ei, g.num_nodes, plan=g.make_plan(feat=128),
                        rplan=g.make_relation_plan(feat=128), **typed)
        launched = kops.launch_counts()
        want = model(x, ei, g.num_nodes, impl="ref", **typed)
    assert fusion and all(k.startswith("fused:") for k in fusion)
    assert launched["segment_matmul"] == 3
    assert launched["gather_segment_reduce"] >= 3
    _close(got, want, torch.float32)


# ---------------------------------------------------------------------------
# backwards on the card: each op's gradients against its plain version's
# ---------------------------------------------------------------------------

def _grad_case(dev, op, dtype):
    """(kernel, plain, leaves) for one op on a graph with a hub, gapped ids
    and padded rows. ``kernel(*leaves)`` runs the op through the kernels,
    with a graph plan for the aggregations (so the backward walks its
    source order); ``plain(*leaves)`` the same function in plain PyTorch,
    which autograd differentiates (on the fp32 upcast of bf16 leaves: the
    cast-then-reduce oracle, since autograd of a bf16 index_select sums
    its gradient in bf16)."""
    from repro_torch.core.plan import make_graph_plan
    v, f = 3000, 40
    src, dst, x, w = _graph(dev, v, 20000, f, seed=21, hub=30_000, pad=64)
    ei = torch.stack([src, dst]).cpu().numpy()
    plan = make_graph_plan(ei, v, feat=64)
    h = x.to(dtype)
    wt = w.to(dtype)
    wm = (torch.randn(f, 24, device=dev) / f ** 0.5).to(dtype)
    e = int(dst.numel())
    reduce = op.split("_")[-1]
    if op.startswith("segment_reduce"):
        return (lambda x: rt.segment_reduce(x, dst, v, reduce, None, None,
                                            plan),
                lambda x: kops.segment_reduce(x, dst, v, reduce, impl="ref"),
                [torch.randn(e, f, device=dev).to(dtype)])
    if op == "gather":
        return (lambda h: rt.gather(h, src),
                lambda h: h.index_select(0, src.long()), [h])
    if op.startswith("isr"):
        return (lambda h: rt.index_segment_reduce(h, src, dst, v, reduce,
                                                  None, None, plan),
                lambda h: kops.gather_segment_reduce(h, src, dst, v, None,
                                                     reduce, impl="ref"), [h])
    if op.startswith("iwsr"):
        kernel = (lambda h, w: rt.index_weight_segment_reduce(
            h, src, w, dst, v, reduce, None, None, plan))
        if reduce == "max" and dtype == torch.bfloat16:
            # a bf16 weighted max splits its cotangent among the messages
            # that round to the max (the reference's rule), where autograd
            # of the fp32 max picks one: the oracle is the same rule on the
            # plain versions, in bf16
            return kernel, (lambda h, w: rt.index_weight_segment_reduce(
                h, src, w, dst, v, reduce, "ref")), [h, wt]
        return kernel, (lambda h, w: kops.gather_segment_reduce(
            h, src, dst, v, w, reduce, impl="ref")), [h, wt]
    if op == "fused_sum_weighted":
        return (lambda h, m, w: rt.fused_transform_reduce(
                    h, m, src, w, dst, v, "sum", None, None, plan),
                lambda h, m, w: kops.fused_transform_reduce(
                    h, m, src, dst, v, w, "sum", impl="ref"), [h, wm, wt])
    if op == "fused_mean":
        return (lambda h, m: rt.fused_transform_reduce(
                    h, m, src, None, dst, v, "mean", None, None, plan),
                lambda h, m: kops.fused_transform_reduce(
                    h, m, src, dst, v, None, "mean", impl="ref"), [h, wm])
    if op == "sddmm":
        keep = dst < v
        rows, cols = dst[keep], src[keep]
        return (lambda a, b: rt.sddmm(a, b, rows, cols),
                lambda a, b: kops.sddmm(a, b, rows, cols, impl="ref"),
                [h, torch.randn(v, f, device=dev).to(dtype)])
    if op == "softmax":
        return (lambda x: rt.segment_softmax(x, dst, v, None, None, plan),
                lambda x: kops.segment_softmax(x, dst, v, impl="ref"),
                [(torch.randn(e, 4, device=dev) * 3).to(dtype)])
    sizes = torch.tensor([0, 3000, 1, 0, 12000, 7], dtype=torch.int32,
                         device=dev)
    return (lambda x, w: rt.grouped_segment_matmul(x, sizes, w),
            lambda x, w: kops.segment_matmul(x, sizes, w, impl="ref"),
            [torch.randn(15100, 64, device=dev).to(dtype),
             (torch.randn(6, 64, 16, device=dev) / 8).to(dtype)])


GRAD_OPS = ["segment_reduce_sum", "segment_reduce_mean", "segment_reduce_max",
            "gather", "isr_sum", "isr_mean", "isr_max", "iwsr_sum",
            "iwsr_mean", "iwsr_max", "fused_sum_weighted", "fused_mean",
            "sddmm", "softmax", "gsm"]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("op", GRAD_OPS)
def test_op_backward_kernels_match_plain(dev, op, dtype):
    """Every gradient through the kernels (no plain version, no atomic
    scatter) equals plain PyTorch autograd of the same function on the
    card, and two backwards give the same bits."""
    kernel, plain, inputs = _grad_case(dev, op, dtype)
    leaves = [t.requires_grad_() for t in inputs]
    y = kernel(*leaves)
    ct = torch.randn(y.shape, device=dev).to(y.dtype)
    ct = torch.where(torch.isfinite(y), ct, torch.zeros_like(ct))

    def grads():
        with kops.fusion_scope() as fusion:      # forward and backward
            got = torch.autograd.grad(kernel(*leaves), leaves, ct)
        torch.cuda.synchronize()
        assert fusion and all(k.startswith("fused:") for k in fusion), \
            fusion
        return got

    got, again = grads(), grads()
    upcast = dtype == torch.bfloat16 and not (op == "iwsr_max")
    oracle = [t.detach().float().requires_grad_() if upcast else t
              for t in leaves]
    want = torch.autograd.grad(plain(*oracle), oracle,
                               ct.float() if upcast else ct)
    for g, g2, wnt, leaf in zip(got, again, want, leaves):
        assert g.dtype == leaf.dtype
        assert torch.equal(g, g2), f"{op}: two backwards differ"
        _close(g, wnt, dtype)


def test_gcn_fit_on_the_card(dev):
    """Three steps of ``repro_torch.fit`` through the kernels: the plain
    versions' losses within 1e-4, two runs bitwise equal, no op on a plain
    version."""
    from repro_torch import train
    data = train.GraphEpochProvider(shapes=((3000, 20000),),
                                    graphs_per_shape=1, feat=32)

    def run(impl):
        task = train.NodeClassification.from_provider(data, model="gcn",
                                                      impl=impl)
        with kops.fusion_scope() as fusion:
            res = train.fit(task, data, train.TrainerConfig(steps=3,
                                                            warmup_steps=1))
        return res, dict(fusion)

    kops.reset_launch_counts()
    res, fusion = run(None)
    launched = kops.launch_counts()
    assert all(k.startswith("fused:") for k in fusion), fusion
    assert launched["fused_transform_reduce"] >= 9
    assert launched["gather_segment_reduce"] >= 3
    again, _ = run(None)
    assert again.losses == res.losses
    want, _ = run("ref")
    np.testing.assert_allclose(res.losses, want.losses, rtol=1e-4)


# ---------------------------------------------------------------------------
# the sampled path: producer streams, events, lifetimes
# ---------------------------------------------------------------------------

_SAMPLED_ARRAYS = ("x", "edge_index", "deg_inv_sqrt", "labels", "label_mask")


def _sampled_producer(dev):
    from repro_torch.data.pipeline import SampledBatchProducer
    from repro_torch.data.sampling import NeighborSampler
    g = rt.synth_graph("sampled", 4000, 30000, feat=32, seed=1)
    seeds = np.unique(g.edge_index[1])
    return SampledBatchProducer(
        NeighborSampler(g, fanouts=(6, 4), batch_size=64, seed_nodes=seeds,
                        seed=3), feat=64, device=dev)


def _sampled_tensors(b):
    p, o = b.plan, b.plan.src_order
    return ([b.arrays[k] for k in _SAMPLED_ARRAYS]
            + [p.row_ptr, o.perm, o.src, o.dst, o.row_ptr])


def test_producer_works_on_a_side_stream_and_records_an_event(dev):
    """On the card a producer copies and stamps on its thread's own stream
    and hands over an event: the batch is the CPU producer's, bit for
    bit, once the consumer's stream has waited on it."""
    from repro_torch.data.pipeline import SampledBatchProducer
    prod = _sampled_producer(dev)
    cpu = SampledBatchProducer(prod.sampler, feat=64, device="cpu")
    b = prod.produce(0)
    assert isinstance(b.event, torch.cuda.Event)
    assert prod._stream() != torch.cuda.current_stream()
    assert all(t.is_cuda for t in _sampled_tensors(b))
    b.ready()
    want = cpu.produce(0)
    for got, ref in zip(_sampled_tensors(b), _sampled_tensors(want)):
        assert torch.equal(got.cpu(), ref)


@pytest.mark.parametrize("depth,threads", [(0, 1), (2, 2), (4, 4)])
def test_prefetched_batches_survive_their_producers(dev, depth, threads):
    """Batches made on producer streams and consumed (and freed) on the
    current stream, while producers keep allocating: every batch a
    consumer reads, after a kernel has run on it, is bitwise the
    synchronous loader's."""
    from repro_torch.data.pipeline import PrefetchPipeline
    prod = _sampled_producer(dev)
    with PrefetchPipeline(_sampled_producer(dev), depth=0) as ref_pipe:
        want = [[t.cpu() for t in _sampled_tensors(ref_pipe.batch(s))]
                for s in range(12)]
    model = gnn.init("gcn", 32, 64, 8, device=dev)
    with PrefetchPipeline(prod, depth=depth, num_threads=threads) as pipe:
        for s in range(12):
            b = pipe.batch(s)
            a = b.arrays
            with torch.no_grad():
                out = model(a["x"], a["edge_index"], b.bucket.num_nodes,
                            a["deg_inv_sqrt"], plan=b.plan)
            del a
            got = [t.cpu() for t in _sampled_tensors(b)]
            del b
            assert bool(torch.isfinite(out).all())
            for g, w in zip(got, want[s]):
                assert torch.equal(g, w), f"step {s}"


def test_sampled_fit_and_serving_on_the_card(dev):
    """Three sampled gcn steps through the kernels (every op fused, losses
    within 1e-4 of the plain versions, two runs bitwise equal), and
    sampled serving equal to the plain forward."""
    from repro_torch import train
    from repro_torch.serve import GNNServer
    g = rt.synth_graph("sampled", 4000, 30000, feat=32, seed=1)
    seeds = np.unique(g.edge_index[1])

    def run(impl):
        with train.SampledNodeProvider(g, fanouts=(6, 4), batch_size=64,
                                       seed_nodes=seeds, plan_feat=64,
                                       depth=2) as data:
            task = train.NodeClassification.from_provider(
                data, model="gcn", impl=impl)
            with kops.fusion_scope() as fusion:
                res = train.fit(task, data, train.TrainerConfig(
                    steps=3, warmup_steps=1))
        return res, dict(fusion)

    kops.reset_launch_counts()
    res, fusion = run(None)
    assert fusion and all(k.startswith("fused:") for k in fusion), fusion
    assert kops.launch_counts()["fused_transform_reduce"] >= 9
    assert all(s.sampled for s in res.buckets)
    again, _ = run(None)
    assert again.losses == res.losses
    want, _ = run("ref")
    np.testing.assert_allclose(res.losses, want.losses, rtol=1e-4)

    srv = GNNServer(gnn.init("gcn", 32, 64, 8, device=dev), "gcn")
    prod = _sampled_producer(dev)
    with srv.sampled_pipeline(prod.sampler, depth=2) as pipe:
        for s in range(4):
            b = pipe.batch(s)
            got = srv.serve_sampled(b)
            a = b.arrays
            with torch.no_grad():
                ref = srv.model(a["x"], a["edge_index"], b.bucket.num_nodes,
                                a["deg_inv_sqrt"], impl="ref")
            _close(torch.from_numpy(got), ref[:b.num_seeds].cpu(),
                   torch.float32)
    assert srv.stats()["builds"] == len(srv.cache)


# ---------------------------------------------------------------------------
# LM training: the embedding's backward, the MoE products' backward and the
# dispatch gather's backward at MoE widths
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
def test_embedding_backward_kernel_matches_plain(dev, dtype):
    """The embedding's backward (sort, then segment_reduce into one segment
    a vocabulary row) on the kernel against the same backward with the
    plain segment_reduce, fp32 sums either way; repeated and unused ids."""
    from repro_torch.models import layers
    rng = np.random.default_rng(31)
    vocab, d = 5000, 256
    ids = torch.from_numpy(rng.integers(0, 3000, (4, 512)).astype(
        np.int32)).to(dev)
    ids[0, :100] = 17
    table = torch.randn(vocab, d, device=dev).to(dtype)
    g = torch.randn(4, 512, d, device=dev).to(dtype)

    class Table:
        pass
    grads = {}
    for impl in ("cuda", "ref"):
        t = table.clone().requires_grad_()
        tab = Table()
        tab.table = t
        kops.reset_launch_counts()
        if impl == "ref":
            orig = kops.segment_reduce
            kops.segment_reduce = lambda *a, **k: orig(*a, **dict(
                k, impl="ref"))
        try:
            (grads[impl],) = torch.autograd.grad(layers.embed(tab, ids), [t],
                                                 g)
        finally:
            if impl == "ref":
                kops.segment_reduce = orig
        torch.cuda.synchronize()
        launched = kops.launch_counts()["segment_reduce"]
        assert launched == (1 if impl == "cuda" else 0)
    assert grads["cuda"].dtype == dtype
    _close(grads["cuda"], grads["ref"].float(), dtype)
    assert not bool(grads["cuda"][3000:].any())


@pytest.mark.parametrize("k,n", [(2048, 768), (768, 2048)])
def test_moe_width_segment_matmul_backward_matches_plain(dev, k, n):
    """_GroupedSegmentMatmul's backward at qwen3-moe widths in bf16: 128
    groups (some empty), dX on the kernel with Wᵀ, dW by the per-group
    loop, against plain autograd of the fp32 plain version of the same
    upcast inputs."""
    from repro_torch.core import ops as geot
    rng = np.random.default_rng(32)
    sizes_np = rng.integers(0, 64, 128)
    sizes_np[[3, 40, 41, 127]] = 0
    sizes = torch.from_numpy(sizes_np.astype(np.int32)).to(dev)
    m = int(sizes_np.sum())
    x = (torch.randn(m, k, device=dev) / 8).to(torch.bfloat16)
    w = (torch.randn(128, k, n, device=dev) / k ** 0.5).to(torch.bfloat16)
    gy = torch.randn(m, n, device=dev).to(torch.bfloat16)
    out = {}
    for impl, xs, ws, g in (("cuda", x, w, gy),
                            ("ref", x.float(), w.float(), gy.float())):
        xl, wl = xs.clone().requires_grad_(), ws.clone().requires_grad_()
        kops.reset_launch_counts()
        y = geot.segment_matmul(xl, sizes, wl, impl=impl)
        out[impl] = (y,) + torch.autograd.grad(y, [xl, wl], g)
        torch.cuda.synchronize()
        assert kops.launch_counts()["segment_matmul"] == (
            2 if impl == "cuda" else 0)
    for got, want in zip(out["cuda"], out["ref"]):
        assert got.dtype == torch.bfloat16
        _close(got, want, torch.bfloat16)
    empty = torch.from_numpy(sizes_np == 0).to(dev)
    assert not bool(out["cuda"][2][empty].any())


def test_moe_dispatch_gather_backward_is_bitwise_repeatable(dev):
    """The MoE dispatch gather's backward (sorted segment reduction on the
    gather kernel) at the 2048-token training shape: two backwards give
    the same bits, and the plain version's within the bf16 tolerance."""
    from repro_torch.core import ops as geot
    rng = np.random.default_rng(33)
    t, topk, d = 2048, 8, 2048
    tok = torch.from_numpy(np.repeat(np.arange(t), topk)[
        rng.permutation(t * topk)].astype(np.int32)).to(dev)
    x = torch.randn(t, d, device=dev).to(torch.bfloat16)
    g = torch.randn(t * topk, d, device=dev).to(torch.bfloat16)

    def backward(impl):
        xl = x.clone().requires_grad_()
        return torch.autograd.grad(geot.gather(xl, tok, impl=impl), [xl],
                                   g)[0]
    kops.reset_launch_counts()
    first, again = backward(None), backward(None)
    torch.cuda.synchronize()
    assert kops.launch_counts()["gather_segment_reduce"] == 2
    assert torch.equal(first, again)
    want = torch.zeros(t, d, device=dev).index_add_(0, tok.long(), g.float())
    _close(first, want, torch.bfloat16)
    _close(backward("ref"), want, torch.bfloat16)
