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

from repro_torch.core.config_space import KernelConfig  # noqa: E402
from repro_torch.core.plan import make_plan  # noqa: E402
from repro_torch.data.graphs import dataset  # noqa: E402
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
    scale = float(want[torch.isfinite(want)].abs().max()) if want.numel() else 0.0
    torch.testing.assert_close(got.float(), want, rtol=tol,
                               atol=tol * max(scale, 1.0), equal_nan=True)


def _graph(dev, v, e, f, seed, gapped=False, pad=0):
    """Sorted dst (optionally gapped), src, x (v, f), w (e,), plus ``pad``
    drop-id rows (dst = v) at the end."""
    rng = np.random.default_rng(seed)
    dst = np.sort(rng.integers(0, v, e))
    if gapped:
        dst = dst - dst % 3
    dst = np.concatenate([dst, np.full(pad, v)]).astype(np.int32)
    src = rng.integers(0, v, e + pad).astype(np.int32)
    x = rng.standard_normal((v, f)).astype(np.float32)
    w = rng.standard_normal(e + pad).astype(np.float32)
    t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    return t(src), t(dst), t(x), t(w)


SHAPES = [
    dict(v=700, e=3400, f=12, cfg=KernelConfig("SR", 64, 128, 64, 1)),
    dict(v=5000, e=40000, f=64, cfg=KernelConfig("SR", 32, 256, 64, 1)),
    # num_segments % s_b != 0, gapped ids, padding rows, F above one block
    dict(v=1001, e=6000, f=300, cfg=KernelConfig("SR", 32, 128, 32, 1),
         gapped=True, pad=77),
]


@pytest.mark.parametrize("shape", range(len(SHAPES)))
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("reduce", ["sum", "mean", "max"])
@pytest.mark.parametrize("weighted", [False, True])
def test_gather_segment_reduce_kernel(dev, shape, dtype, reduce, weighted):
    s = SHAPES[shape]
    src, dst, x, w = _graph(dev, s["v"], s["e"], s["f"], seed=shape,
                            gapped=s.get("gapped", False), pad=s.get("pad", 0))
    plan = make_plan(dst, s["v"], config=s["cfg"])
    xi = x.to(dtype)
    wi = w.to(dtype) if weighted else None
    before = kops.launch_counts()["gather_segment_reduce"]
    got = kops.gather_segment_reduce(xi, src, dst, s["v"], weight=wi,
                                     reduce=reduce, plan=plan, impl="cuda")
    torch.cuda.synchronize()
    assert kops.launch_counts()["gather_segment_reduce"] == before + 1
    assert got.dtype == dtype and got.shape == (s["v"], s["f"])
    want = kops.gather_segment_reduce(
        xi.float(), src, dst, s["v"], weight=None if wi is None else wi.float(),
        reduce=reduce, impl="ref")
    _close(got, want, dtype)


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
@pytest.mark.parametrize("reduce", ["sum", "mean"])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("dims", [(32, 64, 32), (100, 48, 32), (256, 128, 128)])
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
    assert card.chunk_first.is_cuda and card.chunk_count.is_cuda
    assert torch.equal(card.chunk_first.cpu(), host.chunk_first)
    assert torch.equal(card.chunk_count.cpu(), host.chunk_count)


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
}


@pytest.mark.parametrize("case", list(SMM_CASES))
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("with_plan", [False, True])
def test_segment_matmul_kernel(dev, case, dtype, with_plan):
    from repro_torch.core.plan import make_relation_plan
    c = SMM_CASES[case]
    rng = np.random.default_rng(len(case))
    sizes = torch.from_numpy(c["sizes"](rng).astype(np.int32)).to(dev)
    m = int(sizes.sum()) + c["pad"]
    x = torch.randn(m, c["k"], device=dev).to(dtype)
    w = (torch.randn(sizes.numel(), c["k"], c["n"], device=dev)
         / c["k"] ** 0.5).to(dtype)
    plan = make_relation_plan(sizes, num_rows=m, feat=c["n"]) \
        if with_plan else None
    before = kops.launch_counts()["segment_matmul"]
    got = kops.segment_matmul(x, sizes, w, plan=plan, impl="cuda")
    torch.cuda.synchronize()
    assert kops.launch_counts()["segment_matmul"] == before + 1
    assert got.dtype == dtype and got.shape == (m, c["n"])
    _close(got, kops.segment_matmul(x.float(), sizes, w.float(), impl="ref"),
           dtype)
    if c["pad"]:
        assert bool((got[m - c["pad"]:] == 0).all()), "rows of no group"


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("reduce", ["sum", "mean", "max"])
@pytest.mark.parametrize("shape", range(len(SHAPES)))
def test_segment_reduce_kernel(dev, dtype, reduce, shape):
    s = SHAPES[shape]
    _, dst, _, _ = _graph(dev, s["v"], s["e"], 1, seed=shape,
                          gapped=s.get("gapped", False), pad=s.get("pad", 0))
    x = torch.randn(dst.numel(), s["f"], device=dev).to(dtype)
    plan = make_plan(dst, s["v"], config=s["cfg"])
    for p in (plan, None):
        got = kops.segment_reduce(x, dst, s["v"], reduce, plan=p, impl="cuda")
        torch.cuda.synchronize()
        assert got.dtype == dtype and got.shape == (s["v"], s["f"])
        _close(got, kops.segment_reduce(x.float(), dst, s["v"], reduce,
                                        impl="ref"), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", [8, 64, 300])
def test_sddmm_kernel(dev, dtype, n):
    a = torch.randn(900, n, device=dev).to(dtype)
    b = torch.randn(700, n, device=dev).to(dtype)
    row = torch.randint(0, 900, (20000,), device=dev, dtype=torch.int32)
    col = torch.randint(0, 700, (20000,), device=dev, dtype=torch.int32)
    got = kops.sddmm(a, b, row, col, impl="cuda")
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == (20000,)
    _close(got, kops.sddmm(a.float(), b.float(), row, col, impl="ref"), dtype)
    with pytest.raises(ValueError, match="sddmm"):
        kops.sddmm(a, b, row, col.clone().fill_(700), impl="cuda")


def test_plan_on_the_host_is_refused_for_card_data(dev):
    _, dst, _, _ = _graph(dev, 500, 3000, 8, seed=3)
    host_plan = make_plan(dst, 500, device="cpu")
    with pytest.raises(ValueError, match="lies on cpu"):
        kops.segment_reduce(torch.randn(3000, 8, device=dev), dst, 500,
                            plan=host_plan, impl="cuda")
    card_plan = make_plan(dst, 500)
    assert card_plan.chunk_first.is_cuda and host_plan.to(dev).chunk_first.is_cuda


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
