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
