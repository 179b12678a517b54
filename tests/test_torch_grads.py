"""The port's op backwards against ``jax.vjp`` of the reference on the CPU.

Same numpy inputs for both packages, made from a seed: sorted segment ids
with empty segments and dropped rows (``seg == num_segments``, the padding
convention) at the end, gather indices with repeats, F ∈ {3, 8, 16}. The
port runs its plain versions (``impl=None`` on CPU tensors) and, where a
kernel has a CPU mirror of its schedule, ``impl="blocked"``: the backward's
transposed walk then runs the gather kernel's row runs over the source
order. The reference runs at ``impl="ref"``.

Tolerances: fp32 within rtol = atol = 1e-5 element-wise. bf16 inputs and
cotangents are held against the fp32 cast-then-reduce oracle (the
reference's fp32 VJP of the same values upcast) within 2e-2, norm-relative
as ``tests/test_precision.py`` holds the reference's own bf16 gradients
(a contraction over many rows, such as the fused op's dW, may exceed an
element-wise tier in one element while the tensor stays inside it). The
weighted max is the one exception: its winners are decided on the bf16
products the forward rounds to, which the fp32 oracle does not see, so it
is held against the reference's own bf16 VJP, whose ``impl="ref"`` rounds
the same way.
"""
import collections
import functools
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import ops as jops  # noqa: E402

import repro_torch as rt  # noqa: E402
from repro_torch.core import plan as tplan  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402

V, S, E, DROP = 30, 26, 220, 12
FEATS = [3, 8, 16]
DTYPES = ["float32", "bfloat16"]
REDUCES = ["sum", "mean", "max"]
T = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _indices(seed=0):
    """(gather ids (E,), sorted segment ids (E,)): ids of every third
    segment skipped (empty segments), DROP rows past the segments."""
    rng = np.random.default_rng(seed)
    seg = np.sort(rng.integers(0, S, E - DROP))
    seg = np.where(seg % 3 == 1, seg - 1, seg)
    seg = np.concatenate([seg, np.full(DROP, S)]).astype(np.int32)
    gidx = rng.integers(0, V, E).astype(np.int32)
    return gidx, seg


def _normal(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _round(a, dtype):
    """The inputs as the port sees them, and as the oracle sees them (the
    same values, upcast)."""
    t = torch.from_numpy(a).to(T[dtype])
    return t, t.float().numpy()


@functools.lru_cache(maxsize=None)
def _jax_grads(op, dtype, *case):
    """The reference's gradients of one case (cached: the plain and the
    blocked port runs share them)."""
    fn, args, ct = _CASES[op](dtype, *case)
    oracle_dtype = "bfloat16" if (op == "iwsr" and case[0] == "max"
                                  and dtype == "bfloat16") else "float32"
    jargs = [jnp.asarray(a, jnp.dtype(oracle_dtype)) for a in args[0]]
    _, vjp = jax.vjp(lambda *a: fn[0](*a), *jargs)
    return [np.asarray(g, np.float32)
            for g in vjp(jnp.asarray(ct[1], jnp.dtype(oracle_dtype)))]


def _port_grads(op, dtype, impl, *case):
    fn, args, ct = _CASES[op](dtype, *case)
    targs = [t.clone().requires_grad_() for t in args[1]]
    y = fn[1](*targs, impl)
    y.backward(ct[0].to(y.dtype))
    for t, a in zip(targs, args[1]):
        assert t.grad.dtype == a.dtype
    return [t.grad.float().numpy() for t in targs]


def _assert_close(got, want, dtype):
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        rel = np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-12)
        assert rel < 2e-2, f"norm-relative error {rel:.3e}"


# ---------------------------------------------------------------------------
# the cases: (jax fn, torch fn), (jax args, torch args), (torch ct, np ct)
# ---------------------------------------------------------------------------

def _seg_reduce(dtype, reduce, f):
    _, seg = _indices(1)
    x, xo = _round(_normal((E, f), 2), dtype)
    ct, cto = _round(_normal((S, f), 3), dtype)
    j = (lambda x: jops.segment_reduce(x, jnp.asarray(seg), S, reduce,
                                       "ref"),
         lambda x, impl: rt.segment_reduce(x, torch.from_numpy(seg), S,
                                           reduce, impl))
    return j, ([xo], [x]), (ct, cto)


def _gather(dtype, f):
    gidx, _ = _indices(4)
    h, ho = _round(_normal((V, f), 5), dtype)
    ct, cto = _round(_normal((E, f), 6), dtype)
    j = (lambda h: jops.gather(h, jnp.asarray(gidx)),
         lambda h, impl: rt.gather(h, torch.from_numpy(gidx)))
    return j, ([ho], [h]), (ct, cto)


def _isr(dtype, reduce, f):
    gidx, seg = _indices(7)
    h, ho = _round(_normal((V, f), 8), dtype)
    ct, cto = _round(_normal((S, f), 9), dtype)
    j = (lambda h: jops.index_segment_reduce(
            h, jnp.asarray(gidx), jnp.asarray(seg), S, reduce, "ref"),
         lambda h, impl: rt.index_segment_reduce(
            h, torch.from_numpy(gidx), torch.from_numpy(seg), S, reduce,
            impl))
    return j, ([ho], [h]), (ct, cto)


def _iwsr(dtype, reduce, f):
    gidx, seg = _indices(10)
    h, ho = _round(_normal((V, f), 11), dtype)
    w, wo = _round(_normal((E,), 12), dtype)
    ct, cto = _round(_normal((S, f), 13), dtype)
    j = (lambda h, w: jops.index_weight_segment_reduce(
            h, jnp.asarray(gidx), w, jnp.asarray(seg), S, reduce, "ref"),
         lambda h, w, impl: rt.index_weight_segment_reduce(
            h, torch.from_numpy(gidx), w, torch.from_numpy(seg), S, reduce,
            impl))
    return j, ([ho, wo], [h, w]), (ct, cto)


def _fused(dtype, reduce, weighted, f):
    gidx, seg = _indices(14)
    h, ho = _round(_normal((V, f), 15), dtype)
    wm, wmo = _round(_normal((f, 5), 16) / f ** 0.5, dtype)
    ct, cto = _round(_normal((S, 5), 18), dtype)
    jg, js = jnp.asarray(gidx), jnp.asarray(seg)
    tg, ts = torch.from_numpy(gidx), torch.from_numpy(seg)
    if not weighted:
        j = (lambda h, wm: jops.fused_transform_reduce(
                h, wm, jg, None, js, S, reduce, "ref"),
             lambda h, wm, impl: rt.fused_transform_reduce(
                h, wm, tg, None, ts, S, reduce, impl))
        return j, ([ho, wmo], [h, wm]), (ct, cto)
    w, wo = _round(_normal((E,), 17), dtype)
    j = (lambda h, wm, w: jops.fused_transform_reduce(
            h, wm, jg, w, js, S, reduce, "ref"),
         lambda h, wm, w, impl: rt.fused_transform_reduce(
            h, wm, tg, w, ts, S, reduce, impl))
    return j, ([ho, wmo, wo], [h, wm, w]), (ct, cto)


def _sddmm(dtype, f):
    row, col = (np.random.default_rng(19).integers(0, n, E).astype(np.int32)
                for n in (S, V))
    a, ao = _round(_normal((S, f), 20), dtype)
    b, bo = _round(_normal((V, f), 21), dtype)
    ct, cto = _round(_normal((E,), 22), dtype)
    j = (lambda a, b: jops.sddmm(a, b, jnp.asarray(row), jnp.asarray(col),
                                 "ref"),
         lambda a, b, impl: rt.sddmm(a, b, torch.from_numpy(row),
                                     torch.from_numpy(col), impl))
    return j, ([ao, bo], [a, b]), (ct, cto)


def _softmax(dtype, heads):
    _, seg = _indices(23)
    shape = (E,) if heads == 0 else (E, heads)
    x, xo = _round(_normal(shape, 24) * 3, dtype)
    ct, cto = _round(_normal(shape, 25), dtype)
    j = (lambda x: jops.segment_softmax(x, jnp.asarray(seg), S, "ref"),
         lambda x, impl: rt.segment_softmax(x, torch.from_numpy(seg), S,
                                            impl))
    return j, ([xo], [x]), (ct, cto)


GROUPS = np.array([0, 40, 0, 77, 1, 0, 60], np.int32)   # empty groups
M_PAST = 9                                              # rows of no group


def _gsm(dtype, k):
    m = int(GROUPS.sum()) + M_PAST
    x, xo = _round(_normal((m, k), 26), dtype)
    w, wo = _round(_normal((GROUPS.size, k, 6), 27) / k ** 0.5, dtype)
    ct, cto = _round(_normal((m, 6), 28), dtype)
    j = (lambda x, w: jops.grouped_segment_matmul(x, jnp.asarray(GROUPS), w,
                                                  "ref"),
         lambda x, w, impl: rt.grouped_segment_matmul(
            x, torch.from_numpy(GROUPS), w, impl))
    return j, ([xo, wo], [x, w]), (ct, cto)


_CASES = {"segment_reduce": _seg_reduce, "gather": _gather, "isr": _isr,
          "iwsr": _iwsr, "fused": _fused, "sddmm": _sddmm,
          "softmax": _softmax, "gsm": _gsm}


def _check(op, dtype, impl, *case):
    want = _jax_grads(op, dtype, *case)
    got = _port_grads(op, dtype, impl, *case)
    assert len(got) == len(want)
    if op == "softmax":
        # the reference's softmax reads its dropped rows' max with an
        # out-of-range jnp.take, which fills NaN; the port's padded rows
        # are exactly 0, and so is their gradient
        assert np.isnan(want[0][E - DROP:]).all()
        assert (got[0][E - DROP:] == 0).all()
        got, want = [got[0][:E - DROP]], [want[0][:E - DROP]]
    for g, w in zip(got, want):
        _assert_close(g, w, dtype)


# ---------------------------------------------------------------------------
# each op against jax.vjp
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("impl", [None, "blocked"])
@pytest.mark.parametrize("f", FEATS)
@pytest.mark.parametrize("reduce", REDUCES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_segment_reduce_grad(dtype, reduce, f, impl):
    _check("segment_reduce", dtype, impl, reduce, f)


@pytest.mark.parametrize("f", FEATS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_gather_grad(dtype, f):
    _check("gather", dtype, None, f)


@pytest.mark.parametrize("impl", [None, "blocked"])
@pytest.mark.parametrize("f", FEATS)
@pytest.mark.parametrize("reduce", REDUCES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_index_segment_reduce_grad(dtype, reduce, f, impl):
    _check("isr", dtype, impl, reduce, f)


@pytest.mark.parametrize("impl", [None, "blocked"])
@pytest.mark.parametrize("f", FEATS)
@pytest.mark.parametrize("reduce", REDUCES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_index_weight_segment_reduce_grad(dtype, reduce, f, impl):
    _check("iwsr", dtype, impl, reduce, f)


def test_weight_grad_reads_bf16_h_in_its_own_dtype(monkeypatch):
    """The MoE combine's router-weight gradient with bf16 expert outputs
    (T = 16 tokens, top-4, F = 2048; the rows gathered through a
    permutation, fp32 weights): the port's sddmm reads H in bf16, the
    reference widens it to fp32 (``sum(f32(H[g]) * f32(g_msg))``); the
    same products, summed in another order, within the fp32 tier. On the
    CPU the dots run on the plain version."""
    t, k, f = 16, 4, 2048
    rng = np.random.default_rng(41)
    seg = np.repeat(np.arange(t), k).astype(np.int32)
    gidx = rng.permutation(t * k).astype(np.int32)
    h, ho = _round(_normal((t * k, f), 42), "bfloat16")
    w = _normal((t * k,), 43)
    ct, cto = _round(_normal((t, f), 44), "bfloat16")
    _, vjp = jax.vjp(lambda w: jops.index_weight_segment_reduce(
        jnp.asarray(ho, jnp.bfloat16), jnp.asarray(gidx), w,
        jnp.asarray(seg), t, "sum", "ref"), jnp.asarray(w))
    want = np.asarray(vjp(jnp.asarray(cto, jnp.bfloat16))[0], np.float32)
    seen = []
    rows = kops.sddmm_rows

    def spy(a, b, *args):
        seen.append((a.dtype, b.dtype))
        return rows(a, b, *args)
    monkeypatch.setattr(kops, "sddmm_rows", spy)
    wt = torch.from_numpy(w).requires_grad_()
    with kops.fusion_scope() as fusion:     # the backward records here too
        y = rt.index_weight_segment_reduce(h, torch.from_numpy(gidx), wt,
                                           torch.from_numpy(seg), t, "sum",
                                           impl="ref")
        y.backward(ct)
    assert y.dtype == torch.bfloat16
    assert fusion["unfused:sddmm:ref"] == 1
    assert seen == [(torch.float32, torch.bfloat16)]    # H not widened
    assert wt.grad.dtype == torch.float32
    _assert_close(wt.grad.numpy(), want, "float32")


@pytest.mark.parametrize("impl", [None, "blocked"])
@pytest.mark.parametrize("f", FEATS)
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("reduce", ["sum", "mean"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_fused_transform_reduce_grad(dtype, reduce, weighted, f, impl):
    _check("fused", dtype, impl, reduce, weighted, f)


@pytest.mark.parametrize("f", FEATS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_sddmm_grad(dtype, f):
    _check("sddmm", dtype, None, f)


@pytest.mark.parametrize("impl", [None, "blocked"])
@pytest.mark.parametrize("heads", [0, 1, 4])
@pytest.mark.parametrize("dtype", DTYPES)
def test_segment_softmax_grad(dtype, heads, impl):
    _check("softmax", dtype, impl, heads)


@pytest.mark.parametrize("k", FEATS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_grouped_segment_matmul_grad(dtype, k):
    _check("gsm", dtype, None, k)


@pytest.mark.parametrize("impl", [None, "blocked"])
@pytest.mark.parametrize("k", FEATS)
def test_grouped_segment_matmul_dx_reads_w_in_place(k, impl, monkeypatch):
    """The backward's dX is one segment_matmul that reads W[g]ᵀ in place
    (``w_transposed``, the forward's own W tensor, no transposed copy),
    held with dW to ``jax.vjp`` of the reference in fp32 (1e-5); with
    ``impl="blocked"`` the forward and the dX walk the wgmma path's work
    items."""
    calls = []
    orig = kops.segment_matmul

    def spy(x, group_sizes, w, *args, **kwargs):
        calls.append((w, kwargs.get("w_transposed", False)))
        return orig(x, group_sizes, w, *args, **kwargs)
    monkeypatch.setattr(kops, "segment_matmul", spy)
    want = _jax_grads("gsm", "float32", k)
    fn, args, ct = _CASES["gsm"]("float32", k)
    x, w = (t.clone().requires_grad_() for t in args[1])
    y = fn[1](x, w, impl)
    y.backward(ct[0])
    (fw, fw_t), (bw, bw_t) = calls
    assert fw is w and not fw_t
    assert bw is w and bw_t          # W itself, read transposed
    for g, want_g in zip((x.grad, w.grad), want):
        _assert_close(g.numpy(), want_g, "float32")


# ---------------------------------------------------------------------------
# rules: ties, the graph plan's source order, gradients not asked for
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("impl", [None, "blocked"])
def test_max_ties_split_the_gradient(impl):
    """Tied maxima share a segment's cotangent equally (the reference's
    ``_split_ties``), for segment_reduce and through duplicate edges."""
    x = torch.tensor([[5.0], [5.0], [1.0]], requires_grad=True)
    idx = torch.zeros(3, dtype=torch.int32)
    rt.segment_reduce(x, idx, 1, "max", impl).sum().backward()
    assert x.grad[:, 0].tolist() == [0.5, 0.5, 0.0]
    # segment 0 gets row 2 through two tied edges and row 1 through one:
    # each edge 1/3 of the cotangent, row 2 twice
    h = torch.tensor([[1.0], [3.0], [3.0]], requires_grad=True)
    gidx = torch.tensor([2, 1, 2, 0], dtype=torch.int32)
    seg = torch.tensor([0, 0, 0, 1], dtype=torch.int32)
    rt.index_segment_reduce(h, gidx, seg, 2, "max", impl).sum().backward()
    torch.testing.assert_close(h.grad[:, 0], torch.tensor([1.0, 1 / 3,
                                                           2 / 3]))


@pytest.mark.parametrize("op", ["iwsr", "fused"])
def test_graph_plan_source_order_gives_the_same_bits(op):
    """With a graph plan the backward walks the plan's source order (its
    dropped edges past the sources' offsets); without one it sorts on the
    device: the same schedule, the same bits. A plan whose source order
    belongs to another gather index is refused."""
    from repro_torch.data.graphs import pad_graph, synth_graph
    g = pad_graph(synth_graph("g", 40, 300, feat=8, seed=5), 40, 320)
    plan = g.make_plan(device="cpu")
    assert plan.src_order.num_real == 300
    src, dst = (torch.from_numpy(a) for a in g.edge_index)
    x = torch.from_numpy(g.x)
    w = torch.from_numpy(_normal((320,), 30))
    wm = torch.from_numpy(_normal((8, 4), 31))

    def grads(p):
        leaves = [t.clone().requires_grad_() for t in (x, w, wm)]
        if op == "iwsr":
            y = rt.index_weight_segment_reduce(leaves[0], src, leaves[1],
                                               dst, 40, "sum", "blocked",
                                               None, p)
        else:
            y = rt.fused_transform_reduce(leaves[0], leaves[2], src,
                                          leaves[1], dst, 40, "mean",
                                          "blocked", None, p)
        y.backward(torch.ones_like(y))
        return [t.grad for t in leaves if t.grad is not None]

    for a, b in zip(grads(plan), grads(None)):
        assert torch.equal(a, b)
    # the dropped edges get no weight gradient
    assert bool((grads(plan)[1][300:] == 0).all())
    # the typed layers' case: (E, F) messages gathered by a permutation
    msg = torch.from_numpy(_normal((320, 8), 32)).requires_grad_()
    perm = torch.randperm(320, generator=torch.Generator().manual_seed(0))
    y = rt.index_segment_reduce(msg, perm.to(torch.int32), dst, 40, "sum",
                                None, None, plan)
    with pytest.raises(ValueError, match="without_source_order"):
        y.sum().backward()
    y = rt.index_segment_reduce(msg, perm.to(torch.int32), dst, 40, "sum",
                                None, None, plan.without_source_order())
    y.sum().backward()
    assert bool((msg.grad[perm[300:]] == 0).all())


def test_only_the_gradients_asked_for_run():
    """No dH walk when H needs no gradient (a first layer's input), no
    SDDMM when the edge weight needs none (GCN's normalization); counted
    through the fusion counters."""
    gidx, seg = (torch.from_numpy(a) for a in _indices(32))
    h = torch.from_numpy(_normal((V, 8), 33))
    w = torch.from_numpy(_normal((E,), 34))
    wm = torch.from_numpy(_normal((8, 4), 35))

    def run(fn):
        with kops.fusion_scope() as fusion:
            y = fn()
            forward = collections.Counter(fusion)
            y.sum().backward()
        return set(collections.Counter(fusion) - forward)  # the backward's

    wg = w.clone().requires_grad_()
    assert run(lambda: rt.index_weight_segment_reduce(
        h, gidx, wg, seg, S)) == {"unfused:sddmm:ref"}
    hg = h.clone().requires_grad_()
    assert run(lambda: rt.index_weight_segment_reduce(
        hg, gidx, w, seg, S)) == {"unfused:transposed_gather_weighted:ref"}
    wmg = wm.clone().requires_grad_()
    assert run(lambda: rt.fused_transform_reduce(
        h, wmg, gidx, w, seg, S)) == {
            "unfused:gather_segment_reduce_weighted:ref"}
    assert wg.grad is not None and hg.grad is not None
    assert wmg.grad is not None


def test_source_order_schedule():
    """The source order keeps the edges of each source in edge order and
    sorts the dropped ones last, past the sources' offsets."""
    gidx = torch.tensor([2, 0, 2, 1, 0, 2], dtype=torch.int32)
    seg = torch.tensor([0, 0, 1, 1, 2, 3], dtype=torch.int32)
    order = tplan.source_order(gidx, seg, 3, 3)
    assert order.perm.tolist() == [1, 4, 3, 0, 2, 5]
    assert order.src.tolist() == [0, 0, 1, 2, 2, 3]
    assert order.dst.tolist() == [0, 2, 1, 0, 1, 0]
    assert order.row_ptr.tolist() == [0, 2, 3, 5]
    plain = tplan.source_order(gidx, None, 0, 3)
    assert plain.dst.tolist() == plain.perm.tolist()


def test_backward_records_in_its_forwards_fusion_scope():
    """The autograd engine runs a CUDA backward on a thread of its own; the
    ops' backwards record their kernels in the scope their forward ran in,
    whatever thread runs them (here a thread started for the backward)."""
    gidx, seg = (torch.from_numpy(a) for a in _indices(36))
    h = torch.from_numpy(_normal((V, 8), 37)).requires_grad_()
    with kops.fusion_scope() as fusion:
        y = rt.index_segment_reduce(h, gidx, seg, S, "sum")
        th = threading.Thread(target=lambda: y.sum().backward())
        th.start()
        th.join(timeout=60)
    assert not th.is_alive() and h.grad is not None
    assert dict(fusion) == {"unfused:gather_segment_reduce:ref": 1,
                            "unfused:transposed_gather:ref": 1}
