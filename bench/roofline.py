"""The yardstick's arithmetic: the card's published peaks, the least time a
call of each of the port's custom ops needs (from its recorded shapes and
dtypes), and each model's FLOPs a unit of work.

Peaks are NVIDIA's data sheet for the H100 SXM (dense, no sparsity): they
assume the full 700 W power limit, so every reading that uses them is
printed beside the card's limit.

An op's least time is the larger of its bytes over the memory rate and its
FLOPs over the peak of the unit that does them (for a call that does work
on two units, each unit's share is a separate floor and the largest floor
holds). Each input is read once and each output written once, whatever the
kernel reads again: a gathered operand counts the rows it has, or the rows
gathered where those are fewer. The counts follow ``chip_smoke.py``'s
reviewed reckoning (the MoE combine and the expert products reproduce its
byte counts exactly), applied alike to every role of an op.
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12     # 80 GB HBM3
FP32_FLOPS = 67e12            # fp32 outside the tensor cores
TF32_FLOPS = 495e12           # tensor cores, TF32
BF16_FLOPS = 989e12           # tensor cores, bf16 and fp16

# the element sizes of the dtypes the profiler records ("Input type")
ELEMENT_BYTES = {
    "float": 4, "c10::BFloat16": 2, "c10::Half": 2, "double": 8,
    "int": 4, "long int": 8, "short int": 2, "signed char": 1,
    "unsigned char": 1, "bool": 1,
}
_LOW_PRECISION = ("c10::BFloat16", "c10::Half")


class Arg:
    """One recorded argument of a call: its dims (empty for a scalar or
    None), its type name and, for a scalar, its value as recorded."""

    def __init__(self, dims, dtype: str = "", value: str = ""):
        self.dims = [int(d) for d in (dims or [])]
        self.dtype = dtype or ""
        self.value = value or ""

    @property
    def present(self) -> bool:
        return bool(self.dims) or self.dtype not in ("", "Scalar")

    @property
    def es(self) -> int:
        if self.dtype not in ELEMENT_BYTES:
            raise KeyError(f"no element size for dtype {self.dtype!r}")
        return ELEMENT_BYTES[self.dtype]

    @property
    def numel(self) -> int:
        n = 1
        for d in self.dims:
            n *= d
        return n

    @property
    def nbytes(self) -> int:
        return self.numel * self.es if self.present else 0

    def rows(self) -> int:
        return self.dims[0] if self.dims else 0

    def width(self) -> int:
        n = 1
        for d in self.dims[1:]:
            n *= d
        return n

    def int_value(self) -> int:
        return int(float(self.value))


def least_s(nbytes: int, floors) -> float:
    """max(bytes / HBM rate, each (flops, peak) floor's flops / peak)."""
    return max([nbytes / HBM_BYTES_PER_S]
               + [flops / peak for flops, peak in floors])


def _gather_rows(h: Arg, rows: int) -> int:
    """Bytes of a gathered operand: its rows, or the rows gathered where
    those are fewer."""
    return min(h.rows(), rows) * h.width() * h.es


def gather_segment_reduce(args) -> tuple:
    """``repro_torch::gather_segment_reduce(h, gather_idx, seg_idx,
    num_segments, weight, reduce, row_ptr, run_rows)``: rows of h gathered,
    the two indices, the weights, the row offsets where the runs path reads
    them, the (S, F) output; 2 FLOPs a weighted row element, 1 unweighted."""
    h, gidx, seg, nseg, weight, _reduce, row_ptr = args[:7]
    m, s, f = seg.rows(), nseg.int_value(), h.width()
    nbytes = (_gather_rows(h, m) + gidx.nbytes + seg.nbytes + weight.nbytes
              + row_ptr.nbytes + s * f * h.es)
    flops = (2 if weight.present else 1) * m * f
    return nbytes, [(flops, FP32_FLOPS)]


def segment_reduce(args) -> tuple:
    """``repro_torch::segment_reduce(x, idx, num_segments, reduce, row_ptr,
    run_rows)``."""
    x, idx, nseg, _reduce, row_ptr = args[:5]
    s, f = nseg.int_value(), x.width()
    nbytes = x.nbytes + idx.nbytes + row_ptr.nbytes + s * f * x.es
    return nbytes, [(x.numel, FP32_FLOPS)]


def segment_softmax(args) -> tuple:
    """``repro_torch::segment_softmax(x, idx, num_segments, row_ptr)``: x
    read, the output (x's shape) written; max, exp, sum and divide."""
    x, idx, _nseg, row_ptr = args[:4]
    nbytes = 2 * x.nbytes + idx.nbytes + row_ptr.nbytes
    return nbytes, [(4 * x.numel, FP32_FLOPS)]


def fused_transform_reduce(args) -> tuple:
    """``repro_torch::fused_transform_reduce(h, w, gather_idx, num_segments,
    weight, reduce, row_ptr, tile)``: the aggregation at d_in on the CUDA
    cores and the (S, d_in) x (d_in, d_out) product on the tensor cores
    (fp32 as 3xTF32, three TF32 products)."""
    h, w, gidx, nseg, weight, _reduce, row_ptr = args[:7]
    e, s = gidx.rows(), nseg.int_value()
    d_in, d_out = h.width(), w.dims[-1]
    nbytes = (_gather_rows(h, e) + w.nbytes + gidx.nbytes + weight.nbytes
              + row_ptr.nbytes + s * d_out * h.es)
    agg = (2 if weight.present else 1) * e * d_in
    gemm = 2 * s * d_in * d_out
    mm = (gemm, BF16_FLOPS) if h.dtype in _LOW_PRECISION \
        else (3 * gemm, TF32_FLOPS)
    return nbytes, [(agg, FP32_FLOPS), mm]


def segment_matmul(args) -> tuple:
    """``repro_torch::segment_matmul(x, w, offsets, first_group,
    group_count, m_b, w_transposed)``: X read and the output written once,
    every group's W once, the group offsets; bf16 on the tensor cores, fp32
    as 3xTF32 (the per-tile metadata is the program's own schedule and not
    counted)."""
    x, w, offsets = args[:3]
    transposed = len(args) > 6 and args[6].value.lower() in ("true", "1")
    m, k = x.rows(), x.width()
    g = w.dims[0]
    n = w.dims[1] if transposed else w.dims[2]
    nbytes = m * k * x.es + g * k * n * w.es + offsets.nbytes + m * n * x.es
    flops = 2 * m * k * n
    peak = (flops, BF16_FLOPS) if x.dtype in _LOW_PRECISION \
        else (3 * flops, TF32_FLOPS)
    return nbytes, [peak]


def sddmm(args) -> tuple:
    """``repro_torch::sddmm(a, b, row_idx, col_idx)``: the rows of A and B
    the pairs read, both indices, one output a pair (A's dtype)."""
    a, b, row, col = args[:4]
    m, f = row.rows(), a.width()
    nbytes = (_gather_rows(a, m) + _gather_rows(b, m) + row.nbytes
              + col.nbytes + m * a.es)
    return nbytes, [(2 * m * f, FP32_FLOPS)]


OPS = {
    "repro_torch::gather_segment_reduce": gather_segment_reduce,
    "repro_torch::segment_reduce": segment_reduce,
    "repro_torch::segment_softmax": segment_softmax,
    "repro_torch::fused_transform_reduce": fused_transform_reduce,
    "repro_torch::segment_matmul": segment_matmul,
    "repro_torch::sddmm": sddmm,
}


def op_cost(name: str, args) -> tuple:
    """(bytes, [(flops, peak)]) of a call of the custom op ``name``."""
    return OPS[name](args)


def op_least_s(name: str, args) -> float:
    """The least seconds a call of the custom op ``name`` needs."""
    return least_s(*op_cost(name, args))


# ---------------------------------------------------------------------------
# model FLOPs a unit of work (fixed formulas of the configurations' shapes)
# ---------------------------------------------------------------------------

def sage_infer_flops(num_nodes: int, num_edges: int, dims) -> int:
    """One full-graph GraphSAGE (mean) forward: each layer's two dense
    transforms (self and neighbour, 2·V·d_in·d_out each) and one mean
    aggregation at the narrower width (E·min(d_in, d_out) adds)."""
    total = 0
    for d_in, d_out in zip(dims[:-1], dims[1:]):
        total += 2 * 2 * num_nodes * d_in * d_out
        total += num_edges * min(d_in, d_out)
    return total


def qwen3_moe_active_matmul_params(cfg: dict) -> int:
    """The matmul parameters a token passes through: attention's q, k, v
    and o projections, the router, the top-k experts' three products in
    every layer, and the head (the embedding lookup is no matmul)."""
    d = cfg["hidden_size"]
    q = cfg["num_attention_heads"] * cfg["head_dim"]
    kv = cfg["num_key_value_heads"] * cfg["head_dim"]
    attn = d * q + 2 * d * kv + q * d
    router = d * cfg["num_experts"]
    experts = cfg["num_experts_per_tok"] * 3 * d * cfg["moe_intermediate_size"]
    return cfg["num_hidden_layers"] * (attn + router + experts) \
        + d * cfg["vocab_size"]


def qwen3_moe_train_flops_per_token(cfg: dict, seq_len: int) -> float:
    """6 x the active matmul parameters (forward and backward) plus causal
    attention's scores and values: 2 products of 2·(S/2)·q_dim FLOPs a
    token a layer in the forward, three times that with the backward."""
    q = cfg["num_attention_heads"] * cfg["head_dim"]
    attn = 3 * 2 * 2 * (seq_len / 2) * q * cfg["num_hidden_layers"]
    return 6 * qwen3_moe_active_matmul_params(cfg) + attn
