"""The yardstick's arithmetic against ``chip_smoke.py``'s reviewed
reckoning and the configurations' published shapes (CPU)."""
from __future__ import annotations

import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from bench import roofline  # noqa: E402
from bench.roofline import Arg  # noqa: E402


def _bytes(name, args):
    return roofline.op_cost("repro_torch::" + name, args)[0]


def test_moe_combine_t4096_matches_chip_smoke():
    """PR 26's 3h (a) combine: 32,768 bf16 rows of F = 2048 into 4096
    tokens on the runs path (151,355,400 B in chip_smoke.py)."""
    t, a, d = 4096, 32768, 2048
    args = [Arg([a, d], "c10::BFloat16"), Arg([a], "int"), Arg([a], "int"),
            Arg([], "Scalar", str(t)), Arg([a], "c10::BFloat16"),
            Arg([], ""), Arg([t + 1], "long int"), Arg([], "Scalar", "64")]
    assert _bytes("gather_segment_reduce", args) == 151_355_400


def test_moe_training_product_matches_chip_smoke():
    """PR 26's 3i forward up product: 16,384 bf16 rows 2048 -> 768 over 128
    experts (494,928,388 B in chip_smoke.py)."""
    a, k, n, g = 16384, 2048, 768, 128
    args = [Arg([a, k], "c10::BFloat16"), Arg([g, k, n], "c10::BFloat16"),
            Arg([g + 1], "int"), Arg([256], "int"), Arg([256], "int"),
            Arg([], "Scalar", "64"), Arg([], "Scalar", "False")]
    nbytes, floors = roofline.op_cost("repro_torch::segment_matmul", args)
    assert nbytes == 494_928_388
    assert floors == [(2 * a * k * n, roofline.BF16_FLOPS)]


def test_segment_matmul_reads_w_transposed():
    a, k, n, g = 16384, 768, 2048, 128
    args = [Arg([a, k], "c10::BFloat16"), Arg([g, n, k], "c10::BFloat16"),
            Arg([g + 1], "int"), Arg([256], "int"), Arg([256], "int"),
            Arg([], "Scalar", "64"), Arg([], "Scalar", "True")]
    assert _bytes("segment_matmul", args) == (a * (k + n) * 2 + g * k * n * 2
                                              + (g + 1) * 4)


def test_sddmm_router_weight_gradient_matches_chip_smoke():
    """3i's combine dw: A fp32 (2048, 2048), B bf16 (16,384, 2048), 16,384
    pairs: t·d·4 + a·d·2 + a·8 + a·4."""
    t, a, d = 2048, 16384, 2048
    args = [Arg([t, d], "float"), Arg([a, d], "c10::BFloat16"),
            Arg([a], "int"), Arg([a], "int")]
    assert _bytes("sddmm", args) == t * d * 4 + a * d * 2 + a * 8 + a * 4


def test_fused_bound_takes_the_tensor_cores_for_its_product():
    v, e, d_in, d_out = 232965, 23213838, 64, 64
    args = [Arg([v, d_in], "float"), Arg([d_in, d_out], "float"),
            Arg([e], "int"), Arg([], "Scalar", str(v)), Arg([], ""),
            Arg([], ""), Arg([v + 1], "long int"), Arg([], "Scalar", "16")]
    nbytes, floors = roofline.op_cost("repro_torch::fused_transform_reduce",
                                      args)
    assert nbytes == (v * d_in * 4 + d_in * d_out * 4 + e * 4 + (v + 1) * 8
                      + v * d_out * 4)
    assert floors == [(e * d_in, roofline.FP32_FLOPS),
                      (3 * 2 * v * d_in * d_out, roofline.TF32_FLOPS)]


def test_least_time_is_the_largest_floor():
    assert roofline.least_s(3.35e12, [(67e12, roofline.FP32_FLOPS)]) == \
        pytest.approx(1.0)
    assert roofline.least_s(0, [(1e12, 1e12), (4e12, 1e12)]) == 4.0


def test_sage_reddit2_flops():
    cfg = json.loads((ROOT / "bench/configs/sage-reddit2.json").read_text())
    dims = [602, 64, 64, 41]
    got = roofline.sage_infer_flops(cfg["num_nodes"], cfg["num_edges"], dims)
    assert got == pytest.approx(46.1e9, rel=2e-3)


def test_qwen3_moe_flops_a_token():
    cfg = json.loads((ROOT / "bench/configs/qwen3-moe-30b-a3b-4l.json")
                     .read_text())
    active = roofline.qwen3_moe_active_matmul_params(cfg)
    assert active == pytest.approx(539e6, rel=2e-3)
    assert roofline.qwen3_moe_train_flops_per_token(cfg, 1024) == \
        pytest.approx(3.33e9, rel=1e-2)
