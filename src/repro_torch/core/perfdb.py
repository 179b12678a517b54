"""Performance database (paper §III-C, Fig. 5), over the Hopper lattice.

The paper gathers 51 PyG datasets, augments them by noising and scaling to
3060, sweeps the pruned config space per (dataset, F) offline on a GPU and
keeps the Top-1 config per key. The pipeline here is the reference
package's, with its dataset statistics (Table II verbatim) and its
augmentation factor, over the port's lattice (M_b run lengths × S_b
tiles, :func:`repro_torch.core.config_space.all_configs`). The analytical
sweep scores a point with the H100 cost model (:mod:`costmodel`); a sweep
measured on the card (:mod:`repro_torch.core.autotune`) feeds the same
Top-1 selection through :func:`repro_torch.core.train_rules.
records_from_perfdb`.

The two axes are read by different kernels, so a record says which it
measured (``axes``): an analytical record scores a layer pair (a gather at
M_b and a fused transform at S_b, both at width F), a measured gather or
segment_reduce sweep only M_b, a measured fused sweep only S_b. Top-1 is
taken per axis over the records that measured it; an axis no record at a
key measured keeps the shipped value.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Iterable, List, Sequence, Tuple

import numpy as np

from repro_torch.core import costmodel
from repro_torch.core.config_space import (DEFAULT_M_B, DEFAULT_S_B,
                                           KernelConfig, all_configs)
from repro_torch.core.features import InputFeatures

# Table II of the paper (name, |V|, |E|)
TABLE_II = [
    ("citeseer", 3_327, 9_104),
    ("cora", 2_708, 10_556),
    ("ppi", 2_245, 61_318),
    ("pubmed", 19_717, 88_648),
    ("amazon-photo", 7_650, 238_162),
    ("flickr", 89_250, 899_756),
    ("ogbn-arxiv", 169_343, 1_166_243),
    ("ogbl-collab", 235_868, 1_285_465),
    ("reddit2", 232_965, 23_213_838),
]

FEATURE_SIZES = (1, 2, 4, 8, 16, 32, 64, 128)
AXES = ("s_b", "m_b")       # the tree's outputs, in this order
# a value other than the shipped one must beat it by this factor in the
# cost model before the analytical rules leave it: the model's error on
# the card is larger than most of the gains it predicts (PERF.md)
MARGIN = 1.05


@dataclasses.dataclass(frozen=True)
class DatasetStats:
    name: str
    num_nodes: int
    num_edges: int

    @property
    def avg_degree(self) -> float:
        return self.num_edges / max(self.num_nodes, 1)


def base_datasets(n_base: int = 51, seed: int = 0) -> List[DatasetStats]:
    """Table II + synthetic graphs spanning the PyG-collection regime
    (|V| ∈ [1e3, 5e5], avg degree ∈ [1.5, 120], log-uniform)."""
    rng = np.random.default_rng(seed)
    out = [DatasetStats(*row) for row in TABLE_II]
    while len(out) < n_base:
        v = int(10 ** rng.uniform(3.0, 5.7))
        deg = 10 ** rng.uniform(np.log10(1.5), np.log10(120.0))
        out.append(DatasetStats(f"synth{len(out)}", v, int(v * deg)))
    return out[:n_base]


def augment(datasets: Sequence[DatasetStats], factor: int = 60,
            seed: int = 1) -> List[DatasetStats]:
    """Noise + scale augmentation (paper: 51 → 3060, i.e. ×60)."""
    rng = np.random.default_rng(seed)
    out: List[DatasetStats] = []
    for ds in datasets:
        for k in range(factor):
            scale = 2.0 ** rng.uniform(-2.0, 2.0)
            noise = rng.uniform(0.85, 1.15)
            v = max(64, int(ds.num_nodes * scale))
            e = max(v, int(ds.num_edges * scale * noise))
            out.append(DatasetStats(f"{ds.name}/aug{k}", v, e))
    return out


@dataclasses.dataclass(frozen=True)
class PerfRecord:
    """One row of the performance database (Fig. 5: key → GFlops)."""
    features: Tuple[float, ...]     # InputFeatures.as_vector()
    schedule: str
    config: Tuple                   # KernelConfig.astuple()
    gflops: float
    axes: Tuple[str, ...] = AXES    # the config axes this record measured


def default_evaluate(m: int, s: int, n: int, cfg: KernelConfig) -> float:
    """GFlops of a layer pair under the H100 model (higher is better): the
    gather at M_b plus, where its block fits, the fused kernel at S_b, both
    at width ``n`` → ``n``; a value off the shipped one pays
    :data:`MARGIN`."""
    from repro_torch.kernels.fused_transform_reduce import fusable
    t = costmodel.spmm_cost(m, s, n, cfg).total_s * (
        1.0 if cfg.m_b == DEFAULT_M_B else MARGIN)
    if fusable(n, n, "float32", cfg):
        t += costmodel.fused_transform_reduce_cost(m, s, n, n, cfg).total_s \
            * (1.0 if cfg.s_b == DEFAULT_S_B else MARGIN)
    return costmodel.useful_flops(m, n) / t / 1e9


def build_perfdb(datasets: Iterable[DatasetStats] | None = None,
                 feature_sizes: Sequence[int] = FEATURE_SIZES,
                 evaluate_fn: Callable[[int, int, int, KernelConfig], float]
                 = default_evaluate,
                 augment_factor: int = 60) -> List[PerfRecord]:
    """Sweep the lattice per (dataset × F); keep every measurement."""
    if datasets is None:
        datasets = augment(base_datasets(), factor=augment_factor)
    configs = {f: all_configs(feat_dim=f) for f in feature_sizes}
    records: List[PerfRecord] = []
    for ds in datasets:
        for f in feature_sizes:
            fv = tuple(InputFeatures(ds.num_edges, ds.num_nodes,
                                     f).as_vector())
            for cfg in configs[f]:
                g = evaluate_fn(ds.num_edges, ds.num_nodes, f, cfg)
                records.append(PerfRecord(fv, cfg.schedule, cfg.astuple(), g))
    return records


def top1_training_set(records: Sequence[PerfRecord], schedule: str = "SR"):
    """Top-1 selection (paper §III-C), per unique feature key and per axis:
    the best record of ``schedule`` among those that measured the axis
    gives its value; an axis none measured keeps the shipped value.
    Returns (X features, Y configs) with Y's columns :data:`AXES`."""
    best: dict = {}
    for r in records:
        if r.schedule != schedule:
            continue
        for axis in r.axes:
            cur = best.get((r.features, axis))
            if cur is None or r.gflops > cur.gflops:
                best[(r.features, axis)] = r
    shipped = {"s_b": DEFAULT_S_B, "m_b": DEFAULT_M_B}
    column = {"s_b": 1, "m_b": 3}       # positions in KernelConfig.astuple()
    xs, ys = [], []
    for feats in sorted({k for k, _ in best}):
        xs.append(feats)
        ys.append([best[(feats, a)].config[column[a]] if (feats, a) in best
                   else shipped[a] for a in AXES])
    return np.asarray(xs, np.float64), np.asarray(ys, np.float64)


def snap_config(raw: np.ndarray, feat_dim: int | None = None) -> KernelConfig:
    """Snap a (possibly fractional) tree prediction (S_b, M_b) onto the
    built lattice (nearest in log2 space). Degenerate predictions (zeros,
    NaN, ±inf) are clamped to 1 before the log, so the result is always a
    built point."""
    raw = np.asarray(raw, np.float64)
    raw = np.where(np.isnan(raw), 1.0, raw)
    raw = np.clip(raw, 1.0, 2.0 ** 30)
    target = np.log2(raw)

    def dist(c: KernelConfig) -> float:
        vec = np.log2(np.array([c.s_b, c.m_b], np.float64))
        return float(((vec - target) ** 2).sum())

    return min(all_configs(feat_dim), key=dist)
