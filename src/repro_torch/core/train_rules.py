"""End-to-end rule training pipeline (paper Fig. 5):

    datasets → augment → offline sweep → performance database
    → Top-1 per key → multi-output decision tree (S_b, M_b) → codegen
    → ``_generated_rules.py``

Two sources for the database:
  * analytical (default): the H100 cost model scores the lattice over the
    augmented Table II datasets (runs anywhere, no card; the committed
    rules are this mode's output, byte for byte);
  * measured: ``--from-perfdb <path>`` reads the sweeps that
    :func:`repro_torch.core.autotune.tune` timed on the card.

Run:  PYTHONPATH=src python -m repro_torch.core.train_rules [--out P]
      PYTHONPATH=src python -m repro_torch.core.train_rules --from-perfdb DB
"""
from __future__ import annotations

import argparse
import pathlib
import sys
from typing import List, Optional, Sequence

from repro_torch.core import codegen, costmodel, perfdb
from repro_torch.core.config_space import OP_AXIS, KernelConfig
from repro_torch.core.decision_tree import MultiOutputDecisionTree
from repro_torch.core.features import InputFeatures

# the measured ops whose sweeps train an axis, and the axis
MEASURED_AXES = {op: (axis,) for op, axis in OP_AXIS.items() if axis}
ANALYTICAL_SOURCE = ("the analytical H100 cost model "
                     "(repro_torch.core.costmodel) over the augmented "
                     "Table II datasets")


def records_from_perfdb(path=None) -> List[perfdb.PerfRecord]:
    """Every measured (config, µs) pair of the ops in
    :data:`MEASURED_AXES` as a :class:`PerfRecord` of the axis its op
    reads; GFlops is the shape class's useful work over the measured time,
    so Top-1 works the same on measured and analytical rows."""
    from repro_torch.core.autotune import PerfDB
    records: List[perfdb.PerfRecord] = []
    for entry in PerfDB(path).load().values():
        axes = MEASURED_AXES.get(entry.get("op"))
        if axes is None:
            continue
        m, s, f = entry["idx_size"], entry["num_segments"], entry["feat"]
        fv = tuple(InputFeatures(m, s, f).as_vector())
        flops = costmodel.useful_flops(m, f)
        for t in entry["timings"]:
            cfg = KernelConfig(*t["config"])
            us = max(float(t["us"]), 1e-9)
            records.append(perfdb.PerfRecord(fv, cfg.schedule, cfg.astuple(),
                                             flops / us / 1e3, axes))
    return records


def train(out_path: Optional[pathlib.Path] = None, augment_factor: int = 60,
          max_depth: int = 5, verbose: bool = True,
          records: Optional[Sequence[perfdb.PerfRecord]] = None,
          source: str = ANALYTICAL_SOURCE, args: str = ""):
    if records is None:
        records = perfdb.build_perfdb(augment_factor=augment_factor)
    x, y = perfdb.top1_training_set(records, "SR")
    if x.size == 0:
        raise ValueError("no records in the database")
    if verbose:
        print(f"perfdb: {len(records)} measurements over {x.shape[0]} keys",
              file=sys.stderr)
    # measured databases can be tiny (a few shape classes); scale the leaf
    # floor down so the tree still splits
    leaf = max(1, min(8, x.shape[0] // 4))
    tree = MultiOutputDecisionTree(max_depth=max_depth, min_samples_leaf=leaf,
                                   min_samples_split=2 * leaf).fit(x, y)
    if verbose:
        print(f"tree: depth={tree.depth()}, leaves={tree.num_leaves()}",
              file=sys.stderr)
    src = codegen.generate_rules_source(tree, InputFeatures.names(), source,
                                        args)
    if out_path is None:
        out_path = pathlib.Path(__file__).parent / "_generated_rules.py"
    pathlib.Path(out_path).write_text(src)
    if verbose:
        print(f"wrote {out_path}", file=sys.stderr)
    return tree, records


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.core.train_rules",
        description="Distill kernel-config rules from a performance database")
    ap.add_argument("--from-perfdb", metavar="PATH", default=None,
                    help="train on the sweeps measured on the card in the "
                         "PerfDB at PATH (dir or perfdb.json) instead of "
                         "the analytical cost model")
    ap.add_argument("--out", default=None,
                    help="output module path (default: _generated_rules.py "
                         "next to this file)")
    ap.add_argument("--augment-factor", type=int, default=60,
                    help="dataset augmentation factor of the analytical "
                         "sweep (paper: ×60)")
    ap.add_argument("--max-depth", type=int, default=5)
    args = ap.parse_args(argv)

    records, source, flags = None, ANALYTICAL_SOURCE, ""
    if args.from_perfdb is not None:
        records = records_from_perfdb(args.from_perfdb)
        if not records:
            ap.error(f"no measured sweeps of {sorted(MEASURED_AXES)} under "
                     f"{args.from_perfdb}; run the autotuner first "
                     "(make_plan(..., tune=True) on the card)")
        from repro_torch.core.autotune import PerfDB
        backends = sorted({e["backend"]
                           for e in PerfDB(args.from_perfdb).load().values()})
        source = ("a PerfDB measured on the card (" + ", ".join(backends)
                  + f", {len(records)} timings)")
        flags = " --from-perfdb DB"
    if args.augment_factor != 60:
        flags += f" --augment-factor {args.augment_factor}"
    if args.max_depth != 5:
        flags += f" --max-depth {args.max_depth}"
    train(out_path=pathlib.Path(args.out) if args.out else None,
          augment_factor=args.augment_factor, max_depth=args.max_depth,
          records=records, source=source, args=flags)


if __name__ == "__main__":
    main()
