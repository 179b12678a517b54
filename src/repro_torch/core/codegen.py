"""Decision tree → code generation (paper §III-C, Fig. 5 + Listing 3).

The paper compiles the fitted decision trees into if/else kernel-config
functions inside ``GeoT.so``. As in the reference package, codegen emits a
Python module, ``_generated_rules.py``: nested if/else, no numpy and no
tree object at run time. The port has one schedule, so it emits
``select_sr`` and ``select``, which calls it.
"""
from __future__ import annotations

import io
import textwrap
from typing import Sequence

from repro_torch.core.decision_tree import MultiOutputDecisionTree, _Node
from repro_torch.core.perfdb import snap_config

_HEADER = '''"""AUTO-GENERATED by repro_torch.core.codegen — do not edit.

{about}
Features: {feat_names}.
Regenerate with ``python -m repro_torch.core.train_rules{args}``.
"""
from repro_torch.core.config_space import KernelConfig, rule_config


'''


def _emit_node(node: _Node, feat_names: Sequence[str], buf: io.StringIO,
               indent: int) -> None:
    pad = "    " * indent
    if node.is_leaf:
        cfg = snap_config(node.value)
        buf.write(f"{pad}return rule_config({cfg.s_b}, {cfg.m_b}, "
                  f"{feat_names[-1]})\n")
        return
    buf.write(f"{pad}if {feat_names[node.feature]} <= {node.threshold!r}:\n")
    _emit_node(node.left, feat_names, buf, indent + 1)
    buf.write(f"{pad}else:\n")
    _emit_node(node.right, feat_names, buf, indent + 1)


def generate_rules_source(tree: MultiOutputDecisionTree,
                          feat_names: Sequence[str], source: str,
                          args: str = "") -> str:
    """The rules module for a tree fitted on (S_b, M_b). ``source`` names
    the database in the docstring, ``args`` the command line that
    regenerates it."""
    buf = io.StringIO()
    about = textwrap.fill(
        "Data-aware kernel-config rules of the port's Hopper kernels (M_b: "
        "rows a run of the gather and segment_reduce; S_b: segments a tile "
        f"of the fused transform-reduce), distilled from {source}.", 72)
    buf.write(_HEADER.format(feat_names=", ".join(feat_names), about=about,
                             args=args))
    sig = ", ".join(f"{n}: float" for n in feat_names)
    buf.write(f"def select_sr({sig}) -> KernelConfig:\n")
    _emit_node(tree.root, feat_names, buf, 1)
    buf.write("\n\n")
    buf.write(f"def select({sig}) -> KernelConfig:\n")
    buf.write(f"    return select_sr({', '.join(feat_names)})\n")
    return buf.getvalue()
