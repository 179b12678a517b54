"""O(1)-complexity input features for data-aware config selection
(paper §III-C): ``Idx_size``, ``Idx_max`` (O(1) because Idx is sorted —
it is the last element), ``avg = Idx_size / Idx_max``, plus feature size F.
The same features, and the same vector, as the reference package's, so a
PerfDB key and a tree's split mean the same thing in both.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class InputFeatures:
    idx_size: int        # M = |E|
    idx_max: int         # ≈ number of live segments (last element + 1)
    feat: int            # F = N
    dtype_bytes: int = 4  # io dtype width (4 = fp32, 2 = bf16); not part of
                          # as_vector(): the dtype selects a PerfDB shelf
                          # through perf_key instead

    @property
    def avg(self) -> float:
        """Average segment length (≈ average in-degree)."""
        return self.idx_size / max(self.idx_max, 1)

    def as_vector(self) -> np.ndarray:
        """Feature vector for the decision tree: log2 sizes, log2 avg, log2
        F (Table II spans 9K → 23M edges)."""
        return np.array([
            np.log2(max(self.idx_size, 1)),
            np.log2(max(self.avg, 2 ** -4)),
            np.log2(max(self.feat, 1)),
        ], dtype=np.float64)

    @staticmethod
    def names() -> list[str]:
        return ["log2_idx_size", "log2_avg", "log2_feat"]


def extract_features(idx, feat: int, dtype_bytes: int = 4) -> InputFeatures:
    """``idx`` (numpy array or tensor, any device) must be sorted
    non-decreasing; its max is its last element, read alone (one element
    from the card, not the index)."""
    n = int(idx.numel()) if hasattr(idx, "numel") else int(np.asarray(idx).size)
    idx_max = int(idx[-1]) + 1 if n else 1
    return InputFeatures(idx_size=n, idx_max=idx_max, feat=int(feat),
                         dtype_bytes=int(dtype_bytes))
