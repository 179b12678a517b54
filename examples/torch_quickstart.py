"""Quickstart: the GeoT tensor-centric API of the PyTorch port in 2
minutes (the port of ``examples/quickstart.py``).

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]

On the card (the default) every op below launches its hand-written CUDA
kernel; ``--device cpu`` runs their plain PyTorch versions.
"""
import argparse
import json

import numpy as np
import torch

import repro_torch as rt
from repro_torch.core.device import resolve_device
from repro_torch.kernels import ops as kops

ap = argparse.ArgumentParser()
ap.add_argument("--device", default=None,
                help="default: the card; 'cpu' runs the plain versions")
args = ap.parse_args()
dev = resolve_device(args.device, "examples/torch_quickstart.py")
rng = np.random.default_rng(0)

# --- segment reduction (paper Fig. 2): sorted Idx, dense X — no sparse
# formats anywhere (format-agnostic, §IV) -----------------------------------
M, S, F = 10_000, 1_000, 32
idx = torch.from_numpy(np.sort(rng.integers(0, S, M)).astype(np.int32)).to(dev)
x = torch.from_numpy(rng.standard_normal((M, F), np.float32)).to(dev)

y = rt.segment_reduce(x, idx, S)                    # sum per segment
print("segment_reduce:", tuple(y.shape))

# --- data-aware config selection (paper §III-C): O(1) features → codegen'd
# decision-tree rules pick the kernel's run length and tile -----------------
cfg = rt.select_config(M, S, F)
print("selected config:", cfg)

# --- the kernel (the card) against the plain version -----------------------
y_kernel = kops.segment_reduce(x, idx, S, config=cfg)
y_plain = kops.segment_reduce(x, idx, S, impl="ref")
print("kernel == oracle:", bool(torch.allclose(y_kernel, y_plain, atol=1e-3)))

# --- fused message+aggregate ≡ SpMM (paper Listing 2, §IV) -----------------
V = 2_000
h = torch.from_numpy(rng.standard_normal((V, F), np.float32)).to(dev)
src = torch.from_numpy(rng.integers(0, V, M).astype(np.int32)).to(dev)
w = torch.from_numpy(rng.standard_normal(M).astype(np.float32)).to(dev)
out = rt.index_weight_segment_reduce(h, src, w, idx, S)
print("fused SpMM:", tuple(out.shape))

# --- it is all differentiable (beyond-paper: autograd, §VI) ----------------
h.requires_grad_()
(grad,) = torch.autograd.grad(
    (rt.index_weight_segment_reduce(h, src, w, idx, S) ** 2).sum(), h)
print("kernel launches:", json.dumps(rt.launch_counts()))
print("d(SpMM)/dH:", tuple(grad.shape),
      "— VJP is itself a segment reduction")
