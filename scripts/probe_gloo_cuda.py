#!/usr/bin/env python3
"""Which collectives gloo runs on CUDA tensors, on the card.

    python3 scripts/probe_gloo_cuda.py

Four ranks share one card on the gloo backend (NCCL takes one card a
rank), as ``chip_smoke.py`` phases 3g and 3j run them. For each case (the
c10d collectives, the functional ones DTensor issues, DTensor
redistributions, a subgroup all-reduce, a point-to-point ring hop) a fresh
group of 4 spawned ranks runs it once on CUDA tensors, so a case that
ends its processes (a crash) or raises cannot hide the others. Prints the
torch and CUDA versions, then one ``RESULT name: ok|FAIL|CRASH|TIMEOUT``
line a case. Needs one CUDA device.
"""
import datetime
import subprocess
import sys
import tempfile

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

WORLD = 4
NAMES = ["all_reduce", "all_reduce_max", "all_reduce_bf16", "broadcast",
         "all_gather_into_tensor", "all_gather_list",
         "reduce_scatter_tensor", "all_to_all_single", "fc_all_reduce",
         "fc_all_gather", "fc_reduce_scatter", "dt_S_R", "dt_P_R", "dt_P_S",
         "dt_S0_S1", "dt_mm_bwd", "subgroup_all_reduce", "p2p"]


def case(name, rank, dev):
    """Run one case on this rank; returns a printable result."""
    import torch.distributed._functional_collectives as fc
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import (DTensor, Partial, Replicate, Shard,
                                          distribute_tensor)
    x = torch.ones(8, 4, device=dev) * (rank + 1)
    world = dist.group.WORLD
    if name == "all_reduce":
        y = x.clone()
        dist.all_reduce(y)
        return y[0, 0].item()
    if name == "all_reduce_max":
        y = x.clone()
        dist.all_reduce(y, op=dist.ReduceOp.MAX)
        return y[0, 0].item()
    if name == "all_reduce_bf16":
        y = x.to(torch.bfloat16)
        dist.all_reduce(y)
        return y[0, 0].item()
    if name == "all_gather_into_tensor":
        o = torch.empty(32, 4, device=dev)
        dist.all_gather_into_tensor(o, x)
        return o.sum().item()
    if name == "all_gather_list":
        parts = [torch.empty_like(x) for _ in range(WORLD)]
        dist.all_gather(parts, x)
        return sum(t.sum().item() for t in parts)
    if name == "reduce_scatter_tensor":
        o = torch.empty(2, 4, device=dev)
        dist.reduce_scatter_tensor(o, x)
        return o.sum().item()
    if name == "all_to_all_single":
        o = torch.empty_like(x)
        dist.all_to_all_single(o, x)
        return o.sum().item()
    if name == "broadcast":
        y = x.clone()
        dist.broadcast(y, 0)
        return y.sum().item()
    if name == "fc_all_reduce":
        return fc.all_reduce(x, "sum", world).sum().item()
    if name == "fc_all_gather":
        return fc.all_gather_tensor(x, 0, world).sum().item()
    if name == "fc_reduce_scatter":
        return fc.reduce_scatter_tensor(x, "sum", 0, world).sum().item()
    mesh = DeviceMesh("cuda", torch.arange(WORLD).reshape(2, 2),
                      mesh_dim_names=("data", "model"))
    torch.manual_seed(0)

    def dt(shape, pls):
        return distribute_tensor(torch.randn(*shape, device=dev), mesh, pls,
                                 src_data_rank=None)
    if name == "dt_S_R":
        w = dt((8, 6), [Shard(0), Shard(1)])
        return str(w.redistribute(mesh, [Replicate(), Replicate()])
                   .placements)
    if name == "dt_P_R":
        p = DTensor.from_local(torch.ones(4, 6, device=dev), mesh,
                               [Partial(), Partial()])
        return p.redistribute(mesh, [Replicate(), Replicate()]) \
            .to_local()[0, 0].item()
    if name == "dt_P_S":
        p = DTensor.from_local(torch.ones(4, 6, device=dev), mesh,
                               [Partial(), Replicate()])
        return str(p.redistribute(mesh, [Shard(0), Replicate()])
                   .to_local().shape)
    if name == "dt_S0_S1":
        w = dt((8, 6), [Shard(0), Replicate()])
        return str(w.redistribute(mesh, [Shard(1), Replicate()]).placements)
    if name == "dt_mm_bwd":
        xx = dt((4, 3, 8), [Shard(0), Replicate()])
        wq = dt((8, 6), [Shard(0), Shard(1)]).detach().requires_grad_()
        ((xx @ wq) ** 2).sum().backward()
        return str(wq.grad.redistribute(mesh, [Shard(0), Shard(1)])
                   .placements)
    if name == "subgroup_all_reduce":
        y = x.clone()
        dist.all_reduce(y, group=mesh.get_group("model"))
        return y[0, 0].item()
    if name == "p2p":
        send, recv = x.contiguous(), torch.empty_like(x)
        ops = [dist.P2POp(dist.isend, send, (rank + 1) % WORLD),
               dist.P2POp(dist.irecv, recv, (rank - 1) % WORLD)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return recv[0, 0].item()
    raise ValueError(f"unknown case {name!r}")


def run(rank, world, store, name):
    torch.cuda.set_device(0)
    dist.init_process_group(
        "gloo", store=dist.FileStore(store, world), rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=30))
    dev = torch.device("cuda", 0)
    try:
        out = case(name, rank, dev)
        torch.cuda.synchronize()
        if rank == 0:
            print(f"RESULT {name}: ok {str(out)[:100]}", flush=True)
    except Exception as e:       # a failed case is a result, not a crash
        if rank == 0:
            print(f"RESULT {name}: FAIL {repr(e)[:300]}", flush=True)
    dist.destroy_process_group()


def main():
    print("versions", torch.__version__, torch.version.cuda,
          sys.version.split()[0], flush=True)
    for name in NAMES:
        try:
            r = subprocess.run([sys.executable, __file__, name],
                               capture_output=True, text=True, timeout=60)
        except subprocess.TimeoutExpired:
            print(f"RESULT {name}: TIMEOUT", flush=True)
            continue
        lines = [ln for ln in r.stdout.splitlines()
                 if ln.startswith("RESULT")]
        print(lines[0] if lines else
              f"RESULT {name}: CRASH rc={r.returncode} {r.stderr[-300:]!r}",
              flush=True)


if __name__ == "__main__":
    if len(sys.argv) > 1:
        mp.spawn(run, args=(WORLD, tempfile.mkdtemp() + "/store",
                            sys.argv[1]), nprocs=WORLD)
    else:
        main()
