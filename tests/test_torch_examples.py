"""The ten ``examples/torch_*.py`` scripts, the port's counterparts of the
reference's ``examples/``, each run on the CPU (``--device cpu``) at its
smallest setting in a subprocess with a timeout: it exits 0 and prints its
result line (and the kernel-launch line every example prints before it;
on the CPU the plain versions run, so no kernel launches). Their
assertions — ``gnn_training``'s kill-and-resume, ``gnn_serving``'s
parity check, ``gnn_inference``'s sharded == single-device over 2 gloo
ranks, ``gnn_sampled_training``'s pipeline contract — run inside.
"""
import json
import os
import pathlib
import re
import subprocess
import sys

import pytest

pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parents[1]

# script -> (arguments beside --device cpu, its result line)
EXAMPLES = {
    "torch_quickstart": ([], r"^d\(SpMM\)/dH: \(2000, 32\)"),
    "torch_gnn_inference": (["--dataset", "cora", "--scale", "0.25",
                             "--hidden", "16", "--shards", "2"],
                            r"^served 4 models: gcn,gin,sage,gat"),
    "torch_gnn_serving": (["--requests", "12", "--max-nodes", "256",
                           "--max-batch-nodes", "512"],
                          r"^serving contract holds"),
    "torch_gnn_training": (["--steps", "12", "--ckpt-every", "4"],
                           r"^all training checks passed"),
    "torch_gnn_sampled_training": (["--steps", "12", "--nodes", "512",
                                    "--edges", "2048"],
                                   r"^all sampled-pipeline checks passed"),
    "torch_hetero_inference": (["--nodes", "512", "--edges", "2048",
                                "--hidden", "16"],
                               r"grouped vs per-type-loop parity: "),
    "torch_lm_serving": (["--gen", "2", "--batch", "2"], r"^decode: "),
    "torch_continuous_batching": ([], r"^served 10 requests in \d+ ticks"),
    "torch_moe_training": (["--steps", "1"],
                           r"^MoE \(ragged dispatch\) loss: "),
    "torch_train_100m": (["--steps", "1"], r"^loss: .* over 1 steps"),
}


def test_every_reference_example_has_a_port():
    ref = {p.stem for p in (ROOT / "examples").glob("*.py")
           if not p.stem.startswith("torch_")}
    assert {f"torch_{n}" for n in ref} == set(EXAMPLES)


@pytest.mark.parametrize("name", sorted(EXAMPLES))
def test_example_runs_on_the_cpu(name, tmp_path):
    args, result = EXAMPLES[name]
    path = [str(ROOT / "src")] + [p for p in [os.environ.get("PYTHONPATH")]
                                  if p]
    # two threads a script: the suite runs beside it in other workers
    env = dict(os.environ, TMPDIR=str(tmp_path), OMP_NUM_THREADS="2",
               PYTHONPATH=os.pathsep.join(path))
    out = subprocess.run(
        [sys.executable, str(ROOT / "examples" / f"{name}.py"), *args,
         "--device", "cpu"], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=150)
    assert out.returncode == 0, out.stderr[-4000:]
    lines = out.stdout.splitlines()
    assert any(re.search(result, ln) for ln in lines), out.stdout[-3000:]
    launches = [json.loads(ln.split(":", 1)[1]) for ln in lines
                if ln.startswith("kernel launches:")]
    assert launches and not sum(launches[-1].values())
