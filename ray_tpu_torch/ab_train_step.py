"""The train step of several trees of this repository, timed in turns on one card.

    python3 -m ray_tpu_torch.ab_train_step TREE [TREE ...]

For each TREE, in the order given (parent, change, change, parent, say),
runs one process from TREE's root, so that the ``ray_tpu_torch`` it
imports is TREE's. That process takes bench.py's train step
(``bench.config``: gpt2-small, B 32, T 1024, flash attention, fused CE,
AdamW at ``bench.setup``'s values) from the port's seeded init and
``bench.batch_tokens``, twice: with no remat, then with every block
recomputed in the backward under the config's default policy
(``remat=True``). Each is timed over ``STEPS`` steps after ``WARMUP``
(host clock around steps that end in a synchronise). It uses only what
every tree of the port has had since its first slice (``bench.config``,
``bench.batch_tokens``, ``gpt2.init``, ``gpt2.make_train_step``), so a
parent tree runs it as it is.

Prints one line per tree and setting, with the card's name and power
limit; exits non-zero if a tree's process fails. ``--device cpu`` with a
smaller ``--model``, ``--batch`` and ``--seq`` runs the same on the CPU,
where nothing is timed as the card's.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

WARMUP, STEPS = 2, 5

# Run from a tree's root by ``python -c``; argv: device, model, batch, seq.
_CHILD = f"""
import dataclasses, statistics, sys, time
import torch
from ray_tpu_torch import bench
from ray_tpu_torch.models import gpt2

device, model, batch, seq = sys.argv[1], sys.argv[2], int(sys.argv[3]), int(sys.argv[4])
sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
for remat in (False, True):
    cfg = dataclasses.replace(bench.config(model), remat=remat)
    net = gpt2.init(torch.Generator(device=device).manual_seed(0), cfg, device)
    opt = torch.optim.AdamW(net.parameters(), lr=3e-4, weight_decay=0.01, betas=(0.9, 0.999),
                            eps=1e-8)
    step = gpt2.make_train_step(net, opt)
    times = []
    for i in range({WARMUP} + {STEPS}):
        tokens = torch.from_numpy(bench.batch_tokens(i, cfg.vocab_size, batch, seq)).to(device)
        sync()
        t0 = time.perf_counter()
        step(tokens)
        sync()
        times.append((time.perf_counter() - t0) * 1e3)
    times = times[{WARMUP}:]
    print(f"remat {{remat}}: median of {STEPS} steps {{statistics.median(times):.2f}} ms "
          f"({{', '.join(f'{{t:.2f}}' for t in times)}})", flush=True)
    del net, opt, step
"""


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("trees", nargs="+")
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    parser.add_argument("--model", default="gpt2-small")
    parser.add_argument("--batch", type=int, default=32)
    parser.add_argument("--seq", type=int, default=1024)
    args = parser.parse_args(argv)
    if args.device == "cuda":
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    else:
        card = "CPU, no time here is the card's"
    for tree in args.trees:
        root = os.path.abspath(tree)
        env = dict(os.environ, PYTHONPATH=root)
        done = subprocess.run(
            [sys.executable, "-c", _CHILD, args.device, args.model, str(args.batch),
             str(args.seq)], cwd=root, env=env, capture_output=True, text=True)
        if done.returncode != 0:
            sys.exit(f"{tree}: exit {done.returncode}\n{done.stdout}{done.stderr}")
        for line in done.stdout.splitlines():
            print(f"{tree}: {line} [{card}]", flush=True)


if __name__ == "__main__":
    main()
