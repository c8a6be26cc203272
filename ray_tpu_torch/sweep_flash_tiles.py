"""Sweep the ring depths of the three flash kernels on the card.

    python3 -m ray_tpu_torch.sweep_flash_tiles [--head-dim 64|128]

``csrc/flash_attention.cu`` takes its ring depths from three macros per
tile set: ``RT_FWD_STAGES``, ``RT_DKV_STAGES``, ``RT_DQ_STAGES`` for head
dims 16, 32 and 64, and the same with ``_128`` for head dim 128. The head
dim 256 instance has no such macros: two stages are the most its shared
memory holds. This
builds the library once per setting with a ``-D`` override of one of the
head dim's macros, prints nvcc's register and spill lines for each kernel
at that head dim, holds the three kernels against their plain versions at
gpt2-small's train step with that head dim (B 32, T 1024, 768 / Dh heads,
causal, bf16; ``ray_tpu_torch.bench.disagreement``), then times each
setting in turns, ROUNDS times (median of 20 calls each, CUDA events), and
prints one line per setting and round, the best median of each kernel,
and the card's name and power limit. The kernels' wrappers load the
library built with the setting under test: the sweep swaps
``_build.load`` for the length of a setting, so nothing in the wrappers
knows of it. The depths tried are the ones whose shared memory fits (the
``.cu`` refuses to build others). Needs one NVIDIA card; a build takes
about 30 s.
"""

from __future__ import annotations

import argparse
import functools
import re
import statistics
import subprocess
from unittest import mock

import torch

from ray_tpu_torch import bench
from ray_tpu_torch.ops import _build
from ray_tpu_torch.ops import flash_attention as fa

# Ring depths tried per tile set (head dim 64 stands for 16, 32 and 64):
# forward, dK/dV, dQ.
DEPTHS = {64: ((2, 3, 4), (2, 3, 4, 5, 6), (2, 3, 4, 6)),
          128: ((2,), (2, 3, 4, 5), (2, 3, 4, 6, 8))}
SWEPT_HEAD_DIMS = (16, 32, 64, 128)  # the head dims of the tile sets above
ROUNDS = 2
T, D_MODEL = 1024, 768  # gpt2-small's train step, B 32
# Each kernel and the prefix of the macro that sets its ring depth.
KERNELS = {"flash_fwd": "RT_FWD_", "flash_dq": "RT_DQ_", "flash_dkv": "RT_DKV_"}
# The constants a setting leaves alone keep the values the .cu chooses.


def settings(head_dim: int = 64):
    """-D overrides, one tuple per build: the forward's ring depth, then
    dK/dV's, then dQ's, of the macros of ``head_dim``'s tile set."""
    suffix = "_128" if head_dim == 128 else ""
    fwd, dkv, dq = DEPTHS[128 if head_dim == 128 else 64]
    return ([(f"RT_FWD_STAGES{suffix}={st}",) for st in fwd]
            + [(f"RT_DKV_STAGES{suffix}={st}",) for st in dkv]
            + [(f"RT_DQ_STAGES{suffix}={st}",) for st in dq])


def built_with(defines):
    """The kernels' wrappers load the library built with ``defines`` while
    this is entered."""
    return mock.patch.object(_build, "load", functools.partial(_build.load, defines=defines))


def _ptxas_report(path, head_dim: int) -> str:
    """The register and spill lines nvcc printed for the three kernels at
    ``head_dim``."""
    out, kernel = [], None
    for line in path.with_name(path.name + ".log").read_text().splitlines():
        if "Compiling entry" in line:
            kernel = next((k for k in KERNELS if k + "_kernel" in line), None)
            found = re.search(r"ILi(\d+)E(13__nv_bfloat16|f)(?:Li\dE)?E", line)
            kernel = (kernel if found and int(found[1]) == head_dim else None) and \
                f"{kernel}<{found[1]}, {'bf16' if found[2] != 'f' else 'f32'}>"
        elif kernel and ("spill" in line or "registers" in line):
            out.append(f"{kernel}: {line.split(':', 1)[-1].strip()}")
    return "; ".join(out)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--head-dim", type=int, default=64, choices=SWEPT_HEAD_DIMS,
                        help="the tile set to sweep (16, 32 and 64 share one)")
    D = parser.parse_args(argv).head_dim
    if not torch.cuda.is_available():
        raise SystemExit("the sweep needs an NVIDIA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    BH = 32 * D_MODEL // D
    g = torch.Generator(device="cuda").manual_seed(1234)
    q, k, v, do = (torch.randn(BH, T, D, device="cuda", dtype=torch.bfloat16, generator=g)
                   for _ in range(4))
    o_ref, lse_ref = fa.flash_fwd_reference(q, k, v, True)
    delta = (do.float() * o_ref.float()).sum(-1)
    dq_ref, dk_ref, dv_ref = fa.flash_bwd_reference(q, k, v, do, lse_ref, delta, True)
    calls = {
        "flash_fwd": lambda: fa.flash_fwd(q, k, v, True),
        "flash_dq": lambda: fa.flash_dq(q, k, v, do, lse_ref, delta, True),
        "flash_dkv": lambda: fa.flash_dkv(q, k, v, do, lse_ref, delta, True),
    }

    print(f"sweeping head dim {D}: BH {BH}, T {T}, causal, bf16 [{card}]", flush=True)
    for defines in settings(D):
        path = _build.build("flash_attention", defines)
        print(f"{' '.join(defines)}: {_ptxas_report(path, D)}", flush=True)
        with built_with(defines):
            o, _ = calls["flash_fwd"]()
            dq = calls["flash_dq"]()
            dk, dv = calls["flash_dkv"]()
        gaps = [bench.disagreement(a, b)
                for a, b in ((o, o_ref), (dq, dq_ref), (dk, dk_ref), (dv, dv_ref))]
        if not all(gap["ok"] for gap in gaps):
            raise SystemExit(f"{defines}: a kernel disagrees with its plain version: {gaps}")

    times = {d: {name: [] for name in KERNELS} for d in settings(D)}
    for rnd in range(ROUNDS):
        for defines in settings(D):
            with built_with(defines):
                for name in KERNELS:
                    times[defines][name].append(bench.time_ms(calls[name]))
            print(f"round {rnd} {' '.join(defines)}: "
                  + ", ".join(f"{name} {times[defines][name][-1]:.4f} ms" for name in KERNELS)
                  + f" [{card}]", flush=True)
    for name, prefix in KERNELS.items():
        own = [d for d in times if d[0].startswith(prefix)]  # the settings that change this kernel
        best = min(own, key=lambda d: statistics.median(times[d][name]))
        print(f"best {name}: {' '.join(best)} at {statistics.median(times[best][name]):.4f} ms "
              f"(median of {ROUNDS} rounds) [{card}]")


if __name__ == "__main__":
    main()
