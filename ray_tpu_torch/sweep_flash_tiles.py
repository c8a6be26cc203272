"""Sweep the ring depths of the three flash kernels on the card.

    python3 -m ray_tpu_torch.sweep_flash_tiles

``csrc/flash_attention.cu`` takes its ring depths from three macros
(``RT_FWD_STAGES``, ``RT_DKV_STAGES``, ``RT_DQ_STAGES``). This builds the
library once per setting with a ``-D`` override of one of them, prints
nvcc's register and spill lines for each kernel, holds the three kernels
against their plain versions at the train step's shape (BH 384, T 1024,
Dh 64, causal, bf16; ``ray_tpu_torch.bench.disagreement``), then times
each setting in turns, ROUNDS times (median of 20 calls each, CUDA
events), and prints one line per setting and round, the best median of
each kernel, and the card's name and power limit. The kernels' wrappers
load the library built with the setting under test: the sweep swaps
``_build.load`` for the length of a setting, so nothing in the wrappers
knows of it. Needs one NVIDIA card; the 12 builds take about 15 s each.
"""

from __future__ import annotations

import functools
import statistics
import subprocess
from unittest import mock

import torch

from ray_tpu_torch import bench
from ray_tpu_torch.ops import _build
from ray_tpu_torch.ops import flash_attention as fa

FWD_STAGES = (2, 3, 4)
DKV_STAGES = (2, 3, 4, 5, 6)
DQ_STAGES = (2, 3, 4, 6)
ROUNDS = 2
SHAPE = (384, 1024, 64)  # BH, T, Dh of the train step (gpt2-small, B 32, 12 heads)
# Each kernel and the prefix of the macro that sets its ring depth.
KERNELS = {"flash_fwd": "RT_FWD_", "flash_dq": "RT_DQ_", "flash_dkv": "RT_DKV_"}
# The constants a setting leaves alone keep the values the .cu chooses.


def settings():
    """-D overrides, one tuple per build: the forward's ring depth, then
    dK/dV's, then dQ's."""
    return ([(f"RT_FWD_STAGES={st}",) for st in FWD_STAGES]
            + [(f"RT_DKV_STAGES={st}",) for st in DKV_STAGES]
            + [(f"RT_DQ_STAGES={st}",) for st in DQ_STAGES])


def built_with(defines):
    """The kernels' wrappers load the library built with ``defines`` while
    this is entered."""
    return mock.patch.object(_build, "load", functools.partial(_build.load, defines=defines))


def _ptxas_report(path) -> str:
    """The register and spill lines nvcc printed for the three kernels."""
    out, kernel = [], None
    for line in path.with_name(path.name + ".log").read_text().splitlines():
        if "Compiling entry" in line:
            kernel = next((k for k in KERNELS if k + "_kernel" in line), None)
            kernel = kernel and kernel + ("<64>" if "ILi64E" in line else "<16>")
        elif kernel and ("spill" in line or "registers" in line):
            out.append(f"{kernel}: {line.split(':', 1)[-1].strip()}")
    return "; ".join(out)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("the sweep needs an NVIDIA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    BH, T, D = SHAPE
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

    for defines in settings():
        path = _build.build("flash_attention", defines)
        print(f"{' '.join(defines)}: {_ptxas_report(path)}", flush=True)
        with built_with(defines):
            o, _ = calls["flash_fwd"]()
            dq = calls["flash_dq"]()
            dk, dv = calls["flash_dkv"]()
        gaps = [bench.disagreement(a, b)
                for a, b in ((o, o_ref), (dq, dq_ref), (dk, dk_ref), (dv, dv_ref))]
        if not all(gap["ok"] for gap in gaps):
            raise SystemExit(f"{defines}: a kernel disagrees with its plain version: {gaps}")

    times = {d: {name: [] for name in KERNELS} for d in settings()}
    for rnd in range(ROUNDS):
        for defines in settings():
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
