"""``python -m ray_tpu_torch.sharded_cards`` rehearsed on the CPU.

The module's own CPU mode (``--device cpu``: four gloo processes on the
loopback, the kernels' plain versions) at gpt2-tiny, B 8, T 64: every mesh
of ``MESHES`` is held to the unsharded step by the module's own limits
(``LOSS_TOL``, ``GRAD_RELNORM_TOL``) and its launch counts to the design
(none on the CPU); on every mesh of ``OP_MESHES`` ring attention or the
MoE block, each leg of ``RING_LEGS["cpu"]`` or ``MOE_LEGS["cpu"]`` and the
dryrun's, is held to its one-card reference (gaps within the limits) with
no launch; a rank that fails makes the command exit non-zero. The test
runs the command once and reads rank 0's lines.
"""

import os
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
TIMEOUT_S = 300


def test_sharded_cards_rehearses_every_mesh_on_the_cpu():
    from ray_tpu_torch import sharded_cards
    from ray_tpu_torch.ops import flash_attention as fa

    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(ROOT), os.environ.get("PYTHONPATH", "")]),
               OMP_NUM_THREADS="1", GLOO_SOCKET_IFNAME="lo")
    done = subprocess.run(
        [sys.executable, "-m", "ray_tpu_torch.sharded_cards", "--device", "cpu", "--model",
         "gpt2-tiny", "--batch", "8", "--seq", "64"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=TIMEOUT_S)
    assert done.returncode == 0, done.stdout + done.stderr
    lines = done.stdout.splitlines()
    none = f"launches per step {dict.fromkeys(fa.launches, 0.0)}"
    assert any(line.startswith("unsharded, every card alone at B 2:") for line in lines), lines
    for name in sharded_cards.MESHES:
        [line] = [line for line in lines if line.startswith(f"{name}: loss ")]
        assert f"median of {sharded_cards.STEPS} steps" in line, line
        assert none in line, line
    none = f"launches summed over ranks {dict.fromkeys(fa.launches, 0)}"
    for name, axes in sharded_cards.OP_MESHES.items():
        if axes.get("cp", 1) > 1:
            legs = [f"ring {label} [B, T, H, Dh] = {list(shape)}"
                    for label, shape, _ in sharded_cards.RING_LEGS["cpu"]]
            if name == sharded_cards.DRYRUN_RING[0]:
                legs.append(f"ring dryrun f32 [B, T, H, Dh] = {list(sharded_cards.DRYRUN_RING[1])}")
        else:
            legs = [f"moe {leg[0]} ({leg[1]} tokens a rank"
                    for leg in sharded_cards.MOE_LEGS["cpu"]]
            if name == sharded_cards.DRYRUN_MOE[0]:
                legs.append(f"moe {sharded_cards.DRYRUN_MOE[1][0]} (")
        for leg in legs:
            [line] = [line for line in lines if line.startswith(f"{name}: {leg}")]
            ratio = float(re.search(r"worst gap/limit ([0-9.e+-]+);", line)[1])
            assert 0 <= ratio <= 1, line
            assert none in line, line
    assert lines[-1] == ("sharded step and ops across cards: every mesh held to its one-card "
                         "reference")


def test_op_legs_are_chip_smokes_shapes():
    """The card's legs are phase 5's shapes and limits (chip_smoke.py)."""
    import chip_smoke
    from ray_tpu_torch import sharded_cards

    ring = sharded_cards.RING_LEGS["cuda"]
    assert ring[0][1] == chip_smoke.RING_SHAPE and ring[0][2] is chip_smoke.torch.bfloat16
    assert [shape for _, shape, _ in ring[1:]] == chip_smoke.RING_F32_SHAPES
    assert (sharded_cards.RING_F32_TOL, sharded_cards.RING_F32_GRAD_TOL) == (
        chip_smoke.RING_F32_TOL, chip_smoke.RING_F32_GRAD_TOL)
    [(_, tokens, D, F, E, top_k, C, _, _)] = sharded_cards.MOE_LEGS["cuda"]
    assert (tokens, D, F, E, top_k, C) == (
        chip_smoke.MOE_TOKENS, chip_smoke.MOE_D, chip_smoke.MOE_F, chip_smoke.MOE_E,
        chip_smoke.MOE_TOP_K, chip_smoke.MOE_CAPACITY)
    assert (sharded_cards.MOE_LOSS_RTOL, sharded_cards.MOE_GRAD_RELNORM) == (
        chip_smoke.MOE_LOSS_RTOL, chip_smoke.MOE_GRAD_RELNORM)
