"""``python -m ray_tpu_torch.sharded_cards`` rehearsed on the CPU.

The module's own CPU mode (``--device cpu``: four gloo processes on the
loopback, the kernels' plain versions) at gpt2-tiny, B 8, T 64: every mesh
of ``MESHES`` is held to the unsharded step by the module's own limits
(``LOSS_TOL``, ``GRAD_RELNORM_TOL``) and its launch counts to the design
(none on the CPU), and a rank that fails makes the command exit non-zero.
The test runs the command once and reads rank 0's lines.
"""

import os
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
    assert lines[-1] == "sharded step across cards: every mesh held to the unsharded step"
