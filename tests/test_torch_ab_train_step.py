"""``python -m ray_tpu_torch.ab_train_step`` on the CPU, at gpt2-tiny.

One tree (this one) given twice: each turn runs in its own process from the
tree's root and prints the step's time with no remat and with remat.
"""

import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
TIMEOUT_S = 300


def test_ab_train_step_times_each_tree_in_turn():
    env = dict(os.environ, OMP_NUM_THREADS="1")
    done = subprocess.run(
        [sys.executable, "-m", "ray_tpu_torch.ab_train_step", str(ROOT), str(ROOT), "--device",
         "cpu", "--model", "gpt2-tiny", "--batch", "2", "--seq", "32"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=TIMEOUT_S)
    assert done.returncode == 0, done.stdout + done.stderr
    lines = done.stdout.splitlines()
    assert len(lines) == 4, lines
    for line, remat in zip(lines, ["False", "True"] * 2):
        assert line.startswith(f"{ROOT}: remat {remat}: median of 5 steps "), line


def test_ab_train_step_takes_f32():
    """``--dtype f32`` trains the same model in f32 (the f32 flash kernels
    on the card; their plain versions here)."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    done = subprocess.run(
        [sys.executable, "-m", "ray_tpu_torch.ab_train_step", str(ROOT), "--device", "cpu", "--model",
         "gpt2-tiny", "--batch", "2", "--seq", "32", "--dtype", "f32"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=TIMEOUT_S)
    assert done.returncode == 0, done.stdout + done.stderr
    lines = done.stdout.splitlines()
    assert [line.split(": median")[0] for line in lines] == [f"{ROOT}: remat False", f"{ROOT}: remat True"]


def test_ab_train_step_times_the_f32_ring():
    """``--ring T`` also times the emulated f32 ring (forward, then forward
    and backward) after the train steps, in each tree's process."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    done = subprocess.run(
        [sys.executable, "-m", "ray_tpu_torch.ab_train_step", str(ROOT), "--device", "cpu", "--model",
         "gpt2-tiny", "--batch", "2", "--seq", "32", "--dtype", "f32", "--ring", "64"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=TIMEOUT_S)
    assert done.returncode == 0, done.stdout + done.stderr
    lines = done.stdout.splitlines()
    assert [line.split(": median")[0] for line in lines] == [
        f"{ROOT}: remat False", f"{ROOT}: remat True", f"{ROOT}: f32 ring T 64 forward",
        f"{ROOT}: f32 ring T 64 forward+backward"], lines
