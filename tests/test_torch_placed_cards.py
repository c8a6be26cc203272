"""``python3 placed_cards.py --device cpu``: the four-card script's
trainer path rehearsed on the CPU (four cards declared on a host that has
none, a bundle of one card a worker, gloo, gpt2-tiny). Each worker of a
group of 2 and of 4 holds a card id of its own, the data-parallel mesh
step is held to the unsharded step, and grad_sync's mean to all_reduce's.
Then its two-domain part: two hosts of two declared cards, a slice each
(``num_slices=2``), four workers in one gloo group, ranks domain-major,
the dcn 2 x tp 2 step held to the unsharded step. Then its autoscaler
part: the same gang pending on a cluster whose head node has no card, an
``Autoscaler`` over ``GpuDomainProvider`` provisioning exactly two domains
of two declared cards for it, the same step on them, and both domains
terminated after ``remove()``. The script exits non-zero otherwise. On a
host with four GPUs it runs as ``python3 placed_cards.py``."""

import json

import placed_cards

from ray_tpu_torch.core import cluster_utils


def test_placed_cards_rehearses_the_trainer_on_the_cpu(capsys, monkeypatch):
    cluster_utils.sweep_stale_runtime()
    monkeypatch.setenv("OMP_NUM_THREADS", "1")  # the train workers inherit it
    placed_cards.main(["--device", "cpu", "--model", "gpt2-tiny", "--batch", "8",
                       "--seq", "64"])
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    for world in placed_cards.WORLDS:
        got = summary["train"][str(world)]
        assert sorted(got["visible"]) == [str(i) for i in range(world)]
        assert got["loss_gap"] <= placed_cards.LOSS_TOL
        assert got["worst_relnorm"] <= placed_cards.GRAD_RELNORM_TOL
        assert got["grad_bytes"] > 0 and len(got["grad_sync_ms"]) == world
    slices = summary["multislice"]
    # each host's two declared cards, one a worker of its slice
    assert slices["slices"] == {str(s): ["0", "1"] for s in range(placed_cards.SLICES)}
    assert slices["loss_gap"] <= placed_cards.LOSS_TOL
    assert slices["worst_relnorm"] <= placed_cards.GRAD_RELNORM_TOL
    assert slices["launches_a_step_per_worker"] == dict.fromkeys(
        slices["launches_a_step_per_worker"], 0.0)
    assert len(slices["step_ms"]) == placed_cards.SLICES * placed_cards.SLICE_CARDS
    scaled = summary["autoscaled"]
    assert scaled["slices"] == {str(s): ["0", "1"] for s in range(placed_cards.SLICES)}
    assert scaled["loss_gap"] <= placed_cards.LOSS_TOL
    assert scaled["worst_relnorm"] <= placed_cards.GRAD_RELNORM_TOL
    assert scaled["terminated_s"] < placed_cards.AS_TERMINATE_S
    assert len(scaled["step_ms"]) == placed_cards.SLICES * placed_cards.SLICE_CARDS
