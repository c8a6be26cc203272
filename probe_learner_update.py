"""Repeat chip_smoke.py phase 13's learner check on the card, and show what lies under it.

    python3 probe_learner_update.py [--runs 10] [--procs 2] [--out FILE]

``chip_smoke.check_learner_update`` holds one minibatch update of
``rllib.PPO``'s learner on the card to the same update in plain torch on
the CPU, from the same init and batch, at chip_smoke's limits
(``PPO_LOSS_RTOL``, ``PPO_UPDATE_RELNORM_TOL``, ``PPO_MOMENT_RELNORM_TOL``).
This runs that check ``--runs`` times in each of ``--procs`` fresh
processes (one after another: the card's cuBLAS state starts anew in each)
and prints, per run and parameter:

  - the gradient's relative norm, card against CPU, before the clip and
    before Adam, and whether each side's gradient is bitwise the first
    run's of its process (is each side deterministic?);
  - the update's and the Adam moments' relative norms, as the check takes
    them, and whether the check would fail;
  - the entry that carries most of the update's gap, with its gradient on
    both sides beside Adam's eps (Adam's first step moves an entry by about
    lr * g / (|g| + eps), so an entry with |g| near eps turns a rounding
    difference in g into one of the same order in its update);
  - TF32's flags at that point, and the card.

Needs one NVIDIA card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

import torch

from chip_smoke import (PPO_CHECK_STEPS, PPO_LOSS_RTOL, PPO_MOMENT_RELNORM_TOL, PPO_SEED,
                        PPO_UPDATE_RELNORM_TOL, _ppo_batch, _relnorm)


def _update(algo, mb: dict) -> tuple:
    """One learner update (PPO's _train_minibatch), keeping each gradient
    before the clip. Returns (loss, {name: gradient on the CPU})."""
    on = {k: torch.as_tensor(v, device=algo.device) for k, v in mb.items()}
    grads = {}

    def keep(name):
        def hook(g):
            grads[name] = g.detach().to("cpu", copy=True)
        return hook

    handles = [p.register_hook(keep(name)) for name, p in algo.policy.items()]
    try:
        loss = algo._train_minibatch(on)
    finally:
        for h in handles:
            h.remove()
    return float(loss), grads


def one_run() -> dict:
    """One check: a card learner and a CPU learner from the same seed, one
    minibatch each, as chip_smoke.check_learner_update takes it."""
    from ray_tpu_torch.rllib import PPOConfig
    from ray_tpu_torch.rllib import ppo as ppo_mod

    on_card = PPOConfig(num_env_runners=0, seed=PPO_SEED).build()
    on_cpu = PPOConfig(num_env_runners=0, seed=PPO_SEED, device="cpu").build()
    before = {k: torch.from_numpy(v) for k, v in ppo_mod._host_params(on_cpu.policy).items()}
    mb = _ppo_batch({k: v.numpy() for k, v in before.items()}, PPO_CHECK_STEPS)
    loss_card, g_card = _update(on_card, mb)
    loss_cpu, g_cpu = _update(on_cpu, mb)
    torch.cuda.synchronize()
    out = {"loss_card": loss_card, "loss_cpu": loss_cpu, "loss_rel": abs(loss_card - loss_cpu) / abs(loss_cpu),
           "eps": on_card.opt.defaults["eps"], "params": {}}
    for k in before:
        pc, pp = on_card.policy[k], on_cpu.policy[k]
        du_card, du_cpu = (pc.detach().cpu() - before[k]).double(), (pp.detach() - before[k]).double()
        sc, sp = on_card.opt.state[pc], on_cpu.opt.state[pp]
        gap = (du_card - du_cpu).abs().flatten()
        i = int(gap.argmax())
        out["params"][k] = {
            "grad_relnorm": _relnorm(g_card[k], g_cpu[k]),
            "update_relnorm": _relnorm(du_card, du_cpu),
            "moment_relnorm": max(_relnorm(sc["exp_avg"], sp["exp_avg"]),
                                  _relnorm(sc["exp_avg_sq"], sp["exp_avg_sq"])),
            "top": {"index": i, "gap": float(gap[i]), "update_card": float(du_card.flatten()[i]),
                    "update_cpu": float(du_cpu.flatten()[i]), "g_card": float(g_card[k].flatten()[i]),
                    "g_cpu": float(g_cpu[k].flatten()[i])},
            "g_card": g_card[k], "g_cpu": g_cpu[k],
        }
    return out


def child(runs: int) -> None:
    """The runs of one process: one JSON line a run."""
    if not torch.cuda.is_available():
        raise SystemExit("torch.cuda.is_available() is false: this probe needs an NVIDIA card")
    torch.backends.cuda.matmul.allow_tf32 = False  # as chip_smoke.identify() sets it
    torch.backends.cudnn.allow_tf32 = False
    first = {}
    for r in range(runs):
        res = one_run()
        line = {"run": r, "loss_card": res["loss_card"], "loss_cpu": res["loss_cpu"], "loss_rel": res["loss_rel"],
                "eps": res["eps"], "tf32": [torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
                                            torch.get_float32_matmul_precision()], "params": {}}
        fails = ["loss"] if res["loss_rel"] > PPO_LOSS_RTOL else []
        for k, p in res["params"].items():
            line["params"][k] = {n: p[n] for n in ("grad_relnorm", "update_relnorm", "moment_relnorm", "top")}
            line["params"][k].update(
                card_grad_as_first_run=torch.equal(p["g_card"], first.setdefault(("card", k), p["g_card"])),
                cpu_grad_as_first_run=torch.equal(p["g_cpu"], first.setdefault(("cpu", k), p["g_cpu"])))
            if p["update_relnorm"] > PPO_UPDATE_RELNORM_TOL or p["moment_relnorm"] > PPO_MOMENT_RELNORM_TOL:
                fails.append(k)
        line["check_fails"] = fails
        print("RUN " + json.dumps(line), flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--runs", type=int, default=10, help="runs in each process")
    ap.add_argument("--procs", type=int, default=2, help="fresh processes, one after another")
    ap.add_argument("--out", default=None, help="append every run's JSON line to this file")
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        child(args.runs)
        return
    from ray_tpu_torch import bench

    card = ", ".join(bench.card())
    print(f"{card}; uuid {getattr(torch.cuda.get_device_properties(0), 'uuid', '')}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}; CPU threads {torch.get_num_threads()}", flush=True)
    lines = []
    for proc in range(args.procs):
        out = subprocess.run([sys.executable, __file__, "--child", "--runs", str(args.runs)],
                             capture_output=True, text=True, timeout=600)
        if out.returncode != 0:
            raise SystemExit(f"probe process {proc} failed ({out.returncode}):\n{out.stderr[-4000:]}")
        for raw in out.stdout.splitlines():
            if not raw.startswith("RUN "):
                continue
            line = dict(json.loads(raw[4:]), proc=proc)
            lines.append(line)
            ps = line["params"]
            worst = max(ps, key=lambda k: ps[k]["update_relnorm"])
            print(f"proc {proc} run {line['run']}: loss {line['loss_card']:.7f} vs {line['loss_cpu']:.7f} (rel "
                  f"{line['loss_rel']:.2e}); update relnorm max {ps[worst]['update_relnorm']:.3e} ({worst}), "
                  f"moments max {max(p['moment_relnorm'] for p in ps.values()):.3e}, gradient max "
                  f"{max(p['grad_relnorm'] for p in ps.values()):.3e}; card bits as run 0: "
                  f"{all(p['card_grad_as_first_run'] for p in ps.values())}, CPU bits as run 0: "
                  f"{all(p['cpu_grad_as_first_run'] for p in ps.values())}; tf32 {line['tf32']}; fails "
                  f"{line['check_fails']}", flush=True)
            if line["run"] == 0 or line["check_fails"]:
                for k, p in ps.items():
                    t = p["top"]
                    print(f"    {k}: gradient {p['grad_relnorm']:.2e}, update {p['update_relnorm']:.2e}, moments "
                          f"{p['moment_relnorm']:.2e}; top gap {t['gap']:.3e} at {t['index']} (update card "
                          f"{t['update_card']:.5e}, cpu {t['update_cpu']:.5e}; g card {t['g_card']:.5e}, cpu "
                          f"{t['g_cpu']:.5e}; eps {line['eps']:g})", flush=True)
    if args.out:
        with open(args.out, "a") as f:
            for line in lines:
                f.write(json.dumps(line) + "\n")
    fails = [(ln["proc"], ln["run"], ln["check_fails"]) for ln in lines if ln["check_fails"]]
    print(f"SUMMARY {len(lines)} runs in {args.procs} processes: {len(fails)} would fail the check {fails} "
          f"[{card}]", flush=True)


if __name__ == "__main__":
    main()
