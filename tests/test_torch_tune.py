"""The port's Tune (``ray_tpu_torch/tune/``, pinned copies of the JAX
package's; ``tune/tuner.py`` maps a trial's ``GPU`` onto ``num_gpus``):
the contracts of ``tests/test_tune.py``, re-run on one port cluster that
declares two cards it does not have. Besides them: the seeded decisions
(trial generation, each scheduler's on a seeded stream of reports, TPE's
suggestions) held to the JAX package's in this process, with no cluster;
trials gated by the declared cards, each trial's worker seeing only its
card; and a trial that asks for a TPU refused at once.

The trainables here are shipped by value to the port's workers, so this
module names no module of the JAX package among its globals: the parity
test imports it inside the function."""

import os
import time

import numpy as np
import pytest

import ray_tpu_torch
from ray_tpu_torch import tune
from ray_tpu_torch.core import cluster_utils

CARDS = 2  # declared on this host, which has none


@pytest.fixture(scope="module")
def rt():
    cluster_utils.sweep_stale_runtime()
    ray_tpu_torch.init(num_cpus=4, num_gpus=CARDS)
    yield ray_tpu_torch
    ray_tpu_torch.shutdown()


def test_search_space_generation():
    from ray_tpu_torch.tune.search import generate_trials

    space = {
        "lr": tune.loguniform(1e-4, 1e-1),
        "layers": tune.grid_search([1, 2]),
        "units": tune.choice([16, 32]),
        "fixed": 7,
    }
    trials = generate_trials(space, num_samples=3, seed=0)
    assert len(trials) == 6  # 2 grid points x 3 samples
    assert {t["layers"] for t in trials} == {1, 2}
    assert all(1e-4 <= t["lr"] <= 1e-1 for t in trials)
    assert all(t["fixed"] == 7 for t in trials)
    again = generate_trials(space, num_samples=3, seed=0)
    assert [t["lr"] for t in again] == [t["lr"] for t in trials]


def test_asha_scheduler_unit():
    s = tune.ASHAScheduler(metric="acc", mode="max", max_t=27,
                           grace_period=1, reduction_factor=3)
    assert s.on_result("a", {"training_iteration": 1, "acc": 0.9}) == "CONTINUE"
    assert s.on_result("b", {"training_iteration": 1, "acc": 0.8}) == "CONTINUE"
    assert s.on_result("c", {"training_iteration": 1, "acc": 0.1}) == "STOP"
    assert s.on_result("a", {"training_iteration": 27, "acc": 0.99}) == "STOP"


def test_mlp_sweep_with_asha(rt, tmp_path):
    """The hopeless configs run forever unless ASHA stops them: the sweep
    ending at all shows early stopping."""

    def trainable(config):
        import time

        rng = np.random.default_rng(0)
        X = rng.normal(size=(128, 4))
        w_true = np.asarray([1.0, -2.0, 0.5, 3.0])
        y = X @ w_true
        w = np.zeros(4)
        step = 0
        while True:
            step += 1
            if step > 50_000:
                raise RuntimeError("hopeless trial was never early-stopped")
            grad = -2 * X.T @ (y - X @ w) / len(y)
            w -= config["lr"] * grad
            loss = float(np.mean((y - X @ w) ** 2))
            tune.report({"loss": loss, "training_iteration": step})
            if config["lr"] > 1e-3 and step >= 30:
                return
            time.sleep(0.05)

    tuner = tune.Tuner(
        trainable,
        param_space={"lr": tune.grid_search([0.2, 0.05, 1e-5, 1e-6])},
        tune_config=tune.TuneConfig(
            metric="loss", mode="min", num_samples=1,
            max_concurrent_trials=2,
            scheduler=tune.ASHAScheduler(
                metric="loss", mode="min", max_t=10_000,
                grace_period=3, reduction_factor=2,
            ),
        ),
        run_dir=str(tmp_path / "sweep"),
    )
    results = tuner.fit()
    assert len(results) == 4
    assert results.num_errors == 0
    best = results.get_best_result()
    assert best.config["lr"] in (0.2, 0.05)
    assert best.metrics["loss"] < 1e-2
    stopped_lrs = {r.config["lr"] for r in results if r.stopped_early}
    assert {1e-5, 1e-6} <= stopped_lrs, stopped_lrs


def test_trial_checkpointing(rt, tmp_path):
    def trainable(config):
        for step in range(3):
            tune.report({"score": step}, checkpoint={"step": step, "w": [1, 2, 3]})

    tuner = tune.Tuner(
        trainable,
        param_space={"x": tune.choice([1])},
        tune_config=tune.TuneConfig(metric="score", mode="max"),
        run_dir=str(tmp_path / "ckpt"),
    )
    best = tuner.fit().get_best_result()
    assert best.checkpoint_path is not None
    state = tune.load_checkpoint(best.checkpoint_path)
    assert state["step"] == 2 and state["w"] == [1, 2, 3]


def test_trial_error_reported(rt, tmp_path):
    def trainable(config):
        if config["boom"]:
            raise ValueError("exploded")
        tune.report({"score": 1})

    tuner = tune.Tuner(
        trainable,
        param_space={"boom": tune.grid_search([False, True])},
        tune_config=tune.TuneConfig(metric="score", mode="max"),
        run_dir=str(tmp_path / "err"),
    )
    results = tuner.fit()
    assert results.num_errors == 1
    assert results.get_best_result().metrics["score"] == 1


def test_class_trainable(rt):
    class Quad(tune.Trainable):
        def setup(self, config):
            self.x = config["x"]
            self.total = 0.0

        def step(self):
            self.total += self.x
            return {"score": self.total, "done": self.iteration >= 4}

        def save_checkpoint(self):
            return {"total": self.total}

        def load_checkpoint(self, state):
            self.total = state["total"]

    grid = tune.Tuner(
        Quad,
        param_space={"x": tune.grid_search([1.0, 3.0])},
        tune_config=tune.TuneConfig(metric="score", mode="max"),
    ).fit()
    assert grid.num_errors == 0
    best = grid.get_best_result()
    assert best.config["x"] == 3.0
    assert best.metrics["score"] == 15.0  # 5 steps x 3.0
    assert best.checkpoint_path
    # the default run directory is under the port's own temp dir
    from ray_tpu_torch.utils.config import config

    assert best.checkpoint_path.startswith(os.path.join(str(config.temp_dir), "tune") + os.sep)


def test_pbt_exploit_mutates_config_mid_run(rt):
    class LrTrial(tune.Trainable):
        def setup(self, config):
            self.lr = config["lr"]
            self.weight = 0.0

        def step(self):
            import time

            time.sleep(0.15)  # slower than the controller's poll: decisions mid-run
            self.weight += self.lr
            return {"score": self.weight, "done": self.iteration >= 11}

        def save_checkpoint(self):
            return {"weight": self.weight}

        def load_checkpoint(self, state):
            self.weight = state["weight"]

    pbt = tune.PopulationBasedTraining(
        metric="score", mode="max", perturbation_interval=3,
        hyperparam_mutations={"lr": [0.1, 1.0, 2.0]}, quantile_fraction=0.5,
        seed=3,
    )
    grid = tune.Tuner(
        LrTrial,
        param_space={"lr": tune.grid_search([0.01, 2.0])},
        tune_config=tune.TuneConfig(metric="score", mode="max", scheduler=pbt,
                                    max_concurrent_trials=2),
    ).fit()
    assert grid.num_errors == 0
    assert pbt.exploit_count >= 1, "no PBT exploit happened"
    exploited = [r for r in grid if r.exploited_from]
    assert exploited, "no trial was cloned"
    assert exploited[0].config["lr"] in (0.1, 1.0, 2.0)
    assert exploited[0].metrics["score"] > 1.0


def test_with_resources_per_trial(rt):
    def trainable(config):
        import time

        time.sleep(0.2)
        tune.report({"score": config["x"]})

    grid = tune.Tuner(
        tune.with_resources(trainable, {"CPU": 2.0}),
        param_space={"x": tune.grid_search([1, 2, 3])},
        tune_config=tune.TuneConfig(metric="score", mode="max", max_concurrent_trials=3),
    ).fit()
    assert grid.num_errors == 0
    assert grid.get_best_result().metrics["score"] == 3


def test_tpe_searcher_converges_unit():
    from ray_tpu_torch.tune.search import TPESearcher

    searcher = TPESearcher(metric="loss", mode="min", n_startup=10, seed=0)
    searcher.set_search_space({"x": tune.uniform(0.0, 1.0)})
    for i in range(60):
        cfg = searcher.suggest(f"t{i}")
        searcher.on_trial_complete(f"t{i}", {"loss": (cfg["x"] - 0.3) ** 2})
    late = []
    for i in range(20):
        cfg = searcher.suggest(f"probe{i}")
        late.append(cfg["x"])
        searcher.on_trial_complete(f"probe{i}", {"loss": (cfg["x"] - 0.3) ** 2})
    mean_err = sum(abs(x - 0.3) for x in late) / len(late)
    assert mean_err < 0.15, f"TPE not concentrating: mean err {mean_err}"


def test_tpe_categorical_unit():
    from ray_tpu_torch.tune.search import TPESearcher

    searcher = TPESearcher(metric="score", mode="max", n_startup=8, seed=1)
    searcher.set_search_space({"opt": tune.choice(["bad", "good", "worse"])})
    for i in range(40):
        cfg = searcher.suggest(f"t{i}")
        score = {"bad": 0.2, "good": 1.0, "worse": 0.0}[cfg["opt"]]
        searcher.on_trial_complete(f"t{i}", {"score": score})
    picks = [searcher.suggest(f"p{i}")["opt"] for i in range(10)]
    assert picks.count("good") >= 7


def test_hyperband_scheduler_unit():
    from ray_tpu_torch.tune import schedulers as sched_mod

    hb = tune.HyperBandScheduler(metric="acc", mode="max", max_t=9,
                                 grace_period=1, reduction_factor=3)
    assert len(hb.brackets) == 3  # grace 1, 3, 9
    hb.on_trial_add("a", {})
    hb.on_trial_add("b", {})
    for v in (0.9, 0.8, 0.7):
        hb.brackets[0].on_result(f"seed{v}", {"acc": v, "training_iteration": 1})
    assert hb.on_result("a", {"acc": 0.01, "training_iteration": 1}) == sched_mod.STOP
    assert hb.on_result("b", {"acc": 0.01, "training_iteration": 1}) == sched_mod.CONTINUE


def test_tpe_end_to_end_with_tuner(rt, tmp_path):
    from ray_tpu_torch.tune.search import TPESearcher

    def objective(config):
        tune.report(loss=(config["x"] - 0.5) ** 2 + 0.01)

    searcher = TPESearcher(metric="loss", mode="min", n_startup=6, seed=2)
    grid = tune.Tuner(
        objective,
        param_space={"x": tune.uniform(0.0, 1.0)},
        tune_config=tune.TuneConfig(metric="loss", mode="min", num_samples=18,
                                    max_concurrent_trials=3, search_alg=searcher),
        run_dir=str(tmp_path),
    ).fit()
    assert grid.get_best_result().metrics["loss"] < 0.05


def test_trial_restores_after_runner_death(rt, tmp_path):
    def trainable(config):
        import os as os_mod

        ckpt = tune.get_checkpoint()
        start = (tune.load_checkpoint(ckpt)["step"] + 1) if ckpt else 0
        marker = config["marker"]
        for step in range(start, 6):
            tune.report(step=step, score=float(step), checkpoint={"step": step})
            if step == 2 and not os_mod.path.exists(marker):
                open(marker, "w").close()
                os_mod.kill(os_mod.getpid(), 9)  # die mid-trial, once

    marker = str(tmp_path / "died_once")
    grid = tune.Tuner(
        trainable,
        param_space={"marker": marker},
        tune_config=tune.TuneConfig(metric="score", mode="max", num_samples=1, max_failures=2),
        run_dir=str(tmp_path / "run"),
    ).fit()
    best = grid.get_best_result()
    assert best.error is None, best.error
    assert best.metrics["score"] == 5.0
    assert os.path.exists(marker)
    steps = [r["step"] for r in best.all_reports]
    assert steps[-1] == 5
    assert steps == sorted(set(steps))


# -- the trial's cards -------------------------------------------------------


def test_gpu_trials_gated_by_cards(rt, tmp_path):
    """Three trials at {"GPU": 1} on two declared cards: at most two run at
    once, each worker's CUDA_VISIBLE_DEVICES names one card, and the trials
    running at once hold different cards."""

    def trainable(config):
        import os
        import time

        t0 = time.time()
        time.sleep(1.5)
        tune.report(score=config["x"], start=t0, end=time.time(), pid=os.getpid(),
                    visible=os.environ.get("CUDA_VISIBLE_DEVICES"))

    grid = tune.Tuner(
        tune.with_resources(trainable, {"GPU": 1}),
        param_space={"x": tune.grid_search([1, 2, 3])},
        tune_config=tune.TuneConfig(metric="score", mode="max", max_concurrent_trials=3),
        run_dir=str(tmp_path / "cards"),
    ).fit()
    assert grid.num_errors == 0
    recs = [r.metrics for r in grid]
    ids = [str(i) for i in range(CARDS)]
    assert all(r["visible"] in ids for r in recs), [r["visible"] for r in recs]
    for r in recs:
        # the trials running when this one started, itself included: the
        # most at once is reached at some trial's start
        during = [o for o in recs if o["start"] <= r["start"] < o["end"]]
        assert len(during) <= CARDS, recs
        assert len({o["visible"] for o in during}) == len(during), recs
    # the third trial waited for a card that a finished trial gave back
    first, second, third = sorted(recs, key=lambda r: r["start"])
    assert third["start"] >= min(first["end"], second["end"]), recs
    assert grid.get_best_result().metrics["score"] == 3


def test_queued_trial_outlasts_the_miss_budget(rt, tmp_path, monkeypatch):
    """Two trials that each ask for every declared card, so one waits for
    its lease while the other runs for longer than the controller's miss
    budget (24 drains in a row that time out). A runner still queued for
    its cards is not polled, so it counts no miss: both trials finish
    without error, one after the other."""
    from ray_tpu_torch.tune import tuner as tuner_mod

    monkeypatch.setattr(tuner_mod, "DRAIN_TIMEOUT_S", 0.2)
    budget_s = 24 * (0.2 + 0.1)  # 24 rounds of a timed-out drain and the loop's sleep

    def trainable(config):
        import time

        t0 = time.time()
        while time.time() - t0 < config["run_s"]:
            time.sleep(0.5)
            tune.report(score=config["x"], start=t0, end=time.time())

    t0 = time.time()
    grid = tune.Tuner(
        tune.with_resources(trainable, {"GPU": CARDS}),
        param_space={"x": tune.grid_search([1, 2]), "run_s": budget_s + 1.0},
        tune_config=tune.TuneConfig(metric="score", mode="max", max_concurrent_trials=2),
        run_dir=str(tmp_path / "queued"),
    ).fit()
    assert [r.error for r in grid if r.error] == []
    first, second = sorted((r.metrics for r in grid), key=lambda m: m["start"])
    assert second["start"] >= first["end"], (first, second)
    # the second trial's runner waited in the queue beyond the miss budget
    assert second["start"] - t0 > budget_s, (t0, first, second)
    assert grid.get_best_result().metrics["score"] == 2


def test_tpu_trial_refused(rt, tmp_path):
    """No node of the port has a TPU: a trial that asks for one fails at
    its launch with the actors' num_tpus error, and never waits."""

    def trainable(config):
        tune.report(score=1)

    tuner = tune.Tuner(
        tune.with_resources(trainable, {"TPU": 1}),
        param_space={"x": tune.grid_search([1])},
        tune_config=tune.TuneConfig(metric="score", mode="max"),
        run_dir=str(tmp_path / "tpu"),
    )
    t0 = time.monotonic()
    with pytest.raises(ValueError, match="num_tpus asks for TPU chips"):
        tuner.fit()
    assert time.monotonic() - t0 < 30


# -- the seeded decisions against the JAX package ---------------------------


def _space(pkg):
    return {"lr": pkg.loguniform(1e-4, 1e-1), "layers": pkg.grid_search([1, 2, 3]),
            "units": pkg.choice([16, 32, 64]), "drop": pkg.uniform(0.0, 0.5),
            "heads": pkg.randint(1, 9), "fixed": 7}


def _reports(seed: int, trials: int = 6, rounds: int = 12):
    """A seeded stream of (trial, report): every trial reports once a round
    in a shuffled order, its metric a noisy curve of its own."""
    rng = np.random.default_rng(seed)
    rates = rng.uniform(0.05, 1.0, trials)
    out = []
    for it in range(1, rounds + 1):
        for t in rng.permutation(trials):
            acc = float(1.0 - np.exp(-rates[t] * it) + rng.normal(0, 0.02))
            out.append((f"t{t}", {"training_iteration": it, "acc": acc}))
    return out


def _decisions(make, seed: int):
    """Each decision of a scheduler on the seeded stream; a trial gets no
    report after its first STOP or exploit."""
    sched = make()
    done, out = set(), []
    for tid, _ in _reports(seed)[:6]:
        if hasattr(sched, "on_trial_add"):
            sched.on_trial_add(tid, {"lr": 0.01})
    for tid, rep in _reports(seed):
        if tid in done:
            continue
        d = sched.on_result(tid, dict(rep))
        out.append((tid, rep["training_iteration"], d))
        if d != "CONTINUE":
            done.add(tid)
    return out


@pytest.mark.parametrize("what", ["generate_trials", "fifo", "asha", "hyperband", "pbt", "tpe"])
@pytest.mark.parametrize("seed", [0, 1])
def test_seeded_decisions_equal_the_jax_packages(what, seed):
    """The same seeded input through the JAX package's Tune and the port's
    gives the same trials, the same scheduler decisions and the same TPE
    suggestions. (The JAX package has no median-stopping rule; HyperBand
    stands in its place.)"""
    from ray_tpu import tune as jax_tune
    from ray_tpu.tune import search as jax_search

    from ray_tpu_torch.tune import search as port_search

    if what == "generate_trials":
        got = port_search.generate_trials(_space(tune), num_samples=3, seed=seed)
        want = jax_search.generate_trials(_space(jax_tune), num_samples=3, seed=seed)
        assert len(got) == 9 and got == want
        return
    if what == "tpe":
        def suggestions(pkg, searcher_cls):
            s = searcher_cls(metric="loss", mode="min", n_startup=5, seed=seed)
            s.set_search_space({"x": pkg.uniform(0.0, 1.0), "opt": pkg.choice(["a", "b", "c"])})
            out = []
            for i in range(25):
                cfg = s.suggest(f"t{i}")
                out.append(cfg)
                s.on_trial_complete(f"t{i}", {"loss": (cfg["x"] - 0.3) ** 2
                                              + (cfg["opt"] != "b")})
            return out

        assert suggestions(tune, port_search.TPESearcher) == \
            suggestions(jax_tune, jax_search.TPESearcher)
        return
    kw = {"fifo": {}, "asha": dict(metric="acc", mode="max", max_t=12, grace_period=1,
                                   reduction_factor=2),
          "hyperband": dict(metric="acc", mode="max", max_t=9, grace_period=1,
                            reduction_factor=3),
          "pbt": dict(metric="acc", mode="max", perturbation_interval=3,
                      hyperparam_mutations={"lr": [0.001, 0.01, 0.1]}, quantile_fraction=0.5,
                      seed=seed)}[what]
    cls = {"fifo": "FIFOScheduler", "asha": "ASHAScheduler",
           "hyperband": "HyperBandScheduler", "pbt": "PopulationBasedTraining"}[what]
    got = _decisions(lambda: getattr(tune, cls)(**kw), seed)
    want = _decisions(lambda: getattr(jax_tune, cls)(**kw), seed)
    assert got == want
    if what != "fifo":  # the stream exercises the scheduler
        assert any(d != "CONTINUE" for _, _, d in got), got
