"""Trial schedulers.

Parity: ray.tune schedulers (reference python/ray/tune/schedulers/ —
FIFOScheduler, AsyncHyperBandScheduler/ASHA async_hyperband.py).
"""

from __future__ import annotations

from typing import Dict, List

CONTINUE = "CONTINUE"
STOP = "STOP"


class FIFOScheduler:
    """No early stopping: every trial runs to its own completion."""

    def on_result(self, trial_id: str, result: Dict) -> str:
        return CONTINUE


class ASHAScheduler:
    """Asynchronous Successive Halving (reference async_hyperband.py):
    rungs at grace_period * reduction_factor^k; when a trial first reports
    at/past a rung, its metric joins the rung's record and the trial stops
    unless it is in the rung's top 1/reduction_factor fraction."""

    def __init__(
        self,
        metric: str,
        mode: str = "max",
        max_t: int = 100,
        grace_period: int = 1,
        reduction_factor: int = 3,
        time_attr: str = "training_iteration",
    ):
        if mode not in ("min", "max"):
            raise ValueError(f"mode must be min|max, got {mode!r}")
        self.metric = metric
        self.mode = mode
        self.max_t = max_t
        self.grace_period = grace_period
        self.rf = reduction_factor
        self.time_attr = time_attr
        self.rungs: List[int] = []
        t = grace_period
        while t < max_t:
            self.rungs.append(t)
            t *= reduction_factor
        # rung milestone -> list of recorded metric values
        self._rung_records: Dict[int, List[float]] = {r: [] for r in self.rungs}
        # trial_id -> highest rung already judged
        self._judged: Dict[str, int] = {}

    def on_result(self, trial_id: str, result: Dict) -> str:
        t = result.get(self.time_attr)
        value = result.get(self.metric)
        if t is None or value is None:
            return CONTINUE
        if t >= self.max_t:
            return STOP  # ran to the horizon
        for rung in reversed(self.rungs):
            if t < rung or self._judged.get(trial_id, -1) >= rung:
                continue
            self._judged[trial_id] = rung
            records = self._rung_records[rung]
            records.append(float(value))
            if len(records) < self.rf:
                return CONTINUE  # not enough peers to judge yet
            ordered = sorted(records, reverse=(self.mode == "max"))
            k = max(1, len(ordered) // self.rf)
            cutoff = ordered[k - 1]
            good = value >= cutoff if self.mode == "max" else value <= cutoff
            return CONTINUE if good else STOP
        return CONTINUE


class PopulationBasedTraining:
    """PBT (parity: reference python/ray/tune/schedulers/pbt.py):
    at each perturbation interval a bottom-quantile trial EXPLOITS a
    top-quantile trial — it restarts from the winner's latest checkpoint
    with EXPLORED (mutated) hyperparameters. Decisions are returned to
    the controller as ("EXPLOIT", source_trial_id, mutated_config); the
    controller performs the clone/restart (tuner.py)."""

    def __init__(
        self,
        metric: str,
        mode: str = "max",
        perturbation_interval: int = 4,
        hyperparam_mutations: Dict = None,
        quantile_fraction: float = 0.25,
        resample_probability: float = 0.25,
        time_attr: str = "training_iteration",
        seed: int = 0,
    ):
        if mode not in ("min", "max"):
            raise ValueError(f"mode must be min|max, got {mode!r}")
        if not hyperparam_mutations:
            raise ValueError("hyperparam_mutations is required for PBT")
        import random as _random

        self.metric = metric
        self.mode = mode
        self.interval = perturbation_interval
        self.mutations = dict(hyperparam_mutations)
        self.quantile = quantile_fraction
        self.resample_p = resample_probability
        self.time_attr = time_attr
        self._rng = _random.Random(seed)
        self._configs: Dict[str, Dict] = {}
        self._scores: Dict[str, float] = {}
        self._last_perturb: Dict[str, int] = {}
        self.exploit_count = 0  # observability / tests

    # controller hooks ---------------------------------------------------

    def on_trial_add(self, trial_id: str, config: Dict) -> None:
        self._configs[trial_id] = dict(config)
        self._last_perturb[trial_id] = 0

    def _explore(self, config: Dict) -> Dict:
        out = dict(config)
        for key, spec in self.mutations.items():
            if isinstance(spec, list):
                out[key] = self._rng.choice(spec)
            elif callable(spec) and not hasattr(spec, "sample"):
                out[key] = spec()
            elif hasattr(spec, "sample"):  # search-space Domain
                out[key] = spec.sample(self._rng)
            elif isinstance(out.get(key), (int, float)):
                factor = 1.2 if self._rng.random() > 0.5 else 0.8
                out[key] = type(out[key])(out[key] * factor)
        return out

    def on_result(self, trial_id: str, result: Dict):
        t = result.get(self.time_attr)
        value = result.get(self.metric)
        if t is None or value is None:
            return CONTINUE
        self._scores[trial_id] = float(value)
        if t - self._last_perturb.get(trial_id, 0) < self.interval:
            return CONTINUE
        self._last_perturb[trial_id] = t
        peers = sorted(
            self._scores.items(), key=lambda kv: kv[1],
            reverse=(self.mode == "max"),
        )
        if len(peers) < 2:
            return CONTINUE
        k = max(1, int(len(peers) * self.quantile))
        top = [tid for tid, _ in peers[:k]]
        bottom = {tid for tid, _ in peers[-k:]}
        if trial_id not in bottom or trial_id in top:
            return CONTINUE
        source = self._rng.choice(top)
        base = self._configs.get(source, self._configs.get(trial_id, {}))
        if self._rng.random() < self.resample_p:
            new_config = self._explore(self._explore(base))
        else:
            new_config = self._explore(base)
        self._configs[trial_id] = dict(new_config)
        self.exploit_count += 1
        return ("EXPLOIT", source, new_config)


class HyperBandScheduler:
    """HyperBand (asynchronous-bracket formulation): trials are assigned
    round-robin to brackets whose grace periods span
    ``grace_period * rf^k`` up to max_t, and each bracket runs ASHA-style
    successive halving at its own rungs. This is the multi-bracket
    generalization of ASHA the HyperBand paper reduces to under async
    arrival (the role the reference's hyperband.py / hb_bohb.py family
    plays; the synchronous cohort barrier is deliberately dropped — it
    wastes cluster time waiting for stragglers and can deadlock with
    early-stopped trials)."""

    def __init__(
        self,
        metric: str,
        mode: str = "max",
        max_t: int = 81,
        grace_period: int = 1,
        reduction_factor: int = 3,
        time_attr: str = "training_iteration",
    ):
        self.brackets: List[ASHAScheduler] = []
        t = grace_period
        while t <= max_t:
            self.brackets.append(
                ASHAScheduler(
                    metric, mode=mode, max_t=max_t, grace_period=t,
                    reduction_factor=reduction_factor, time_attr=time_attr,
                )
            )
            t *= reduction_factor
        self._assignment: Dict[str, int] = {}
        self._next = 0

    def on_trial_add(self, trial_id: str, config: Dict) -> None:
        self._assignment[trial_id] = self._next % len(self.brackets)
        self._next += 1

    def _bracket(self, trial_id: str) -> ASHAScheduler:
        idx = self._assignment.get(trial_id)
        if idx is None:  # trial added without on_trial_add (restore path)
            idx = self._next % len(self.brackets)
            self._assignment[trial_id] = idx
            self._next += 1
        return self.brackets[idx]

    def on_result(self, trial_id: str, result: Dict) -> str:
        return self._bracket(trial_id).on_result(trial_id, result)
