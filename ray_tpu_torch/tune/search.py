"""Search spaces + trial generation.

Parity: ray.tune search-space API (reference python/ray/tune/search/ —
sample.py domains, BasicVariantGenerator grid/random expansion).
"""

from __future__ import annotations

import math
import random
from typing import Any, Dict, List, Optional, Sequence


class Domain:
    def sample(self, rng: random.Random) -> Any:
        raise NotImplementedError


class Uniform(Domain):
    def __init__(self, low: float, high: float):
        self.low, self.high = low, high

    def sample(self, rng):
        return rng.uniform(self.low, self.high)


class LogUniform(Domain):
    def __init__(self, low: float, high: float):
        import math

        self._lo, self._hi = math.log(low), math.log(high)

    def sample(self, rng):
        import math

        return math.exp(rng.uniform(self._lo, self._hi))


class RandInt(Domain):
    def __init__(self, low: int, high: int):
        self.low, self.high = low, high

    def sample(self, rng):
        return rng.randrange(self.low, self.high)


class Choice(Domain):
    def __init__(self, options: Sequence[Any]):
        self.options = list(options)

    def sample(self, rng):
        return rng.choice(self.options)


class GridSearch:
    """Marker: expands the cross-product instead of sampling."""

    def __init__(self, values: Sequence[Any]):
        self.values = list(values)


def uniform(low: float, high: float) -> Uniform:
    return Uniform(low, high)


def loguniform(low: float, high: float) -> LogUniform:
    return LogUniform(low, high)


def randint(low: int, high: int) -> RandInt:
    return RandInt(low, high)


def choice(options: Sequence[Any]) -> Choice:
    return Choice(options)


def grid_search(values: Sequence[Any]) -> GridSearch:
    return GridSearch(values)


def generate_trials(
    param_space: Dict[str, Any],
    num_samples: int,
    seed: Optional[int] = None,
) -> List[Dict[str, Any]]:
    """Expand grid_search dims into their cross-product; sample Domain
    dims num_samples times per grid point (reference BasicVariantGenerator
    semantics)."""
    rng = random.Random(seed)
    grid_keys = [k for k, v in param_space.items() if isinstance(v, GridSearch)]
    grids: List[Dict[str, Any]] = [{}]
    for k in grid_keys:
        grids = [
            {**g, k: v} for g in grids for v in param_space[k].values
        ]
    trials = []
    for g in grids:
        for _ in range(num_samples):
            cfg = dict(g)
            for k, v in param_space.items():
                if k in cfg:
                    continue
                cfg[k] = v.sample(rng) if isinstance(v, Domain) else v
            trials.append(cfg)
    return trials


class TPESearcher:
    """Model-based search: Tree-structured Parzen Estimator, no external
    deps (the role optuna's TPESampler plays for the reference,
    python/ray/tune/search/optuna/optuna_search.py:1; algorithm per
    Bergstra et al. 2011, per-dimension independent factorization like
    hyperopt's default).

    After ``n_startup`` random trials, completed trials split at the
    ``gamma`` quantile into good/bad sets. Per dimension, candidates are
    drawn from a kernel density over the GOOD values (bad-set density in
    the denominator), and the candidate maximizing l(x)/g(x) is chosen —
    categorical dims use smoothed count ratios instead of kernels.
    """

    def __init__(self, metric: str, mode: str = "max",
                 n_startup: int = 10, gamma: float = 0.25,
                 n_candidates: int = 24, seed: Optional[int] = None):
        if mode not in ("min", "max"):
            raise ValueError("mode must be 'min' or 'max'")
        self.metric = metric
        self.mode = mode
        self.n_startup = n_startup
        self.gamma = gamma
        self.n_candidates = n_candidates
        self._rng = random.Random(seed)
        self._space: Dict[str, Any] = {}
        self._observed: List[Any] = []  # (score_minimized, config)
        self._suggested: Dict[str, Dict[str, Any]] = {}

    def set_search_space(self, param_space: Dict[str, Any]) -> None:
        bad = [k for k, v in param_space.items() if isinstance(v, GridSearch)]
        if bad:
            raise ValueError(
                f"TPESearcher cannot optimize grid_search dimensions {bad}; "
                "use a Domain (uniform/loguniform/randint/choice) instead"
            )
        self._space = dict(param_space)

    # -- searcher protocol ---------------------------------------------

    def suggest(self, trial_id: str) -> Dict[str, Any]:
        if len(self._observed) < self.n_startup:
            cfg = {
                k: (v.sample(self._rng) if isinstance(v, Domain) else v)
                for k, v in self._space.items()
            }
        else:
            cfg = self._suggest_tpe()
        self._suggested[trial_id] = cfg
        return cfg

    def on_trial_complete(self, trial_id: str,
                          result: Optional[Dict[str, Any]]) -> None:
        cfg = self._suggested.pop(trial_id, None)
        if cfg is None or not result or self.metric not in result:
            return
        score = float(result[self.metric])
        if self.mode == "max":
            score = -score  # normalize to minimization
        self._observed.append((score, cfg))

    # -- TPE core -------------------------------------------------------

    def _split(self):
        ordered = sorted(self._observed, key=lambda sc: sc[0])
        n_good = max(1, int(math.ceil(self.gamma * len(ordered))))
        good = [c for _, c in ordered[:n_good]]
        bad = [c for _, c in ordered[n_good:]] or good
        return good, bad

    def _suggest_tpe(self) -> Dict[str, Any]:
        good, bad = self._split()
        cfg: Dict[str, Any] = {}
        for key, dom in self._space.items():
            if isinstance(dom, Choice):
                cfg[key] = self._pick_categorical(key, dom, good, bad)
            elif isinstance(dom, (Uniform, LogUniform, RandInt)):
                cfg[key] = self._pick_numeric(key, dom, good, bad)
            elif isinstance(dom, Domain):
                cfg[key] = dom.sample(self._rng)
            else:
                cfg[key] = dom
        return cfg

    def _pick_categorical(self, key, dom: "Choice", good, bad):
        def weights(rows):
            counts = {i: 1.0 for i in range(len(dom.options))}  # +1 smooth
            for c in rows:
                try:
                    counts[dom.options.index(c[key])] += 1.0
                except (ValueError, KeyError):
                    pass
            total = sum(counts.values())
            return {i: v / total for i, v in counts.items()}

        wl, wg = weights(good), weights(bad)
        best = max(range(len(dom.options)), key=lambda i: wl[i] / wg[i])
        return dom.options[best]

    def _pick_numeric(self, key, dom, good, bad):
        to_x, from_x, lo, hi = self._transform(dom)
        if hi - lo <= 0:
            return from_x(lo)  # degenerate (pinned) dimension
        gx = [to_x(c[key]) for c in good if key in c]
        bx = [to_x(c[key]) for c in bad if key in c]
        if not gx:
            return dom.sample(self._rng)
        span = hi - lo
        bw_g = max(span / max(1.0, math.sqrt(len(gx))), 1e-6 * span)
        bw_b = max(span / max(1.0, math.sqrt(len(bx) or 1)), 1e-6 * span)

        def density(x, centers, bw):
            if not centers:
                return 1.0 / span  # uniform prior
            s = sum(
                math.exp(-0.5 * ((x - c) / bw) ** 2) for c in centers
            )
            return s / (len(centers) * bw * math.sqrt(2 * math.pi)) + 1e-12

        best_x, best_ratio = None, -1.0
        for _ in range(self.n_candidates):
            center = self._rng.choice(gx)
            x = min(max(self._rng.gauss(center, bw_g), lo), hi)
            ratio = density(x, gx, bw_g) / density(x, bx, bw_b)
            if ratio > best_ratio:
                best_x, best_ratio = x, ratio
        return from_x(best_x)

    def _transform(self, dom):
        if isinstance(dom, LogUniform):
            # LogUniform stores its bounds pre-logged (_lo/_hi)
            return (math.log, math.exp, dom._lo, dom._hi)
        if isinstance(dom, RandInt):
            return (
                float,
                lambda x: int(min(max(round(x), dom.low), dom.high - 1)),
                float(dom.low), float(dom.high - 1),
            )
        return (float, float, float(dom.low), float(dom.high))
