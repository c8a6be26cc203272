"""ray_tpu_torch.tune — hyperparameter tuning.

Parity target: Ray Tune (reference python/ray/tune — Tuner + trial
controller over actors, search spaces, ASHA early stopping, per-trial
checkpoints).
"""

from ray_tpu_torch.tune.schedulers import (
    ASHAScheduler,
    FIFOScheduler,
    HyperBandScheduler,
    PopulationBasedTraining,
)
from ray_tpu_torch.tune.trainable import Trainable, with_resources
from ray_tpu_torch.tune.search import (
    TPESearcher,
    choice,
    grid_search,
    loguniform,
    randint,
    uniform,
)
from ray_tpu_torch.tune.session import (
    get_checkpoint,
    get_trial_dir,
    load_checkpoint,
    report,
)
from ray_tpu_torch.tune.tuner import ResultGrid, TrialResult, TuneConfig, Tuner

__all__ = [
    "ASHAScheduler",
    "HyperBandScheduler",
    "TPESearcher",
    "PopulationBasedTraining",
    "Trainable",
    "get_checkpoint",
    "with_resources",
    "FIFOScheduler",
    "ResultGrid",
    "TrialResult",
    "TuneConfig",
    "Tuner",
    "choice",
    "get_trial_dir",
    "grid_search",
    "load_checkpoint",
    "loguniform",
    "randint",
    "report",
    "uniform",
]
