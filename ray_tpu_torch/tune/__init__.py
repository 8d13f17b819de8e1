"""Hyperparameter tuning library (port of ``ray_tpu/tune``; reference:
``python/ray/tune`` —
``Tuner.fit`` ``tune/tuner.py:327`` → ``TrialRunner`` event loop
``tune/execution/trial_runner.py:61``).

Trials are function trainables hosted in worker actors that reuse the
train library's session/report plumbing (the reference likewise unifies
Train and Tune on ``air.session``). Schedulers (ASHA) can stop
underperforming trials early; failed trials retry per FailureConfig.
"""

from ray_tpu_torch.tune.search import (  # noqa: F401
    grid_search, choice, uniform, loguniform, randint, sample_from,
    BasicVariantGenerator, Searcher, TPESearcher,
)
from ray_tpu_torch.tune.schedulers import (  # noqa: F401
    FIFOScheduler, AsyncHyperBandScheduler, ASHAScheduler,
    HyperBandScheduler, PopulationBasedTraining,
)
from ray_tpu_torch.tune.tuner import TuneConfig, Tuner, ResultGrid  # noqa: F401
from ray_tpu_torch.tune.placement_groups import PlacementGroupFactory  # noqa: F401
from ray_tpu_torch.train.session import report  # noqa: F401  (tune.report alias)

__all__ = [
    "grid_search", "choice", "uniform", "loguniform", "randint",
    "sample_from", "BasicVariantGenerator", "Searcher", "TPESearcher",
    "FIFOScheduler", "AsyncHyperBandScheduler", "ASHAScheduler",
    "HyperBandScheduler", "PopulationBasedTraining",
    "TuneConfig", "Tuner", "PlacementGroupFactory",
    "ResultGrid", "report",
]

from ray_tpu_torch._private import usage as _usage  # noqa: E402
_usage.record_library_usage("tune")
del _usage
