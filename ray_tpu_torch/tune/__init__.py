"""Tune: distributed hyperparameter search (reference: python/ray/tune)."""

from ray_tpu_torch.air.session import get_checkpoint, get_trial_id, get_trial_name
from ray_tpu_torch.air.session import report  # tune.report == session.report
from ray_tpu_torch.tune.callbacks import (Callback, CSVLoggerCallback,
                                    JsonLoggerCallback,
                                    MLflowLoggerCallback, SyncerCallback,
                                    TBXLoggerCallback, WandbLoggerCallback)
from ray_tpu_torch.tune.schedulers import (ASHAScheduler, FIFOScheduler,
                                     HyperBandScheduler, MedianStoppingRule,
                                     PopulationBasedTraining)
from ray_tpu_torch.tune.search import (BasicVariantGenerator, BayesOptSearch,
                                 BOHBSearcher, ConcurrencyLimiter,
                                 Searcher, TPESearcher,
                                 TuneBOHB, choice, grid_search, loguniform,
                                 quniform, randint, sample_from, uniform)
from ray_tpu_torch.tune.tuner import ResultGrid, TuneConfig, Tuner


def with_resources(trainable, resources: dict):
    """Attach per-trial resource requests (reference: tune.with_resources)."""
    mapped = {}
    for key, value in resources.items():
        if key in ("cpu", "CPU", "num_cpus"):
            mapped["num_cpus"] = value
        elif key in ("gpu", "GPU", "num_gpus"):
            mapped["num_gpus"] = value
        elif key in ("tpu", "TPU", "num_tpus"):
            raise ValueError(
                f"with_resources: {key!r} asks for a TPU, and the port has "
                "none; its accelerator resource is the CUDA card ('gpu')")
        else:
            mapped.setdefault("resources", {})[key] = value
    trainable._tune_resources = mapped
    return trainable


def with_parameters(trainable, **kwargs):
    """Bind large constant objects to the trainable
    (reference: tune.with_parameters)."""
    import functools

    @functools.wraps(trainable)
    def wrapped(config):
        return trainable(config, **kwargs)

    return wrapped


__all__ = [
    "ASHAScheduler",
    "BasicVariantGenerator",
    "BayesOptSearch",
    "Callback",
    "CSVLoggerCallback",
    "ConcurrencyLimiter",
    "FIFOScheduler",
    "HyperBandScheduler",
    "JsonLoggerCallback",
    "MLflowLoggerCallback",
    "MedianStoppingRule",
    "PopulationBasedTraining",
    "ResultGrid",
    "Searcher",
    "SyncerCallback",
    "TBXLoggerCallback",
    "TPESearcher",
    "BOHBSearcher",
    "TuneBOHB",
    "TuneConfig",
    "Tuner",
    "choice",
    "get_checkpoint",
    "get_trial_id",
    "get_trial_name",
    "grid_search",
    "loguniform",
    "quniform",
    "randint",
    "report",
    "sample_from",
    "uniform",
    "WandbLoggerCallback",
    "with_parameters",
    "with_resources",
]
