"""Predictors: checkpoint → batch inference.

The counterpart of ``ray_tpu/train/predictor.py`` (the reference's
train/predictor.py + batch_predictor.py). ``Predictor`` and
``BatchPredictor`` are the JAX package's; ``TorchPredictor`` takes the
place of ``JaxPredictor``: it holds a model on one device (the card
unless ``"cpu"`` is asked for) and answers in numpy, as ``JaxPredictor``
does. A BatchPredictor's scoring actors ask for CPUs only and run on
threads of the calling process, so they see the cards it sees.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Type

import numpy as np
import torch

from ray_tpu_torch._private.device import (DeviceLike, resolve_device,
                                           to_host)
from ray_tpu_torch.air.checkpoint import Checkpoint


class Predictor:
    """Base predictor. Subclasses implement ``_predict_numpy``."""

    def __init__(self, preprocessor=None):
        self._preprocessor = preprocessor

    @classmethod
    def from_checkpoint(cls, checkpoint: Checkpoint, **kwargs) -> "Predictor":
        raise NotImplementedError

    def predict(self, batch: Any) -> Any:
        if self._preprocessor is not None:
            batch = self._preprocessor.transform_batch(batch)
        return self._predict_numpy(batch)

    def _predict_numpy(self, batch: Any) -> Any:
        raise NotImplementedError


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


class TorchPredictor(Predictor):
    """Predictor over a PyTorch model on ``device``: ``model(batch)`` for
    an ``nn.Module``, or ``apply_fn(model, batch)`` where ``model`` is the
    module or a tree of parameters (numpy leaves are moved to the device
    as tensors). The batch's arrays are moved there as tensors; the
    output comes back as numpy arrays of the same tree. Runs under
    ``torch.inference_mode()``."""

    def __init__(self, model, apply_fn: Optional[Callable] = None,
                 preprocessor=None, device: DeviceLike = None):
        super().__init__(preprocessor)
        self.device = resolve_device(device)
        if isinstance(model, torch.nn.Module):
            model = model.to(self.device).eval()
        elif apply_fn is None:
            raise TypeError("a tree of parameters needs its apply_fn")
        else:
            model = _tree_map(lambda a: torch.tensor(a, device=self.device),
                              model)
        self.model = model
        self._apply = apply_fn

    @classmethod
    def from_checkpoint(cls, checkpoint: Checkpoint, *,
                        apply_fn: Optional[Callable] = None,
                        model=None, device: DeviceLike = None,
                        **kwargs) -> "TorchPredictor":
        """From a dict checkpoint holding ``"params"`` (or ``"model"``),
        as ``JaxPredictor.from_checkpoint`` takes one; or from a
        ``ShardedCheckpoint`` of the port's train state, whose parameters
        ``restore_params`` copies into ``model`` (the optimizer's state is
        not read into the card, so a state of any optimizer serves).
        ``model`` is a model of the saved config, whose values are
        overwritten, or a function that builds one on a given device: a
        BatchPredictor ships its arguments to every scoring actor, which
        then builds its own."""
        from ray_tpu_torch.train._internal.sharded_checkpoint import \
            ShardedCheckpoint
        if isinstance(checkpoint, ShardedCheckpoint):
            if model is None:
                raise ValueError("a sharded train state restores into a "
                                 "model: pass model=")
            model = _restored(checkpoint, model, resolve_device(device))
            return cls(model, apply_fn, device=device, **kwargs)
        data = checkpoint.to_dict()
        params = data.get("params", data.get("model"))
        if params is None:
            raise ValueError(
                "Checkpoint must contain 'params' (or 'model') for "
                "TorchPredictor")
        return cls(params, apply_fn, preprocessor=data.get("preprocessor"),
                   device=device, **kwargs)

    def _predict_numpy(self, batch: Any) -> Any:
        def to_device(a):
            return torch.tensor(np.asarray(a), device=self.device)

        inp = ({k: to_device(v) for k, v in batch.items()}
               if isinstance(batch, dict) else to_device(batch))
        with torch.inference_mode():
            out = (self.model(inp) if self._apply is None
                   else self._apply(self.model, inp))
        return _tree_map(to_host, out)


def _restored(checkpoint, model, device) -> torch.nn.Module:
    """``model`` on ``device`` holding the parameters of ``checkpoint``'s
    train state."""
    from ray_tpu_torch.train.torch.checkpoint import restore_params
    if not isinstance(model, torch.nn.Module):
        model = model(device)
    return restore_params(model.to(device), checkpoint)


class BatchPredictor:
    """Maps a Predictor over a Dataset (reference: batch_predictor.py):
    one predictor instance per actor, batches stream through the actor
    pool."""

    def __init__(self, checkpoint: Checkpoint,
                 predictor_cls: Type[Predictor], **predictor_kwargs):
        self._checkpoint = checkpoint
        self._predictor_cls = predictor_cls
        self._predictor_kwargs = predictor_kwargs

    @classmethod
    def from_checkpoint(cls, checkpoint: Checkpoint,
                        predictor_cls: Type[Predictor],
                        **predictor_kwargs) -> "BatchPredictor":
        return cls(checkpoint, predictor_cls, **predictor_kwargs)

    def predict(self, dataset, *, batch_size: int = 256,
                min_scoring_workers: int = 1,
                max_scoring_workers: int = 2,
                num_cpus_per_worker: float = 1.0,
                feature_columns=None,
                keep_columns=None):
        """Returns a Dataset of prediction batches."""
        from ray_tpu_torch.data._internal.compute import ActorPoolStrategy

        checkpoint = self._checkpoint
        predictor_cls = self._predictor_cls
        predictor_kwargs = self._predictor_kwargs

        class _ScoringActor:
            def __init__(self):
                self.predictor = predictor_cls.from_checkpoint(
                    checkpoint, **predictor_kwargs)

            def __call__(self, batch: Dict[str, np.ndarray]):
                inp = batch
                if feature_columns:
                    inp = {k: batch[k] for k in feature_columns}
                out = self.predictor.predict(inp)
                if not isinstance(out, dict):
                    out = {"predictions": np.asarray(out)}
                if keep_columns:
                    for k in keep_columns:
                        out[k] = batch[k]
                return out

        return dataset.map_batches(
            _ScoringActor,
            batch_size=batch_size,
            compute=ActorPoolStrategy(min_size=min_scoring_workers,
                                      max_size=max_scoring_workers),
            num_cpus=num_cpus_per_worker)


__all__ = ["BatchPredictor", "Predictor", "TorchPredictor"]
