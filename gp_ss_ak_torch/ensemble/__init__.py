"""Batched independent-GP ensembles (multi-deposit)."""

from gp_ss_ak_torch.ensemble.batched import (
    EnsembleFit,
    fit_ensemble,
    predict_ensemble,
)

__all__ = ["EnsembleFit", "fit_ensemble", "predict_ensemble"]
