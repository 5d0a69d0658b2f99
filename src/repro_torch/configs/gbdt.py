"""The paper's own experiment configurations, as code (twin of
``repro.configs.gbdt``).

Validity experiments (§VI.B): real-sim 400 trees / 100 leaves (depth 7),
Higgs 1000 trees / 20 leaves (depth 5), feature_fraction 0.8, v = 0.01.
Efficiency experiments (§VI.C): 400 trees / 400 leaves (depth 9), R = 0.8.

Datasets are the property-matched synthetic stand-ins of
``data.synthetic.PAPER_DATASETS``; the ``quick`` variants keep every ratio
but shrink the tree budget. ``efficiency-e2006`` is the squared-error
experiment (paper §VI.C, Fig. 10) on the e2006-like regression set.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.sgbdt import SGBDTConfig
from repro_torch.data.synthetic import PAPER_DATASETS, DatasetSpec, load
from repro_torch.trees.binning import BinnedData
from repro_torch.trees.learner import LearnerConfig


@dataclasses.dataclass(frozen=True)
class PaperExperiment:
    name: str
    dataset: DatasetSpec
    config: SGBDTConfig
    paper_section: str


def _cfg(n_trees: int, depth: int, rate: float, v: float, loss: str,
         hist_mode: str = "subtract") -> SGBDTConfig:
    return SGBDTConfig(
        n_trees=n_trees, step_length=v, sampling_rate=rate, loss=loss,
        learner=LearnerConfig(depth=depth, n_bins=64, feature_fraction=0.8,
                              hist_mode=hist_mode),
    )


EXPERIMENTS: dict[str, PaperExperiment] = {
    # validity: real-sim, 400 trees x 100 leaves (depth 7 = 128 leaves)
    "validity-realsim": PaperExperiment(
        name="validity-realsim",
        dataset=PAPER_DATASETS["realsim-like"],
        config=_cfg(400, 7, 0.8, 0.01, "logistic"),
        paper_section="VI.B / Figs. 6, 8",
    ),
    # validity: Higgs, 1000 trees x 20 leaves (depth 5 = 32 leaves)
    "validity-higgs": PaperExperiment(
        name="validity-higgs",
        dataset=PAPER_DATASETS["higgs-like"],
        config=_cfg(1000, 5, 0.8, 0.01, "logistic"),
        paper_section="VI.B / Figs. 5, 7",
    ),
    # efficiency: real-sim, 400 trees x 400 leaves (depth 9 = 512 leaves)
    "efficiency-realsim": PaperExperiment(
        name="efficiency-realsim",
        dataset=PAPER_DATASETS["realsim-like"],
        config=_cfg(400, 9, 0.8, 0.01, "logistic"),
        paper_section="VI.C / Fig. 10",
    ),
    "efficiency-e2006": PaperExperiment(
        name="efficiency-e2006",
        dataset=PAPER_DATASETS["e2006-like"],
        config=_cfg(400, 9, 0.8, 0.01, "mse"),
        paper_section="VI.C / Fig. 10",
    ),
}


def get(name: str, quick: bool = False,
        device: str | torch.device | None = None) -> tuple[SGBDTConfig, BinnedData]:
    """-> (config, binned dataset on ``device``, the card unless one is
    given). ``quick`` shrinks the tree budget 5x (at least 40)."""
    exp = EXPERIMENTS[name]
    cfg = exp.config
    if quick:
        cfg = cfg._replace(n_trees=max(cfg.n_trees // 5, 40))
    return cfg, load(exp.dataset, device)
