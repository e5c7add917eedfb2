"""Selfplay data-quality settings — cpp/program/playsettings.{cpp,h}.

The port's own copy of katago_tpu/selfplay/playsettings.py
(katago_torch imports nothing of the JAX package, not even its modules
that do not import JAX).

The reference spends full visits on only ~25% of moves and plays the rest
with cheap searches recorded at reduced weight (cheapSearchProb/
cheapSearchVisits/cheapSearchTargetWeight, playsettings.h:45-51), starts
games with a few raw-policy moves (policyInitAvgMoveNum), and weights rows
by policy surprise (playsettings.h:56). This module holds those knobs and
the host-side per-move decisions for the lockstep batch; in the batched
engine the cheap/full decision is per *move* rather than per game-thread
(same long-run data mix, one search configuration per budget).
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class PlaySettings:
    # policy-initialized opening moves (playsettings.h:9-14)
    init_games_with_policy: bool = True
    policy_init_avg_move_num: float = 4.0
    # cheap/full search mixing (playsettings.h:45-51)
    cheap_search_prob: float = 0.75
    cheap_search_visits: int = 100
    cheap_search_target_weight: float = 0.0
    # policy-surprise weighting (playsettings.h:56)
    policy_surprise_data_weight: float = 0.5
    # per-game komi randomization (GameInitializer, play.cpp:195-199 and
    # selfplay1.cfg:101-103)
    komi_stdev: float = 0.0
    komi_big_stdev_prob: float = 0.06
    komi_big_stdev: float = 12.0

    @staticmethod
    def for_selfplay() -> "PlaySettings":
        """configs/training/selfplay1.cfg-flavored defaults."""
        return PlaySettings(komi_stdev=1.0)

    @staticmethod
    def for_testing(full_visits: int) -> "PlaySettings":
        return PlaySettings(init_games_with_policy=False,
                            cheap_search_prob=0.0,
                            cheap_search_visits=max(full_visits // 4, 2))


def sample_komis(base_komi: float, ps: "PlaySettings", num_games: int,
                 rng: np.random.Generator) -> np.ndarray:
    """Per-game komi draws on the half-integer grid
    (GameInitializer::createGameSharedUnsynchronized komi sampling)."""
    komi = np.full(num_games, base_komi, np.float64)
    if ps.komi_stdev > 0:
        komi = komi + rng.normal(0.0, ps.komi_stdev, num_games)
        big = rng.random(num_games) < ps.komi_big_stdev_prob
        komi = komi + np.where(big,
                               rng.normal(0.0, ps.komi_big_stdev, num_games),
                               0.0)
    return (np.round(komi * 2.0) / 2.0).astype(np.float32)


def policy_surprise_weights(policy_target: np.ndarray,
                            policy_prior: np.ndarray,
                            base_weight: np.ndarray,
                            data_weight: float) -> np.ndarray:
    """Row weights boosted by policy surprise (KL of the search result from
    the prior), normalized to preserve total weight
    (Play::markSurpriseWeight semantics)."""
    p = np.maximum(policy_target, 0.0) + 1e-30
    p = p / p.sum(-1, keepdims=True)
    q = np.maximum(policy_prior, 1e-10)
    q = q / q.sum(-1, keepdims=True)
    kl = np.sum(p * (np.log(p) - np.log(q)), axis=-1)
    if data_weight <= 0.0 or kl.size == 0:
        return base_weight
    surprise = kl / max(np.mean(kl), 1e-10)
    w = base_weight * ((1.0 - data_weight) + data_weight * surprise)
    # renormalize to keep the dataset's total weight unchanged
    total = np.sum(base_weight)
    return w * (total / max(np.sum(w), 1e-10))
