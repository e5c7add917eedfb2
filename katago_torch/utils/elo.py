"""Elo computation with uncertainty — equivalent of cpp/core/elo.{cpp,h};
the port's own copy of katago_tpu/utils/elo.py (katago_torch imports
nothing of the JAX package, not even its modules that do not import JAX).

Used by match and gatekeeper tooling to estimate strength differences from
game records, including approximate standard deviations via the observed
Fisher information (the reference computes Elo with covariance for its
match summaries).
"""

from __future__ import annotations

import math

ELO_PER_NAT = 400.0 / math.log(10.0)


def win_prob_of_elo_diff(elo_diff: float) -> float:
    """P(A beats B) given elo(A) - elo(B)."""
    return 1.0 / (1.0 + 10.0 ** (-elo_diff / 400.0))


def elo_diff_of_win_prob(p: float) -> float:
    p = min(max(p, 1e-9), 1.0 - 1e-9)
    return -400.0 * math.log10(1.0 / p - 1.0)


def estimate_elo(wins: float, losses: float, draws: float = 0.0
                 ) -> tuple[float, float]:
    """(elo_diff, stdev) of player A vs B from a match record.

    Draws count half a win each way. Stdev from the Fisher information of
    the Bradley-Terry likelihood at the MLE.
    """
    w = wins + 0.5 * draws
    l = losses + 0.5 * draws
    n = w + l
    if n <= 0:
        return 0.0, float("inf")
    p = w / n
    elo = elo_diff_of_win_prob(p)
    # var(p_hat) = p(1-p)/n; delta method through the logistic link
    p_c = min(max(p, 1.0 / (n + 1)), n / (n + 1))
    dp = math.sqrt(p_c * (1.0 - p_c) / n)
    d_elo_dp = ELO_PER_NAT / (p_c * (1.0 - p_c))
    return elo, d_elo_dp * dp


def log_likelihood_of_record(elo_diff: float, wins: float, losses: float,
                             draws: float = 0.0) -> float:
    p = win_prob_of_elo_diff(elo_diff)
    w = wins + 0.5 * draws
    l = losses + 0.5 * draws
    return w * math.log(max(p, 1e-300)) + l * math.log(max(1 - p, 1e-300))


# ---- multi-player Elo (ComputeElos, cpp/core/elo.cpp) ----------------------

ELO_PER_LOG_GAMMA = 173.717792761  # 400/ln(10)


def compute_elos(win_matrix, prior_wl: float = 2.0, max_iters: int = 10000,
                 tolerance: float = 0.0001) -> list[float]:
    """Bradley-Terry MLE Elos for a round-robin record.

    win_matrix[a][b] = (firstWins, secondWins): the record of the games
    where a played FIRST vs b — firstWins = a's wins, secondWins = b's
    wins in those games (ComputeElos::computeElos, elo.h:7-10,
    elo.cpp:145-146). prior_wl is a
    virtual prior of that many wins AND losses against a 0-Elo opponent,
    anchoring the scale. Solved by the standard BT minorization fixpoint
    (gamma_x <- wins_x / sum_opponents games/(gamma_x+gamma_y)), iterated
    to a max per-player step below `tolerance` Elo.
    """
    import numpy as np
    wm = np.asarray(win_matrix, dtype=np.float64)
    n = wm.shape[0]
    assert wm.shape == (n, n, 2)
    log_g = np.zeros(n)

    wins = wm[:, :, 0].sum(axis=1) + wm[:, :, 1].sum(axis=0)  # wins of each x
    games = wm[:, :, 0] + wm[:, :, 1]                         # games x-first-vs-y
    tot_games = games + games.T                                # all games x vs y
    np.fill_diagonal(tot_games, 0.0)

    for _ in range(max_iters):
        g = np.exp(log_g)
        denom = (tot_games / (g[:, None] + g[None, :])).sum(axis=1)
        denom = denom + 2.0 * prior_wl / (g + 1.0)
        new_g = (wins + prior_wl) / np.maximum(denom, 1e-300)
        new_log_g = np.log(np.maximum(new_g, 1e-300))
        max_diff = ELO_PER_LOG_GAMMA * np.abs(new_log_g - log_g).max()
        log_g = new_log_g
        if max_diff < tolerance:
            break
    return (ELO_PER_LOG_GAMMA * log_g).tolist()


def compute_approx_elo_stdevs(elos, win_matrix, prior_wl: float = 2.0,
                              radius: int = 1500) -> list[float]:
    """Per-player Elo stdevs holding all other Elos fixed
    (ComputeElos::computeApproxEloStdevs): discretize the local likelihood
    over elo +- radius in 1-Elo steps and take its second moment."""
    import numpy as np
    wm = np.asarray(win_matrix, dtype=np.float64)
    n = wm.shape[0]
    elos = np.asarray(elos, dtype=np.float64)
    offsets = np.arange(-radius, radius + 1, dtype=np.float64)
    out = []
    for x in range(n):
        # wins/losses of x vs each opponent (either seat) + the prior
        w_x = np.concatenate([wm[x, :, 0] + wm[:, x, 1], [prior_wl]])
        l_x = np.concatenate([wm[x, :, 1] + wm[:, x, 0], [prior_wl]])
        opp = np.concatenate([elos, [0.0]])
        w_x[x], l_x[x] = 0.0, 0.0
        diffs = (elos[x] + offsets)[:, None] - opp[None, :]
        lg = diffs / ELO_PER_LOG_GAMMA
        ll = -(w_x * np.log1p(np.exp(-np.clip(lg, -50, 50)))
               + l_x * np.log1p(np.exp(np.clip(lg, -50, 50)))).sum(axis=1)
        rel = np.exp(ll - ll.max())
        rel /= rel.sum()
        out.append(float(np.sqrt((rel * offsets ** 2).sum())))
    return out
