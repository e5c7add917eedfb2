"""Training-data npz writer/reader — reference schema interop.

The port's own copy of katago_tpu/dataio/trainingwrite.py: the writer
(pack_rows / write_npz) for selfplay and the reader (decode_rows /
read_npz) for the trainer.

Writes selfplay rows in the exact array layout of the reference's
TrainingDataWriter (cpp/dataio/trainingwrite.h:183-290 — channel map cited
inline below), so the reference's shuffle.py / training tools can consume
our data and vice versa:

  binaryInputNCHWPacked uint8  [N, 22, ceil(area/8)]   bit-packed V7 planes
  globalInputNC         float  [N, 19]
  policyTargetsNCMove   int16  [N, 2, area+1]          C0 this turn, C1 next
  globalTargetsNC       float  [N, 80]                 targets/weights map
  scoreDistrN           int8   [N, 2*area+120]         two-hot final score
  valueTargetsNCHW      int8   [N, 5, H, W]            ownership etc.
  qValueTargetsNCMove   int16  [N, 3, area+1]

Fields not yet produced by the minimum slice (futurepos, seki aux, q-value
targets, reanalysis channels) are zero-filled with their weight channels 0,
which the reference reader treats as "absent" — files remain valid.
"""

from __future__ import annotations

import numpy as np

GLOBAL_TARGET_CHANNELS = 80
EXTRA_SCORE_DISTR_RADIUS = 60

# td-value group coefficients (trainingwrite.cpp:573-581):
# nowFactor = 0 (pure final result), 1/(1+area*c) for c in {.176,.056,.016},
# and 1 (the immediate MCTS estimate)
TD_NOW_COEFFS = (None, 0.176, 0.056, 0.016, 0.0)


def td_blend(white_targets: np.ndarray, now_factor: float) -> np.ndarray:
    """fillValueTDTargets (trainingwrite.cpp:411): forward-geometric blend
    of per-turn value targets, current turn first, remaining weight on the
    final entry.

    white_targets: [T+1, K] per-turn white-perspective targets; the last
    row is the game's final result. Returns [T, K] blends (one per turn):
    S_t = f*m_t + (1-f)*S_{t+1}, S_T = m_T.
    """
    t = white_targets.shape[0] - 1
    out = np.zeros((t, white_targets.shape[1]), np.float32)
    s = white_targets[t].astype(np.float32)
    for k in range(t - 1, -1, -1):
        s = now_factor * white_targets[k] + (1.0 - now_factor) * s
        out[k] = s
    return out


def td_groups(white_targets: np.ndarray, board_area: int) -> np.ndarray:
    """[T, 5, K]: the five td groups of trainingwrite.cpp:573-581."""
    t = white_targets.shape[0] - 1
    k = white_targets.shape[1]
    out = np.zeros((t, 5, k), np.float32)
    for gi, c in enumerate(TD_NOW_COEFFS):
        if c is None:
            nf = 0.0
        elif c == 0.0:
            nf = 1.0
        else:
            nf = 1.0 / (1.0 + board_area * c)
        out[:, gi, :] = td_blend(white_targets, nf)
    return out


def variance_time_target(white_winloss: np.ndarray) -> np.ndarray:
    """C22 (trainingwrite.cpp:604-616): per turn, sum over future turns of
    turnsFromNow * (delta winloss)^2. white_winloss: [T+1] incl. final."""
    t = len(white_winloss) - 1
    d2 = np.square(np.diff(white_winloss)).astype(np.float64)   # [T]
    out = np.zeros((t,), np.float32)
    # sum_{i>t} (i-t) * d2[i-1] computed by double suffix-cumsum
    suffix = np.cumsum(d2[::-1])[::-1]           # sum_{j>=k} d2[j]
    suffix2 = np.cumsum(suffix[::-1])[::-1]      # sum_{j>=k} (j-k+1) d2[j]
    out[:] = suffix2
    return out


def pack_rows(spatial: np.ndarray, global_in: np.ndarray,
              policy_target: np.ndarray, next_policy_target: np.ndarray,
              value_target: np.ndarray, td_targets: np.ndarray,
              score_target: np.ndarray, lead_target: np.ndarray,
              ownership_target: np.ndarray, self_komi: np.ndarray,
              turn_idx: np.ndarray, visits: np.ndarray,
              size: int,
              variance_time: np.ndarray | None = None,
              futurepos: np.ndarray | None = None,
              seki_diff: np.ndarray | None = None,
              scoring: np.ndarray | None = None,
              q_winloss: np.ndarray | None = None,
              q_score: np.ndarray | None = None,
              q_visits: np.ndarray | None = None,
              game_hash: np.ndarray | None = None,
              row_weight: np.ndarray | None = None
              ) -> dict[str, np.ndarray]:
    """Assemble reference-schema arrays from mover-perspective row data.

    spatial [N,H,W,22] f32 binary; policy targets [N,area+1] probabilities
    (converted to visit-count int16).

    td_targets: either [N,4] win-minus-loss per group (legacy; noresult 0,
    score channel = final score) or [N,5,4] full (win,loss,noresult,score)
    groups per trainingwrite.cpp:573-581 — group 0 becomes C0-3.

    Optional targets, zero-filled with weight 0 when absent:
    variance_time [N]; futurepos [N,2,area] mover-persp +-1; seki_diff
    [N,area] +-1; scoring [N,area] mover-persp in [-1,1]; q_* [N,area+1];
    game_hash [N] uint64 row-group id (C41-46 chunks).
    """
    n = spatial.shape[0]
    area = size * size

    planes = np.transpose(spatial.astype(np.uint8), (0, 3, 1, 2))  # NCHW
    packed = np.packbits(planes.reshape(n, 22, area), axis=2)

    pol = np.zeros((n, 2, area + 1), np.int16)
    pol[:, 0] = np.round(policy_target * 30000).astype(np.int16)
    pol[:, 1] = np.round(next_policy_target * 30000).astype(np.int16)

    gt = np.zeros((n, GLOBAL_TARGET_CHANNELS), np.float32)
    if td_targets.ndim == 3:
        # [N, 5, 4] full groups: C0-3, C4-7, C8-11, C12-15, C16-19
        gt[:, 0:20] = td_targets.reshape(n, 20)
    else:
        gt[:, 0] = value_target[:, 0]
        gt[:, 1] = value_target[:, 1]
        gt[:, 2] = value_target[:, 2]
        gt[:, 3] = score_target
        for i in range(4):
            wl = td_targets[:, i]
            gt[:, 4 + 4 * i + 0] = 0.5 * (1.0 + wl)
            gt[:, 4 + 4 * i + 1] = 0.5 * (1.0 - wl)
            gt[:, 4 + 4 * i + 3] = score_target
    gt[:, 20] = score_target                # C20 final score
    gt[:, 21] = lead_target                 # C21 lead
    if variance_time is not None:
        gt[:, 22] = variance_time           # C22 WL-variance arrival time
    gt[:, 24] = 0.0                         # full weight on td targets
    gt[:, 25] = 1.0 if row_weight is None else row_weight  # C25 row weight
    gt[:, 26] = 1.0                         # C26 policy weight
    gt[:, 27] = 1.0                         # C27 ownership/scoredistr weight
    gt[:, 28] = (next_policy_target.sum(-1) > 0).astype(np.float32)
    gt[:, 29] = 1.0                         # C29 lead weight
    gt[:, 33] = 0.0 if futurepos is None else 1.0   # C33 futurepos weight
    gt[:, 34] = 0.0 if scoring is None else 1.0     # C34 scoring weight
    gt[:, 36:41] = 1.0                      # C36-40 history-usable flags
    if game_hash is not None:               # C41-46: 128-bit id in chunks
        h = game_hash.astype(np.uint64)
        for i, bits in enumerate((22, 22, 20)):
            gt[:, 41 + i] = (h & ((1 << bits) - 1)).astype(np.float32)
            h = h >> np.uint64(bits)
        # upper 64 bits unavailable from a uint64 id; reuse mixed low bits
        h2 = game_hash.astype(np.uint64) * np.uint64(0x9E3779B97F4A7C15)
        for i, bits in enumerate((22, 22, 20)):
            gt[:, 44 + i] = (h2 & ((1 << bits) - 1)).astype(np.float32)
            h2 = h2 >> np.uint64(bits)
    gt[:, 47] = self_komi                   # C47 komi (mover persp)
    gt[:, 48] = 1.0                         # C48 area-scoring-like phase
    gt[:, 51] = turn_idx                    # C51 turn index
    gt[:, 60] = visits                      # C60 search visits
    gt[:, 62] = 1.0                         # C62 game finished
    gt[:, 63] = 3.0                         # C63 data format version

    # score distribution: two-hot at the actual final score (+0.5 offsets)
    distr_len = 2 * area + 2 * EXTRA_SCORE_DISTR_RADIUS
    mid = distr_len // 2
    sd = np.zeros((n, distr_len), np.int8)
    idx_f = score_target + mid - 0.5
    lo = np.clip(np.floor(idx_f).astype(np.int64), 0, distr_len - 1)
    hi = np.clip(lo + 1, 0, distr_len - 1)
    frac = np.clip(idx_f - lo, 0.0, 1.0)
    rows = np.arange(n)
    sd[rows, lo] = np.round((1.0 - frac) * 100).astype(np.int8)
    sd[rows, hi] = np.clip(sd[rows, hi] + np.round(frac * 100), -128, 127).astype(np.int8)

    # C0 ownership is stored raw in [-1,1] (trainingwrite.h:286 — only C4
    # area/territory uses the [-120,120] scale)
    vt = np.zeros((n, 5, size, size), np.int8)
    vt[:, 0] = np.round(ownership_target.reshape(n, size, size)).astype(np.int8)
    if seki_diff is not None:
        vt[:, 1] = np.round(seki_diff.reshape(n, size, size)).astype(np.int8)
    if futurepos is not None:
        vt[:, 2] = np.round(futurepos[:, 0].reshape(n, size, size)
                            ).astype(np.int8)
        vt[:, 3] = np.round(futurepos[:, 1].reshape(n, size, size)
                            ).astype(np.int8)
    if scoring is not None:
        vt[:, 4] = np.clip(np.round(scoring.reshape(n, size, size) * 120.0),
                           -120, 120).astype(np.int8)

    qv = np.zeros((n, 3, area + 1), np.int16)
    if q_winloss is not None:
        qv[:, 0] = np.clip(np.round(q_winloss * 32000.0), -32000, 32000
                           ).astype(np.int16)
        qv[:, 1] = np.clip(np.round(q_score * 60.0), -32000, 32000
                           ).astype(np.int16)
        qv[:, 2] = np.clip(q_visits, 0, 32000).astype(np.int16)

    return {
        "binaryInputNCHWPacked": packed,
        "globalInputNC": global_in.astype(np.float32),
        "policyTargetsNCMove": pol,
        "globalTargetsNC": gt,
        "scoreDistrN": sd,
        "valueTargetsNCHW": vt,
        "qValueTargetsNCMove": qv,
    }


def write_npz(path: str, arrays: dict[str, np.ndarray]):
    np.savez_compressed(path, **arrays)


def decode_rows(arrays: dict[str, np.ndarray], size: int
                ) -> dict[str, np.ndarray]:
    """Schema arrays (as stored on disk) -> the learner's float batch dict:
    binary planes unpacked to float NCHW, everything else float-cast raw
    (matching data_processing_pytorch.py:28-299 — per-channel scaling like
    scoreDistrN/100 or valueTargets C4/120 happens inside the loss)."""
    from katago_torch.dataio import native
    area = size * size
    packed = arrays["binaryInputNCHWPacked"]
    n = packed.shape[0]
    binary = native.unpack_bits_nchw(packed, area).reshape(n, 22, size, size)
    return {
        "binaryInputNCHW": binary,
        "globalInputNC": arrays["globalInputNC"].astype(np.float32),
        "policyTargetsNCMove":
            arrays["policyTargetsNCMove"].astype(np.float32),
        "globalTargetsNC": arrays["globalTargetsNC"].astype(np.float32),
        "scoreDistrN": arrays["scoreDistrN"].astype(np.float32),
        "valueTargetsNCHW": arrays["valueTargetsNCHW"].astype(np.float32),
        "qValueTargetsNCMove":
            arrays["qValueTargetsNCMove"].astype(np.float32),
    }


def read_npz(path: str, size: int) -> dict[str, np.ndarray]:
    """Read a reference-schema npz into the learner's batch dict."""
    with np.load(path) as z:
        return decode_rows({k: z[k] for k in z.files if k != "metadataInputNC"
                            }, size)
