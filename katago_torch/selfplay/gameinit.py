"""Per-game initialization diversity — cpp/program/play.{h,cpp}

The port's own copy of katago_tpu/selfplay/gameinit.py; its rules
arrays are the port's RulesArr tensors on the caller's device.
GameInitializer.

The reference samples, per selfplay game: board size (allowedBSizes /
bSizeRelProbs), rules (allowedKoRules / allowedScoringRules /
allowedTaxRules / allowedSuicides / allowedButtons), komi jitter
(komiStdev + komiBigStdevProb/komiBigStdev), handicap stones
(handicapProb, placed by the net's policy, PlayUtils::playExtraBlack)
with optional komi compensation to an even game via the net's lead
estimate (handicapCompensateKomiProb, PlayUtils::adjustKomiToEven).

Batch shape: rules/komi/handicap are PER-GAME (RulesArr holds tensors,
so one lockstep batch plays mixed rules); board size is PER-BUCKET (a
batch's tensors share one board shape, so a selfplay round groups its
games by sampled size and runs one lockstep batch per size — the
analogue of the reference's per-game-thread sizes).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from katago_torch.game import rules as R


@dataclasses.dataclass
class GameInitParams:
    """Config mirror of GameInitializer's sampling knobs
    (play.cpp:104-206, config keys of selfplay1.cfg)."""
    allowed_sizes: tuple[int, ...] = (19,)
    size_rel_probs: tuple[float, ...] = (1.0,)
    allowed_ko_rules: tuple[int, ...] = (R.KO_SIMPLE, R.KO_POSITIONAL,
                                         R.KO_SITUATIONAL)
    allowed_scoring_rules: tuple[int, ...] = (R.SCORING_AREA,
                                              R.SCORING_TERRITORY)
    allowed_tax_rules: tuple[int, ...] = (R.TAX_NONE, R.TAX_SEKI, R.TAX_ALL)
    allowed_suicides: tuple[bool, ...] = (True, False)
    allowed_buttons: tuple[bool, ...] = (True, False)
    komi_mean: float = 7.0
    komi_stdev: float = 1.0
    komi_big_stdev_prob: float = 0.06
    komi_big_stdev: float = 12.0
    handicap_prob: float = 0.0
    handicap_compensate_komi_prob: float = 0.0
    fork_compensate_komi_prob: float = 0.0
    early_fork_game_prob: float = 0.0
    fork_game_prob: float = 0.0
    max_handicap: int = 0    # 0 -> size-scaled default (play.cpp)
    # start positions: with prob, a game begins from a weighted sample of
    # a poses file (startPosesProb/startPosesFiles, selfplay.cpp:182-207)
    start_poses_prob: float = 0.0
    start_poses_files: tuple = ()

    @staticmethod
    def from_config(cfg: dict) -> "GameInitParams":
        """Build from reference selfplay config keys (bSizes,
        bSizeRelProbs, koRules, scoringRules, taxRules, multiStoneSuicideLegals,
        hasButtons, komiMean/komiStdev/..., handicapProb...)."""
        def get_list(key, parse, default):
            if key not in cfg:
                return default
            v = cfg[key]
            items = v if isinstance(v, (list, tuple)) else str(v).split(",")
            return tuple(parse(str(x).strip()) for x in items)

        ko_map = {"SIMPLE": R.KO_SIMPLE, "POSITIONAL": R.KO_POSITIONAL,
                  "SITUATIONAL": R.KO_SITUATIONAL, "SPIGHT": R.KO_SPIGHT}
        sc_map = {"AREA": R.SCORING_AREA, "TERRITORY": R.SCORING_TERRITORY}
        tax_map = {"NONE": R.TAX_NONE, "SEKI": R.TAX_SEKI, "ALL": R.TAX_ALL}
        as_bool = lambda s: s.lower() == "true"
        return GameInitParams(
            allowed_sizes=get_list("bSizes", int, (19,)),
            size_rel_probs=get_list("bSizeRelProbs", float, None) or (1.0,),
            allowed_ko_rules=get_list("koRules", lambda s: ko_map[s],
                                      (R.KO_SIMPLE, R.KO_POSITIONAL,
                                       R.KO_SITUATIONAL)),
            allowed_scoring_rules=get_list("scoringRules",
                                           lambda s: sc_map[s],
                                           (R.SCORING_AREA,
                                            R.SCORING_TERRITORY)),
            allowed_tax_rules=get_list("taxRules", lambda s: tax_map[s],
                                       (R.TAX_NONE, R.TAX_SEKI, R.TAX_ALL)),
            allowed_suicides=get_list("multiStoneSuicideLegals", as_bool,
                                      (True, False)),
            allowed_buttons=get_list("hasButtons", as_bool, (True, False)),
            komi_mean=float(cfg.get("komiMean", 7.0)),
            komi_stdev=float(cfg.get("komiStdev", 1.0)),
            komi_big_stdev_prob=float(cfg.get("komiBigStdevProb", 0.06)),
            komi_big_stdev=float(cfg.get("komiBigStdev", 12.0)),
            handicap_prob=float(cfg.get("handicapProb", 0.0)),
            handicap_compensate_komi_prob=float(
                cfg.get("handicapCompensateKomiProb", 0.0)),
            fork_compensate_komi_prob=float(
                cfg.get("forkCompensateKomiProb",
                        cfg.get("handicapCompensateKomiProb", 0.0))),
            early_fork_game_prob=float(cfg.get("earlyForkGameProb", 0.0)),
            fork_game_prob=float(cfg.get("forkGameProb", 0.0)),
            start_poses_prob=float(cfg.get("startPosesProb", 0.0)),
            start_poses_files=get_list("startPosesFiles", str, ()),
        )


@dataclasses.dataclass
class GameSpec:
    """One sampled game: everything play_games needs except the net."""
    size: int
    ko_rule: int
    scoring_rule: int
    tax_rule: int
    suicide: bool
    button: bool
    komi: float
    num_handicap: int
    compensate_komi: bool
    early_fork: bool
    start_pos: object = None    # dataio.poses.PositionSample | None


def sample_game_specs(p: GameInitParams, num_games: int,
                      rng: np.random.Generator) -> list[GameSpec]:
    """Sample num_games independent specs (createGameSharedUnsynchronized,
    play.cpp:360-470)."""
    sizes = np.asarray(p.allowed_sizes)
    sprobs = np.asarray(p.size_rel_probs, np.float64)
    sprobs = sprobs / sprobs.sum()
    poses, pose_w = [], None
    if p.start_poses_prob > 0 and p.start_poses_files:
        from katago_torch.dataio.poses import load_poses
        poses = [ps for ps in load_poses(list(p.start_poses_files))
                 if ps.x_size == ps.y_size]
        if poses:
            pose_w = np.asarray([ps.weight for ps in poses], np.float64)
            pose_w = pose_w / pose_w.sum()
    out = []
    for _ in range(num_games):
        start = None
        if poses and rng.random() < p.start_poses_prob:
            start = poses[int(rng.choice(len(poses), p=pose_w))]
        size = start.x_size if start is not None \
            else int(rng.choice(sizes, p=sprobs))
        ko = int(rng.choice(p.allowed_ko_rules))
        sc = int(rng.choice(p.allowed_scoring_rules))
        # territory scoring requires a tax in {SEKI, ALL}? No — the
        # reference allows any tax; button requires area scoring
        tax = int(rng.choice(p.allowed_tax_rules))
        sui = bool(rng.choice(p.allowed_suicides))
        btn = bool(rng.choice(p.allowed_buttons)) and sc == R.SCORING_AREA
        komi = p.komi_mean
        if p.komi_stdev > 0:
            komi += rng.normal(0.0, p.komi_stdev)
        if rng.random() < p.komi_big_stdev_prob and p.komi_big_stdev > 0:
            komi += rng.normal(0.0, p.komi_big_stdev)
        komi = float(np.round(komi * 2.0) / 2.0)
        nh = 0
        # handicap placement needs star points: size >= 7 (the reference
        # scales handicap by board area and never offers it below that)
        if (size >= 7 and p.handicap_prob > 0
                and rng.random() < p.handicap_prob):
            max_h = p.max_handicap or max(2, min(9, size * size // 40))
            nh = int(rng.integers(2, max_h + 1)) if max_h >= 2 else 0
        comp = (rng.random() < p.handicap_compensate_komi_prob) if nh else \
               (rng.random() < p.fork_compensate_komi_prob)
        fork = (p.early_fork_game_prob > 0
                and rng.random() < p.early_fork_game_prob)
        if start is not None:
            nh = 0
            fork = False
        out.append(GameSpec(size=size, ko_rule=ko, scoring_rule=sc,
                            tax_rule=tax, suicide=sui, button=btn,
                            komi=komi, num_handicap=nh,
                            compensate_komi=comp, early_fork=fork,
                            start_pos=start))
    return out


def specs_to_rules_arrays(specs: list[GameSpec], device):
    """Stack one size-bucket's specs into a per-game RulesArr on device
    + host arrays for handicap/fork handling. All specs must share size."""
    import torch
    from katago_torch.game.history import RulesArr
    if len({s.size for s in specs}) != 1:
        raise ValueError("specs of one bucket must share a board size")

    def arr(vals, dt):
        return torch.tensor(vals, dtype=dt, device=device)

    rules = RulesArr(
        ko_rule=arr([s.ko_rule for s in specs], torch.int64),
        scoring_rule=arr([s.scoring_rule for s in specs], torch.int64),
        tax_rule=arr([s.tax_rule for s in specs], torch.int64),
        multi_suicide=arr([s.suicide for s in specs], torch.bool),
        has_button=arr([s.button for s in specs], torch.bool),
        friendly_pass_ok=arr([False] * len(specs), torch.bool),
        komi=arr([s.komi for s in specs], torch.float32),
    )
    nh = np.asarray([s.num_handicap for s in specs], np.int32)
    comp = np.asarray([s.compensate_komi for s in specs], bool)
    fork = np.asarray([s.early_fork for s in specs], bool)
    starts = [s.start_pos for s in specs]
    return rules, nh, comp, fork, starts


def fixed_handicap_locs(size: int, n: int) -> list[int]:
    """Standard star-point handicap placement, stone-for-stone the
    reference's pattern (PlayUtils::placeFixedHandicap,
    playutils.cpp:308-343): corners in the order (lo,hi), (hi,lo),
    (lo,lo), (hi,hi); then sides; 5 and 7 take the center."""
    if size < 7 or n < 2 or n > 9:
        raise ValueError(f"cannot place {n} handicap on size {size}")
    if size % 2 == 0 and n > 4:
        raise ValueError("fixed handicap > 4 needs odd board dimensions")
    if size <= 7 and n > 4:
        raise ValueError("fixed handicap > 4 not allowed on size 7")
    edge = 3 if size >= 13 else 2
    lo, hi, mid = edge, size - 1 - edge, size // 2
    pts = [(lo, hi), (hi, lo), (lo, lo), (hi, hi), (lo, mid), (hi, mid),
           (mid, lo), (mid, hi), (mid, mid)]
    chosen = pts[:n]
    if n in (5, 7):
        chosen = pts[:n - 1] + [pts[8]]
    return [y * size + x for x, y in chosen]


def group_specs_by_size(specs: list[GameSpec]) -> dict[int, list[GameSpec]]:
    buckets: dict[int, list[GameSpec]] = {}
    for s in specs:
        buckets.setdefault(s.size, []).append(s)
    return buckets
