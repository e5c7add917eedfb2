"""HumanSL SGF metadata conditioning — the port's own copy of
katago_tpu/models/sgfmetadata.py (pure numpy; the reference's
cpp/neuralnet/sgfmetadata).

Builds the 192-channel metadata input row for human-SL conditioned nets
(fillMetadataRow, sgfmetadata.cpp:135-220) and the named rank/pro profiles
("rank_5d", "preaz_9d", "proyear_1990", sgfmetadata.cpp:265-345).

The model side is MetadataEncoder (models/model.py; the metaencoder of
models/desc.py): a small MLP on the 192 floats whose output is added to
the trunk's global-input bias.
"""

from __future__ import annotations

import dataclasses
import datetime
import math

import numpy as np

METADATA_INPUT_NUM_CHANNELS = 192

SOURCE_OGS = 1
SOURCE_KGS = 2
SOURCE_FOX = 3
SOURCE_TYGEM = 4
SOURCE_GOGOD = 5
SOURCE_GO4GO = 6


@dataclasses.dataclass
class SGFMetadata:
    initialized: bool = False
    inverse_b_rank: int = 0    # KG=0, 9d=1, ..., 1d=9, 1k=10, 2k=11, ...
    inverse_w_rank: int = 0
    b_is_unranked: bool = False
    w_is_unranked: bool = False
    b_rank_is_unknown: bool = False
    w_rank_is_unknown: bool = False
    b_is_human: bool = False
    w_is_human: bool = False
    game_is_unrated: bool = False
    game_ratedness_is_unknown: bool = False
    tc_is_unknown: bool = False
    tc_is_none: bool = False
    tc_is_absolute: bool = False
    tc_is_simple: bool = False
    tc_is_byo_yomi: bool = False
    tc_is_canadian: bool = False
    tc_is_fischer: bool = False
    main_time_seconds: float = 0.0
    period_time_seconds: float = 0.0
    byo_yomi_periods: int = 0
    canadian_moves: int = 0
    game_date: datetime.date = datetime.date(1970, 1, 1)
    source: int = 0

    _WIRE_KEYS = {
        "inverseBRank": "inverse_b_rank", "inverseWRank": "inverse_w_rank",
        "bIsUnranked": "b_is_unranked", "wIsUnranked": "w_is_unranked",
        "bRankIsUnknown": "b_rank_is_unknown",
        "wRankIsUnknown": "w_rank_is_unknown",
        "bIsHuman": "b_is_human", "wIsHuman": "w_is_human",
        "gameIsUnrated": "game_is_unrated",
        "gameRatednessIsUnknown": "game_ratedness_is_unknown",
        "tcIsUnknown": "tc_is_unknown", "tcIsNone": "tc_is_none",
        "tcIsAbsolute": "tc_is_absolute", "tcIsSimple": "tc_is_simple",
        "tcIsByoYomi": "tc_is_byo_yomi", "tcIsCanadian": "tc_is_canadian",
        "tcIsFischer": "tc_is_fischer",
        "mainTimeSeconds": "main_time_seconds",
        "periodTimeSeconds": "period_time_seconds",
        "byoYomiPeriods": "byo_yomi_periods",
        "canadianMoves": "canadian_moves",
        "gameDate": "game_date", "source": "source",
    }

    @classmethod
    def of_dict(cls, data: dict) -> "SGFMetadata":
        """Build from the camelCase wire format of the reference's
        humanslnet protocol (python/katago/game/sgfmetadata.py:54)."""
        kw = {"initialized": True}
        for wire, field in cls._WIRE_KEYS.items():
            if wire in data:
                v = data[wire]
                if field == "game_date" and isinstance(v, str):
                    v = datetime.date.fromisoformat(v)
                kw[field] = v
        m = cls(**kw)
        if not any([m.tc_is_unknown, m.tc_is_none, m.tc_is_absolute,
                    m.tc_is_simple, m.tc_is_byo_yomi, m.tc_is_canadian,
                    m.tc_is_fischer]):
            m.tc_is_unknown = True
        return m

    def to_dict(self) -> dict:
        return {wire: (getattr(self, field).isoformat()
                       if field == "game_date" else getattr(self, field))
                for wire, field in self._WIRE_KEYS.items()}


def fill_metadata_row(meta: SGFMetadata, next_player_is_white: bool,
                      board_area: int) -> np.ndarray:
    """float32[192] — faithful port of fillMetadataRow."""
    if not meta.initialized:
        raise ValueError("uninitialized SGFMetadata")
    row = np.zeros(METADATA_INPUT_NUM_CHANNELS, np.float32)
    w = next_player_is_white
    row[0] = 1.0 if (meta.w_is_human if w else meta.b_is_human) else 0.0
    row[1] = 1.0 if (meta.b_is_human if w else meta.w_is_human) else 0.0
    pla_unranked = meta.w_is_unranked if w else meta.b_is_unranked
    opp_unranked = meta.b_is_unranked if w else meta.w_is_unranked
    row[2] = float(pla_unranked)
    row[3] = float(opp_unranked)
    row[4] = float(meta.w_rank_is_unknown if w else meta.b_rank_is_unknown)
    row[5] = float(meta.b_rank_is_unknown if w else meta.w_rank_is_unknown)

    rank_start, rank_len = 6, 34
    inv_pla = meta.inverse_w_rank if w else meta.inverse_b_rank
    inv_opp = meta.inverse_b_rank if w else meta.inverse_w_rank
    if not pla_unranked:
        row[rank_start:rank_start + min(inv_pla, rank_len)] = 1.0
    if not opp_unranked:
        row[rank_start + rank_len:
            rank_start + rank_len + min(inv_opp, rank_len)] = 1.0

    row[74] = 0.5 if meta.game_ratedness_is_unknown else \
        (1.0 if meta.game_is_unrated else 0.0)
    tcs = [meta.tc_is_unknown, meta.tc_is_none, meta.tc_is_absolute,
           meta.tc_is_simple, meta.tc_is_byo_yomi, meta.tc_is_canadian,
           meta.tc_is_fischer]
    if sum(tcs) != 1:
        raise ValueError("exactly one time-control flag must be set")
    row[75:82] = np.asarray(tcs, np.float32)

    mt = min(max(meta.main_time_seconds, 0.0), 3.0 * 86400)
    pt = min(max(meta.period_time_seconds, 0.0), 1.0 * 86400)
    row[82] = 0.4 * (math.log(mt + 60.0) - 6.5)
    row[83] = 0.3 * (math.log(pt + 1.0) - 3.0)
    byo = min(max(meta.byo_yomi_periods, 0), 50)
    can = min(max(meta.canadian_moves, 0), 50)
    row[84] = 0.5 * (math.log(byo + 2.0) - 1.5)
    row[85] = 0.25 * (math.log(can + 2.0) - 1.5)
    row[86] = 0.5 * math.log(board_area / 361.0)

    days = (meta.game_date - datetime.date(1970, 1, 1)).days
    date_start, date_len = 87, 32
    period = 7.0
    factor = 80000 ** (1.0 / (date_len - 1))
    for i in range(date_len):
        rev = days / period
        row[date_start + 2 * i] = math.cos(rev * 2.0 * math.pi)
        row[date_start + 2 * i + 1] = math.sin(rev * 2.0 * math.pi)
        period *= factor
    if not (0 <= meta.source < 16):
        raise ValueError(f"invalid source {meta.source}")
    row[151 + meta.source] = 1.0
    return row


_RANKS = {f"{9 - i}d": i + 1 for i in range(9)}
_RANKS.update({f"{i}k": 9 + i for i in range(1, 21)})


def _basic_rank_profile(inv_b: int, inv_w: int, pre_az: bool) -> SGFMetadata:
    return SGFMetadata(
        initialized=True, inverse_b_rank=inv_b, inverse_w_rank=inv_w,
        b_is_human=True, w_is_human=True, game_ratedness_is_unknown=True,
        tc_is_byo_yomi=True, main_time_seconds=1200,
        period_time_seconds=30, byo_yomi_periods=5,
        game_date=(datetime.date(2016, 9, 1) if pre_az
                   else datetime.date(2020, 3, 1)),
        source=SOURCE_KGS)


def _pro_profile(date: datetime.date, modern: bool) -> SGFMetadata:
    return SGFMetadata(
        initialized=True, inverse_b_rank=1, inverse_w_rank=1,
        b_is_human=True, w_is_human=True, tc_is_unknown=True,
        game_date=date, source=SOURCE_GO4GO if modern else SOURCE_GOGOD)


def get_profile(name: str) -> SGFMetadata:
    """sgfmetadata.cpp:265 getProfile: '', rank_5d, rank_3d_2k,
    preaz_9d, proyear_1990 etc."""
    if name in ("", "_", '""'):
        return SGFMetadata()
    if name.startswith("proyear_"):
        year = int(name[len("proyear_"):])
        if 1800 <= year <= 2020:
            return _pro_profile(datetime.date(year, 6, 1), modern=False)
        if 2021 <= year <= 2023:
            return _pro_profile(datetime.date(year, 6, 1), modern=True)
        raise ValueError(f"unknown humanSL profile {name!r}")
    for prefix, pre_az in (("rank_", False), ("preaz_", True)):
        if name.startswith(prefix):
            ranks = name[len(prefix):]
            if ranks in _RANKS:
                r = _RANKS[ranks]
                return _basic_rank_profile(r, r, pre_az)
            pieces = ranks.split("_")
            if len(pieces) == 2 and all(x in _RANKS for x in pieces):
                return _basic_rank_profile(_RANKS[pieces[0]],
                                           _RANKS[pieces[1]], pre_az)
    raise ValueError(f"unknown humanSL profile {name!r}")


def make_dummy_warmup_profile() -> SGFMetadata:
    return _pro_profile(datetime.date(2020, 1, 1), modern=True)
