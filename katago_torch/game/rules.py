"""Go rules variants, mirroring the reference's rules surface.

A plain-Python copy of katago_tpu/game/rules.py (the port imports nothing
from the JAX package). Reference: KataGo cpp/game/rules.h:9-42 — ko rule
{SIMPLE, POSITIONAL, SITUATIONAL, SPIGHT}, scoring {AREA, TERRITORY}, tax
{NONE, SEKI, ALL}, multi-stone suicide, button go, white handicap bonus,
friendly pass, komi in [-400, 400].

The rules live in two forms:
  * this host-side dataclass (parse/serialize, config), and
  * per-game tensors inside the batched GameState (history.RulesArr), so
    one batch can play games under mixed rules (the reference randomizes
    rules per selfplay game, play.h:76-135).
"""

from __future__ import annotations

import dataclasses
import json

KO_SIMPLE = 0
KO_POSITIONAL = 1
KO_SITUATIONAL = 2
KO_SPIGHT = 3

SCORING_AREA = 0
SCORING_TERRITORY = 1

TAX_NONE = 0
TAX_SEKI = 1
TAX_ALL = 2

WHB_ZERO = 0
WHB_N = 1
WHB_N_MINUS_ONE = 2

_KO_STRS = {"SIMPLE": KO_SIMPLE, "POSITIONAL": KO_POSITIONAL,
            "SITUATIONAL": KO_SITUATIONAL, "SPIGHT": KO_SPIGHT}
_SCORING_STRS = {"AREA": SCORING_AREA, "TERRITORY": SCORING_TERRITORY}
_TAX_STRS = {"NONE": TAX_NONE, "SEKI": TAX_SEKI, "ALL": TAX_ALL}
_WHB_STRS = {"0": WHB_ZERO, "N": WHB_N, "N-1": WHB_N_MINUS_ONE}

MIN_USER_KOMI = -400.0
MAX_USER_KOMI = 400.0


@dataclasses.dataclass(frozen=True)
class Rules:
    ko_rule: int = KO_POSITIONAL
    scoring_rule: int = SCORING_AREA
    tax_rule: int = TAX_NONE
    multi_stone_suicide_legal: bool = True
    has_button: bool = False
    white_handicap_bonus_rule: int = WHB_ZERO
    friendly_pass_ok: bool = False
    komi: float = 7.5

    @staticmethod
    def tromp_taylorish() -> "Rules":
        """Reference default: Rules::getTrompTaylorish (rules.cpp)."""
        return Rules(ko_rule=KO_POSITIONAL, scoring_rule=SCORING_AREA,
                     tax_rule=TAX_NONE, multi_stone_suicide_legal=True,
                     has_button=False, white_handicap_bonus_rule=WHB_ZERO,
                     friendly_pass_ok=False, komi=7.5)

    @staticmethod
    def simple_territory() -> "Rules":
        """Reference: Rules::getSimpleTerritory — Japanese-like."""
        return Rules(ko_rule=KO_SIMPLE, scoring_rule=SCORING_TERRITORY,
                     tax_rule=TAX_SEKI, multi_stone_suicide_legal=False,
                     has_button=False, white_handicap_bonus_rule=WHB_ZERO,
                     friendly_pass_ok=False, komi=6.5)

    def komi_is_int_or_half_int(self) -> bool:
        return float(2 * self.komi) == int(2 * self.komi)

    def game_result_will_be_integer(self) -> bool:
        komi_is_int = float(self.komi) == int(self.komi)
        return komi_is_int != self.has_button

    def equals_ignoring_komi(self, other: "Rules") -> bool:
        return dataclasses.replace(self, komi=0.0) == dataclasses.replace(other, komi=0.0)

    # -- string / json round trip (reference rules.cpp parse/write) --------

    def to_json(self) -> dict:
        ko = {v: k for k, v in _KO_STRS.items()}[self.ko_rule]
        sc = {v: k for k, v in _SCORING_STRS.items()}[self.scoring_rule]
        tx = {v: k for k, v in _TAX_STRS.items()}[self.tax_rule]
        whb = {v: k for k, v in _WHB_STRS.items()}[self.white_handicap_bonus_rule]
        return {
            "ko": ko, "scoring": sc, "tax": tx,
            "suicide": self.multi_stone_suicide_legal,
            "hasButton": self.has_button,
            "whiteHandicapBonus": whb,
            "friendlyPassOk": self.friendly_pass_ok,
            "komi": self.komi,
        }

    def to_json_string(self) -> str:
        return json.dumps(self.to_json())

    @staticmethod
    def from_json(d: dict, default: "Rules | None" = None) -> "Rules":
        base = default or Rules.tromp_taylorish()
        kw = {}
        if "ko" in d:
            kw["ko_rule"] = _KO_STRS[str(d["ko"]).upper()]
        if "scoring" in d:
            kw["scoring_rule"] = _SCORING_STRS[str(d["scoring"]).upper()]
        if "tax" in d:
            kw["tax_rule"] = _TAX_STRS[str(d["tax"]).upper()]
        if "suicide" in d:
            kw["multi_stone_suicide_legal"] = bool(d["suicide"])
        if "hasButton" in d:
            kw["has_button"] = bool(d["hasButton"])
        if "whiteHandicapBonus" in d:
            kw["white_handicap_bonus_rule"] = _WHB_STRS[str(d["whiteHandicapBonus"]).upper()]
        if "friendlyPassOk" in d:
            kw["friendly_pass_ok"] = bool(d["friendlyPassOk"])
        if "komi" in d:
            komi = float(d["komi"])
            if not (MIN_USER_KOMI <= komi <= MAX_USER_KOMI):
                raise ValueError(f"komi out of range: {komi}")
            kw["komi"] = komi
        return dataclasses.replace(base, **kw)

    @staticmethod
    def parse(s: str) -> "Rules":
        """Parse named rulesets and json, per reference Rules::parseRules."""
        low = s.strip().lower()
        # field order: ko, scoring, tax, suicide, button, whb, fpok, komi
        # (rules.cpp:280-381 named rulesets)
        named = {
            "tromp-taylor": Rules.tromp_taylorish(),
            "tromptaylor": Rules.tromp_taylorish(),
            "chinese": Rules(KO_SIMPLE, SCORING_AREA, TAX_NONE, False, False,
                             WHB_N, True, 7.5),
            "chinese-ogs": Rules(KO_POSITIONAL, SCORING_AREA, TAX_NONE,
                                 False, False, WHB_N, True, 7.5),
            "chinese-kgs": Rules(KO_POSITIONAL, SCORING_AREA, TAX_NONE,
                                 False, False, WHB_N, True, 7.5),
            "japanese": Rules(KO_SIMPLE, SCORING_TERRITORY, TAX_SEKI, False,
                              False, WHB_ZERO, False, 6.5),
            "korean": Rules(KO_SIMPLE, SCORING_TERRITORY, TAX_SEKI, False,
                            False, WHB_ZERO, False, 6.5),
            "aga": Rules(KO_SITUATIONAL, SCORING_AREA, TAX_NONE, False, False,
                         WHB_N_MINUS_ONE, True, 7.5),
            "bga": Rules(KO_SITUATIONAL, SCORING_AREA, TAX_NONE, False, False,
                         WHB_N_MINUS_ONE, True, 7.5),
            "french": Rules(KO_SITUATIONAL, SCORING_AREA, TAX_NONE, False,
                            False, WHB_N_MINUS_ONE, True, 7.5),
            "aga-button": Rules(KO_SITUATIONAL, SCORING_AREA, TAX_NONE,
                                False, True, WHB_N_MINUS_ONE, True, 7.0),
            "new-zealand": Rules(KO_SITUATIONAL, SCORING_AREA, TAX_NONE, True,
                                 False, WHB_ZERO, True, 7.0),
            "goe": Rules(KO_POSITIONAL, SCORING_AREA, TAX_NONE, True, False,
                         WHB_ZERO, True, 7.5),
            "ing": Rules(KO_POSITIONAL, SCORING_AREA, TAX_NONE, True, False,
                         WHB_ZERO, True, 7.5),
            "stone-scoring": Rules(KO_SIMPLE, SCORING_AREA, TAX_ALL, False,
                                   False, WHB_ZERO, True, 7.5),
            "ancient-area": Rules(KO_SIMPLE, SCORING_AREA, TAX_ALL, False,
                                  False, WHB_ZERO, True, 7.5),
            "ancient-territory": Rules(KO_SIMPLE, SCORING_TERRITORY, TAX_ALL,
                                       False, False, WHB_ZERO, False, 6.5),
        }
        if low in named:
            return named[low]
        if s.strip().startswith("{"):
            return Rules.from_json(json.loads(s))
        return Rules._parse_legacy(s)

    @staticmethod
    def _parse_legacy(s: str) -> "Rules":
        """The reference's concatenated-token format (rules.cpp:436-530):
        e.g. "koSPIGHTscoreTERRITORYtaxSEKIsui0button0komi6.5". Defaults
        to tromp-taylor; territory scoring defaults tax to SEKI when tax
        is unspecified (rules.cpp:540-543)."""
        r = Rules.tromp_taylorish()
        kw: dict = {}
        tax_specified = False
        rest = s.strip()
        if not rest:
            raise ValueError(f"could not parse rules: {s!r}")

        def strip_prefix(prefix: str) -> bool:
            nonlocal rest
            if rest.startswith(prefix):
                rest = rest[len(prefix):].lstrip()
                return True
            return False

        def take_enum(table: dict) -> int:
            nonlocal rest
            for name, val in table.items():
                if strip_prefix(name):
                    return val
            raise ValueError(f"could not parse rules: {s!r}")

        while rest:
            if strip_prefix("komi"):
                i = 0
                while i < len(rest) and not (rest[i].isalpha()
                                             or rest[i].isspace()):
                    i += 1
                kw["komi"] = float(rest[:i])
                rest = rest[i:].lstrip()
            elif strip_prefix("ko"):
                kw["ko_rule"] = take_enum(_KO_STRS)
            elif strip_prefix("scoring"):
                kw["scoring_rule"] = take_enum(_SCORING_STRS)
            elif strip_prefix("score"):
                kw["scoring_rule"] = take_enum(_SCORING_STRS)
            elif strip_prefix("tax"):
                kw["tax_rule"] = take_enum(_TAX_STRS)
                tax_specified = True
            elif strip_prefix("sui"):
                kw["multi_stone_suicide_legal"] = take_enum({"1": True,
                                                             "0": False})
            elif strip_prefix("button"):
                kw["has_button"] = take_enum({"1": True, "0": False})
            elif strip_prefix("whb"):
                kw["white_handicap_bonus_rule"] = take_enum(
                    {"N-1": WHB_N_MINUS_ONE, "N": WHB_N, "0": WHB_ZERO})
            elif strip_prefix("fpok"):
                kw["friendly_pass_ok"] = take_enum({"1": True, "0": False})
            else:
                raise ValueError(f"could not parse rules: {s!r}")
        if (not tax_specified
                and kw.get("scoring_rule") == SCORING_TERRITORY):
            kw["tax_rule"] = TAX_SEKI
        return dataclasses.replace(r, **kw)

    def __str__(self) -> str:
        return self.to_json_string()
