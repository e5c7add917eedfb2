"""Time controls — the port's own copy of katago_tpu/search/timecontrols.py
(cpp/search/timecontrols.{h,cpp}); katago_torch imports nothing of the
JAX package, not even its modules that do not import JAX.

Host-side logic (time management never touches the device): Fischer /
absolute / byo-yomi-Canadian clocks, and the getTime() policy that turns a
clock state into (min, recommended, max) seconds for the next search
(timecontrols.cpp:184-380, constants preserved). The chunked
SearchDriver stops between chunks on the recommendation;
`visits_for_time_budget` turns a budget into a visit count on a coarse
geometric grid.
"""

from __future__ import annotations

import dataclasses
import math

UNLIMITED_TIME_THRESHOLD = 1e20
MAX_USER_INPUT_TIME = 1e25
UNLIMITED_TIME_DEFAULT = 1e30
UNLIMITED_TIME_DEFAULT_LARGE = 1e40


def _apply_lag_buffer(time: float, lag_buffer: float) -> float:
    """applyLagBuffer (timecontrols.cpp:175-182)."""
    if time < 0:
        return time
    if time < 2.0 * lag_buffer:
        return time * 0.5
    return time - lag_buffer


@dataclasses.dataclass
class TimeControls:
    original_main_time: float = UNLIMITED_TIME_DEFAULT
    increment: float = 0.0
    main_time_limit: float = UNLIMITED_TIME_DEFAULT_LARGE
    max_time_per_move: float = UNLIMITED_TIME_DEFAULT
    original_num_periods: int = 0
    num_stones_per_period: int = 0
    per_period_time: float = 0.0

    main_time_left: float = UNLIMITED_TIME_DEFAULT
    in_overtime: bool = False
    num_periods_left_including_current: int = 0
    num_stones_left_in_period: int = 0
    time_left_in_period: float = 0.0

    # ---- constructors (timecontrols.cpp:22-96) ----
    @staticmethod
    def absolute_time(main_time: float) -> "TimeControls":
        return TimeControls(
            original_main_time=main_time, increment=0.0,
            main_time_limit=max(main_time, UNLIMITED_TIME_DEFAULT_LARGE),
            max_time_per_move=UNLIMITED_TIME_DEFAULT,
            main_time_left=main_time)

    @staticmethod
    def fischer_time(main_time: float, increment: float) -> "TimeControls":
        return TimeControls(
            original_main_time=main_time, increment=increment,
            main_time_limit=UNLIMITED_TIME_DEFAULT_LARGE,
            max_time_per_move=UNLIMITED_TIME_DEFAULT,
            main_time_left=main_time)

    @staticmethod
    def fischer_capped_time(main_time: float, increment: float,
                            main_time_limit: float,
                            max_time_per_move: float) -> "TimeControls":
        """fischerCappedTime (timecontrols.cpp:65): fischer with a cap on
        accumulated main time and on any single move's time; negative
        caps mean unlimited (gtp.cpp:2936-2939)."""
        if main_time_limit < 0:
            main_time_limit = UNLIMITED_TIME_DEFAULT_LARGE
        if max_time_per_move < 0:
            max_time_per_move = UNLIMITED_TIME_DEFAULT
        if main_time_limit < main_time:
            raise ValueError(
                "TimeControls: mainTimeLimit is smaller than mainTime")
        return TimeControls(
            original_main_time=main_time, increment=increment,
            main_time_limit=main_time_limit,
            max_time_per_move=max_time_per_move,
            main_time_left=main_time)

    @staticmethod
    def canadian_or_byo_yomi_time(main_time: float, per_period_time: float,
                                  num_periods: int,
                                  num_stones_per_period: int
                                  ) -> "TimeControls":
        return TimeControls(
            original_main_time=main_time, increment=0.0,
            main_time_limit=UNLIMITED_TIME_DEFAULT_LARGE,
            max_time_per_move=UNLIMITED_TIME_DEFAULT,
            original_num_periods=num_periods,
            num_stones_per_period=num_stones_per_period,
            per_period_time=per_period_time,
            main_time_left=main_time,
            num_periods_left_including_current=num_periods,
            num_stones_left_in_period=num_stones_per_period,
            time_left_in_period=per_period_time)

    def is_effectively_unlimited(self) -> bool:
        return (self.main_time_left >= UNLIMITED_TIME_THRESHOLD and
                self.num_periods_left_including_current <= 0)

    # ---- GTP clock updates ----
    def update_from_gtp_time_left(self, time_left: float,
                                  stones_left: int) -> None:
        """GTP time_left semantics (gtp.cpp:2991-3014): stones == 0 ->
        main time; stones > 0 -> overtime. For KGS Japanese byo-yomi
        (multiple 1-stone periods) the stones field counts PERIODS left;
        otherwise it is the Canadian stones-left-in-period count."""
        if stones_left <= 0:
            self.main_time_left = time_left
            self.in_overtime = False
            self.num_periods_left_including_current = \
                self.original_num_periods
            self.num_stones_left_in_period = 0
            self.time_left_in_period = 0.0
        elif self.original_num_periods > 1 and \
                self.num_stones_per_period == 1:
            # KGS byo-yomi hack: stones = periods left
            self.main_time_left = 0.0
            self.in_overtime = True
            self.num_periods_left_including_current = min(
                stones_left, self.original_num_periods)
            self.num_stones_left_in_period = 1
            self.time_left_in_period = time_left
        else:
            self.main_time_left = 0.0
            self.in_overtime = True
            self.num_periods_left_including_current = 1
            self.num_stones_left_in_period = min(
                stones_left, self.num_stones_per_period)
            self.time_left_in_period = time_left

    # ---- the policy (timecontrols.cpp:184-380) ----
    def get_time(self, board_area: int, num_stones_on_board: int,
                 lag_buffer: float) -> tuple[float, float, float]:
        """Returns (min_time, recommended_time, max_time) seconds."""
        typical_abs = 0.95 * board_area + 20.0
        typical_inc = 0.75 * board_area + 15.0
        typical_byo = 0.50 * board_area + 10.0
        min_abs = 0.15 * board_area + 30.0
        min_inc = 0.10 * board_area + 20.0
        min_byo = 0.02 * board_area + 4.0
        turns_abs = max(typical_abs - num_stones_on_board, min_abs) * 0.5
        turns_inc = max(typical_inc - num_stones_on_board, min_inc) * 0.5
        turns_byo = max(typical_byo - num_stones_on_board, min_byo) * 0.5

        def divide_evenly(time, is_increment_or_abs, is_byo_yomi):
            if_absolute = time / turns_abs
            if is_increment_or_abs:
                if time <= 0:
                    return time
                return min(time / turns_inc,
                           if_absolute + 2.0 * self.increment)
            if is_byo_yomi:
                if self.per_period_time <= 0 or \
                        self.num_stones_per_period <= 0:
                    return if_absolute
                byo_per_move = self.per_period_time / \
                    self.num_stones_per_period
                optimal_turns = (time / byo_per_move) * math.exp(-1.0)
                turns_to_use = optimal_turns
                if turns_byo > optimal_turns:
                    turns_to_use = min(turns_byo, optimal_turns * 1.75)
                turns_to_use = min(turns_to_use, turns_abs)
                turns_to_use = max(turns_to_use, 1.0)
                t = time / turns_to_use
                t = min(t, if_absolute + 3.0 * byo_per_move)
                t = max(t, byo_per_move)
                if t < byo_per_move * 1.5 and time < byo_per_move * 1.5:
                    t = time + byo_per_move
                return t
            return if_absolute

        lag = lag_buffer
        if self.increment > 0 or self.num_periods_left_including_current <= 0:
            # Fischer / absolute
            if self.main_time_left <= self.increment:
                min_t = min(max(0.0, self.main_time_left * 0.5),
                            max(0.0, self.main_time_left + self.increment -
                                self.main_time_limit))
                rec = _apply_lag_buffer(self.main_time_left, lag)
                max_t = self.main_time_left
            else:
                excess = _apply_lag_buffer(
                    self.main_time_left - self.increment, lag)
                min_t = min(max(0.0, self.main_time_left * 0.5),
                            max(0.0, self.main_time_left + self.increment -
                                self.main_time_limit))
                rec = self.increment + divide_evenly(excess, True, False)
                max_t = min(self.main_time_left,
                            self.increment + excess / 5.0)
        else:
            # byo-yomi / Canadian
            eff_main = self.main_time_left
            eff_ot = self.in_overtime
            eff_periods = self.num_periods_left_including_current
            eff_t_period = self.time_left_in_period
            eff_stones = self.num_stones_left_in_period
            if eff_main < 0 and not eff_ot:
                eff_ot = True
                eff_t_period = eff_main + self.per_period_time
                eff_stones = self.num_stones_per_period
            if eff_ot:
                while eff_t_period < 0 and eff_periods > 1:
                    eff_periods -= 1
                    eff_t_period += self.per_period_time
            reserved = 5
            if eff_periods > reserved:
                if not self.in_overtime:
                    eff_main += self.per_period_time * (eff_periods - reserved)
                else:
                    eff_main += eff_t_period + self.per_period_time * \
                        (eff_periods - reserved - 1)
                eff_ot = False
            if not eff_ot:
                large_byo = self.per_period_time / \
                    (0.75 * max(self.num_stones_per_period, 1) + 0.25)
                min_t = 0.0
                rec = divide_evenly(eff_main, False, True)
                max_t = large_byo + max(min(large_byo * 1.75, eff_main),
                                        eff_main / 5.0)
                if max_t > eff_main and max_t < eff_main + large_byo:
                    max_t = eff_main + large_byo
                if max_t > eff_main and eff_periods <= 1 and \
                        self.num_stones_per_period <= 1:
                    lag *= 2.0
            else:
                eff_stones = max(eff_stones, 1)
                if eff_periods > 1 and \
                        _apply_lag_buffer(eff_t_period, lag) < \
                        _apply_lag_buffer(0.5 * self.per_period_time, lag) * \
                        (eff_periods - 1) / (reserved - 1):
                    eff_periods -= 1
                    eff_t_period += self.per_period_time
                min_t = eff_t_period if eff_stones <= 1 else 0.0
                rec = eff_t_period / eff_stones
                max_t = eff_t_period / (0.75 * eff_stones + 0.25)
                if eff_periods <= 1 and eff_stones <= 1:
                    lag *= 2.0

        # tail (timecontrols.cpp:386-400)
        max_t = min(max_t, self.max_time_per_move)
        min_t = max(0.0, _apply_lag_buffer(min_t, lag))
        rec = max(0.0, _apply_lag_buffer(rec, lag))
        max_t = max(0.0, _apply_lag_buffer(max_t, lag))
        return min_t, rec, max_t


def visits_for_time_budget(recommended_s: float, playouts_per_s: float,
                           min_visits: int = 8,
                           max_visits: int = 8192) -> int:
    """Convert a time recommendation into a visit budget on a geometric
    grid (so few distinct budgets occur)."""
    if recommended_s >= UNLIMITED_TIME_THRESHOLD:
        return max_visits
    target = max(min_visits, recommended_s * max(playouts_per_s, 1.0))
    budget = min_visits
    while budget * 2 <= min(target, max_visits):
        budget *= 2
    return int(budget)


def recompute_search_time_limit(sp, tc_rec: float, tc_max: float, *,
                                turn_number: int, board_area: int,
                                policy_entropy: float | None = None,
                                policy_surprise: float | None = None
                                ) -> float:
    """Search::recomputeSearchTimeLimit (searchtimehelpers.cpp:37-97):
    scale the clock's recommended time by overallocation, a midgame
    weighting (think longest mid-game, tapering into the endgame), and
    an obvious-move discount when the policy was confident and the
    search agrees. sp: SearchParams (host fields)."""
    import math
    rec = tc_rec * sp.overallocate_time_factor
    if sp.midgame_time_factor != 1.0:
        scale = board_area / 361.0
        t = max(float(turn_number), 0.0)
        peak = sp.midgame_turn_peak_time * scale
        if t < peak:
            w = t / max(peak, 1e-9)
        else:
            w = math.exp(-(t - peak) /
                         max(sp.endgame_turn_time_decay * scale, 1e-9))
        w = min(max(w, 0.0), 1.0)
        rec *= 1.0 + w * (sp.midgame_time_factor - 1.0)
    if sp.obvious_moves_time_factor < 1.0 and policy_entropy is not None:
        obv_e = math.exp(-policy_entropy /
                         max(sp.obvious_moves_policy_entropy_tolerance,
                             1e-9))
        obv_s = math.exp(-(policy_surprise or 0.0) /
                         max(sp.obvious_moves_policy_surprise_tolerance,
                             1e-9))
        obv = min(obv_e, obv_s)
        rec *= 1.0 + obv * (sp.obvious_moves_time_factor - 1.0)
    if tc_max and tc_max > 0:
        rec = min(rec, tc_max)
    return rec


def num_visits_needed_to_be_non_futile(sp, max_visits_move_visits: float,
                                       turn_number: int,
                                       board_area: int) -> float:
    """Search::numVisitsNeededToBeNonFutile (searchtimehelpers.cpp:10-20)."""
    required = sp.futile_visits_threshold * max_visits_move_visits
    halflife = sp.chosen_move_temperature_halflife * board_area / 361.0
    import math
    frac = 0.5 ** (turn_number / max(halflife, 1e-9))
    temp = (sp.chosen_move_temperature
            + (sp.chosen_move_temperature_early
               - sp.chosen_move_temperature) * frac)
    if temp < 1e-3:
        return required
    return min(required, max_visits_move_visits * (0.01 ** temp))
