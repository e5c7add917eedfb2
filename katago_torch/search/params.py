"""Search parameters — port of katago_tpu/search/params.py (mirror of the
reference cpp/search/searchparams.h:11-177).

`SearchParams` is the same host-side dataclass; `to_arr(device)` turns it
into a `SearchParamsArr` of 0-dim tensors (float32 / bool / int64), so
the search's scalar arithmetic runs in float32 like the JAX package's.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class SearchParams:
    # utility
    win_loss_utility_factor: float = 1.0
    static_score_utility_factor: float = 0.3
    dynamic_score_utility_factor: float = 0.0
    dynamic_score_center_zero_weight: float = 0.0
    dynamic_score_center_scale: float = 1.0
    no_result_utility_for_white: float = 0.0
    draw_equivalent_wins_for_white: float = 0.5
    # puct
    cpuct_exploration: float = 1.0
    cpuct_exploration_log: float = 0.0
    cpuct_exploration_base: float = 500.0
    cpuct_utility_stdev_prior: float = 0.25
    cpuct_utility_stdev_prior_weight: float = 1.0
    cpuct_utility_stdev_scale: float = 0.0
    fpu_reduction_max: float = 0.2
    fpu_loss_prop: float = 0.0
    fpu_parent_weight: float = 0.0
    value_weight_exponent: float = 0.5
    # uncertainty weighting (searchparams.h:40-49)
    use_uncertainty: bool = False
    uncertainty_coeff: float = 0.2
    uncertainty_exponent: float = 1.0
    uncertainty_max_weight: float = 8.0
    # root
    root_noise_enabled: bool = False
    root_dirichlet_noise_total_concentration: float = 10.83
    root_dirichlet_noise_weight: float = 0.25
    root_policy_temperature: float = 1.0
    root_policy_temperature_early: float = 1.0
    root_fpu_reduction_max: float = 0.2
    root_fpu_loss_prop: float = 0.0
    # move selection
    chosen_move_temperature: float = 0.0
    chosen_move_temperature_early: float = 0.0
    chosen_move_temperature_halflife: float = 19.0
    chosen_move_subtract: float = 0.0
    chosen_move_prune: float = 1.0
    use_lcb_for_selection: bool = False
    lcb_stdevs: float = 4.0
    min_visit_prop_for_lcb: float = 0.05
    # graph search (MCGS transpositions, searchparams.h:52-55)
    use_graph_search: bool = True
    graph_search_rep_bound: int = 11   # searchparams.cpp:42
    # subtree value bias (searchparams.h:115-118; selfplay1.cfg:180)
    subtree_value_bias_factor: float = 0.0
    subtree_value_bias_weight_exponent: float = 0.5
    # misc
    nn_policy_temperature: float = 1.0
    # optimistic-policy blending (policyOptimism/rootPolicyOptimism,
    # searchparams.cpp:32,55; blend trtbackend.cpp:2082)
    policy_optimism: float = 0.0
    root_policy_optimism: float = 0.0
    # analysis root-widening (wideRootNoise, searchparams.cpp:71; the
    # policy-smoothing pow of searchexplorehelpers.cpp:90 — the per-visit
    # random utility bonus dissolves in the lockstep batch)
    wide_root_noise: float = 0.0
    # endgame shaping: discourage pointless territory fills / encourage
    # dame-filling (rootEndingBonusPoints, searchparams.cpp:66; standard
    # gtp/match presets use 0.5, searchparams.cpp:288)
    root_ending_bonus_points: float = 0.0
    # forbid root moves in either side's pass-alive area after the
    # opponent passed four times in a row (isAllowedRootMove,
    # searchhelpers.cpp:311-341)
    root_prune_useless_moves: bool = False
    # prune symmetry-duplicate root moves on symmetric positions
    # (rootSymmetryPruning, search.cpp:732 + markDuplicateMoveLocs,
    # nninputs.cpp:675-760)
    root_symmetry_pruning: bool = False
    # ---- host-side time-manager knobs (searchparams.h:139-156,
    # Search::recomputeSearchTimeLimit) — consumed between chunks by the
    # SearchDriver, never traced, so they are not in SearchParamsArr ----
    overallocate_time_factor: float = 1.0
    midgame_time_factor: float = 1.0
    midgame_turn_peak_time: float = 130.0
    endgame_turn_time_decay: float = 100.0
    obvious_moves_time_factor: float = 1.0
    obvious_moves_policy_entropy_tolerance: float = 0.30
    obvious_moves_policy_surprise_tolerance: float = 0.15
    futile_visits_threshold: float = 0.0
    lag_buffer: float = 1.0
    playout_doubling_advantage: float = 0.0
    conservative_pass: bool = False
    # per-eval random dihedral symmetry (nnRandomize, nneval.h:169-179)
    nn_random_symmetry: bool = False
    # symmetries averaged at the root eval (rootNumSymmetriesToSample,
    # searchparams.h:76); static in the compiled search
    root_num_symmetries: int = 1
    # avoid-repeated-shapes white-utility penalty
    # (avoidRepeatedPatternUtility, searchparams.h:119); host-side — the
    # table it parameterizes is built between searches (search/patternbonus)
    avoid_repeated_pattern_utility: float = 0.0

    @staticmethod
    def for_selfplay() -> "SearchParams":
        """Selfplay-flavored settings per cpp/configs/training/selfplay1.cfg."""
        return SearchParams(
            static_score_utility_factor=0.1,
            dynamic_score_utility_factor=0.3,
            dynamic_score_center_zero_weight=0.2,
            dynamic_score_center_scale=0.75,
            cpuct_exploration=1.0,
            cpuct_exploration_log=0.45,
            root_noise_enabled=True,
            root_policy_temperature=1.4,
            root_policy_temperature_early=1.8,
            root_fpu_reduction_max=0.1,
            subtree_value_bias_factor=0.30,
            chosen_move_temperature=0.1,
            chosen_move_temperature_early=0.75,
            chosen_move_temperature_halflife=19.0,
            use_uncertainty=True,
            value_weight_exponent=0.25,
            root_ending_bonus_points=0.5,
            root_prune_useless_moves=True,
        )

    def to_arr(self, device=None) -> "SearchParamsArr":
        from katago_torch.device import resolve_device
        dev = resolve_device(device)
        vals = {}
        for f in dataclasses.fields(SearchParamsArr):
            v = getattr(self, f.name)
            if isinstance(v, bool):
                vals[f.name] = torch.tensor(v, device=dev)
            elif isinstance(v, int) and f.name == "graph_search_rep_bound":
                vals[f.name] = torch.tensor(v, dtype=torch.int64, device=dev)
            else:
                vals[f.name] = torch.tensor(float(v), dtype=torch.float32,
                                            device=dev)
        return SearchParamsArr(**vals)


_ARR_FIELDS = (
    "win_loss_utility_factor", "static_score_utility_factor",
    "dynamic_score_utility_factor", "dynamic_score_center_zero_weight",
    "dynamic_score_center_scale", "no_result_utility_for_white",
    "draw_equivalent_wins_for_white", "cpuct_exploration",
    "cpuct_exploration_log", "cpuct_exploration_base",
    "cpuct_utility_stdev_prior", "cpuct_utility_stdev_prior_weight",
    "cpuct_utility_stdev_scale", "fpu_reduction_max", "fpu_loss_prop",
    "fpu_parent_weight", "value_weight_exponent", "use_uncertainty",
    "uncertainty_coeff", "uncertainty_exponent", "uncertainty_max_weight",
    "root_noise_enabled", "root_dirichlet_noise_total_concentration",
    "root_dirichlet_noise_weight", "root_policy_temperature",
    "root_policy_temperature_early", "root_fpu_reduction_max",
    "root_fpu_loss_prop", "chosen_move_temperature",
    "chosen_move_temperature_early", "chosen_move_temperature_halflife",
    "use_lcb_for_selection", "lcb_stdevs", "min_visit_prop_for_lcb",
    "use_graph_search", "graph_search_rep_bound",
    "subtree_value_bias_factor", "subtree_value_bias_weight_exponent",
    "nn_policy_temperature", "policy_optimism", "root_policy_optimism",
    "wide_root_noise", "root_ending_bonus_points",
    "root_prune_useless_moves", "root_symmetry_pruning",
    "playout_doubling_advantage", "conservative_pass", "nn_random_symmetry")

SearchParamsArr = dataclasses.make_dataclass(
    "SearchParamsArr", [(n, torch.Tensor) for n in _ARR_FIELDS])
SearchParamsArr.__doc__ = ("The device-side search parameters: one 0-dim "
                           "tensor per field.")
