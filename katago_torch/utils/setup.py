"""Setup: config file -> SearchParams — the port's own copy of
katago_tpu/utils/setup.py (the reference's cpp/program/setup.{cpp,h}
loadSingleParams), working on the port's SearchParams and ConfigParser.

Maps the reference's exact key=value config names onto our SearchParams
fields (searchparams.h:11-177 semantics), with typed range-checked
getters from utils.config_parser. Keys the batched engine has no
equivalent for (thread counts, GPU ids, NN buffer sizes) are accepted and
ignored with a note, so reference gtp/match/selfplay configs parse as-is.
"""

from __future__ import annotations

import dataclasses

from katago_torch.search.params import SearchParams
from katago_torch.utils.config_parser import ConfigParser

# reference config key -> SearchParams field (searchparams.h names)
_PARAM_KEYS = {
    "winLossUtilityFactor": "win_loss_utility_factor",
    "staticScoreUtilityFactor": "static_score_utility_factor",
    "dynamicScoreUtilityFactor": "dynamic_score_utility_factor",
    "dynamicScoreCenterZeroWeight": "dynamic_score_center_zero_weight",
    "dynamicScoreCenterScale": "dynamic_score_center_scale",
    "noResultUtilityForWhite": "no_result_utility_for_white",
    "drawEquivalentWinsForWhite": "draw_equivalent_wins_for_white",
    "cpuctExploration": "cpuct_exploration",
    "cpuctExplorationLog": "cpuct_exploration_log",
    "cpuctExplorationBase": "cpuct_exploration_base",
    "cpuctUtilityStdevPrior": "cpuct_utility_stdev_prior",
    "cpuctUtilityStdevPriorWeight": "cpuct_utility_stdev_prior_weight",
    "cpuctUtilityStdevScale": "cpuct_utility_stdev_scale",
    "fpuReductionMax": "fpu_reduction_max",
    "fpuLossProp": "fpu_loss_prop",
    "fpuParentWeight": "fpu_parent_weight",
    "valueWeightExponent": "value_weight_exponent",
    "useUncertainty": "use_uncertainty",
    "uncertaintyCoeff": "uncertainty_coeff",
    "uncertaintyExponent": "uncertainty_exponent",
    "uncertaintyMaxWeight": "uncertainty_max_weight",
    "rootNoiseEnabled": "root_noise_enabled",
    "rootDirichletNoiseTotalConcentration":
        "root_dirichlet_noise_total_concentration",
    "rootDirichletNoiseWeight": "root_dirichlet_noise_weight",
    "rootPolicyTemperature": "root_policy_temperature",
    "rootPolicyTemperatureEarly": "root_policy_temperature_early",
    "rootFpuReductionMax": "root_fpu_reduction_max",
    "rootFpuLossProp": "root_fpu_loss_prop",
    "chosenMoveTemperature": "chosen_move_temperature",
    "chosenMoveTemperatureEarly": "chosen_move_temperature_early",
    "chosenMoveTemperatureHalflife": "chosen_move_temperature_halflife",
    "chosenMoveSubtract": "chosen_move_subtract",
    "chosenMovePrune": "chosen_move_prune",
    "useLcbForSelection": "use_lcb_for_selection",
    "useGraphSearch": "use_graph_search",
    "graphSearchRepBound": "graph_search_rep_bound",
    "subtreeValueBiasFactor": "subtree_value_bias_factor",
    "subtreeValueBiasWeightExponent": "subtree_value_bias_weight_exponent",
    "lcbStdevs": "lcb_stdevs",
    "minVisitPropForLCB": "min_visit_prop_for_lcb",
    "nnPolicyTemperature": "nn_policy_temperature",
    "playoutDoublingAdvantage": "playout_doubling_advantage",
    "conservativePass": "conservative_pass",
    "nnRandomize": "nn_random_symmetry",
    "rootNumSymmetriesToSample": "root_num_symmetries",
    "avoidRepeatedPatternUtility": "avoid_repeated_pattern_utility",
    "policyOptimism": "policy_optimism",
    "rootPolicyOptimism": "root_policy_optimism",
    "wideRootNoise": "wide_root_noise",
    "rootEndingBonusPoints": "root_ending_bonus_points",
    "rootPruneUselessMoves": "root_prune_useless_moves",
    "rootSymmetryPruning": "root_symmetry_pruning",
    "overallocateTimeFactor": "overallocate_time_factor",
    "midgameTimeFactor": "midgame_time_factor",
    "midgameTurnPeakTime": "midgame_turn_peak_time",
    "endgameTurnTimeDecay": "endgame_turn_time_decay",
    "obviousMovesTimeFactor": "obvious_moves_time_factor",
    "obviousMovesPolicyEntropyTolerance":
        "obvious_moves_policy_entropy_tolerance",
    "obviousMovesPolicySurpriseTolerance":
        "obvious_moves_policy_surprise_tolerance",
    "futileVisitsThreshold": "futile_visits_threshold",
    "lagBuffer": "lag_buffer",
}

# accepted-but-inapplicable keys (thread/GPU machinery the batched
# engine replaces; see SURVEY.md section 2.11)
_IGNORED_PREFIXES = (
    "numSearchThreads", "numNNServerThreadsPerModel", "nnMaxBatchSize",
    "nnCacheSizePowerOfTwo", "nnMutexPoolSizePowerOfTwo",
    "nnRandSeed", "gpuToUse", "deviceToUse", "cudaUseFP16", "cudaUseNHWC",
    "trtUseFP16", "openclUseFP16", "numEvalThreads", "numAnalysisThreads",
    "searchRandSeed", "mutexPoolSize", "maxBoardSizeForNNBuffer",
    "maxBoardXSizeForNNBuffer", "maxBoardYSizeForNNBuffer",
    "inputsUseNHWC", "cudaDisableWarmup", "debugSkipNeuralNet",
    "numVirtualLossesPerThread",
)


def load_search_params(cfg: ConfigParser,
                       base: SearchParams | None = None) -> SearchParams:
    """Setup::loadSingleParams equivalent: overlay config keys on `base`."""
    params = base or SearchParams()
    updates = {}
    for key, field in _PARAM_KEYS.items():
        if not cfg.contains(key):
            continue
        current = getattr(params, field)
        if isinstance(current, bool):
            updates[field] = cfg.get_bool(key)
        elif isinstance(current, int) and not isinstance(current, bool):
            updates[field] = cfg.get_int(key)
        else:
            updates[field] = cfg.get_float(key)
    return dataclasses.replace(params, **updates)


def apply_overrides(params: SearchParams,
                    overrides: dict) -> tuple[SearchParams, list]:
    """Per-query `overrideSettings` -> SearchParams (the analysis
    engine's arbitrary-SearchParams override path, analysis.cpp /
    docs/Analysis_Engine.md `overrideSettings`). Accepts the same
    camelCase keys as config files (_PARAM_KEYS) plus the
    accepted-and-ignored machinery keys; returns (new_params,
    unknown_keys). Values may be JSON numbers/bools or strings."""
    updates = {}
    unknown = []
    for key, val in (overrides or {}).items():
        field = _PARAM_KEYS.get(key)
        if field is None:
            if not any(key.startswith(p) for p in _IGNORED_PREFIXES):
                unknown.append(key)
            continue
        current = getattr(params, field)
        if isinstance(current, bool):
            updates[field] = (val if isinstance(val, bool)
                              else str(val).lower() in ("true", "1"))
        elif isinstance(current, int):
            updates[field] = int(val)
        else:
            updates[field] = float(val)
    if updates:
        params = dataclasses.replace(params, **updates)
    return params, unknown


def search_limits(cfg: ConfigParser) -> dict:
    """maxVisits / maxPlayouts / maxTime limits (setup.cpp)."""
    out = {}
    if cfg.contains("maxVisits"):
        out["max_visits"] = cfg.get_int("maxVisits")
    if cfg.contains("maxPlayouts"):
        out["max_playouts"] = cfg.get_int("maxPlayouts")
    if cfg.contains("maxTime"):
        out["max_time"] = cfg.get_float("maxTime")
    if cfg.contains("lagBuffer"):
        out["lag_buffer"] = cfg.get_float("lagBuffer")
    return out


def warn_unused(cfg: ConfigParser, log=print) -> list[str]:
    """The reference's unused-key warnings (config_parser.h:20-69), minus
    keys we deliberately accept-and-ignore."""
    unused = []
    for key in cfg.unused_keys():
        if any(key.startswith(p) for p in _IGNORED_PREFIXES):
            continue
        unused.append(key)
        log(f"WARNING: unused config key {key}")
    return unused
