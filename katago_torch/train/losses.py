"""Training losses — term-for-term port of katago_tpu/train/losses.py (the
reference's Metrics, python/katago/train/metrics_pytorch.py:78-324, target
wiring metrics_pytorch.py:497-860), as functions on tensors.

Consumes reference-schema batches (the npz arrays of
dataio/trainingwrite.py, already unpacked to float), so the same loss
stack trains on data from either this framework's selfplay or the
reference's. All loss scales and target-channel indices match the
reference exactly.

As in the JAX package:
  * The seki loss's moving unowned-proportion EMA is state passed in and
    returned (seki_ema in, seki_ema out), updated only when is_training.
  * softplus_with_floor is the plain composite that autograd
    differentiates, not the reference's custom-backward
    SoftPlusWithGradientFloorFunction, so the gradients equal the JAX
    package's.
  * Every stop_gradient of the JAX code is a .detach() here.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F


class LossScales(NamedTuple):
    """Per-term multipliers the trainer may scale dynamically
    (value_loss_scale etc. in train.py); defaults match metrics_pytorch."""
    soft_policy_weight_scale: float = 8.0
    value_loss_scale: float = 1.0
    td_value_loss_scales: tuple = (0.6, 0.6, 0.6)
    seki_loss_scale: float = 1.0
    variance_time_loss_scale: float = 1.0
    main_loss_scale: float = 1.0
    intermediate_loss_scale: float = 1.0
    disable_optimistic_policy: bool = False
    predict_q_values: bool = True


class SekiEma(NamedTuple):
    """Moving unowned-proportion state (metrics_pytorch.py:210-222):
    float32 0-dim tensors."""
    sum: torch.Tensor
    weight: torch.Tensor

    @staticmethod
    def init(device=None) -> "SekiEma":
        return SekiEma(sum=torch.tensor(0.0, device=device),
                       weight=torch.tensor(0.001, device=device))


def huber(x, target, delta):
    d = x - target
    absd = torch.abs(d)
    return torch.where(absd < delta, 0.5 * d * d, delta * (absd - 0.5 * delta))


def _cross_entropy(pred_logits, target_probs, dim):
    return -torch.sum(target_probs * F.log_softmax(pred_logits, dim=dim),
                      dim=dim)


def softplus_with_floor(x, grad_floor=0.05, square=False):
    """SoftPlusWithGradientFloorFunction forward (model_pytorch.py:118-142)
    as the plain composite the JAX package differentiates.

    square: the v14+ variant — softplus(x/2)^2, used for the shortterm
    error heads (model_pytorch.py:4113-4114, nneval.cpp:1163-1168)."""
    if square:
        return torch.square((1.0 - grad_floor) * F.softplus(0.5 * x)
                            + grad_floor * 0.5 * x)
    return (1.0 - grad_floor) * F.softplus(x) + grad_floor * x


# Postprocess multipliers (model_pytorch.py Model.__init__)
SCOREMEAN_MULT = 20.0
SCORESTDEV_MULT = 20.0
LEAD_MULT = 20.0
VARIANCE_TIME_MULT = 40.0
SHORTTERM_VALUE_ERROR_MULT = 0.25
SHORTTERM_SCORE_ERROR_MULT = 30.0
TD_SCORE_MULT = 20.0


def postprocess(raw: dict) -> dict:
    """Raw head outputs -> the reference's postprocess_single_heads_output
    quantities (model_pytorch.py:4084-4135)."""
    misc = raw["miscvalue"]            # [B,10]
    more = raw["moremiscvalue"]        # [B,8]
    td_value_logits = torch.stack(
        [misc[:, 4:7], misc[:, 7:10], more[:, 2:5]], dim=1)  # [B,3,3]
    return {
        "policy_logits": raw["policy_logits"],              # [B,C,A]
        "value_logits": raw["value_logits"],                # [B,3]
        "td_value_logits": td_value_logits,
        "td_score": more[:, 5:8] * TD_SCORE_MULT,
        "ownership_pretanh": raw["ownership_pretanh"],      # [B,H,W]
        "scoring": raw["scoring_presoftmax"],               # [B,H,W]
        "futurepos_pretanh": raw["futurepos_pretanh"],      # [B,H,W,2]
        "seki_logits": raw["seki_logits"],                  # [B,H,W,4]
        "scoremean": misc[:, 0] * SCOREMEAN_MULT,
        "scorestdev": softplus_with_floor(misc[:, 1]) * SCORESTDEV_MULT,
        "lead": misc[:, 2] * LEAD_MULT,
        "variance_time": softplus_with_floor(misc[:, 3]) * VARIANCE_TIME_MULT,
        "shortterm_value_error":
            softplus_with_floor(more[:, 0], square=True)
            * SHORTTERM_VALUE_ERROR_MULT,
        "shortterm_score_error":
            softplus_with_floor(more[:, 1], square=True)
            * SHORTTERM_SCORE_ERROR_MULT,
        "scorebelief_logits": raw["scorebelief_logprobs"],  # [B,SB]
    }


def unowned_prop_rows(batch: dict) -> torch.Tensor:
    """Each row's ownership-weighted unowned proportion of its target
    (the seki loss's batch statistic, metrics_pytorch.py:210-216)."""
    mask = batch["binaryInputNCHW"][:, 0, :, :]
    target_ownership = batch["valueTargetsNCHW"][:, 0, :, :]
    unowned_t = 1.0 - torch.square(target_ownership)
    unowned_prop = torch.sum(unowned_t * mask, dim=(1, 2)) / \
        (1.0 + torch.sum(mask, dim=(1, 2)))
    return unowned_prop * batch["globalTargetsNC"][:, 27]


def compute_losses(raw: dict, batch: dict, *,
                   scales: LossScales = LossScales(),
                   seki_ema: SekiEma | None = None,
                   is_training: bool = True,
                   unowned_prop: torch.Tensor | None = None
                   ) -> tuple[torch.Tensor, dict, SekiEma]:
    """All reference loss terms for one batch.

    When `raw` carries intermediate-head outputs (intermediate_* keys,
    has_intermediate_head models) the same term set is computed on them
    (without the seki moving-average update, metrics_pytorch.py:461-484)
    and the total becomes scales.main_loss_scale * main +
    scales.intermediate_loss_scale * intermediate, as the JAX package
    computes it.

    batch keys (reference npz schema, float-decoded, float32 tensors):
      binaryInputNCHW  [B, 22, H, W]   (only channel 0, the mask, read)
      globalTargetsNC  [B, 80]         (trainingwrite.h:183-290)
      policyTargetsNCMove [B, 2, A]
      scoreDistrN      [B, SB]
      valueTargetsNCHW [B, 5, H, W]    (decoded: own/seki in [-1,1],
                                        futurepos, scoring raw int8)
      qValueTargetsNCMove [B, 3, A]    (raw int16 scale)

    unowned_prop: the seki statistic's batch mean when the batch is one
    rank's slice of a larger batch (the mean over the whole batch);
    default the mean of unowned_prop_rows(batch).

    Returns (total_loss_mean, metrics, new_seki_ema)."""
    pp = postprocess(raw)
    dev = pp["value_logits"].device
    if seki_ema is None:
        seki_ema = SekiEma.init(dev)

    mask = batch["binaryInputNCHW"][:, 0, :, :]               # [B,H,W]
    n, h, w_ = mask.shape
    mask_sum_hw = torch.sum(mask, dim=(1, 2))
    gt = batch["globalTargetsNC"]
    pol_t = batch["policyTargetsNCMove"]
    policymask = torch.cat(
        [mask.reshape(n, h * w_), torch.ones((n, 1), dtype=mask.dtype,
                                             device=dev)], dim=1)

    def norm_pol(t):
        return t / torch.clamp(torch.sum(t, dim=1, keepdim=True), min=1e-30)

    target_policy_player = norm_pol(pol_t[:, 0, :])
    target_policy_opponent = norm_pol(pol_t[:, 1, :])
    tpp_soft = torch.pow((target_policy_player + 1e-7) * policymask, 0.25)
    tpp_soft = norm_pol(tpp_soft)
    tpo_soft = torch.pow((target_policy_opponent + 1e-7) * policymask, 0.25)
    tpo_soft = norm_pol(tpo_soft)

    w_pol_player = gt[:, 26]
    w_pol_opp = gt[:, 28]
    target_value = gt[:, 0:3]
    target_scoremean = gt[:, 3]
    target_td_value = torch.stack([gt[:, 4:7], gt[:, 8:11], gt[:, 12:15]],
                                  dim=1)                       # [B,3,3]
    target_td_score = torch.cat(
        [gt[:, 7:8], gt[:, 11:12], gt[:, 15:16]], dim=1)       # [B,3]
    target_lead = gt[:, 21]
    target_variance_time = gt[:, 22]
    global_weight = gt[:, 25]
    w_ownership = gt[:, 27]
    w_lead = gt[:, 29]
    w_futurepos = gt[:, 33]
    w_scoring = gt[:, 34]
    w_value = 1.0 - gt[:, 35]
    w_td_value = 1.0 - gt[:, 24]

    target_score_distribution = batch["scoreDistrN"] / 100.0

    vt = batch["valueTargetsNCHW"]
    target_ownership = vt[:, 0, :, :]
    target_seki = vt[:, 1, :, :]
    target_futurepos = vt[:, 2:4, :, :]
    target_scoring = vt[:, 4, :, :] / 120.0

    pol = pp["policy_logits"]

    def policy_ce(logits, target, weight, scale=1.0):
        return scale * torch.sum(global_weight * weight *
                                 _cross_entropy(logits, target, dim=1))

    loss_policy_player = policy_ce(pol[:, 0, :], target_policy_player,
                                   w_pol_player)
    loss_policy_opponent = policy_ce(pol[:, 1, :], target_policy_opponent,
                                     w_pol_opp, 0.15)
    sps = scales.soft_policy_weight_scale
    loss_policy_player_soft = sps * policy_ce(
        pol[:, 2, :], tpp_soft, w_pol_player)
    loss_policy_opponent_soft = sps * policy_ce(
        pol[:, 3, :], tpo_soft, w_pol_opp, 0.15)

    # optimistic policies (metrics_pytorch.py:653-733)
    if scales.disable_optimistic_policy:
        w_longopt = w_pol_player * 0.5
        w_shortopt = w_pol_player * 0.5
    else:
        win_squared = torch.square(gt[:, 0] + 0.5 * gt[:, 2])
        lt_excess = (gt[:, 3] - pp["scoremean"].detach()) / \
            torch.sqrt(torch.square(pp["scorestdev"].detach()) + 0.25)
        w_longopt = torch.clamp(
            win_squared + torch.sigmoid((lt_excess - 1.5) * 3.0), 0.0, 1.0)
        w_longopt = w_longopt * w_pol_player * w_ownership

        st_val_actual = gt[:, 12] - gt[:, 13]
        st_val_pred = F.softmax(pp["td_value_logits"][:, 2, :].detach(),
                                dim=1)
        st_val_pred = st_val_pred[:, 0] - st_val_pred[:, 1]
        st_val_excess = (st_val_actual - st_val_pred) / torch.sqrt(
            pp["shortterm_value_error"].detach() + 1e-4)
        st_score_excess = (gt[:, 15] - pp["td_score"][:, 2].detach()) / \
            torch.sqrt(pp["shortterm_score_error"].detach() + 0.25)
        w_shortopt = torch.clamp(
            torch.sigmoid((st_val_excess - 1.5) * 3.0) +
            torch.sigmoid((st_score_excess - 1.5) * 3.0), 0.0, 1.0)
        w_shortopt = w_shortopt * w_pol_player * w_ownership

    loss_longopt = 0.100 * policy_ce(pol[:, 4, :], target_policy_player,
                                     w_longopt)
    loss_shortopt = 0.200 * policy_ce(pol[:, 5, :], target_policy_player,
                                      w_shortopt)
    # main policy optimism rescale (policy_opt_loss_scale = 0.930)
    loss_policy_player = loss_policy_player * 0.930

    loss_value = 1.20 * scales.value_loss_scale * torch.sum(
        global_weight * w_value *
        _cross_entropy(pp["value_logits"], target_value, dim=1))

    td_ce = _cross_entropy(pp["td_value_logits"], target_td_value, dim=2) \
        - (-torch.sum(target_td_value *
                      torch.log(target_td_value + 1e-30), dim=2))
    td_l = 1.20 * global_weight[:, None] * w_td_value[:, None] * td_ce
    tds = torch.tensor(scales.td_value_loss_scales, dtype=torch.float32,
                       device=dev)
    loss_td_value = torch.sum(td_l * tds[None, :])

    loss_td_score = 0.0004 * torch.sum(
        global_weight * w_ownership *
        torch.sum(huber(pp["td_score"], target_td_score, 12.0), dim=1))

    own_logits = pp["ownership_pretanh"].reshape(n, -1) * 2.0
    own_probs = (1.0 + target_ownership.reshape(n, -1)) / 2.0
    own_bce = own_probs * F.logsigmoid(own_logits) + \
        (1.0 - own_probs) * F.logsigmoid(-own_logits)
    loss_ownership = 1.5 * torch.sum(
        global_weight * w_ownership *
        torch.sum(-own_bce * mask.reshape(n, -1), dim=1) / mask_sum_hw)

    sc_l = torch.sum(torch.square(pp["scoring"] - target_scoring) * mask,
                     dim=(1, 2)) / mask_sum_hw
    sc_l = 4.0 * (torch.sqrt(sc_l * 0.5 + 1.0) - 1.0)
    # the 0.25 lives in the reference's loss_sum (metrics_pytorch.py:869)
    loss_scoring = 0.25 * torch.sum(global_weight * w_scoring * sc_l)

    fp = pp["futurepos_pretanh"]                                # [B,H,W,2]
    fp_l = torch.square(torch.tanh(fp)
                        - target_futurepos.permute(0, 2, 3, 1)) \
        * mask[..., None]
    fp_l = fp_l * torch.tensor([1.0, 0.25], device=dev)[None, None, None, :]
    fp_l = torch.sum(fp_l, dim=(1, 2, 3)) / torch.sqrt(mask_sum_hw)
    loss_futurepos = 0.25 * torch.sum(global_weight * w_futurepos * fp_l)

    # seki (metrics_pytorch.py:196-248)
    owned_t = torch.square(target_ownership)
    unowned_t = 1.0 - owned_t
    if unowned_prop is None:
        unowned_prop = torch.mean(unowned_prop_rows(batch))
    if is_training:
        ema = SekiEma(sum=seki_ema.sum * 0.998 + unowned_prop.detach(),
                      weight=seki_ema.weight * 0.998 + 1.0)
        moving_prop = ema.sum / ema.weight
        seki_weight_scale = 8.0 * 0.005 / (0.005 + moving_prop)
    else:
        ema = seki_ema
        seki_weight_scale = torch.tensor(7.0, device=dev)
    seki_logits = pp["seki_logits"].permute(0, 3, 1, 2)        # [B,4,H,W]
    sign_pred = seki_logits[:, 0:3, :, :]
    sign_target = torch.stack([
        1.0 - torch.square(target_seki),
        F.relu(target_seki),
        F.relu(-target_seki),
    ], dim=1)
    loss_sign = torch.sum(_cross_entropy(sign_pred, sign_target, dim=1)
                          * mask, dim=(1, 2))
    neutral_pred = torch.stack(
        [seki_logits[:, 3, :, :], torch.zeros_like(target_ownership)], dim=1)
    neutral_target = torch.stack([unowned_t, owned_t], dim=1)
    loss_neutral = torch.sum(
        _cross_entropy(neutral_pred, neutral_target, dim=1) * mask,
        dim=(1, 2))
    seki_l = (loss_sign + 0.5 * loss_neutral) / mask_sum_hw
    loss_seki = scales.seki_loss_scale * seki_weight_scale * torch.sum(
        global_weight * w_ownership * seki_l)

    loss_scoremean = 0.0015 * torch.sum(
        global_weight * w_ownership *
        huber(pp["scoremean"], target_scoremean, 12.0))

    sb_logits = pp["scorebelief_logits"]
    pred_cdf = torch.cumsum(F.softmax(sb_logits, dim=1), dim=1)
    target_cdf = torch.cumsum(target_score_distribution, dim=1)
    loss_sb_cdf = 0.020 * torch.sum(
        global_weight * w_ownership *
        torch.sum(torch.square(pred_cdf - target_cdf), dim=1))
    loss_sb_pdf = 0.020 * torch.sum(
        global_weight * w_ownership *
        _cross_entropy(sb_logits, target_score_distribution, dim=1))

    sb_len = sb_logits.shape[1]
    mid = sb_len // 2
    offsets = torch.arange(sb_len, dtype=torch.float32, device=dev) \
        - mid + 0.5
    sb_probs = F.softmax(sb_logits, dim=1)
    exp_score = torch.sum(sb_probs * offsets[None, :], dim=1, keepdim=True)
    stdev_belief = torch.sqrt(0.001 + torch.sum(
        sb_probs * torch.square(offsets[None, :] - exp_score), dim=1))
    loss_scorestdev = 0.001 * torch.sum(
        global_weight * huber(pp["scorestdev"], stdev_belief, 10.0))

    loss_lead = 0.0060 * torch.sum(
        global_weight * w_lead * huber(pp["lead"], target_lead, 8.0))
    loss_variance_time = 0.0003 * scales.variance_time_loss_scale * \
        torch.sum(global_weight * w_ownership *
                  huber(pp["variance_time"], target_variance_time + 1e-5,
                        50.0))

    # shortterm error heads (squared-softplus targets)
    td3_probs = F.softmax(pp["td_value_logits"][:, 2, :].detach(), dim=1)
    predvalue = td3_probs[:, 0] - td3_probs[:, 1]
    realvalue = target_td_value[:, 2, 0] - target_td_value[:, 2, 1]
    sqerr_v = torch.square(predvalue - realvalue) + 1e-8
    loss_st_value_err = 2.0 * torch.sum(
        global_weight * w_ownership *
        huber(pp["shortterm_value_error"], sqerr_v, 0.4))
    predscore = pp["td_score"][:, 2].detach()
    realscore = target_td_score[:, 2]
    sqerr_s = torch.square(predscore - realscore) + 1e-4
    loss_st_score_err = 0.00002 * torch.sum(
        global_weight * w_ownership *
        huber(pp["shortterm_score_error"], sqerr_s, 100.0))

    # q-value heads (policy channels 6,7; metrics_pytorch.py:90-118)
    if scales.predict_q_values and pol.shape[1] >= 8:
        qt = batch["qValueTargetsNCMove"]
        t_wl = qt[:, 0, :] / 32000.0
        t_sc = qt[:, 1, :] / 60.0
        t_vis = qt[:, 2, :]
        qmask = (t_vis != 0).float()
        sqrtv = torch.sqrt(torch.clamp(t_vis, min=0.0))
        sum_sqrtv = torch.sum(sqrtv, dim=1)
        wl_logits = pol[:, 6, :] * qmask * 2.0
        wl_probs = (1.0 + t_wl) / 2.0
        q_bce = -(wl_probs * F.logsigmoid(wl_logits) +
                  (1.0 - wl_probs) * F.logsigmoid(-wl_logits))
        l_q_wl = torch.sum(q_bce * sqrtv, dim=1) / (sum_sqrtv + 1.0)
        loss_q_winloss = 1.5 * torch.sum(global_weight * l_q_wl)
        q_score = pol[:, 7, :] * qmask * SCOREMEAN_MULT
        l_q_sc = torch.sum(huber(q_score, t_sc, 12.0) * sqrtv, dim=1) / \
            (sum_sqrtv + 1.0)
        loss_q_score = 0.0008 * torch.sum(global_weight * l_q_sc)
    else:
        loss_q_winloss = torch.tensor(0.0, device=dev)
        loss_q_score = torch.tensor(0.0, device=dev)

    nsum = torch.clamp(torch.sum(global_weight), min=1e-8)
    total = (loss_policy_player + loss_policy_opponent +
             loss_policy_player_soft + loss_policy_opponent_soft +
             loss_longopt + loss_shortopt +
             loss_value + loss_td_value + loss_td_score +
             loss_ownership + loss_scoring + loss_futurepos + loss_seki +
             loss_scoremean + loss_sb_cdf + loss_sb_pdf + loss_scorestdev +
             loss_lead + loss_variance_time +
             loss_st_value_err + loss_st_score_err +
             loss_q_winloss + loss_q_score) * scales.main_loss_scale

    metrics = {
        "loss": total / nsum,
        "policy_loss": loss_policy_player / nsum,
        "policy_opp_loss": loss_policy_opponent / nsum,
        "policy_soft_loss": loss_policy_player_soft / nsum,
        "optimistic_policy_loss": (loss_longopt + loss_shortopt) / nsum,
        "value_loss": loss_value / nsum,
        "td_value_loss": loss_td_value / nsum,
        "td_score_loss": loss_td_score / nsum,
        "ownership_loss": loss_ownership / nsum,
        "scoring_loss": loss_scoring / nsum,
        "futurepos_loss": loss_futurepos / nsum,
        "seki_loss": loss_seki / nsum,
        "seki_weight_scale": seki_weight_scale,
        "scoremean_loss": loss_scoremean / nsum,
        "scorebelief_loss": (loss_sb_cdf + loss_sb_pdf) / nsum,
        "scorestdev_loss": loss_scorestdev / nsum,
        "lead_loss": loss_lead / nsum,
        "variance_time_loss": loss_variance_time / nsum,
        "shortterm_error_loss": (loss_st_value_err + loss_st_score_err) / nsum,
        "qvalue_loss": (loss_q_winloss + loss_q_score) / nsum,
        "policy_acc1": torch.sum(
            global_weight * w_pol_player *
            (torch.argmax(pol[:, 0, :], -1) ==
             torch.argmax(target_policy_player, -1)).float()) / nsum,
    }
    total_mean = total / nsum
    if any(k.startswith("intermediate_") for k in raw):
        inter_raw = {k[len("intermediate_"):]: v for k, v in raw.items()
                     if k.startswith("intermediate_")}
        itotal, imetrics, _ = compute_losses(
            inter_raw, batch, scales=scales, seki_ema=seki_ema,
            is_training=False)
        metrics["intermediate_loss"] = itotal
        metrics["intermediate_policy_loss"] = imetrics["policy_loss"]
        metrics["intermediate_value_loss"] = imetrics["value_loss"]
        total_mean = (scales.main_loss_scale * total_mean
                      + scales.intermediate_loss_scale * itotal)
        metrics["loss"] = total_mean
    return total_mean, metrics, ema
