"""Plain KataGo training step: the loss of KataGo's
python/katago/train/metrics_pytorch.py (its default scales, version-15
heads with six policy channels) on the reference forward, and the SGD
step of the port's trainer configuration: clip by global norm, decoupled
weight decay added to the gradient, momentum, a constant learning rate;
then the exported weights' moving average (EMA).

A batch is the learner's float dict of the npz schema (binaryInputNCHW,
globalInputNC, policyTargetsNCMove, globalTargetsNC, scoreDistrN,
valueTargetsNCHW, qValueTargetsNCMove).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from portbench.reference import net as NET


def _ce(logits, target, dim):
    return -(target * F.log_softmax(logits, dim=dim)).sum(dim=dim)


def _huber(x, t, delta):
    d = (x - t).abs()
    return torch.where(d < delta, 0.5 * d * d, delta * (d - 0.5 * delta))


def _sp_floor(x, square=False):
    if square:
        return ((0.95 * F.softplus(0.5 * x)) + 0.05 * 0.5 * x) ** 2
    return 0.95 * F.softplus(x) + 0.05 * x


def unowned_prop(batch) -> torch.Tensor:
    mask = batch["binaryInputNCHW"][:, 0]
    own = batch["valueTargetsNCHW"][:, 0]
    p = ((1.0 - own * own) * mask).sum(dim=(1, 2)) / \
        (1.0 + mask.sum(dim=(1, 2)))
    return (p * batch["globalTargetsNC"][:, 27]).mean()


def loss(raw: dict, batch: dict, seki_ema: tuple) -> tuple:
    """(mean loss over the batch's weight, new seki EMA (sum, weight))."""
    mask = batch["binaryInputNCHW"][:, 0]
    n, h, w = mask.shape
    msum = mask.sum(dim=(1, 2))
    gt = batch["globalTargetsNC"]
    gw = gt[:, 25]
    misc, more = raw["miscvalue"], raw["moremiscvalue"]
    scoremean = misc[:, 0] * 20.0
    scorestdev = _sp_floor(misc[:, 1]) * 20.0
    lead = misc[:, 2] * 20.0
    vtime = _sp_floor(misc[:, 3]) * 40.0
    st_verr = _sp_floor(more[:, 0], square=True) * 0.25
    st_serr = _sp_floor(more[:, 1], square=True) * 30.0
    td_logits = torch.stack([misc[:, 4:7], misc[:, 7:10], more[:, 2:5]], 1)
    td_score = more[:, 5:8] * 20.0
    pol = raw["policy_logits"]

    pmask = torch.cat([mask.reshape(n, -1), torch.ones(n, 1,
                                                       device=mask.device)], 1)

    def norm(t):
        return t / t.sum(dim=1, keepdim=True).clamp(min=1e-30)

    pt = batch["policyTargetsNCMove"]
    t_pla, t_opp = norm(pt[:, 0]), norm(pt[:, 1])
    t_pla_soft = norm(((t_pla + 1e-7) * pmask) ** 0.25)
    t_opp_soft = norm(((t_opp + 1e-7) * pmask) ** 0.25)
    w_pla, w_opp, w_own = gt[:, 26], gt[:, 28], gt[:, 27]

    def pce(ch, target, weight):
        return (gw * weight * _ce(pol[:, ch], target, 1)).sum()

    terms = [0.930 * pce(0, t_pla, w_pla), 0.15 * pce(1, t_opp, w_opp),
             8.0 * pce(2, t_pla_soft, w_pla),
             8.0 * 0.15 * pce(3, t_opp_soft, w_opp)]
    # optimistic policy weights (metrics_pytorch.py:653-733)
    long_x = (gt[:, 3] - scoremean.detach()) / torch.sqrt(
        scorestdev.detach() ** 2 + 0.25)
    w_long = ((gt[:, 0] + 0.5 * gt[:, 2]) ** 2
              + torch.sigmoid((long_x - 1.5) * 3.0)).clamp(0.0, 1.0)
    st_p = F.softmax(td_logits[:, 2].detach(), dim=1)
    sv_x = (gt[:, 12] - gt[:, 13] - (st_p[:, 0] - st_p[:, 1])) / torch.sqrt(
        st_verr.detach() + 1e-4)
    ss_x = (gt[:, 15] - td_score[:, 2].detach()) / torch.sqrt(
        st_serr.detach() + 0.25)
    w_short = (torch.sigmoid((sv_x - 1.5) * 3.0)
               + torch.sigmoid((ss_x - 1.5) * 3.0)).clamp(0.0, 1.0)
    terms += [0.1 * pce(4, t_pla, w_long * w_pla * w_own),
              0.2 * pce(5, t_pla, w_short * w_pla * w_own)]

    terms.append(1.2 * (gw * (1.0 - gt[:, 35])
                        * _ce(raw["value_logits"], gt[:, 0:3], 1)).sum())
    t_td = torch.stack([gt[:, 4:7], gt[:, 8:11], gt[:, 12:15]], 1)
    td = _ce(td_logits, t_td, 2) + (t_td * torch.log(t_td + 1e-30)).sum(2)
    terms.append((1.2 * 0.6 * (gw * (1.0 - gt[:, 24]))[:, None] * td).sum())
    t_tds = torch.stack([gt[:, 7], gt[:, 11], gt[:, 15]], 1)
    terms.append(0.0004 * (gw * w_own
                           * _huber(td_score, t_tds, 12.0).sum(1)).sum())

    vt = batch["valueTargetsNCHW"]
    own_t = vt[:, 0]
    own_l = raw["ownership_pretanh"].reshape(n, -1) * 2.0
    own_p = (1.0 + own_t.reshape(n, -1)) / 2.0
    bce = own_p * F.logsigmoid(own_l) + (1 - own_p) * F.logsigmoid(-own_l)
    terms.append(1.5 * (gw * w_own * (-bce * mask.reshape(n, -1)).sum(1)
                        / msum).sum())
    sc = ((raw["scoring_presoftmax"] - vt[:, 4] / 120.0) ** 2
          * mask).sum(dim=(1, 2)) / msum
    terms.append(0.25 * (gw * gt[:, 34]
                         * 4.0 * (torch.sqrt(sc * 0.5 + 1.0) - 1.0)).sum())
    fp = (torch.tanh(raw["futurepos_pretanh"]) - vt[:, 2:4].permute(0, 2, 3, 1)
          ) ** 2 * mask[..., None]
    fp = (fp * torch.tensor([1.0, 0.25], device=fp.device)).sum(
        dim=(1, 2, 3)) / torch.sqrt(msum)
    terms.append(0.25 * (gw * gt[:, 33] * fp).sum())

    ema_sum = seki_ema[0] * 0.998 + unowned_prop(batch).detach()
    ema_w = seki_ema[1] * 0.998 + 1.0
    seki_scale = 8.0 * 0.005 / (0.005 + ema_sum / ema_w)
    seki = raw["seki_logits"].permute(0, 3, 1, 2)
    seki_t = vt[:, 1]
    sign_t = torch.stack([1.0 - seki_t ** 2, F.relu(seki_t),
                          F.relu(-seki_t)], 1)
    l_sign = (_ce(seki[:, 0:3], sign_t, 1) * mask).sum(dim=(1, 2))
    owned = own_t ** 2
    l_neut = (_ce(torch.stack([seki[:, 3], torch.zeros_like(owned)], 1),
                  torch.stack([1.0 - owned, owned], 1), 1)
              * mask).sum(dim=(1, 2))
    terms.append(seki_scale * (gw * w_own * (l_sign + 0.5 * l_neut)
                               / msum).sum())

    terms.append(0.0015 * (gw * w_own * _huber(scoremean, gt[:, 3],
                                               12.0)).sum())
    sb = raw["scorebelief_logprobs"]
    t_sb = batch["scoreDistrN"] / 100.0
    sb_p = F.softmax(sb, dim=1)
    terms.append(0.02 * (gw * w_own * ((sb_p.cumsum(1) - t_sb.cumsum(1)) ** 2
                                       ).sum(1)).sum())
    terms.append(0.02 * (gw * w_own * _ce(sb, t_sb, 1)).sum())
    mid = sb.shape[1] // 2
    off = torch.arange(sb.shape[1], device=sb.device) - mid + 0.5
    mean = (sb_p * off).sum(1, keepdim=True)
    stdev = torch.sqrt(0.001 + (sb_p * (off - mean) ** 2).sum(1))
    terms.append(0.001 * (gw * _huber(scorestdev, stdev, 10.0)).sum())
    terms.append(0.006 * (gw * gt[:, 29] * _huber(lead, gt[:, 21],
                                                  8.0)).sum())
    terms.append(0.0003 * (gw * w_own * _huber(vtime, gt[:, 22] + 1e-5,
                                               50.0)).sum())
    pv = st_p[:, 0] - st_p[:, 1]
    rv = t_td[:, 2, 0] - t_td[:, 2, 1]
    terms.append(2.0 * (gw * w_own * _huber(st_verr, (pv - rv) ** 2 + 1e-8,
                                            0.4)).sum())
    ps = td_score[:, 2].detach()
    terms.append(0.00002 * (gw * w_own * _huber(
        st_serr, (ps - t_tds[:, 2]) ** 2 + 1e-4, 100.0)).sum())
    # six policy channels: no q-value heads (they need eight)
    total = sum(terms)
    return total / gw.sum().clamp(min=1e-8), (ema_sum, ema_w)


def sgd_step(cfg: dict, params: dict, trace: dict, batch: dict, seki_ema,
             opt: dict, half_batch: bool = False):
    """One training step: (new params, new trace, loss, gradients,
    new seki EMA). opt: lr, momentum, weight_decay, grad_clip.
    half_batch: the step's fault (its first half of the rows only).
    The weights' EMA follows the new params: `ema_step`."""
    if half_batch:
        batch = {k: v[:v.shape[0] // 2] for k, v in batch.items()}
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    raw = NET.forward(cfg, leaves,
                      batch["binaryInputNCHW"].permute(0, 2, 3, 1),
                      batch["globalInputNC"])
    lval, ema = loss(raw, batch, seki_ema)
    grads = dict(zip(leaves, torch.autograd.grad(lval, list(leaves.values()))))
    with torch.no_grad():
        gnorm = torch.sqrt(sum((g * g).sum() for g in grads.values()))
        scale = torch.where(gnorm < opt["grad_clip"], 1.0,
                            opt["grad_clip"] / gnorm)
        new_trace, new_params = {}, {}
        for k, g in grads.items():
            g = g * scale + opt["weight_decay"] * params[k]
            new_trace[k] = g + opt["momentum"] * trace[k]
            new_params[k] = params[k] - opt["lr"] * new_trace[k]
    return new_params, new_trace, lval.detach(), grads, \
        (ema[0].detach(), ema[1].detach())


def ema_step(ema: dict, params: dict, decay: float) -> dict:
    """The exported weights' moving average after a step: decay * ema +
    (1 - decay) * the step's new params, leaf by leaf, in float32."""
    with torch.no_grad():
        return {k: decay * e + (1.0 - decay) * params[k]
                for k, e in ema.items()}
