"""Muon optimizer family — port of katago_tpu/train/muon.py (the
reference's python/muon/muon.py: muon_update muon.py:138, NS5 muon.py:23,
Polar Express muon.py:71, NorMuon row normalization muon.py:170-180).

Matrix-shaped parameters (conv kernels and dense kernels whose matrix has
more than one row and column) get orthogonalized-momentum updates;
everything else (biases, norm scales, single-row or single-column
kernels) falls back to AdamW, matching the reference's muon/adam param
split.

Layout: the port stores conv kernels OIHW and dense kernels [out, in];
the JAX package stores them [kh, kw, cin, cout] and [in, out] and
flattens to [kh*kw*cin, cout] / [in, out]. The orthogonalization is
transpose-symmetric, but NorMuon's second moment is one value per row of
that matrix, so every weight is viewed in the JAX package's matrix order
(`as_matrix`) before it is orthogonalized and normalized, and its update
is laid back out with `from_matrix`.

Newton-Schulz runs its matmuls in NS_DTYPE (bfloat16), float32 in and
out, as in the JAX package. The tests set NS_DTYPE to float32 on both
sides to hold everything around the orthogonalization to float32
precision: bfloat16 rounding differs between XLA and PyTorch, and the
iteration amplifies it.
"""

from __future__ import annotations

import numpy as np
import torch

NS_DTYPE = torch.bfloat16
_NS5_COEFFS = (3.4445, -4.7750, 2.0315)

_POLAR_EXPRESS_COEFFS = [
    (8.28721201814563, -23.595886519098837, 17.300387312530933),
    (4.107059111542203, -2.9478499167379106, 0.5448431082926601),
    (3.9486908534822946, -2.908902115962949, 0.5518191394370137),
    (3.3184196573706015, -2.488488024314874, 0.51004894012372),
    (2.300652019954817, -1.6689039845747493, 0.4188073119525673),
    (1.891301407787398, -1.2679958271945868, 0.37680408948524835),
    (1.8750014808534479, -1.2500016453999487, 0.3750001645474248),
    (1.875, -1.25, 0.375),
]
_POLAR_EXPRESS_COEFFS = [
    (a / 1.01, b / 1.01 ** 3, c / 1.01 ** 5)
    for (a, b, c) in _POLAR_EXPRESS_COEFFS[:-1]
] + [_POLAR_EXPRESS_COEFFS[-1]]


def as_matrix(p: torch.Tensor) -> torch.Tensor:
    """A parameter in the port's layout as the JAX package's
    [fan_in, fan_out] matrix: OIHW conv -> [kh*kw*cin, cout], [out, in]
    dense -> [in, out], a vector -> [1, n]."""
    if p.dim() == 4:
        return p.permute(2, 3, 1, 0).reshape(-1, p.shape[0])
    if p.dim() == 2:
        return p.t()
    return p.reshape(1, -1)


def from_matrix(m: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """Inverse of as_matrix: m laid out like `like`."""
    if like.dim() == 4:
        cout, cin, kh, kw = like.shape
        return m.reshape(kh, kw, cin, cout).permute(3, 2, 0, 1).contiguous()
    if like.dim() == 2:
        return m.t().contiguous()
    return m.reshape(like.shape)


def is_muon_param(p: torch.Tensor) -> bool:
    """Matrix-like params take the Muon path (reference param split)."""
    if p.dim() < 2:
        return False
    m = as_matrix(p)
    return m.shape[0] > 1 and m.shape[1] > 1


def _orthogonalize(g: torch.Tensor, coeffs, norm_scale: float
                   ) -> torch.Tensor:
    transpose = g.shape[-2] > g.shape[-1]
    x = g.to(NS_DTYPE)
    if transpose:
        x = x.transpose(-1, -2)
    norm = torch.linalg.norm(x.float(), dim=(-2, -1), keepdim=True)
    norm = norm.to(NS_DTYPE)
    if norm_scale != 1.0:
        norm = norm * norm_scale
    x = x / (norm + 1e-7)
    for a, b, c in coeffs:
        xxt = x @ x.transpose(-1, -2)
        bmat = b * xxt + c * (xxt @ xxt)
        x = a * x + bmat @ x
    if transpose:
        x = x.transpose(-1, -2)
    return x.float()


def zeropower_newtonschulz5(g: torch.Tensor, steps: int = 5) -> torch.Tensor:
    """Quintic Newton-Schulz orthogonalization (muon.py:23-49): returns
    ~US'V^T with S' near identity. NS_DTYPE matmuls, f32 in/out."""
    return _orthogonalize(g, [_NS5_COEFFS] * steps, 1.0)


def zeropower_polar_express(g: torch.Tensor, steps: int = 5) -> torch.Tensor:
    """Polar Express orthogonalization (muon.py:71-97, arXiv:2505.16932)."""
    coeffs = list(_POLAR_EXPRESS_COEFFS[:steps])
    while len(coeffs) < steps:
        coeffs.append(_POLAR_EXPRESS_COEFFS[-1])
    return _orthogonalize(g, coeffs, 1.01)


class Muon:
    """Muon for matrix params, AdamW (eps 1e-10) for the rest — the JAX
    package's `muon()`: per matrix param, momentum (nesterov) ->
    orthogonalize -> RMS-match (or NorMuon rows) -> + weight_decay * p ->
    * -lr(count); per other param, optax.adamw with lr
    adam_lr_ratio * lr(count). State: {"count", "momentum", "normuon_v",
    "mu", "nu"}, dicts keyed like the params; the count is the number of
    updates so far (optax's per-chain counts, which move together)."""

    def __init__(self, learning_rate, *, beta: float = 0.95,
                 ns_steps: int = 5, nesterov: bool = True,
                 use_polar_express: bool = False, normuon: bool = False,
                 normuon_beta2: float = 0.95, normuon_eps: float = 1e-8,
                 weight_decay: float = 0.0, adam_lr_ratio: float = 1.0,
                 adam_b1: float = 0.9, adam_b2: float = 0.95,
                 adam_eps: float = 1e-10):
        self.lr = learning_rate
        self.beta, self.ns_steps, self.nesterov = beta, ns_steps, nesterov
        self.orth = zeropower_polar_express if use_polar_express \
            else zeropower_newtonschulz5
        self.rms_scale = 0.1825 if use_polar_express else 0.2
        self.normuon = normuon
        self.normuon_beta2, self.normuon_eps = normuon_beta2, normuon_eps
        self.weight_decay = weight_decay
        self.adam_lr_ratio = adam_lr_ratio
        self.adam_b1, self.adam_b2, self.adam_eps = adam_b1, adam_b2, adam_eps

    def init(self, params: dict) -> dict:
        muon = {k: p for k, p in params.items() if is_muon_param(p)}
        adam = {k: p for k, p in params.items() if not is_muon_param(p)}
        return {
            "count": 0,
            "momentum": {k: torch.zeros_like(p) for k, p in muon.items()},
            "normuon_v": {k: torch.zeros((as_matrix(p).shape[0],),
                                         dtype=torch.float32,
                                         device=p.device)
                          for k, p in muon.items()},
            "mu": {k: torch.zeros_like(p) for k, p in adam.items()},
            "nu": {k: torch.zeros_like(p) for k, p in adam.items()},
        }

    def _muon_one(self, g, m, v, p, neg_lr):
        beta = self.beta
        new_m = m * beta + g * (1.0 - beta)
        upd = g * (1.0 - beta) + new_m * beta if self.nesterov else new_m
        mat = as_matrix(upd)
        o = self.orth(mat, self.ns_steps)
        if self.normuon:
            b2 = self.normuon_beta2
            new_v = v * b2 + torch.mean(torch.square(o), dim=-1) * (1.0 - b2)
            o = o / (torch.sqrt(new_v)[:, None] + self.normuon_eps)
            mn = torch.tensor(float(o.shape[0] * o.shape[1]),
                              device=o.device)
            o = o * (0.1825 * torch.sqrt(mn) /
                     (torch.linalg.norm(o) + 1e-30))
        else:
            new_v = v
            o = o * (self.rms_scale * max(mat.shape[0], mat.shape[1]) ** 0.5)
        u = from_matrix(o, g)
        if self.weight_decay:
            u = u + self.weight_decay * p
        return neg_lr * u, new_m, new_v

    def _adam_one(self, g, mu, nu, p, count_inc, neg_lr):
        b1, b2 = self.adam_b1, self.adam_b2
        mu = (1 - b1) * g + b1 * mu
        nu = (1 - b2) * (g * g) + b2 * nu
        bc1 = float(np.float32(1) - np.float32(b1) ** np.float32(count_inc))
        bc2 = float(np.float32(1) - np.float32(b2) ** np.float32(count_inc))
        u = (mu / bc1) / (torch.sqrt(nu / bc2) + self.adam_eps)
        u = u + self.weight_decay * p
        return neg_lr * u, mu, nu

    @torch.no_grad()
    def update(self, grads: dict, state: dict, params: dict):
        count = state["count"]
        lr = self.lr(count) if callable(self.lr) else self.lr
        neg_lr = -float(np.float32(lr))
        neg_adam_lr = -float(np.float32(self.adam_lr_ratio * lr))
        updates, mom, nv, mu, nu = {}, {}, {}, {}, {}
        for k, g in grads.items():
            if k in state["momentum"]:
                updates[k], mom[k], nv[k] = self._muon_one(
                    g, state["momentum"][k], state["normuon_v"][k],
                    params[k], neg_lr)
            else:
                updates[k], mu[k], nu[k] = self._adam_one(
                    g, state["mu"][k], state["nu"][k], params[k], count + 1,
                    neg_adam_lr)
        return updates, {"count": count + 1, "momentum": mom,
                         "normuon_v": nv, "mu": mu, "nu": nu}


def muon(learning_rate, **kw) -> Muon:
    """Full optimizer: Muon for matrix params, AdamW for the rest."""
    return Muon(learning_rate, **kw)
