"""GenBoard — position-generation net (python/genboard_common.py); port
of katago_tpu/models/genboard.py.

A small fixup resnet that, given a partially-known board, predicts the
content {empty, black, white} of one "inference point"; sampling points
one at a time completes plausible whole positions (genboard_run.py).
Used to fabricate diverse opening/midgame positions for selfplay
seeding.

Input channels (genboard_common.py:62-70), NHWC as in the JAX package:
  0 inference point   1 on-board   2 black   3 white   4 unknown
  5 turn/100   6 turn-noise-stdev/50   7 source

Heads (genboard_common.py:90-115): a 3-class point head (focus-masked
trunk sum concat global-mean, 2-layer MLP) and a 3-class per-point aux
conv head.

Module and parameter names are the Flax auto-names of the JAX module
(Conv_0, _ResBlock_0, _GPoolResBlock_0, ..., Dense_1), so a Flax
parameter tree carries over through models.weights.from_flax_params
(conv kernels HWIO -> OIHW, dense kernels [in, out] -> [out, in];
`matg` stays [in, out]). The fill (`sample_fill`) is a host loop over a
permutation of the points, each step one batched forward.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as Fn
from torch import nn

EMPTY_CH, BLACK_CH, WHITE_CH = 0, 1, 2  # output class order
NUM_INPUT_CHANNELS = 8
_TRUNC_CORRECTION = 0.87962566103423978


class Conv(nn.Module):
    """Flax nn.Conv with SAME padding: kernel [O, I, kh, kw]."""

    def __init__(self, cin: int, cout: int, k: int, bias: bool = False):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(cout, cin, k, k))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None

    def forward(self, x):   # NCHW
        return Fn.conv2d(x, self.kernel, self.bias,
                         padding=self.kernel.shape[-1] // 2)


class Dense(nn.Module):
    """Flax nn.Dense: kernel [out, in], bias [out]."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(cout, cin))
        self.bias = nn.Parameter(torch.zeros(cout))

    def forward(self, x):
        return Fn.linear(x, self.kernel, self.bias)


def _chan(v):
    return v[None, :, None, None]


class _ResBlock(nn.Module):
    gpool = False

    def __init__(self, ch: int, scale_init: float):
        super().__init__()
        self.scale_init = scale_init
        self.biasa = nn.Parameter(torch.zeros(ch))
        self.Conv_0 = Conv(ch, ch, 3)
        self.scalb = nn.Parameter(torch.ones(ch))
        self.biasb = nn.Parameter(torch.zeros(ch))
        self.Conv_1 = Conv(ch, ch, 3)

    def forward(self, x):
        h = torch.relu(x + _chan(self.biasa))
        h = self.Conv_0(h)
        h = torch.relu(h * _chan(self.scalb) + _chan(self.biasb))
        return x + self.Conv_1(h)


class _GPoolResBlock(nn.Module):
    gpool = True

    def __init__(self, ch: int, scale_init: float):
        super().__init__()
        self.scale_init = scale_init
        self.biasa = nn.Parameter(torch.zeros(ch))
        self.Conv_0 = Conv(ch, ch, 3)
        self.Conv_1 = Conv(ch, ch, 3)
        self.matg = nn.Parameter(torch.zeros(ch, ch))   # [in, out]
        self.scalb = nn.Parameter(torch.ones(ch))
        self.biasb = nn.Parameter(torch.zeros(ch))
        self.Conv_2 = Conv(ch, ch, 3)

    def forward(self, x):
        h = torch.relu(x + _chan(self.biasa))
        a = self.Conv_0(h)
        g = self.Conv_1(h).mean(dim=(2, 3))
        a = a + (g @ self.matg)[:, :, None, None]
        a = torch.relu(a * _chan(self.scalb) + _chan(self.biasb))
        return x + self.Conv_2(a)


def block_kinds(num_blocks: int) -> list:
    """Two plain residual blocks, then alternating global-pooling and
    plain ones (genboard_common.py)."""
    kinds = [_ResBlock, _ResBlock]
    gpool_next = True
    for _ in range(num_blocks - 2):
        kinds.append(_GPoolResBlock if gpool_next else _ResBlock)
        gpool_next = not gpool_next
    return kinds


class GenBoardModel(nn.Module):
    """inputs [B,H,W,8] -> (point_logits [B,3], aux_logits [B,H,W,3])."""

    def __init__(self, num_channels: int = 96, num_blocks: int = 8,
                 dtype=torch.float32):
        super().__init__()
        ch = num_channels
        self.num_channels, self.num_blocks, self.dtype = ch, num_blocks, dtype
        self.Conv_0 = Conv(NUM_INPUT_CHANNELS, ch, 3)
        scale = 1.0 / math.sqrt(num_blocks)
        counts: dict = {}
        self.block_names = []
        for kind in block_kinds(num_blocks):
            i = counts.get(kind.__name__, 0)
            counts[kind.__name__] = i + 1
            name = f"{kind.__name__}_{i}"
            setattr(self, name, kind(ch, scale))
            self.block_names.append(name)
        self.endtrunk_bias_focus = nn.Parameter(torch.zeros(ch))
        self.endtrunk_bias_g = nn.Parameter(torch.zeros(ch))
        self.Conv_1 = Conv(ch, 3, 1, bias=True)
        self.Dense_0 = Dense(2 * ch, ch)
        self.Dense_1 = Dense(ch, 3)
        self.to(dtype)

    def forward(self, inputs):
        x_in = inputs.to(self.dtype).permute(0, 3, 1, 2)
        x = self.Conv_0(x_in)
        for name in self.block_names:
            x = getattr(self, name)(x)
        head_focus = torch.relu(x + _chan(self.endtrunk_bias_focus))
        head_g = torch.relu(x + _chan(self.endtrunk_bias_g))
        aux = self.Conv_1(head_focus)
        focus = (head_focus * x_in[:, 0:1]).sum(dim=(2, 3))
        g = head_g.mean(dim=(2, 3))
        h = torch.relu(self.Dense_0(torch.cat([focus, g], dim=-1)))
        point = self.Dense_1(h)
        return point.float(), aux.permute(0, 2, 3, 1).float()


@torch.no_grad()
def init_weights(model: GenBoardModel, seed: int) -> GenBoardModel:
    """Seeded draws from the JAX module's initializers: normal kernels of
    std sqrt(2/8/9) (input conv), sqrt(2/ch/9) * scale (first residual
    conv), sqrt(1/ch/9) * scale and * sqrt(scale) (global-pooling convs),
    sqrt(1/ch) * sqrt(scale) (matg), zeros for every block's last conv,
    Flax's lecun_normal for the heads; biases zero, scales one. The draws
    come from a torch.Generator, so the numbers differ from JAX's."""
    gen = torch.Generator().manual_seed(seed)

    def normal(p, std):
        p.copy_(torch.randn(p.shape, generator=gen) * std)

    def lecun(p, fan_in):
        std = 1.0 / math.sqrt(fan_in) / _TRUNC_CORRECTION
        t = torch.empty(p.shape)
        torch.nn.init.trunc_normal_(t, 0.0, std, -2 * std, 2 * std,
                                    generator=gen)
        p.copy_(t)

    ch = model.num_channels
    normal(model.Conv_0.kernel, math.sqrt(2.0 / NUM_INPUT_CHANNELS / 9))
    for name in model.block_names:
        blk = getattr(model, name)
        s = blk.scale_init
        if blk.gpool:
            std = math.sqrt(1.0 / ch / 9)
            normal(blk.Conv_0.kernel, std * s)
            normal(blk.Conv_1.kernel, std * math.sqrt(s))
            normal(blk.matg, math.sqrt(1.0 / ch) * math.sqrt(s))
            blk.Conv_2.kernel.zero_()
        else:
            normal(blk.Conv_0.kernel, math.sqrt(2.0 / ch / 9) * s)
            blk.Conv_1.kernel.zero_()
    lecun(model.Conv_1.kernel, ch)
    lecun(model.Dense_0.kernel, 2 * ch)
    lecun(model.Dense_1.kernel, ch)
    return model


def build_inputs(stones, known, infer_point, turn, turn_stdev, source,
                 size: int):
    """Assemble the 8-channel input.

    stones: int[B,NN] 0/1/2; known: bool[B,NN] (False = unknown);
    infer_point: int[B] flat loc; turn/turn_stdev/source: f32[B]."""
    b = stones.shape[0]
    nn_ = size * size
    dev = stones.device
    ch = torch.zeros((b, nn_, NUM_INPUT_CHANNELS), dtype=torch.float32,
                     device=dev)
    ch[torch.arange(b, device=dev), infer_point.long(), 0] = 1.0
    ch[:, :, 1] = 1.0
    ch[:, :, 2] = (known & (stones == 1)).float()
    ch[:, :, 3] = (known & (stones == 2)).float()
    ch[:, :, 4] = (~known).float()
    ch[:, :, 5] = (turn.float() / 100.0)[:, None]
    ch[:, :, 6] = (turn_stdev.float() / 50.0)[:, None]
    ch[:, :, 7] = source.float()[:, None]
    return ch.reshape(b, size, size, NUM_INPUT_CHANNELS)


def genboard_loss(point_logits, aux_logits, point_label, aux_label,
                  inputs):
    """Reference loss (genboard_train.py:382-387): point CE + 0.3 * aux
    CE over unknown points normalized by on-board area. Returns (main,
    aux) batch means."""
    main = -(Fn.one_hot(point_label.long(), 3)
             * torch.log_softmax(point_logits, dim=-1)).sum(-1)
    b, h, w, _ = aux_logits.shape
    aux_label = aux_label.reshape(b, h, w).long()
    unknown = inputs[..., 4:5]
    onboard = inputs[..., 1:2].sum(dim=(1, 2), keepdim=True)
    aux = -(Fn.one_hot(aux_label, 3) * torch.log_softmax(aux_logits, -1)
            * unknown / torch.clamp(onboard, min=1.0)).sum(
                dim=(1, 2, 3)) * 0.3
    return main.mean(), aux.mean()


@torch.no_grad()
def sample_fill(model, stones, known, *, size: int, gen: torch.Generator,
                turn: float, turn_stdev: float, source: float,
                temperature: float = 1.0, order=None, gumbel=None):
    """Autoregressively fill every unknown point (genboard_run.py).

    stones int[B,NN], known bool[B,NN] on the model's device. Returns the
    completed int[B,NN]. The points are visited in a random permutation
    (from gen, or `order` when given); a known point is left as it is.
    Each unknown point takes the argmax of logits / temperature plus
    Gumbel noise (a categorical draw) from gen, or from gumbel
    (float32[NN, B, 3], one row per step) when given — the tests pass
    the JAX package's permutation and draws."""
    b, nn_ = stones.shape
    dev = stones.device
    if order is None:
        order = torch.randperm(nn_, generator=gen, device=dev)
    order = [int(p) for p in order]
    stones, known = stones.clone(), known.clone()
    turn_a = torch.full((b,), turn, dtype=torch.float32, device=dev)
    std_a = torch.full((b,), turn_stdev, dtype=torch.float32, device=dev)
    src_a = torch.full((b,), source, dtype=torch.float32, device=dev)
    for step, point in enumerate(order):
        if bool(known[:, point].all()):
            continue
        pts = torch.full((b,), point, dtype=torch.int64, device=dev)
        x = build_inputs(stones, known, pts, turn_a, std_a, src_a, size)
        logits, _ = model(x)
        if gumbel is not None:
            noise = gumbel[step].to(dev)
        else:
            u = torch.rand(logits.shape, generator=gen, device=dev)
            noise = -torch.log(-torch.log(torch.clamp(u, min=1e-20,
                                                      max=1.0 - 1e-7)))
        choice = torch.argmax(logits / temperature + noise, dim=-1)
        stones[:, point] = torch.where(~known[:, point],
                                       choice.to(stones.dtype),
                                       stones[:, point])
        known[:, point] = True
    return stones
