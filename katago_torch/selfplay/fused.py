"""Fused actor-learner on one device or across ranks — port of
katago_tpu/selfplay/fused.py.

The reference splits selfplay and training into separate processes
coupled through npz files on disk. This path couples them through a
DEVICE-RESIDENT replay ring instead:

  * `actor_chunk` advances every game by `moves_per_chunk` moves —
    search (the batched MCTS with chase ladders), move selection, the
    pre-move V7 rows, mover-perspective targets, compacted ring writes,
    board stepping and the restart of finished games. The JAX package
    jits it into one device program; here it is a host loop over the
    port's run_search whose every tensor, the ring and its cursor
    included, stays on the device (no copy to the host per move).
  * `learner_step` samples a batch from the ring and applies one
    gradient step to the model the actor searches with.
  * `fused_step` runs both back to back.

Targets are the on-device ones the batched search computes:
visit-count policy distributions, the search root's value / score /
lead / score-stdev as TD(0)-style bootstraps, and the tree-averaged
root ownership. Loss forms and scales mirror the file-based trainer's
(value CE 1.20, ownership BCE 1.5, scoremean/lead/scorestdev hubers at
0.0015/0.0060/0.001). What this path trades away against
dataio/trainingwrite.py: final-outcome value mixing, the score-belief
histograms, seki/futurepos targets and multi-horizon TD values — the
file-based pipeline (selfplay/loop.py + train/) stays the
full-fidelity path.

Random draws come from a torch.Generator (search, move choice, the
learner's row indices, the komi jitter); `learner_step` and `new_games`
also take explicit draws, which the tests use to hold the port to the
JAX package's. A fused step splits its generator first, as the JAX step
splits its key: one generator for the actor's chunk, one for the
learner, each seeded from a draw of gen.

Across ranks (`mesh`, parallel/mesh.py over torch.distributed) the
result is the one-rank result, as the JAX step sharded over a device
mesh computes its unsharded result: each rank plays its slice of the
game axis, and the ring is replicated. Each move every rank gathers
all ranks' live masks and rows (one all-gather) and writes them with
the one global compaction from the one cursor, so `cursor`, `filled`
and every row are the same on every rank. The learner draws its global
row indices on rank 0 (broadcast), each rank takes its contiguous slice
of the batch and the mean loss over it, the gradients are summed with
one all-reduce and divided by the ranks, and every rank steps its own
optimizer, so the replicated parameters stay equal; the metrics are the
ranks' mean. The actor's draws follow play_games(mesh=...): rank 0 draws
from gen, every other rank from a generator seeded from gen's first draw
and its rank, so at temperature 0 with no root noise W ranks give the
one-rank games. A replicated ring costs every rank the whole ring (34.8
KB a row at 19x19) and one all-gather of the move's rows; it keeps the
writes and the learner's gather local and the compaction exact.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch
import torch.nn.functional as Fn

from katago_torch import _tensortree as T
from katago_torch.device import resolve_device
from katago_torch.game import history as H
from katago_torch.game import rules as R
from katago_torch.models import features as F
from katago_torch.parallel import mesh as PM
from katago_torch.search import mcts
from katago_torch.search.params import SearchParams

RING_FIELDS = ("spatial", "glob", "policy", "value", "score", "lead",
               "score_stdev", "ownership")


@dataclasses.dataclass
class ReplayRing:
    """Device-resident training-row ring buffer. Every store has one
    row more than the capacity: the last is a scratch row that the
    writes of finished games go to, so a write needs no host sync."""
    spatial: torch.Tensor       # f32[CAP+1, NN, C_SP]
    glob: torch.Tensor          # f32[CAP+1, C_GL]
    policy: torch.Tensor        # f32[CAP+1, A] visit-count distribution
    value: torch.Tensor         # f32[CAP+1, 3] win/loss/noresult (mover)
    score: torch.Tensor         # f32[CAP+1] mover-persp score-mean
    lead: torch.Tensor          # f32[CAP+1] mover-persp lead
    score_stdev: torch.Tensor   # f32[CAP+1] subtree score stdev
    ownership: torch.Tensor     # f32[CAP+1, NN] mover-persp tree-avg own
    cursor: torch.Tensor        # int64 0-dim: next write slot
    filled: torch.Tensor        # int64 0-dim: rows written (<= CAP)

    @property
    def capacity(self) -> int:
        return self.score.shape[0] - 1

    def rows(self, name: str) -> torch.Tensor:
        """A store without its scratch row: [CAP, ...]."""
        return getattr(self, name)[:-1]

    @staticmethod
    def create(capacity: int, size: int, device=None,
               mesh=None) -> "ReplayRing":
        """An empty ring; with a mesh, this rank's replica on its
        device."""
        dev = mesh.device if mesh is not None else resolve_device(device)
        nn = size * size
        c = capacity + 1

        def z(*shape):
            return torch.zeros(shape, dtype=torch.float32, device=dev)

        return ReplayRing(
            spatial=z(c, nn, F.NUM_SPATIAL_V7), glob=z(c, F.NUM_GLOBAL_V7),
            policy=z(c, nn + 1), value=z(c, 3), score=z(c), lead=z(c),
            score_stdev=z(c), ownership=z(c, nn),
            cursor=torch.zeros((), dtype=torch.int64, device=dev),
            filled=torch.zeros((), dtype=torch.int64, device=dev))

    def write(self, live: torch.Tensor, rows: dict) -> None:
        """Write rows[name][i] for each live game i onto consecutive slots
        from the cursor (compacted: finished games leave no gap), in
        place; dead games write the scratch row."""
        cap = self.capacity
        n_live = live.long().sum()
        off = torch.cumsum(live.long(), 0) - 1
        slots = torch.where(live, (self.cursor + off) % cap, cap)
        for name in RING_FIELDS:
            store = getattr(self, name)
            store.index_copy_(0, slots, rows[name].to(store.dtype))
        self.cursor = (self.cursor + n_live) % cap
        self.filled = torch.clamp(self.filled + n_live, max=cap)


def make_actor_chunk(model, *, size: int, visits: int,
                     max_nodes: int | None = None,
                     search_params: SearchParams | None = None,
                     moves_per_chunk: int = 8, mesh=None) -> Callable:
    """Build actor_chunk(games, replay, gen) -> games (the ring is
    written in place). model: the net the learner trains, on the
    games' device. mesh: games is this rank's slice of the game axis
    and replay its replica of the ring (module docstring).

    Finished games restart from the empty position with their own rules
    row (komi kept), so the actor runs forever without host
    intervention."""
    max_nodes = max_nodes or (2 * visits + 8)

    def one_move(games: H.GameState, replay: ReplayRing,
                 gen: torch.Generator) -> H.GameState:
        dev = games.hist_len.device
        sp = (search_params or SearchParams.for_selfplay()).to_arr(dev)
        g = games.hist_len.shape[0]
        res = mcts.run_search(
            model, games, sp, gen, size=size, num_sims=visits,
            max_nodes=max_nodes, with_ladders=True, ladder_mode="chase",
            max_visits=visits + 1, active_mask=~games.pos.game_over)
        moves = mcts.choose_moves(res, sp, games.pos.move_num, gen)

        # training row of the PRE-move position: visit-count policy and
        # the search root's value/score bootstraps
        legal = H.legal_moves(games, size)
        sp_feat, gl_feat = F.fill_features_v7(
            games, size, F.FeatureParams.default(dev), legal,
            with_ladders=True, ladder_mode="chase")
        cv = res.child_visits.float()                       # [G, A]
        pol_t = cv / torch.clamp(cv.sum(1, keepdim=True), min=1.0)
        flip = torch.where(games.pos.to_move == 2, 1.0, -1.0)
        p_win = torch.clamp(0.5 * (1.0 + flip * res.root_winloss.float()),
                            0.0, 1.0)
        val_t = torch.stack([p_win, 1.0 - p_win, torch.zeros_like(p_win)],
                            dim=1)
        # mover-perspective regression targets (the net's heads predict
        # from the mover's view; root_* results are white-persp)
        rows = {"spatial": sp_feat, "glob": gl_feat, "policy": pol_t,
                "value": val_t, "score": flip * res.root_score_mean.float(),
                "lead": flip * res.root_lead.float(),
                "score_stdev": res.root_score_stdev.float(),
                "ownership": flip[:, None] * res.root_ownership.float()}
        # every rank's live games and rows, in game order
        live, *vals = PM.all_gather(
            [~games.pos.game_over] + [rows[k] for k in RING_FIELDS], mesh)
        replay.write(live, dict(zip(RING_FIELDS, vals)))

        games, _ = H.step(games, moves, size)
        # restart finished games from the empty position, each with its
        # own rules row, so the actor stream never drains
        fresh = H.new_game(size, games.rules, games.ko_hash_hist.shape[1],
                           g=g)
        return T.where(games.pos.game_over, fresh, games)

    @torch.no_grad()
    def actor_chunk(games: H.GameState, replay: ReplayRing,
                    gen: torch.Generator) -> H.GameState:
        if mesh is not None and mesh.world_size > 1:
            # every rank draws the seed; each rank but 0 plays from its own
            seed = int(torch.randint(0, 2 ** 31 - 1, (), generator=gen,
                                     device=gen.device))
            gen = PM.rank_generator(gen, seed, mesh)
        for _ in range(moves_per_chunk):
            games = one_move(games, replay, gen)
        return games

    return actor_chunk


def _huber(x, t, d):
    e = x - t
    a = e.abs()
    return torch.where(a <= d, 0.5 * e * e, d * (a - 0.5 * d))


def learner_loss(model, batch: dict, size: int) -> dict:
    """The fused loss terms of one batch (loss forms and scales of
    train/losses.py, metrics_pytorch): a dict of 0-dim tensors, "loss"
    their sum."""
    nn = size * size
    out = model(batch["spatial"].reshape(-1, size, size,
                                         batch["spatial"].shape[-1]),
                batch["glob"])
    logp = torch.log_softmax(out["policy_logits"][:, 0, :].float(), -1)
    pol_loss = -(batch["policy"] * logp).sum(-1).mean()
    logv = torch.log_softmax(out["value_logits"].float(), -1)
    val_loss = -(batch["value"] * logv).sum(-1).mean() * 1.20
    mv = out["miscvalue"].float()
    sc_loss = 0.0015 * _huber(mv[:, 0] * 20.0, batch["score"], 12.0).mean()
    lead_loss = 0.0060 * _huber(mv[:, 2] * 20.0, batch["lead"], 8.0).mean()
    stdev_loss = 0.001 * _huber(Fn.softplus(mv[:, 1]) * 20.0,
                                batch["score_stdev"], 10.0).mean()
    own_logits = out["ownership_pretanh"].float().reshape(-1, nn) * 2.0
    own_probs = (1.0 + batch["ownership"]) * 0.5
    own_bce = own_probs * Fn.logsigmoid(own_logits) + \
        (1.0 - own_probs) * Fn.logsigmoid(-own_logits)
    own_loss = 1.5 * ((-own_bce).sum(1) / nn).mean()
    loss = pol_loss + val_loss + sc_loss + lead_loss + stdev_loss + own_loss
    return {"loss": loss, "policy_loss": pol_loss, "value_loss": val_loss,
            "score_loss": sc_loss, "lead_loss": lead_loss,
            "scorestdev_loss": stdev_loss, "ownership_loss": own_loss}


def make_learner_step(model, optimizer, batch_size: int,
                      size: int, mesh=None) -> Callable:
    """learner_step(replay, gen, idx=None) -> metrics: one optimizer
    step (a torch.optim optimizer over model's parameters) on a batch
    drawn uniformly from the filled part of the ring — or on the rows
    idx (int64[batch_size]) when given. Metrics are 0-dim tensors on the
    device, taken before the update.

    mesh: idx is global (drawn on rank 0 and broadcast when not given),
    each rank computes the loss of its contiguous batch_size / ranks
    rows, and the gradients and metrics are the ranks' mean (module
    docstring); batch_size must divide by the ranks."""
    PM.check_divisible(batch_size, mesh, "learner batch")
    row0, rows = PM.process_batch_slice(batch_size, mesh)
    ranks = 1 if mesh is None else mesh.world_size

    def learner_step(replay: ReplayRing, gen: torch.Generator | None,
                     idx: torch.Tensor | None = None) -> dict:
        if idx is None:
            hi = torch.clamp(replay.filled, min=1)
            if mesh is None or mesh.rank == 0:
                u = torch.rand((batch_size,), generator=gen,
                               device=replay.filled.device)
                idx = torch.minimum((u * hi).long(), hi - 1)
            else:
                idx = torch.zeros((batch_size,), dtype=torch.int64,
                                  device=replay.filled.device)
            idx = PM.broadcast(idx, mesh)
        idx = idx[row0:row0 + rows]
        batch = {k: getattr(replay, k)[idx] for k in RING_FIELDS}
        metrics = learner_loss(model, batch, size)
        optimizer.zero_grad(set_to_none=True)
        metrics["loss"].backward()
        names = list(metrics)
        stacked = torch.stack([metrics[k].detach() for k in names])
        if mesh is not None:
            params = [p for p in model.parameters() if p.grad is not None]
            *grads, stacked = PM.all_reduce_sum(
                [p.grad for p in params] + [stacked], mesh)
            for p, g in zip(params, grads):
                p.grad.copy_(g / ranks)
            stacked = stacked / ranks
        optimizer.step()
        return dict(zip(names, stacked))

    return learner_step


def split_generator(gen: torch.Generator, n: int = 2) -> list:
    """n new generators on gen's device, each seeded from one draw of
    gen (one host sync): the torch counterpart of jax.random.split."""
    seeds = torch.randint(0, 2 ** 62, (n,), generator=gen,
                          device=gen.device).tolist()
    return [torch.Generator(device=gen.device).manual_seed(s)
            for s in seeds]


def make_fused_step(model, optimizer, *, size: int, visits: int,
                    batch_size: int, moves_per_chunk: int = 4,
                    search_params: SearchParams | None = None,
                    mesh=None) -> Callable:
    """fused_step(games, replay, gen) -> (games, metrics): an actor
    chunk, then one learner update from the ring, on generators split
    from gen (so gen advances by the same draws on every rank and at
    every world size). mesh: games is this rank's slice and replay its
    replica (module docstring)."""
    actor = make_actor_chunk(model, size=size, visits=visits,
                             search_params=search_params,
                             moves_per_chunk=moves_per_chunk, mesh=mesh)
    learner = make_learner_step(model, optimizer, batch_size, size, mesh)

    def fused_step(games, replay, gen):
        g_actor, g_learn = split_generator(gen)
        games = actor(games, replay, g_actor)
        return games, learner(replay, g_learn)

    return fused_step


def new_games(size: int, num_games: int, rules: R.Rules | None = None,
              max_moves: int | None = None, komi_stdev: float = 0.0,
              gen: torch.Generator | None = None, device=None,
              normals: torch.Tensor | None = None,
              mesh=None) -> H.GameState:
    """[G]-batch of fresh games for the actor stream.

    komi_stdev > 0 draws each game's komi from a rounded normal around
    the base komi — the fused-path slice of gameinit's komi
    randomization (komiStdev, play.cpp); restarts inside actor_chunk
    keep each game's komi. The standard normals come from gen, or are
    `normals` (float[G]) when given. mesh: this rank's slice of the G
    games (G must divide by the ranks; the draws are the whole
    batch's), on its device."""
    if mesh is not None:
        PM.check_divisible(num_games, mesh, "num_games")
        games = new_games(size, num_games, rules, max_moves, komi_stdev,
                          gen, mesh.device, normals)
        row0, rows = PM.process_batch_slice(num_games, mesh)
        return T.tree_map(lambda x: x[row0:row0 + rows], games)
    dev = resolve_device(device)
    rules = rules or R.Rules.tromp_taylorish()
    nn = size * size
    max_hist = (max_moves or int(nn * 1.6) + 20) + 8
    games = H.new_game(size, rules, max_hist, g=num_games, device=dev)
    if komi_stdev > 0.0:
        if normals is None:
            normals = torch.randn((num_games,), generator=gen, device=dev)
        jitter = normals.to(device=dev, dtype=torch.float32) * komi_stdev
        komi = rules.komi + torch.round(jitter * 2.0) / 2.0
        games = dataclasses.replace(games, rules=dataclasses.replace(
            games.rules, komi=komi.to(games.rules.komi.dtype)))
    return games
