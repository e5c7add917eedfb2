"""Traffic kind "selfplay": lockstep selfplay search through the port's
SearchDriver (search/driver.py), as selfplay drives it.

Set-up plays the cell's openings by the reference's rules
(reference/go.py), deals them to the games in the seed's order, replays
them through the port's rules engine, builds
the program's net in the configuration's dtype with the benchmark's
weights (drawn on the card from the cell's own `weights_seed`: how deep
the trees grow, and with it the work of a playout step, follows the
net), and warms up one chunk of a search. The window then
runs `visits`-visit searches with `chunk` playout steps between two
polls, stopping at the first poll after `--seconds`; a search that
finishes inside the window has its moves chosen (mcts.choose_moves) and
played, and the next search reuses its tree. A unit of work is a
playout step (one leaf for every game).

What the window produced is sampled, the samples drawn from the seed
over every call the window made: the net's inputs and outputs (all its
heads), the featurizer's planes with the moves that lead to each leaf
(the tree's parent links and the leaf's move), and the inputs and
outputs of the two kernels (K1 chase_lanes, K2 connected_labels). After
the window the reference recomputes each sample: it replays each leaf's
game from the empty board by its own rules (the opening, the moves
played, the path) and builds the V7 planes of its own leaf, the ladder
planes of the two boards before it included. The final trees' visits
are audited: each root gained one visit for every playout its backup
took.
"""

from __future__ import annotations

import contextlib
import sys
import time

import numpy as np
import torch

from portbench.reference import board as RB
from portbench.reference import chase as RC
from portbench.reference import go as RG
from portbench.reference import net as REF_NET

_HEADS = ("policy_logits", "value_logits", "miscvalue", "moremiscvalue",
          "ownership_pretanh", "scoring_presoftmax", "futurepos_pretanh",
          "seki_logits", "scorebelief_logprobs")


class Reservoir:
    """A uniform sample of k calls out of however many come, drawn from
    a seeded generator: offer() says which slot the current call fills,
    or None."""

    def __init__(self, k: int, rng: np.random.Generator):
        self.k, self.rng, self.seen, self.items = k, rng, 0, [None] * k

    def offer(self):
        i = self.seen
        self.seen += 1
        if i < self.k:
            return i
        j = int(self.rng.integers(0, i + 1))
        return j if j < self.k else None

    def samples(self):
        return [x for x in self.items if x is not None]


class State:
    def ref_roots(self, search: int) -> list:
        """The reference's replays of the roots of the window's search
        number `search`: each game's opening, then the moves played
        before that search."""
        if search not in self.replayed:
            games = []
            for r, opening in enumerate(self.openings):
                game = RG.Game(self.size)
                for m in opening:
                    game.play(m)
                for actions in self.played[:search]:
                    game.play(int(actions[r]))
                games.append(game)
            self.replayed[search] = games
        return self.replayed[search]


def _install(st, ctx):
    """Wrap the net and the layer calls: counting and sampling always;
    spans and kernel counters in the traced run."""
    from katago_torch.game import history as H
    from katago_torch.game import ladder as LAD
    from katago_torch.models import features as F
    from katago_torch.ops import chase as K1
    from katago_torch.ops import labels as K2
    from katago_torch.search import mcts
    from portbench import trace as TR

    rng = np.random.default_rng(ctx.seed % 2 ** 32 + 1)
    n = ctx.workload["samples"]
    st.res = {k: Reservoir(n[k], rng) for k in ("net", "features", "k1",
                                                 "k2")}
    st.steps = 0
    st.in_trace = False
    st.pending = None           # the features sample awaiting its paths
    st.completed = 0            # playouts the backup took, per game
    st.positions = 0
    st.k1_calls = []
    st.k2_boards = 0
    st.roots_start = []
    st.patches = patches = []

    def patch(obj, attr, wrapper):
        fn = getattr(obj, attr)
        patches.append((obj, attr, fn))
        setattr(obj, attr, wrapper(fn))

    def sampled(key, record, count=None):
        def wrapper(fn):
            def call(*a, **k):
                out = fn(*a, **k)
                if st.recording:
                    if count is not None:
                        count(a)
                    slot = st.res[key].offer()
                    if slot is not None:
                        st.res[key].items[slot] = record(a, k, out)
                return out
            return call
        return wrapper

    def features(fn):
        """Sample the leaves' planes; their paths are taken at the step's
        backup (`count_steps`), so a root evaluation's sample, which no
        backup follows, is dropped."""
        def call(*a, **k):
            out = fn(*a, **k)
            if st.recording:
                res = st.res["features"]
                if st.pending is not None:
                    res.items[st.pending] = None
                st.pending = slot = res.offer()
                if slot is not None:
                    res.items[slot] = dict(sp=out[0].clone(),
                                           gl=out[1].clone())
            return out
        return call

    def rec_k1(a, k, out):
        return dict(args=[t.clone() for t in a], size=k["size"],
                    max_steps=k["max_steps"], out=out.clone())

    def count_k1(a):
        if st.in_trace:         # active lanes summed on the card, read later
            st.k1_calls.append((a[6].sum(), a[6].shape[0]))

    def rec_k2(a, k, out):
        return dict(values=a[0].clone(), out=out.clone())

    def count_k2(a):
        if st.in_trace:
            st.k2_boards += a[0].shape[0]

    patch(F, "fill_features", features)
    patch(K1, "chase_lanes", sampled("k1", rec_k1, count_k1))
    patch(K2, "connected_labels", sampled("k2", rec_k2, count_k2))

    def count_steps(fn):
        def call(*a, **k):
            if st.recording:
                st.steps += 1
                ss, sel, void, active = a[0], a[1], a[6], a[7]
                st.completed = st.completed + (active & ~void).long()
                if st.pending is not None:
                    item = st.res["features"].items[st.pending]
                    if item is not None:
                        tree = ss.tree
                        item.update(
                            search=len(st.roots_start) - 1,
                            parent=tree.parent.clone(),
                            parent_action=tree.parent_action.clone(),
                            leaf_parent=sel.leaf_parent.clone(),
                            leaf_action=sel.leaf_action.clone(),
                            check=active & ~void & ~sel.is_terminal)
                    st.pending = None
            return fn(*a, **k)
        return call
    patch(mcts, "insert_and_backup", count_steps)

    def keep_root(fn):
        def call(*a, **k):
            ss = fn(*a, **k)
            if st.recording:
                st.roots_start.append(ss.tree.visits[:, 0].clone())
                st.ss = ss
                st.completed = 0
            return ss
        return call
    patch(mcts, "init_search", keep_root)

    if ctx.trace_on:
        for mod, name in ((mcts, "select_path"),
                          (mcts, "make_leaf_gamestate"), (H, "legal_moves"),
                          (LAD, "ladder_map_chase_batch"),
                          (F, "fill_features"), (mcts, "nn_leaf_eval"),
                          (mcts, "terminal_eval"),
                          (mcts, "insert_and_backup")):
            TR.wrap_span(mod, name, name, patches)


class _Net(torch.nn.Module):
    """The program's net as the search sees it, sampling its calls."""

    def __init__(self, net, st, trace_on):
        super().__init__()
        self.net, self.st, self.trace_on = net, st, trace_on

    def forward(self, spatial, global_in, **kw):
        st = self.st
        if self.trace_on:
            from torch.profiler import record_function
            from portbench.trace import SPAN_PREFIX
            with record_function(SPAN_PREFIX + "net"):
                out = self.net(spatial, global_in, **kw)
        else:
            out = self.net(spatial, global_in, **kw)
        if st.recording:
            st.positions += spatial.shape[0]
            slot = st.res["net"].offer()
            if slot is not None:
                st.res["net"].items[slot] = dict(
                    spatial=spatial.clone(), global_in=global_in.clone(),
                    out={h: out[h].clone() for h in _HEADS})
        return out


def setup(ctx):
    from katago_torch._tensortree import where as tree_where
    from katago_torch.game import history as H
    from katago_torch.game import rules as R
    from katago_torch.models import config as MC
    from katago_torch.models import model as M
    from katago_torch.ops import _build
    from katago_torch.search.driver import SearchDriver
    from katago_torch.search.params import SearchParams

    wl, cfg = ctx.workload, ctx.cfg
    size, g, dev = cfg["board_size"], wl["games"], ctx.device
    st = State()
    st.recording = False
    _build.build_all()
    # the net is the cell's own (weights_seed): nets drawn per seed grew
    # trees of other depths and changed the work by up to 40%
    st.weights = REF_NET.make_weights(cfg, wl["weights_seed"], dev)
    dtype = getattr(torch, cfg["dtype"])
    model = M.KataGoModel(MC.get_config(cfg["preset"]), size, dtype)
    model.load_state_dict(st.weights, strict=True)
    st.net = _Net(model.to(dev).eval(), st, ctx.trace_on)

    # the cell's own openings (openings_seed), played by the reference
    # and replayed by the port, in the seed's order: the
    # seed then changes which lane plays which game and the search's own
    # draws, not the work
    games, st.ref_boards = RG.random_games(g, size, wl["openings_seed"],
                                           wl["max_opening_plies"])
    order = np.random.default_rng(ctx.seed % 2 ** 32).permutation(g)
    games = [games[i] for i in order]
    st.openings, st.size, st.replayed = games, size, {}
    st.ref_boards = st.ref_boards[order]
    gs = H.new_game(size, R.Rules.tromp_taylorish(), wl["max_hist"], g=g,
                    device=dev)
    longest = max((len(m) for m in games), default=0)
    moves = torch.full((g, max(longest, 1)), -1, dtype=torch.int64)
    for i, m in enumerate(games):
        moves[i, :len(m)] = torch.tensor(m, dtype=torch.int64)
    moves = moves.to(dev)
    for ply in range(longest):
        loc = moves[:, ply]
        gs = tree_where(loc >= 0, H.step(gs, loc.clamp(min=0), size)[0], gs)
    st.roots = gs
    st.plies = torch.tensor([len(m) for m in games], device=dev)

    st.sp = SearchParams.for_selfplay().to_arr(dev)
    st.driver = SearchDriver(st.net, st.sp, size=size,
                             max_nodes=wl["visits"] + 3,
                             chunk_size=wl["chunk"], with_ladders=True,
                             ladder_mode="chase", device=dev)
    _install(st, ctx)
    with torch.no_grad():
        warm = torch.Generator(device=dev).manual_seed(ctx.seed + 1)
        st.driver.search(st.roots, warm, max_visits=1 + wl["chunk"],
                         should_stop=lambda: True)
    torch.cuda.synchronize()
    st.gen = torch.Generator(device=dev).manual_seed(ctx.seed)
    return st


def window(st, ctx):
    """Untraced, the window opens before the first search and closes at
    the first poll after --seconds. Traced, the search first runs
    untraced to the poll at `trace_from` steps, so that the traced trees
    are as deep as the timed window's, and the traced window then covers
    the next `trace_steps` steps."""
    from katago_torch.game import history as H
    from katago_torch.search import mcts

    wl, size = ctx.workload, ctx.cfg["board_size"]
    stop = {"now": False}
    st.polls = []
    opened = contextlib.ExitStack()
    at_open = {}

    def open_window():
        opened.enter_context(ctx.measure())
        st.in_trace = ctx.trace_on
        at_open.update(steps=st.steps, positions=st.positions)

    def should_stop():
        now = time.time()
        st.polls.append((now, st.steps))
        if not at_open:
            if st.steps >= wl["trace_from"]:
                open_window()
            return False
        if ctx.past_deadline(now) or (
                ctx.trace_on and
                st.steps - at_open["steps"] >= wl["trace_steps"]):
            stop["now"] = True
        return stop["now"]

    roots, prev_tree, prev_actions = st.roots, None, None
    move_nums = st.plies.clone()
    total = torch.zeros((), dtype=torch.int64, device=ctx.device)
    st.played = []
    st.recording = True
    with torch.no_grad(), opened:
        if not ctx.trace_on:
            open_window()
        while True:
            res = st.driver.search(roots, st.gen, max_visits=wl["visits"],
                                   prev_tree=prev_tree,
                                   prev_actions=prev_actions,
                                   should_stop=should_stop)
            total += (res.root_visits - st.roots_start[-1]).sum()
            if stop["now"] or should_stop():
                break
            actions = mcts.choose_moves(res, st.sp, move_nums, st.gen)
            st.played.append(actions.cpu())
            roots = H.step(roots, actions, size)[0]
            prev_tree, prev_actions = res.ss.tree, actions
            move_nums = move_nums + 1
    st.recording = st.in_trace = False
    elapsed = ctx.window_end - ctx.window_start
    st.playouts = int(total)
    st.searches = len(st.roots_start)
    ctx.counters["k1_calls"] = st.k1_calls
    ctx.counters["k2_boards"] = st.k2_boards
    steps = st.steps - at_open["steps"]
    return {"attempted": steps, "failed": 0,
            "e2e": {"playouts_per_s": st.playouts / elapsed},
            "counts": {"steps": steps, "playouts": st.playouts,
                       "positions": st.positions - at_open["positions"]}}


def net_gap(cfg, weights, samples, quant=None, program=True, heads=None):
    """The widest relative gap of the net's outputs: max over samples and
    heads of |out - ref|_2 / |ref|_2, ref the float32 reference on the
    sample's inputs; out the program's outputs, or with program=False the
    reference computed in `quant`. heads: a dict that receives each
    head's widest gap."""
    worst = 0.0
    for s in samples:
        ref = REF_NET.forward(cfg, weights, s["spatial"], s["global_in"])
        out = s["out"] if program else REF_NET.forward(
            cfg, weights, s["spatial"], s["global_in"], quant=quant)
        for h in _HEADS:
            r, o = ref[h].float(), out[h].float()
            gap = float(torch.linalg.vector_norm(o - r) /
                        torch.linalg.vector_norm(r).clamp(min=1e-30))
            worst = max(worst, gap)
            if heads is not None:
                heads[h] = max(heads.get(h, 0.0), gap)
    return worst


def leaf_games(st, sample, size):
    """The reference's own replays of a sampled step's leaves: for each
    row that the step expanded (active, not voided, not terminal), the
    game's opening, the moves played before its search, the moves of the
    leaf's parent's line of parent links from the root, and the leaf's
    move. Returns (rows, replayed games, rows with an illegal move)."""
    nn = size * size
    parent = sample["parent"].cpu().numpy()
    parent_action = sample["parent_action"].cpu().numpy()
    leaf_parent = sample["leaf_parent"].cpu().numpy()
    leaf_action = sample["leaf_action"].cpu().numpy()
    rows = np.flatnonzero(sample["check"].cpu().numpy())
    roots = st.ref_roots(sample["search"])
    games, illegal = [], 0
    for r in rows:
        line, node = [int(leaf_action[r])], int(leaf_parent[r])
        while node > 0 and len(line) <= parent.shape[1]:
            line.append(int(parent_action[r, node]))
            node = int(parent[r, node])
        game = roots[r].copy()
        ok = node == 0 and all(0 <= m <= nn and game.play(m)
                               for m in reversed(line))
        illegal += not ok
        games.append(game)
    return rows, games, illegal


def visit_faults(ss, roots_start, completed) -> int:
    """Games whose root gained other than one visit for every playout
    that the backup took (active and not voided by superko) in the last
    search. The search links transpositions (graph search), so a node's
    visits need not equal one more than its children's; the root's gain
    is what every playout must add to."""
    gained = ss.tree.visits[:, 0] - roots_start
    return int((gained != completed).sum())


def judge(st, ctx):
    from portbench import trace as TR

    cfg, size, lim = ctx.cfg, ctx.cfg["board_size"], ctx.workload["limits"]
    TR.unwrap(st.patches)
    roots_wrong = int((st.roots.pos.board.stones.cpu().numpy()
                       != st.ref_boards).sum())
    visits_wrong = visit_faults(st.ss, st.roots_start[-1], st.completed)
    tree = st.ss.tree
    live = torch.arange(tree.depth.shape[1], device=tree.depth.device) < \
        tree.num_nodes.unsqueeze(-1)
    chunks = " ".join(f"{b[0] - a[0]:.2f}"
                      for a, b in zip(st.polls, st.polls[1:]))
    print(f"portbench: {st.searches} search(es); last trees: nodes "
          f"{float(tree.num_nodes.float().mean()):.1f} a game, depth mean "
          f"{float(tree.depth[live].float().mean()):.2f} max "
          f"{int(tree.depth[live].max())}; s per "
          f"{ctx.workload['chunk']} steps {chunks}", file=sys.stderr)
    st.samples = samples = {k: r.samples() for k, r in st.res.items()}
    samples["features"] = [s for s in samples["features"] if "parent" in s]
    st.ss = st.roots = st.driver = st.net = None
    torch.cuda.empty_cache()
    with torch.no_grad():
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        gap = net_gap(cfg, st.weights, samples["net"])
        feat_wrong = illegal = 0
        for s in samples["features"]:
            rows, games, bad = leaf_games(st, s, size)
            illegal += bad
            if not len(rows):
                continue
            ref = RG.leaf_inputs(games, ctx.device)
            ref_sp, ref_gl = RG.features_v7(
                ref["stones"], ref["to_move"], ref["recent_moves"],
                ref["move_num"], ref["turns_this_phase"],
                ref["consec_passes"], ref["game_over"],
                ref["simple_ko_loc"], size, prev=ref["prev"])
            idx = torch.as_tensor(rows, device=s["sp"].device)
            feat_wrong += RG.check_features(
                s["sp"][idx], s["gl"][idx], ref_sp, ref_gl, ref["stones"],
                ref["simple_ko_loc"], ref["game_over"])
        k1_wrong = sum(int((RC.chase_lanes_plain(
            *s["args"], size=s["size"], max_steps=s["max_steps"])
            != s["out"]).sum()) for s in samples["k1"])
        k2_wrong = sum(int((RB.labels(s["values"], size) != s["out"].long())
                           .sum()) for s in samples["k2"])
    return [("roots_wrong", float(roots_wrong), 0.0),
            ("visits_wrong", float(visits_wrong), 0.0),
            ("leaves_illegal", float(illegal), 0.0),
            ("features_wrong", float(feat_wrong), 0.0),
            ("k1_wrong", float(k1_wrong), 0.0),
            ("k2_wrong", float(k2_wrong), 0.0),
            ("net_gap", gap, lim["net_gap"])]


def control(st, ctx):
    """The control: the reference computed in fp8 (e4m3, the precision
    below the configuration's bf16) on the window's sampled net inputs,
    compared with the float32 reference as the program is."""
    prog, ctl = {}, {}
    with torch.no_grad():
        gap = net_gap(ctx.cfg, st.weights, st.samples["net"],
                      quant=torch.float8_e4m3fn, program=False, heads=ctl)
        net_gap(ctx.cfg, st.weights, st.samples["net"], heads=prog)
    return {"fp8": {"net_gap": gap}, "heads": {"program": prog,
                                               "fp8": ctl}}
