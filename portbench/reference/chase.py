"""Frozen copy of the port's plain chase-ladder solver (the greedy chase
of katago_torch/ops/chase.py chase_lanes_plain, semantic source
katago_tpu/game/ladder.py `_chase_one`) and of its lane construction and
verdict marking (katago_torch/game/ladder.py _heads, _chase_setup,
chase_lane_inputs, _chase_finish), taken at the commit that added this
benchmark, on the benchmark's own board helpers.

K1 (the CUDA chase kernel) is held to `chase_lanes_plain`; the search's
ladder planes 14 and 17 to `ladder_map`.
"""

from __future__ import annotations

import torch

from portbench.reference import board as B

K_ADJ = 3   # defender capture candidates examined per ply
C_CAP = 4   # captured stones tracked exactly per move
EVENTS = ("suicide_extension", "ko_ban", "overflow", "double_ko_shape",
          "max_steps")


def _extract(arr, m):
    """arr[l, m[l]] per lane."""
    return arr.gather(1, m.long().unsqueeze(-1))[:, 0]


def _dilate(mask, size):
    """4-neighbour dilation of bool[L, NN]."""
    return (B.shift4(mask.to(torch.int8), size, 0) > 0).any(dim=-2)


def _onehot(loc, nn):
    return torch.arange(nn, device=loc.device) == loc.unsqueeze(-1)


def lowest_k(mask, k: int):
    """[L, k]: the k lowest set indices of bool[L, NN] (NN where unset)."""
    nn = mask.shape[-1]
    idx = torch.arange(nn, device=mask.device)
    vals = torch.where(mask, idx, nn)
    return torch.sort(vals, dim=-1).values[:, :k]


def _nbr_at(sh, m):
    """sh [L, 4, NN] shifted board, m [L] -> [L, 4] neighbour values."""
    return sh.gather(2, m.long().reshape(-1, 1, 1).expand(-1, 4, 1))[..., 0]


def chase_apply(stones, labels, hlibs, m, player, size):
    """Play player[l] at m[l] on every lane (ladder.py _chase_apply).
    Returns (stones, labels, hlibs, ko_loc, legal, overflow)."""
    nn = size * size
    dev = stones.device
    idx = torch.arange(nn, device=dev)
    m = m.long()
    player = player.long()
    opp = B.opponent(player)
    s_sh = B.shift4(stones, size, B.WALL)
    l_sh = B.shift4(labels, size, nn)
    nbr_s = _nbr_at(s_sh, m)                                   # [L, 4]
    nbr_l = _nbr_at(l_sh, m)
    nbr_libs = hlibs.gather(1, nbr_l.clamp(0, nn - 1))
    nbr_stone = (nbr_s == B.BLACK) | (nbr_s == B.WHITE)
    own_sel = nbr_s == player.unsqueeze(-1)
    cap_sel = (nbr_s == opp.unsqueeze(-1)) & (nbr_libs == 1)

    own_mask = torch.zeros_like(stones, dtype=torch.bool)
    cap_mask = torch.zeros_like(own_mask)
    merged = m.clone()
    for i in range(4):
        same = labels == nbr_l[:, i:i + 1]
        own_mask |= own_sel[:, i:i + 1] & same
        cap_mask |= cap_sel[:, i:i + 1] & same
        merged = torch.minimum(merged, torch.where(own_sel[:, i], nbr_l[:, i],
                                                   m))
    own_mask &= stones == player.unsqueeze(-1)
    cap_mask &= stones == opp.unsqueeze(-1)

    target_empty = _extract(stones, m) == B.EMPTY
    at_m = _onehot(m, nn)
    new_stones = torch.where(at_m, player.unsqueeze(-1).to(stones.dtype),
                             torch.where(cap_mask, B.EMPTY, stones))
    my_mask = own_mask | at_m
    new_labels = torch.where(my_mask, merged.unsqueeze(-1),
                             torch.where(cap_mask, idx, labels))
    my_libs = ((new_stones == B.EMPTY) & _dilate(my_mask, size)).sum(-1)
    num_captured = cap_mask.sum(-1)

    h = hlibs.clone()
    rows = torch.arange(h.shape[0], device=dev)
    # (a) surviving chains adjacent to m lose the liberty m
    for i in range(4):
        dup = torch.zeros_like(target_empty)
        for j in range(i):
            dup |= (nbr_l[:, j] == nbr_l[:, i]) & nbr_stone[:, j]
        sel = nbr_stone[:, i] & ~dup & ~own_sel[:, i] & ~cap_sel[:, i]
        tgt = nbr_l[:, i].clamp(0, nn - 1)
        h[rows, tgt] -= sel.to(h.dtype)
    # (b) chains bordering captured points gain those liberties
    cap_pts = lowest_k(cap_mask, C_CAP)
    nl_sh = B.shift4(new_labels, size, nn)
    ns_sh = B.shift4(new_stones, size, B.WALL)
    for t in range(C_CAP):
        c = cap_pts[:, t].clamp(0, nn - 1)
        cvalid = cap_pts[:, t] < nn
        cl = _nbr_at(nl_sh, c)
        cs = _nbr_at(ns_sh, c)
        cstone = (cs == B.BLACK) | (cs == B.WHITE)
        for i in range(4):
            dup = torch.zeros_like(cvalid)
            for j in range(i):
                dup |= (cl[:, j] == cl[:, i]) & cstone[:, j]
            sel = cvalid & cstone[:, i] & ~dup & (cl[:, i] != merged)
            h[rows, cl[:, i].clamp(0, nn - 1)] += sel.to(h.dtype)
    # (c) the mover's merged chain, recounted from its mask
    h[rows, merged] = my_libs.to(h.dtype)

    own_any = own_sel.any(-1)
    is_ko = (num_captured == 1) & ~own_any & (my_libs == 1)
    ko_loc = torch.where(is_ko, B.first_true(cap_mask), -1)
    legal = target_empty & (my_libs > 0)
    overflow = num_captured > C_CAP
    return new_stones, new_labels, h, ko_loc, legal, overflow


def _would_be_ko_capture_at(stones, labels, hlibs, size, defender, l2,
                            s_sh, l_sh):
    """wouldBeKoCapture(loc, attacker) at the two liberty points l2[:, t]."""
    nn = size * size
    d = defender.unsqueeze(-1)
    outs = []
    for t in range(2):
        loc = l2[:, t].clamp(0, nn - 1)
        ns = _nbr_at(s_sh, loc)
        nl = _nbr_at(l_sh, loc)
        all_def = ((ns == d) | (ns == B.WALL)).all(-1)
        cap_cnt = torch.zeros_like(loc)
        single_cnt = torch.zeros_like(loc)
        for i in range(4):
            dup = torch.zeros_like(all_def)
            for j in range(i):
                dup |= (nl[:, j] == nl[:, i]) & (ns[:, j] == defender)
            isdef = (ns[:, i] == defender) & ~dup
            in_atari = hlibs.gather(
                1, nl[:, i:i + 1].clamp(0, nn - 1))[:, 0] == 1
            chain_sz = ((labels == nl[:, i:i + 1]) & (stones == d)).sum(-1)
            cap_cnt += (isdef & in_atari).long()
            single_cnt += (isdef & in_atari & (chain_sz == 1)).long()
        outs.append((l2[:, t] < nn) & all_def & (cap_cnt == 1)
                    & (single_cnt == 1))
    return outs


def chase_lanes_plain(stones, labels, hlibs, rep, defender, premove, active,
                      *, size: int, max_steps: int,
                      stats: dict | None = None) -> torch.Tensor:
    """Plain torch chase over all lanes (ladder.py _chase_one, batched):
    bool[L] captured. stats, when given, receives "lane_plies": the plies
    played summed over lanes (the data-dependent work of the solve), and
    "max_lane_plies": the plies of the longest lane (which sets the time
    of a kernel that gives each lane its own warp), and "events": for each
    branch in EVENTS, the number of lanes that took it."""
    nn = size * size
    dev = stones.device
    lanes = stones.shape[0]
    stones = stones.long()
    labels = labels.long()
    hlibs = hlibs.long()
    rep = rep.long()
    defender = defender.long()
    attacker = B.opponent(defender)
    premove = premove.long()
    d1 = defender.unsqueeze(-1)
    a1 = attacker.unsqueeze(-1)

    has_pre = premove >= 0
    ps, pl, ph, _, plegal, pov = chase_apply(
        stones, labels, hlibs, premove.clamp(0, nn - 1), attacker, size)
    hp = has_pre.unsqueeze(-1)
    stones = torch.where(hp, ps, stones)
    labels = torch.where(hp, pl, labels)
    hlibs = torch.where(hp, ph, hlibs)
    live = active & (~has_pre | (plegal & ~pov))

    ko = torch.full((lanes,), -1, dtype=torch.int64, device=dev)
    done = ~live
    captured = torch.zeros_like(done)
    ply = 0
    plies = torch.zeros((lanes,), dtype=torch.int64, device=dev)
    track = stats is not None      # tally EVENTS (extra launches per ply)
    if track:
        ev = {name: torch.zeros_like(done) for name in EVENTS}
        ev["overflow"] |= active & has_pre & plegal & pov

    def entry():
        empty = stones == B.EMPTY
        lrep = _extract(labels, rep)
        gone = _extract(stones, rep) != defender
        def_mask = (labels == lrep.unsqueeze(-1)) & (stones == d1)
        dlibs = torch.where(gone, 0, _extract(hlibs, lrep))
        libpts = empty & _dilate(def_mask, size)
        return empty, gone, def_mask, dlibs, libpts

    def commit(advance, ns, nl, nh, nko):
        a = advance.unsqueeze(-1)
        return (torch.where(a, ns, stones), torch.where(a, nl, labels),
                torch.where(a, nh, hlibs), torch.where(advance, nko, ko))

    while ply < max_steps and not bool(done.all()):
        # ---------------- defender ply ----------------
        if track:
            plies += ~done
        empty, gone, def_mask, dlibs, libpts = entry()
        term_cap = gone
        term_esc = ~gone & ((ko >= 0) | (dlibs >= 2))
        dil_def = _dilate(def_mask, size)
        ext = B.first_true(libpts)
        ext_oh = _onehot(ext, nn)
        est_ext = ((empty & ~ext_oh) & _dilate(def_mask | ext_oh, size)
                   ).sum(-1)
        best_est = torch.where(libpts.any(-1), est_ext, -1)
        best_move = ext
        rem = (stones == a1) & dil_def
        for _ in range(K_ADJ):
            p = B.first_true(rem)
            any_rem = rem.any(-1)
            lp = _extract(labels, p)
            chain_t = (labels == lp.unsqueeze(-1)) & (stones == a1)
            atari = _extract(hlibs, lp) == 1
            lone = empty & _dilate(chain_t, size)
            ci = B.first_true(lone)
            ci_oh = _onehot(ci, nn)
            valid_t = any_rem & atari & lone.any(-1) & (ci != ko)
            joins = (dil_def & ci_oh).any(-1)
            defm_t = def_mask | (ci_oh & joins.unsqueeze(-1))
            est_t = (((empty | chain_t) & ~ci_oh)
                     & _dilate(defm_t, size)).sum(-1)
            better = valid_t & (est_t >= best_est)
            best_est = torch.where(better, est_t, best_est)
            best_move = torch.where(better, ci, best_move)
            rem = rem & ~chain_t
        def_has = best_est >= 0
        ns, nl, nh, nko, legal, ov = chase_apply(
            stones, labels, hlibs, best_move, defender, size)
        new_cap = term_cap | ~def_has | ~legal
        new_esc = term_esc | (~new_cap & ov)
        if track:
            moved = ~done & ~term_cap & def_has
            ev["suicide_extension"] |= moved & ~legal
            ev["overflow"] |= moved & legal & ~term_esc & ov
        terminal = (new_cap | new_esc) & ~done
        advance = ~terminal & ~done
        stones, labels, hlibs, ko = commit(advance, ns, nl, nh, nko)
        captured = torch.where(terminal, new_cap, captured)
        done = done | terminal
        ply += 1
        if ply >= max_steps:
            break

        # ---------------- attacker ply ----------------
        if track:
            plies += ~done
        empty, gone, def_mask, dlibs, libpts = entry()
        term_cap = gone | (dlibs <= 1)
        term_esc = ~gone & (dlibs >= 3)
        dil_def = _dilate(def_mask, size)
        l2 = lowest_k(libpts, 2)
        att_sh = B.shift4(stones, size, B.WALL)
        atl_sh = B.shift4(labels, size, nn)

        def refute(li_raw, lo_raw):
            li = li_raw.clamp(0, nn - 1)
            lo = lo_raw.clamp(0, nn - 1)
            valid = (li_raw < nn) & (li_raw != ko)
            als = _nbr_at(att_sh, li)
            all_ = _nbr_at(atl_sh, li)
            li_oh = _onehot(li, nn)
            amask = li_oh.clone()
            for i in range(4):
                amask |= ((als[:, i] == attacker).unsqueeze(-1)
                          & (labels == all_[:, i:i + 1]))
            amask &= (stones == a1) | li_oh
            dil_a = _dilate(amask, size)
            a_libs = ((empty & ~li_oh) & dil_a).sum(-1)
            legal_est = a_libs >= 1
            lo_oh = _onehot(lo, nn)
            est_ext2 = ((empty & ~li_oh & ~lo_oh)
                        & _dilate(def_mask | lo_oh, size)).sum(-1)
            lone_a = (empty & ~li_oh) & dil_a
            ca = B.first_true(lone_a)
            ca_oh = _onehot(ca, nn)
            joins_a = (dil_def & ca_oh).any(-1)
            est_cap2 = ((((empty | amask) & ~li_oh & ~ca_oh)
                         & _dilate(def_mask | (ca_oh & joins_a.unsqueeze(-1)),
                                   size))).sum(-1)
            est_def = torch.maximum(est_ext2,
                                    torch.where(a_libs == 1, est_cap2, 0))
            return (~valid) | (~legal_est) | (est_def >= 3), est_def

        r0, e0 = refute(l2[:, 0], l2[:, 1])
        r1, e1 = refute(l2[:, 1], l2[:, 0])
        both_ref = r0 & r1
        pick1 = ~r1 & (r0 | (e1 < e0))
        att_move = torch.where(pick1, l2[:, 1], l2[:, 0]).clamp(0, nn - 1)

        imm = (att_sh == B.EMPTY).sum(-2)
        kocap = _would_be_ko_capture_at(stones, labels, hlibs, size,
                                        defender, l2, att_sh, atl_sh)
        lib0 = l2[:, 0].clamp(0, nn - 1)
        lib1 = l2[:, 1].clamp(0, nn - 1)
        both_libs = (l2[:, 0] < nn) & (l2[:, 1] < nn)
        double_ko = (both_libs & (_extract(imm, lib0) == 0)
                     & (_extract(imm, lib1) == 0) & kocap[0] & kocap[1])

        ns, nl, nh, nko, legal, ov = chase_apply(
            stones, labels, hlibs, att_move, attacker, size)
        if track:
            runs = ~done & ~term_cap & ~term_esc
            ev["ko_ban"] |= runs & (ko >= 0) & ((l2[:, 0] == ko)
                                                | (l2[:, 1] == ko))
            ev["overflow"] |= runs & ov
            ev["double_ko_shape"] |= runs & double_ko
        new_cap = term_cap
        new_esc = term_esc | (~term_cap & (both_ref | ov))
        new_cap = new_cap | (~new_esc & double_ko & ~term_esc)
        terminal = (new_cap | new_esc) & ~done
        advance = ~terminal & ~done
        stones, labels, hlibs, ko = commit(advance, ns, nl, nh, nko)
        captured = torch.where(terminal, new_cap, captured)
        done = done | terminal
        ply += 1
    if track:
        stats["lane_plies"] = int(plies.sum())
        stats["max_lane_plies"] = int(plies.max()) if lanes else 0
        ev["max_steps"] = ~done
        stats["events"] = {k: int(v.sum()) for k, v in ev.items()}
    return captured & done & active




def default_max_steps(size: int) -> int:
    return 4 * size + 14


def _chain_lib_points(stones, labels, rep, size):
    """bool[G, K, NN]: empty points adjacent to the chain containing
    rep[G, K]."""
    lrep = labels.gather(1, rep)                              # [G, K]
    chain = (labels.unsqueeze(1) == lrep.unsqueeze(-1)) & \
        (stones != B.EMPTY).unsqueeze(1)
    return (stones == B.EMPTY).unsqueeze(1) & _dilate(chain, size)


def _lowest_k(mask, k: int):
    """Indices of the k lowest set positions of bool[..., NN] (NN where
    unset)."""
    nn = mask.shape[-1]
    idx = torch.arange(nn, device=mask.device)
    vals = torch.where(mask, idx, nn)
    return torch.sort(vals, dim=-1).values[..., :k]


def _heads(stones, size: int, max_chains: int):
    """Analysis shared by both solvers: stone labels, liberties and the
    lowest-index chains with 1 or 2 liberties (up to max_chains per
    board) with their two lowest liberties."""
    nn = size * size
    labels = B.stone_labels(stones, size)
    libs = B.chain_liberties(stones, labels, size)
    occupied = (stones == B.BLACK) | (stones == B.WHITE)
    idx = torch.arange(nn, device=stones.device)
    is_head = occupied & (labels == idx) & (libs >= 1) & (libs <= 2)
    heads = _lowest_k(is_head, max_chains)                    # [G, K]
    h = heads.clamp(max=nn - 1)
    return dict(labels=labels, libs=libs, occupied=occupied, h=h,
                head_ok=heads < nn, hdef=stones.gather(1, h).long(),
                hlibcnt=libs.gather(1, h),
                libpts=_lowest_k(_chain_lib_points(stones, labels, h, size),
                                 2))




def _chase_setup(stones, size: int, max_chains: int, ko):
    """Per-board lane construction: the lowest-index chains with 1 or 2
    liberties (up to max_chains) each get two query lanes."""
    nn = size * size
    ctx = _heads(stones, size, max_chains)
    h, head_ok, hlibcnt = ctx["h"], ctx["head_ok"], ctx["hlibcnt"]
    libpts = ctx["libpts"]
    ko = ko.long().unsqueeze(-1)
    pre_a = torch.where((hlibcnt == 2) & (libpts[..., 0] < nn),
                        libpts[..., 0], -1)
    pre_b = torch.where(libpts[..., 1] < nn, libpts[..., 1], -1)
    act_a = head_ok & ((hlibcnt == 1)
                       | ((hlibcnt == 2) & (libpts[..., 0] < nn)
                          & (libpts[..., 0] != ko)))
    act_b = head_ok & (hlibcnt == 2) & (libpts[..., 1] < nn) & \
        (libpts[..., 1] != ko)
    return dict(ctx, reps=torch.cat([h, h], 1),
                defenders=torch.cat([ctx["hdef"]] * 2, 1),
                premoves=torch.cat([pre_a, pre_b], 1),
                active=torch.cat([act_a, act_b], 1))


def chase_lane_inputs(stones, ctx, max_chains: int):
    """chase_lanes' positional inputs for the 2 * max_chains lanes of
    each board that _chase_setup built (board-major)."""
    k2 = 2 * max_chains
    i32 = torch.int32
    return (stones.to(i32).repeat_interleave(k2, dim=0),
            ctx["labels"].to(i32).repeat_interleave(k2, dim=0),
            ctx["libs"].to(i32).repeat_interleave(k2, dim=0),
            ctx["reps"].reshape(-1).to(i32),
            ctx["defenders"].reshape(-1).to(i32),
            ctx["premoves"].reshape(-1).to(i32),
            ctx["active"].reshape(-1))


def _chase_finish(ctx, results, size: int, max_chains: int):
    """Mark laddered chains / working attacker moves from lane verdicts
    (results bool[G, 2K])."""
    nn = size * size
    k = max_chains
    labels, occupied = ctx["labels"], ctx["occupied"]
    h, head_ok = ctx["h"], ctx["head_ok"]
    hdef, hlibcnt, libpts = ctx["hdef"], ctx["hlibcnt"], ctx["libpts"]
    lad_a, lad_b = results[:, :k], results[:, k:]
    mark = B.bincount_rows(torch.where(head_ok & (lad_a | lad_b), h, -1), nn)
    laddered = (mark.gather(1, labels) >= 1) & occupied

    def working_mask(color):
        sel_a = head_ok & lad_a & (hdef == color) & (hlibcnt == 2)
        sel_b = head_ok & lad_b & (hdef == color)
        m = B.bincount_rows(torch.where(sel_a, libpts[..., 0], -1), nn)
        m = m + B.bincount_rows(torch.where(sel_b, libpts[..., 1], -1), nn)
        return m >= 1

    return laddered, working_mask(B.BLACK), working_mask(B.WHITE)


def ladder_map(stones, size: int, ko_loc, max_chains: int = 16):
    """(laddered, working_vs_black, working_vs_white) bool[G, NN] of the
    chase solver on [G, NN] boards."""
    g = stones.shape[0]
    ctx = _chase_setup(stones.long(), size, max_chains, ko_loc)
    cap = chase_lanes_plain(*chase_lane_inputs(stones, ctx, max_chains),
                            size=size, max_steps=default_max_steps(size))
    return _chase_finish(ctx, cap.reshape(g, 2 * max_chains), size,
                         max_chains)
