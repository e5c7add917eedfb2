"""genbook / writebook / book-analysis commands
(cpp/command/genbook.cpp, main.cpp:139-150); port of
katago_tpu/cli/book_cmd.py.

Usage:
  python -m katago_torch.cli.book_cmd genbook -book book.json [-model M]
      [-config b6c96] [-size 19] [-visits 64] [-rounds 4] [-device cpu]
  python -m katago_torch.cli.book_cmd writebook -book book.json -out-dir html/
  python -m katago_torch.cli.book_cmd checkbook -book book.json
  python -m katago_torch.cli.book_cmd booktoposes -book book.json
      -out-dir poses/ [-max-depth D] [-min-visits V] [-enable-hints]
      [-constant-weight W] [-depth-weight W] [-depth-weight-scale S]
      [-policy-surprise-weight W] [-min-weight W]
  python -m katago_torch.cli.book_cmd comparebooks -book A.json -book2 B.json
  python -m katago_torch.cli.book_cmd findbookbottlenecks -book book.json
      -out out.jsonl [-winloss-delta 0.1] [-max-depth D] [-min-visits V]

Every command runs on CUDA unless `-device cpu` is given (with no CUDA
device and no -device it raises): genbook searches there, and
booktoposes replays node lines there. genbook's -model is a .bin.gz
served by DescNet (float32), -config a KataGoModel with the port's
seeded weights (the JAX package inits its own from a JAX key, so those
weights differ). The other commands' book logic runs on the host.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from katago_torch.book.book import Book, gen_book


def _book_depths(book):
    """BFS depths over in-book edges from the root."""
    from collections import deque
    depths = {book.root_hash: 0}
    dq = deque([book.root_hash])
    while dq:
        h = dq.popleft()
        node = book.nodes.get(h)
        if node is None:
            continue
        for mv in node.moves.values():
            if mv.child_hash in book.nodes and mv.child_hash not in depths:
                depths[mv.child_hash] = depths[h] + 1
                dq.append(mv.child_hash)
    return depths


def _mover_wl(node):
    """Recursive winloss from the node's mover perspective."""
    wl = node.recursive.winloss
    return wl if node.to_move == 2 else -wl


def cmd_booktoposes(args):
    """Dump book nodes as startposes — booktoposes
    (genbook.cpp:1785-2114): weight = constant + depthWeight *
    exp(-depth / depthWeightScale) + policySurpriseWeight * (-log prior
    of the move played into the node); hint = the best in-book reply."""
    from katago_torch.dataio.poses import PositionSample, PosWriter
    book = Book.load(args.book, args.device)
    depths = _book_depths(book)
    writer = PosWriter("txt", args.out_dir, base="bookposes")
    kept = 0
    for h, node in book.nodes.items():
        depth = depths.get(h)
        if depth is None or depth > args.max_depth:
            continue
        if node.visits < args.min_visits:
            continue
        w = args.constant_weight + args.depth_weight * float(
            np.exp(-depth / max(args.depth_weight_scale, 1e-9)))
        if args.policy_surprise_weight > 0 and node.parents:
            ph, ploc = node.parents[0]
            pnode = book.nodes.get(ph)
            if pnode is not None and ploc in pnode.moves:
                rp = max(pnode.moves[ploc].raw_policy, 1e-6)
                w += args.policy_surprise_weight * float(-np.log(rp))
        if w < args.min_weight:
            continue
        hint = -1
        if args.enable_hints and node.moves:
            best = max(
                (mv for mv in node.moves.values()
                 if mv.child_hash in book.nodes),
                key=lambda mv: -_mover_wl(book.nodes[mv.child_hash]),
                default=None)
            if best is not None:
                hint = best.loc
        stones = book._replay_stones(node.moves_from_root)
        writer.write_pos(PositionSample(
            x_size=book.size, y_size=book.size, stones=stones,
            next_pla=node.to_move, moves=[],
            initial_turn_number=depth, hint_loc=hint,
            weight=float(w), metadata=h[:16]))
        kept += 1
    writer.flush_and_stop()
    print(json.dumps({"poses": kept, "nodes": len(book.nodes),
                      "out_dir": args.out_dir}))


def cmd_comparebooks(args):
    """Compare two books — comparebooks (genbook.cpp:2116-2255): node
    overlap and value drift on shared positions."""
    b1 = Book.load(args.book, args.device)
    b2 = Book.load(args.book2, args.device)
    h1, h2 = set(b1.nodes), set(b2.nodes)
    common = h1 & h2
    dwl = [abs(b1.nodes[h].recursive.winloss
               - b2.nodes[h].recursive.winloss) for h in common]
    dsc = [abs(b1.nodes[h].recursive.score_mean
               - b2.nodes[h].recursive.score_mean) for h in common]
    # ties in hash order (the JAX command leaves them in the set's
    # iteration order, which string-hash salting changes per process)
    worst = sorted(common,
                   key=lambda h: (-abs(b1.nodes[h].recursive.winloss
                                       - b2.nodes[h].recursive.winloss), h))
    print(json.dumps({
        "book1_nodes": len(h1), "book2_nodes": len(h2),
        "common": len(common),
        "only_book1": len(h1 - h2), "only_book2": len(h2 - h1),
        "mean_abs_winloss_diff": round(float(np.mean(dwl)), 5)
        if dwl else 0.0,
        "max_abs_winloss_diff": round(float(np.max(dwl)), 5)
        if dwl else 0.0,
        "mean_abs_score_diff": round(float(np.mean(dsc)), 4)
        if dsc else 0.0,
        "worst_nodes": [{"hash": h[:16],
                         "wl1": round(b1.nodes[h].recursive.winloss, 4),
                         "wl2": round(b2.nodes[h].recursive.winloss, 4)}
                        for h in worst[:10]],
    }))


def cmd_findbookbottlenecks(args):
    """Bottleneck moves — findbookbottlenecks (genbook.cpp:2257-2600,
    simplified): for each node, check which in-book moves lead to a
    subtree containing a position whose winloss clears node_wl +/-
    winloss-delta; nodes where exactly ONE move reaches the improved
    region are bottlenecks (the single gateway the book depends on).
    The reference additionally groups nodes by discretized thresholds
    and runs a shared reachability cache; the per-node criterion here
    is the same."""
    book = Book.load(args.book, args.device)
    depths = _book_depths(book)

    # reachable max/min winloss per subtree (memoized DFS over the DAG)
    memo_max: dict = {}
    memo_min: dict = {}

    def reach(h, memo, op):
        if h in memo:
            return memo[h]
        node = book.nodes.get(h)
        memo[h] = node.recursive.winloss if node else 0.0  # cycle guard
        best = node.recursive.winloss
        for mv in node.moves.values():
            if mv.child_hash in book.nodes:
                best = op(best, reach(mv.child_hash, memo, op))
        memo[h] = best
        return best

    out = open(args.out, "w")
    found = 0
    for h, node in book.nodes.items():
        depth = depths.get(h)
        if depth is None or depth > args.max_depth:
            continue
        if node.visits < args.min_visits:
            continue
        wl = node.recursive.winloss
        for direction, target, memo, op in (
                ("increasing", wl + args.winloss_delta, memo_max, max),
                ("decreasing", wl - args.winloss_delta, memo_min, min)):
            if not -1.0 < target < 1.0:
                continue
            gates = [mv.loc for mv in node.moves.values()
                     if mv.child_hash in book.nodes
                     and (reach(mv.child_hash, memo, op) >= target
                          if direction == "increasing"
                          else reach(mv.child_hash, memo, op) <= target)]
            if len(gates) == 1:
                out.write(json.dumps({
                    "hash": h, "depth": depth, "winloss": round(wl, 4),
                    "direction": direction,
                    "bottleneckMove": gates[0]}) + "\n")
                found += 1
    out.close()
    print(json.dumps({"bottlenecks": found, "nodes": len(book.nodes),
                      "out": args.out}))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("command", choices=[
        "genbook", "writebook", "checkbook", "booktoposes",
        "comparebooks", "findbookbottlenecks"])
    ap.add_argument("-book", required=True)
    ap.add_argument("-book2", default=None)
    ap.add_argument("-out-dir", default=None)
    ap.add_argument("-out", default="bottlenecks.jsonl")
    ap.add_argument("-model", default=None)
    ap.add_argument("-config", default="b6c96")
    ap.add_argument("-size", type=int, default=19)
    ap.add_argument("-visits", type=int, default=64)
    ap.add_argument("-rounds", type=int, default=4)
    ap.add_argument("-nodes-per-round", type=int, default=8)
    ap.add_argument("-max-depth", type=int, default=10 ** 8)
    ap.add_argument("-min-visits", type=float, default=-1.0)
    ap.add_argument("-enable-hints", action="store_true")
    ap.add_argument("-constant-weight", type=float, default=1.0)
    ap.add_argument("-depth-weight", type=float, default=0.0)
    ap.add_argument("-depth-weight-scale", type=float, default=1.0)
    ap.add_argument("-policy-surprise-weight", type=float, default=0.0)
    ap.add_argument("-min-weight", type=float, default=0.0)
    ap.add_argument("-winloss-delta", type=float, default=0.1)
    ap.add_argument("-device", default=None,
                    help="torch device of the book's replays and "
                         "searches (default: cuda; 'cpu' to run on the "
                         "CPU)")
    ap.add_argument("-book-config", default=None,
                    help="reference-keyed genbook cfg with BookParams "
                         "(errorFactor, costPerMove, ... — "
                         "configs/book/genbook7jp.cfg:23-40)")
    args = ap.parse_args(argv)

    if args.command == "booktoposes":
        if not args.out_dir:
            raise SystemExit("booktoposes requires -out-dir")
        cmd_booktoposes(args)
        return
    if args.command == "comparebooks":
        if not args.book2:
            raise SystemExit("comparebooks requires -book2")
        cmd_comparebooks(args)
        return
    if args.command == "findbookbottlenecks":
        cmd_findbookbottlenecks(args)
        return

    if args.command == "genbook":
        from katago_torch.cli.match_cmd import load_net
        from katago_torch.device import resolve_device
        dev = resolve_device(args.device)
        book = Book.load(args.book, dev) if os.path.exists(args.book) \
            else None
        size = book.size if book else args.size
        net, _ = load_net(args.model, args.config, size, dev)
        book_params = None
        if args.book_config:
            from katago_torch.book.book import BookParams
            from katago_torch.utils.config_parser import ConfigParser
            cfg = ConfigParser(args.book_config)
            book_params = BookParams.from_config(
                {k: cfg.get_string(k) for k in BookParams._CFG_KEYS
                 if cfg.contains(k)})
        book = gen_book(net, size=size, visits=args.visits,
                        rounds=args.rounds,
                        nodes_per_round=args.nodes_per_round, book=book,
                        book_params=book_params, device=dev)
        book.save(args.book)
        print(json.dumps({"nodes": len(book.nodes), "book": args.book}))
    elif args.command == "writebook":
        book = Book.load(args.book, args.device)
        out = args.out_dir or (args.book + ".html")
        book.write_html(out)
        print(json.dumps({"nodes": len(book.nodes), "out_dir": out}))
    else:  # checkbook
        book = Book.load(args.book, args.device)
        dangling = sum(1 for n in book.nodes.values()
                       for m in n.moves.values()
                       if m.child_hash not in book.nodes)
        print(json.dumps({"nodes": len(book.nodes), "dangling": dangling,
                          "root": book.root_hash}))


if __name__ == "__main__":
    main()
