"""The port's opening book (katago_torch/book/book.py, cli/book_cmd.py)
against the JAX package's, on the CPU.

The JAX side is the saved `book` reference (tools/make_torch_fixtures.py):
gen_book at 5x5 on the b1c6 net of weights seed 3 (BOOK_ARGS: 2 rounds
of 4 nodes at 8 visits; its searches are deterministic: no root noise,
one symmetry), the saved JSON and HTML, book_cmd's host commands on that
JSON (BOOK_CMD_CASES), and canonical_hash of seeded boards under their 8
symmetries.

Exact: the node set, each node's line, side to move, moves, children,
parents, visits and expandability; canonical_hash; the host commands'
outputs on the JAX book. Within 1e-5: every value, bound, prior and
cost (the costs recomputed from the port's values).
"""

from __future__ import annotations

import contextlib
import io
import json

import pytest

from katago_torch.book import book as TB
from katago_torch.cli import book_cmd as TBC

from tests import test_torch_common as C

_, META = C.load_ref("book")
OUT = META["outputs"]
ARGS = META["args"]
TOL = 1e-5


def stdout_of(fn, *args) -> str:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn(*args)
    return buf.getvalue()


@pytest.fixture(scope="module")
def books(tmp_path_factory):
    """(the port's gen_book, the JAX book loaded by the port)."""
    tmp = tmp_path_factory.mktemp("book")
    got = TB.gen_book(C.ref_model(5), size=5, visits=ARGS["visits"],
                      rounds=ARGS["rounds"],
                      nodes_per_round=ARGS["nodes_per_round"],
                      device="cpu", log=lambda *_: None)
    (tmp / "jax.json").write_text(OUT["book"])
    return got, TB.Book.load(str(tmp / "jax.json"), "cpu"), tmp


def test_canonical_hash_over_symmetries_equals_jax():
    for (syms, pla), want in zip(C.book_hash_boards(), META["hashes"]):
        got = [TB.canonical_hash(b, pla, b.shape[-1]) for b in syms]
        assert got == want
        assert len(set(got)) == 1


def test_gen_book_nodes_and_moves_equal_jax(books):
    got, want, _ = books
    assert got.root_hash == want.root_hash
    assert set(got.nodes) == set(want.nodes)
    for h, w in want.nodes.items():
        g = got.nodes[h]
        assert (g.moves_from_root, g.to_move, g.can_expand, g.searched) == \
            (w.moves_from_root, w.to_move, w.can_expand, w.searched), h
        assert sorted(g.moves) == sorted(w.moves), h
        for loc, m in w.moves.items():
            assert g.moves[loc].child_hash == m.child_hash
            assert abs(g.moves[loc].raw_policy - m.raw_policy) <= TOL
        assert sorted(g.parents) == sorted(w.parents), h
        assert g.this_values.visits == w.this_values.visits, h


def _close(a, b, what):
    for k, v in vars(b).items():
        assert abs(getattr(a, k) - v) <= TOL, (what, k, getattr(a, k), v)


def test_gen_book_values_and_costs_equal_jax(books):
    got, want, _ = books
    for h, w in want.nodes.items():
        g = got.nodes[h]
        _close(g.this_values, w.this_values, h)
        _close(g.recursive, w.recursive, h)
    # the costs, recomputed on both sides from their values
    want.recompute_values()
    want.recompute_costs()
    for h, w in want.nodes.items():
        g = got.nodes[h]
        for k in ("min_depth", "expansion_is_wlpv"):
            assert getattr(g, k) == getattr(w, k), (h, k)
        for k in ("min_cost_from_root", "min_cost_wlpv",
                  "biggest_wl_cost_from_root", "expansion_cost"):
            a, b = getattr(g, k), getattr(w, k)
            assert abs(a - b) <= TOL * max(1.0, abs(b)), (h, k, a, b)
        for loc, m in w.moves.items():
            gm = g.moves[loc]
            assert gm.is_wlpv == m.is_wlpv
            assert abs(gm.cost_from_root - m.cost_from_root) <= \
                TOL * max(1.0, abs(m.cost_from_root))
    assert [n.hash for n in got.get_next_n_to_expand(3)] == \
        [n.hash for n in want.get_next_n_to_expand(3)]


def test_book_save_load_round_trip(books, tmp_path):
    got, _, _ = books
    got.save(str(tmp_path / "b.json"))
    back = TB.Book.load(str(tmp_path / "b.json"), "cpu")
    assert set(back.nodes) == set(got.nodes)
    for h, n in got.nodes.items():
        b = back.nodes[h]
        assert (b.this_values, b.recursive, b.moves_from_root,
                b.can_expand, b.searched) == \
            (n.this_values, n.recursive, n.moves_from_root, n.can_expand,
             n.searched)
        assert {k: (m.child_hash, m.raw_policy) for k, m in b.moves.items()} \
            == {k: (m.child_hash, m.raw_policy) for k, m in n.moves.items()}
    # the JAX book's JSON loads and saves back unchanged
    _, want, tmp = books
    want.save(str(tmp_path / "w.json"))
    assert json.loads((tmp_path / "w.json").read_text()) == \
        json.loads(OUT["book"])


def test_write_html_equals_jax(books, tmp_path):
    _, want, _ = books
    want.write_html(str(tmp_path / "html"))
    got = {p.name: p.read_text() for p in sorted(
        (tmp_path / "html").iterdir())}
    assert got == OUT["html"]


@pytest.mark.parametrize("name", sorted(C.BOOK_CMD_CASES))
def test_book_cmd_host_commands_equal_jax(name, books, tmp_path):
    _, _, tmp = books
    path = tmp / "jax.json"
    if name == "comparebooks":
        b2 = TB.Book.load(str(path), "cpu")
        b2.nodes.pop(sorted(b2.nodes)[-1])
        b2.nodes[b2.root_hash].recursive.winloss += 0.25
        b2.save(str(tmp_path / "b2.json"))
    work = tmp_path / name
    work.mkdir()
    argv = [x.format(book=path, out=work, book2=tmp_path / "b2.json")
            for x in C.BOOK_CMD_CASES[name]] + ["-device", "cpu"]
    printed = stdout_of(TBC.main, argv)
    want = OUT[name]
    # printed paths lay in each run's own directory
    got_json = json.loads(printed.replace(str(tmp_path), "{tmp}")
                          .replace(str(tmp), "{tmp}"))
    want_json = json.loads(want["stdout"])
    for k in ("out_dir", "out", "book"):
        got_json.pop(k, None)
        want_json.pop(k, None)
    if "worst_nodes" in want_json:
        # the JAX command orders tied nodes by a set's iteration order
        # (salted string hashes); the port orders ties by hash
        want_json["worst_nodes"].sort(
            key=lambda n: (-abs(n["wl1"] - n["wl2"]), n["hash"]))
    assert got_json == want_json
    got_files = {p.name: p.read_text() for p in sorted(work.iterdir())}
    assert got_files == want["files"]


def test_genbook_cli_grows_and_resumes_a_book(tmp_path):
    path = tmp_path / "book.json"
    argv = ["genbook", "-book", str(path), "-model",
            str(C.REF_DIR / "b1c6_s3.bin.gz"), "-size", "5", "-visits", "4",
            "-rounds", "1", "-nodes-per-round", "2", "-device", "cpu"]
    first = json.loads(stdout_of(TBC.main, argv).splitlines()[-1])
    second = json.loads(stdout_of(TBC.main, argv).splitlines()[-1])
    assert 1 < first["nodes"] < second["nodes"]
    html = json.loads(stdout_of(TBC.main, [
        "writebook", "-book", str(path), "-out-dir", str(tmp_path / "h"),
        "-device", "cpu"]))
    assert html["nodes"] == second["nodes"]
    assert (tmp_path / "h" / "index.html").exists()
