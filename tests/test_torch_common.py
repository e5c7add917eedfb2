"""Shared helpers for the PyTorch port's tests (tests/test_torch_*.py).

Inputs are made from a seed with numpy and fed to both the JAX package
and its port (on device="cpu"); outputs are compared as numpy arrays.
JAX programs are jitted once per module through `jax_fns`.

Threads are set once, here, for every test: importing this module gives
the process one CPU thread for torch and for OpenMP/MKL (an outside
`OMP_NUM_THREADS` wins). Every xdist worker imports it while it collects
the suite, so the setting holds before any test runs, and processes that
a test spawns inherit it. A test file sets no thread count of its own.
"""

from __future__ import annotations

import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import torch

from katago_tpu.game import history as JH
from katago_tpu.game import rules as JR
from katago_torch.game import history as TH
from katago_torch.game import rules as TR

CPU = "cpu"

# Beside other test workers, more threads only contend: the port's test
# nets and boards are tiny.
os.environ.setdefault("OMP_NUM_THREADS", "1")
os.environ.setdefault("MKL_NUM_THREADS", os.environ["OMP_NUM_THREADS"])
torch.set_num_threads(int(os.environ["OMP_NUM_THREADS"]))

RULESETS = {
    "tromp_taylor": (JR.Rules.tromp_taylorish(), TR.Rules.tromp_taylorish()),
    "japanese": (JR.Rules.parse("japanese"), TR.Rules.parse("japanese")),
}


def to_np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def assert_tree_equal(jax_tree, torch_tree, path="", skip=()):
    """Field-by-field exact comparison of a JAX NamedTuple tree with the
    port's dataclass tree (hash lanes compare as integers)."""
    if dataclasses.is_dataclass(torch_tree):
        for f in dataclasses.fields(torch_tree):
            if f.name in skip:
                continue
            assert_tree_equal(getattr(jax_tree, f.name),
                              getattr(torch_tree, f.name),
                              f"{path}.{f.name}", skip)
        return
    a = np.asarray(jax_tree)
    b = to_np(torch_tree)
    if a.dtype.kind == "f" or b.dtype.kind == "f":
        np.testing.assert_array_equal(a.astype(np.float32),
                                      b.astype(np.float32), err_msg=path)
    else:
        np.testing.assert_array_equal(a.astype(np.int64), b.astype(np.int64),
                                      err_msg=path)


def jax_batch(tree, g):
    return jax.tree.map(
        lambda x: jnp.broadcast_to(x, (g,) + x.shape).copy(), tree)


def to_jax_like(template, torch_tree):
    """The port's dataclass tree as a JAX NamedTuple tree shaped like
    `template` (arrays or jax.eval_shape structs; leaves cast to the
    template's dtypes, hash lanes back to uint32). The inverse of the
    field walk of assert_tree_equal."""
    if dataclasses.is_dataclass(torch_tree):
        names = [f.name for f in dataclasses.fields(torch_tree)]
        assert set(names) == set(template._fields), (names, template._fields)
        return template._replace(**{
            n: to_jax_like(getattr(template, n), getattr(torch_tree, n))
            for n in names})
    b = to_np(torch_tree)
    assert tuple(template.shape) == b.shape, (template.shape, b.shape)
    return jnp.asarray(b.astype(template.dtype))


def jax_games_like(t_gs, size):
    """The port's GameState batch (rules included) as a katago_tpu
    GameState batch."""
    jrules = RULESETS["tromp_taylor"][0]
    g, max_hist = t_gs.ko_hash_hist.shape[:2]
    template = jax_batch(
        JH.new_game(size, JH.RulesArr.from_rules(jrules), max_hist), g)
    return to_jax_like(template, t_gs)


def flax_params(module, size, seed):
    """Seeded random parameters for a Flax KataGoModel, shaped by
    jax.eval_shape (no init compile): kernels N(0, 1/fan_in), norm gammas
    1 + N(0, 0.01), biases and betas N(0, 0.01)."""
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, size, size, 22)),
                            jnp.zeros((1, 19)))
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        z = rng.standard_normal(leaf.shape).astype(np.float32)
        if len(leaf.shape) >= 2:
            return jnp.asarray(z / np.sqrt(np.prod(leaf.shape[:-1])))
        if jax.tree_util.keystr(path).endswith("['gamma']"):
            return jnp.asarray(1.0 + 0.1 * z)
        return jnp.asarray(0.1 * z)

    return jax.tree_util.tree_map_with_path(fill, shapes)


@functools.lru_cache(maxsize=None)
def jax_fns(size: int):
    """Jitted, vmapped JAX engine functions for one board size."""
    return {
        "legal": jax.jit(jax.vmap(lambda gs: JH.legal_moves(gs, size))),
        "step": jax.jit(jax.vmap(lambda gs, m: JH.step(gs, m, size)[0])),
        "score": jax.jit(jax.vmap(lambda gs: JH.final_score(gs, size))),
    }


def _draw_moves(legal, nn, rng, pass_prob):
    """One seeded random legal move per game (a pass with pass_prob, or
    when no point is legal), as int64[g]."""
    moves = np.full((legal.shape[0],), nn, np.int64)
    for i in range(legal.shape[0]):
        on_board = np.flatnonzero(legal[i, :nn])
        if len(on_board) and rng.random() >= pass_prob:
            moves[i] = rng.choice(on_board)
    return moves


def random_games(size: int, g: int, n_moves: int, rules_name: str,
                 seed: int, pass_prob: float = 0.03, check=None):
    """Play g seeded random games of n_moves on both engines in lockstep.

    Moves are drawn with numpy from the JAX legality mask (which must equal
    the port's at every step). check(j_gs, t_gs) runs after every move.
    Returns the final (jax GameState batch, torch GameState batch)."""
    jrules, trules = RULESETS[rules_name]
    fns = jax_fns(size)
    nn = size * size
    rng = np.random.default_rng(seed)
    j_gs = jax_batch(JH.new_game(size, JH.RulesArr.from_rules(jrules), 64), g)
    t_gs = TH.new_game(size, trules, 64, g=g, device=CPU)
    for _ in range(n_moves):
        legal = np.asarray(fns["legal"](j_gs))
        np.testing.assert_array_equal(legal, to_np(TH.legal_moves(t_gs, size)))
        moves = _draw_moves(legal, nn, rng, pass_prob)
        j_gs = fns["step"](j_gs, jnp.asarray(moves.astype(np.int32)))
        t_gs, _ = TH.step(t_gs, torch.from_numpy(moves), size)
        if check is not None:
            check(j_gs, t_gs)
    return j_gs, t_gs


def tree_cat(a, b):
    """Two of the port's batched dataclass trees, concatenated on the
    game axis."""
    from katago_torch import _tensortree as T
    return T.tree_map(lambda x, y: torch.cat([x, y]), a, b)


def random_games_torch(size: int, g: int, n_moves: int, rules_name: str,
                       seed: int, pass_prob: float = 0.03):
    """g seeded random games of n_moves on the port alone (its stepping
    is held against the JAX package by random_games); returns the final
    GameState batch."""
    trules = RULESETS[rules_name][1]
    nn = size * size
    rng = np.random.default_rng(seed)
    t_gs = TH.new_game(size, trules, 64, g=g, device=CPU)
    for _ in range(n_moves):
        moves = _draw_moves(to_np(TH.legal_moves(t_gs, size)), nn, rng,
                            pass_prob)
        t_gs, _ = TH.step(t_gs, torch.from_numpy(moves), size)
    return t_gs


def _remove_libertyless_chains(board, size):
    """Empty every stone chain of a flat board that has no liberty (the
    cleaning of tests/test_chase_pallas.py, as a numpy flood fill)."""
    out = board.copy()
    seen = np.zeros(board.shape, bool)
    for start in np.flatnonzero(board):
        if seen[start]:
            continue
        chain, stack, has_lib = [], [start], False
        seen[start] = True
        while stack:
            p = stack.pop()
            chain.append(p)
            y, x = divmod(p, size)
            for q in ((p - size) if y > 0 else -1,
                      (p + size) if y + 1 < size else -1,
                      (p - 1) if x > 0 else -1,
                      (p + 1) if x + 1 < size else -1):
                if q < 0:
                    continue
                if board[q] == 0:
                    has_lib = True
                elif board[q] == board[p] and not seen[q]:
                    seen[q] = True
                    stack.append(q)
        if not has_lib:
            out[chain] = 0
    return out


def random_boards(size, g, seed, density_lo=0.15, density_hi=0.6):
    """Seeded random reachable boards (libertyless chains removed), as in
    tests/test_chase_pallas.py; returns int32[g, NN] numpy."""
    nn = size * size
    rng = np.random.default_rng(seed)
    boards = []
    for _ in range(g):
        density = rng.uniform(density_lo, density_hi)
        st = rng.choice([0, 1, 2], size=(nn,),
                        p=[1 - density, density / 2, density / 2])
        boards.append(_remove_libertyless_chains(st, size))
    return np.stack(boards).astype(np.int32)


REF_DIR = __import__("pathlib").Path(__file__).resolve().parent / \
    "data" / "torch_ref"


def load_ref(name: str):
    """A reference fixture written by tools/make_torch_fixtures.py:
    (dict of numpy arrays, meta dict)."""
    import json
    with np.load(REF_DIR / f"{name}.npz") as z:
        arrays = {k: z[k] for k in z.files}
    return arrays, json.loads(str(arrays.pop("meta")))


def flax_tree(arrays: dict, prefix: str) -> dict:
    """The nested Flax params tree of a fixture's flat "prefix/a/b/kernel"
    arrays (a "params" level under the prefix is skipped)."""
    tree: dict = {}
    for key, value in arrays.items():
        parts = key.split("/")
        if parts[0] != prefix:
            continue
        *path, leaf = parts[2:] if parts[1] == "params" else parts[1:]
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = value
    return tree


def flat_flax(state_dict: dict, prefix: str) -> dict:
    """A port state_dict in the fixtures' flat Flax form:
    {"prefix/a/b/kernel": numpy array in Flax layout}."""
    from katago_torch.models import weights as TW
    out = {}

    def walk(tree, path):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, path + [k])
            else:
                out["/".join([prefix] + path + [k])] = v
    walk(TW.to_flax_params(state_dict), [])
    return out


def ref_model(size: int, seed: int = 3, dtype=torch.float32):
    """The port's b1c6 net carrying the fixture's seeded Flax weights."""
    from katago_torch.models import config as TC
    from katago_torch.models import model as TM
    from katago_torch.models import weights as TW
    arrays, _ = load_ref(f"weights_b1c6_s{seed}")
    model = TM.KataGoModel(TC.get_config("b1c6"), pos_len=size, dtype=dtype)
    model.load_state_dict(TW.from_flax_params(flax_tree(arrays, "w")))
    return model.eval()


def random_rows(size: int, n: int, seed: int) -> dict:
    """n seeded random training rows at size x size in the reference npz
    schema (through the port's pack_rows, which is held against the JAX
    package's): every target and weight channel populated, full-board
    masks, some rows without a next-move policy target."""
    from katago_torch.dataio import trainingwrite as TTW
    rng = np.random.default_rng(seed)
    area = size * size
    spatial = (rng.random((n, size, size, 22)) < 0.2).astype(np.float32)
    spatial[..., 0] = 1.0
    next_pol = rng.dirichlet(np.ones(area + 1), n).astype(np.float32)
    next_pol[rng.random(n) < 0.25] = 0.0
    td = np.zeros((n, 5, 4), np.float32)
    td[:, :, :3] = rng.dirichlet(np.ones(3), (n, 5))
    td[:, :, 3] = rng.normal(0, 6, (n, 5))
    return TTW.pack_rows(
        spatial=spatial,
        global_in=rng.uniform(-1, 1, (n, 19)).astype(np.float32),
        policy_target=rng.dirichlet(np.ones(area + 1) * 0.3, n).astype(
            np.float32),
        next_policy_target=next_pol,
        value_target=rng.dirichlet(np.ones(3), n).astype(np.float32),
        td_targets=td,
        score_target=rng.normal(0, 6, n).astype(np.float32),
        lead_target=rng.normal(0, 6, n).astype(np.float32),
        ownership_target=rng.integers(-1, 2, (n, area)).astype(np.float32),
        self_komi=np.full(n, 7.5, np.float32),
        turn_idx=rng.integers(0, 40, n).astype(np.float32),
        visits=np.full(n, 32.0, np.float32), size=size,
        variance_time=rng.uniform(0, 5, n).astype(np.float32),
        futurepos=rng.integers(-1, 2, (n, 2, area)).astype(np.float32),
        seki_diff=rng.integers(-1, 2, (n, area)).astype(np.float32),
        scoring=rng.uniform(-1, 1, (n, area)).astype(np.float32),
        q_winloss=rng.uniform(-1, 1, (n, area + 1)).astype(np.float32),
        q_score=rng.normal(0, 0.3, (n, area + 1)).astype(np.float32),
        q_visits=rng.integers(0, 12, (n, area + 1)).astype(np.int32),
        game_hash=rng.integers(0, 2 ** 63, n, dtype=np.uint64),
        row_weight=rng.uniform(0.5, 1.0, n).astype(np.float32))


def write_shards(data_dir, size: int, rows_per_file, seed: int) -> list:
    """One npz shard per entry of rows_per_file, seeded from seed; returns
    the paths."""
    import os
    os.makedirs(data_dir, exist_ok=True)
    paths = []
    for i, n in enumerate(rows_per_file):
        path = os.path.join(str(data_dir), f"shard{i:03d}.npz")
        np.savez_compressed(path, **random_rows(size, n, seed * 1000 + i))
        paths.append(path)
    return paths


# model version -> (inputs version, sv3 channels), modelversion.cpp and
# desc.cpp:2305-2330 (the table of tests/test_desc_versions.py, 3..17)
DESC_VERSIONS = {v: ({3: 3, 4: 3, 5: 4, 6: 5, 7: 6}.get(v, 7),
                     1 if v == 3 else 2 if v <= 7 else 4 if v == 8 else 6)
                 for v in range(3, 18)}
DESC_SPATIAL = {3: 22, 4: 22, 5: 13, 6: 22, 7: 22}
DESC_GLOBAL = {3: 14, 4: 14, 5: 12, 6: 16, 7: 19}
# non-default postprocess multipliers (v13+): the rebase branches
DESC_POSTPROCESS = {13: (20.0, 24.0, 25.0, 18.0, 44.0, 0.25, 30.0),
                    14: (20.0, 20.0, 20.0, 20.0, 40.0, 0.3, 26.0)}


def write_tiny_model(path, version: int, seed: int) -> None:
    """A small valid model file in the reference's text float format for
    any version 3..17 (after tests/test_desc_versions.py's writer): an
    ordinary, a gpool and a nested-bottleneck block (one ordinary and one
    gpool block inside), relu, mish and silu activations from v11, a v15+
    pass MLP, v17 head options, and non-default postprocess multipliers
    at v13 and v14."""
    import gzip
    rng = np.random.default_rng(seed)
    iv, nsv = DESC_VERSIONS[version]
    n_sp, n_gl = DESC_SPATIAL[iv], DESC_GLOBAL[iv]
    tc, mc, gc, pc, vc, v2 = 8, 6, 4, 4, 4, 6
    npol = 1 if version < 12 else 2
    toks = []

    def t(*xs):
        toks.extend(str(x) for x in xs)

    def floats(*shape):
        w = rng.standard_normal(shape).astype(np.float32) * 0.2
        toks.extend(repr(float(x)) for x in w.reshape(-1))

    def conv(name, k, ic, oc):
        t(name, k, k, ic, oc, 1, 1)
        floats(k, k, ic, oc)

    def bn(name, c):
        t(name, c, 1e-5, 1, 1)
        floats(c)                                       # mean
        toks.extend(repr(float(v)) for v in 0.5 + rng.random(c))  # var
        floats(c)                                       # scale
        floats(c)                                       # bias

    def act(name, kind="ACTIVATION_RELU"):
        t(name)
        if version >= 11:
            t(kind)

    def matmul(name, ic, oc):
        t(name, ic, oc)
        floats(ic, oc)

    def matbias(name, c):
        t(name, c)
        floats(c)

    def ordinary(name, c, m):
        t("ordinary_block", name)
        bn(name + "pre", c)
        act(name + "preact")
        conv(name + "c1", 3, c, m)
        bn(name + "mid", m)
        act(name + "midact", "ACTIVATION_MISH")
        conv(name + "c2", 3, m, c)

    def gpool(name, c, m):
        t("gpool_block", name)
        bn(name + "pre", c)
        act(name + "preact", "ACTIVATION_SILU")
        conv(name + "c1", 3, c, m)
        conv(name + "g1", 3, c, gc)
        bn(name + "gbn", gc)
        act(name + "gact")
        matmul(name + "g2b", 3 * gc, m)
        bn(name + "mid", m)
        act(name + "midact")
        conv(name + "c2", 3, m, c)

    t("tiny", version, n_sp, n_gl)
    if version >= 13:
        t(*DESC_POSTPROCESS.get(version,
                                (20.0, 20.0, 20.0, 20.0, 40.0, 0.25, 30.0)))
    if version >= 15:
        t(0, 0, 0, 0, 0, 0, 0, 0)     # metaEncoderVersion, passAlive, 6 rsv
    t("trunk", 3, tc, mc, mc, 0, gc)
    if version >= 15:
        t(0, 0, 0, 0, 0, 0)           # norm kind + 5 reserved
    conv("initconv", 5, n_sp, tc)
    matmul("initmm", n_gl, tc)
    ordinary("b0", tc, mc)
    gpool("b1", tc, mc)
    t("nested_bottleneck_block", "b2", 2)
    bn("b2pre", tc)
    act("b2preact")
    conv("b2c1", 1, tc, mc)
    ordinary("b2s0", mc, mc)
    gpool("b2s1", mc, mc)
    bn("b2post", mc)
    act("b2postact")
    conv("b2c2", 1, mc, tc)
    bn("tipbn", tc)
    act("tipact", "ACTIVATION_MISH")
    t("policyhead")
    if version >= 17:
        t(npol, 0, 0, 0)
    conv("p1conv", 1, tc, pc)
    conv("g1conv", 1, tc, gc)
    bn("g1bn", gc)
    act("g1act")
    matmul("g2b", 3 * gc, pc)
    bn("p1bn", pc)
    act("p1act")
    conv("p2conv", 1, pc, npol)
    matmul("gpass", 3 * gc, npol)
    if version >= 15:
        matbias("passbias", npol)
        act("passact", "ACTIVATION_SILU")
        matmul("gpass2", npol, npol)
    t("valuehead")
    if version >= 17:
        t(0, 0, 0)
    conv("v1conv", 1, tc, vc)
    bn("v1bn", vc)
    act("v1act")
    matmul("v2mul", 3 * vc, v2)
    matbias("v2bias", v2)
    act("v2act")
    matmul("v3mul", v2, 3)
    matbias("v3bias", 3)
    matmul("sv3mul", v2, nsv)
    matbias("sv3bias", nsv)
    conv("ownconv", 1, vc, 1)
    with gzip.GzipFile(path, "wb", mtime=0) as f:   # stable sha256
        f.write(" ".join(toks).encode("ascii"))


def write_tiny_transformer_model(path, seed: int, spatial_rms: bool = True
                                 ) -> None:
    """A small version-17 transformer net in the reference's text float
    format with what the JAX exporter cannot write: a grouped-query
    attention block with learnable RoPE (4 heads over 2 KV heads), a
    SwiGLU FFN, an attention block with fixed RoPE (theta 50), a plain
    (relu) FFN, and the trunk-tip RMSNorm (trunk norm kind 1; spatial or
    per-position by spatial_rms)."""
    import gzip
    rng = np.random.default_rng(seed)
    tc, ffn, gc, pc, vc, v2 = 16, 24, 4, 4, 4, 6
    toks = []

    def t(*xs):
        toks.extend(str(x) for x in xs)

    def floats(*shape, scale=0.2, offset=0.0):
        w = offset + rng.standard_normal(shape).astype(np.float32) * scale
        toks.extend(repr(float(x)) for x in w.reshape(-1))

    def conv(name, k, ic, oc):
        t(name, k, k, ic, oc, 1, 1)
        floats(k, k, ic, oc)

    def bn(name, c):
        t(name, c, 1e-5, 1, 1)
        floats(c)
        toks.extend(repr(float(v)) for v in 0.5 + rng.random(c))
        floats(c)
        floats(c)

    def act(name, kind="ACTIVATION_RELU"):
        t(name, kind)

    def matmul(name, ic, oc, scale=0.2):
        t(name, ic, oc)
        floats(ic, oc, scale=scale)

    def matbias(name, c):
        t(name, c)
        floats(c)

    def trms(name, c):
        t(name, c, 1e-6)
        floats(c, scale=0.1, offset=1.0)

    def attention(name, nh, nkv, learnable):
        qd = tc // nh
        t("transformer_attention_block", name, nh, nkv, qd, qd, 1,
          1 if learnable else 0)
        trms(name + ".norm", tc)
        matmul(name + ".q", tc, nh * qd, 0.4)
        matmul(name + ".k", tc, nkv * qd, 0.4)
        matmul(name + ".v", tc, nkv * qd)
        matmul(name + ".out", nh * qd, tc)
        if learnable:
            t(name + ".rope_freqs", nkv, qd // 2, 2)
            floats(nkv, qd // 2, 2, scale=0.5)
        else:
            t(name + ".rope_theta", 50.0)

    def ffn_block(name, swiglu):
        t("transformer_ffn_block", name, tc, ffn, 1 if swiglu else 0)
        trms(name + ".norm", tc)
        matmul(name + ".l1", tc, ffn)
        if swiglu:
            matmul(name + ".lg", tc, ffn)
        matmul(name + ".l2", ffn, tc)

    t("tinytf", 17, 22, 19)
    t(20.0, 20.0, 20.0, 20.0, 40.0, 0.25, 30.0)
    t(0, 0, 0, 0, 0, 0, 0, 0)         # metaEncoderVersion, passAlive, 6 rsv
    t("trunk", 4, tc, tc, tc, 0, gc)
    t(1, 0, 0, 0, 0, 0)               # trunk norm kind 1 (RMSNorm) + 5 rsv
    conv("initconv", 3, 22, tc)
    matmul("initmm", 19, tc)
    attention("attn1", 4, 2, learnable=True)
    ffn_block("ffn1", swiglu=True)
    attention("attn2", 2, 2, learnable=False)
    ffn_block("ffn2", swiglu=False)
    t("trunkrms", tc, 1e-6, 1 if spatial_rms else 0, 0)
    floats(tc, scale=0.1, offset=1.0)                   # gamma
    floats(tc, scale=0.1)                               # beta
    act("tipact", "ACTIVATION_MISH")
    t("policyhead", 4, 0, 0, 0)
    conv("p1conv", 1, tc, pc)
    conv("g1conv", 1, tc, gc)
    bn("g1bn", gc)
    act("g1act")
    matmul("g2b", 3 * gc, pc)
    bn("p1bn", pc)
    act("p1act")
    conv("p2conv", 1, pc, 4)
    matmul("gpass", 3 * gc, 4)
    matbias("passbias", 4)
    act("passact", "ACTIVATION_SILU")
    matmul("gpass2", 4, 4)
    t("valuehead", 0, 0, 0)
    conv("v1conv", 1, tc, vc)
    bn("v1bn", vc)
    act("v1act")
    matmul("v2mul", 3 * vc, v2)
    matbias("v2bias", v2)
    act("v2act")
    matmul("v3mul", v2, 3)
    matbias("v3bias", 3)
    matmul("sv3mul", v2, 6)
    matbias("sv3bias", 6)
    conv("ownconv", 1, vc, 1)
    with gzip.GzipFile(path, "wb", mtime=0) as f:   # stable sha256
        f.write(" ".join(toks).encode("ascii"))


def desc_inputs(version: int, size: int, b: int, seed: int):
    """Seeded spatial [b, size, size, C] and global [b, G] inputs of a
    version's input planes, and a mask with the last row off-board."""
    iv = DESC_VERSIONS[version][0]
    rng = np.random.default_rng(seed)
    sp = (rng.random((b, size, size, DESC_SPATIAL[iv])) < 0.3).astype(
        np.float32)
    gl = rng.standard_normal((b, DESC_GLOBAL[iv])).astype(np.float32)
    mask = np.ones((b, size, size, 1), np.float32)
    mask[1:, -1] = 0.0
    return sp, gl, mask


# ---- scripted front-end sessions (tools/make_torch_fixtures.py gtp and
# analysis makers; tests/test_torch_{gtp,analysis}.py) --------------------

GTP_VISITS = 8


def _mirror_plays(size: int = 9, n_pairs: int = 15) -> str:
    """play commands of tests/test_mirror.py's history (white mirrors)."""
    cand = [0, 1, 2, 9, 10, 11, 18, 19, 20, 3, 12, 21, 27, 28, 29,
            4, 13, 22, 31, 36, 37]
    cols = "ABCDEFGHJ"
    out = []
    for i in range(n_pairs):
        b = cand[i % len(cand)]
        m = (size - 1 - b // size) * size + (size - 1 - b % size)
        for color, loc in (("b", b), ("w", m)):
            out.append(f"play {color} {cols[loc % size]}{size - loc // size}")
    return "\n".join(out)


GTP_SCRIPT = "\n".join([
    "protocol_version", "name", "version", "known_command genmove",
    "known_command frobnicate", "boardsize 9", "komi 6.5", "clear_board",
    "play b E5", "play w C3", "play b G7", "genmove w", "genmove b",
    "1 kata-analyze interval 0 rootInfo true pvVisits true ownership true "
    "minmoves 3",
    "kata-analyze w avoid w D4,E4 1 maxmoves 4 interval 0",
    "undo", "kata-raw-nn 0", "showboard", "debug_moves C7",
    "kata-search b", "kata-search_debug w", "genmove_analyze w 0",
    "final_score", "final_status_list alive", "final_status_list dead",
    "play b E5", "play b Z9", "play x E5", "frobnicate", "undo",
    "kata-get-rules", "kata-set-rules japanese", "kata-get-rules",
    "kata-set-rule koRule SIMPLE", "kgs-rules chinese", "kata-get-rules",
    "kata-get-komi", "komi 7.5", "get_komi",
    "kata-get-param maxVisits", "kata-set-param cpuctExploration 0.9",
    "kata-get-param cpuctExploration", "kata-get-param frobnicate",
    "kata-set-params {\"antiMirror\": true, \"maxVisits\": 16}",
    "kata-get-params", "kata-list-params", "kata-get-models",
    "kata-raw-human-nn", "printsgf",
    "clear_board", "fixed_handicap 2", "showboard",
    "clear_board", "place_free_handicap 2", "showboard",
    "clear_board", "set_free_handicap C3 G7", "genmove w",
    "kata-set-position b A1 w B2 b C3", "showboard",
    "kata-set-position b A1 w A2 b", "kata-set-position b A1 b A1",
    "boardsize 25", "rectangular_boardsize 9 7", "showboard",
    "genmove b", "boardsize 9",
    "clear_board", _mirror_plays(), "genmove b", "genmove w",
    "kata-debug-print-tc", "time_settings 60 5 1", "kata-debug-print-tc",
    "kata-time_settings fischer 30 2", "kata-debug-print-tc",
    "kata-time_settings fischer-capped 30 2 60 10", "kata-debug-print-tc",
    "kata-time_settings byoyomi 30 5 3", "kata-debug-print-tc",
    "time_left b 20 0", "kata-debug-print-tc",
    "kgs-time_settings canadian 30 10 5", "kata-debug-print-tc",
    "kata-time_settings sundial 1", "kata-list-time-settings",
    "kata-time_settings none", "kata-debug-print-tc",
    "stop", "clear_cache", "quit"]) + "\n"

GTP_CONFIG = """# GTP config for the main() session
maxVisits = 12
rules = japanese
komi = 6.5
cpuctExploration = 1.1
rootEndingBonusPoints = 0.4
lagBuffer = 0.5
ponderingEnabled = false
allowResignation = true
numSearchThreads = 8
"""

GTP_MAIN_SCRIPT = "\n".join([
    "kata-get-rules", "get_komi", "kata-get-param maxVisits",
    "kata-get-param cpuctExploration", "kata-get-param lagBuffer",
    "play b D5", "genmove w", "genmove b", "showboard", "quit"]) + "\n"

_Q1 = {"id": "q1", "moves": [["B", "C3"], ["W", "B2"], ["B", "D4"]],
       "rules": "tromp-taylor", "komi": 7.5, "boardXSize": 5,
       "boardYSize": 5, "analyzeTurns": [1, 2, 3], "maxVisits": 8}

ANALYSIS_SCRIPTS = {"main": "\n".join([
    __import__("json").dumps(q) for q in [
        _Q1,
        {"id": "q2", "moves": [["B", "C3"]], "boardXSize": 5,
         "maxVisits": 8, "includeOwnership": True,
         "includeOwnershipStdev": True, "includeMovesOwnership": True,
         "includeMovesOwnershipStdev": True, "includePVVisits": True,
         "includePolicy": True,
         "avoidMoves": [{"player": "W", "moves": ["B2", "D4"],
                         "untilDepth": 1}]},
        {"id": "q3", "moves": [["B", "B3"]], "boardXSize": 5,
         "maxVisits": 12, "reportDuringSearchEvery": 1e-6},
        {"id": "q4", "moves": [["B", "C3"]], "boardXSize": 5,
         "maxVisits": 6, "allowMoves": [{"player": "W",
                                          "moves": ["B2", "D4", "pass"],
                                          "untilDepth": 1}]},
        {"id": "q5", "action": "query_version"},
        {"id": "q6", "action": "query_models"},
        {"id": "q7", "moves": [], "boardXSize": 5, "maxVisits": 6,
         "priority": 5, "overrideSettings": {"cpuctExploration": 0.8,
                                             "bogusKey": 1},
         "bogusField": 1},
        {"id": "q8", "moves": [["B", "C3"]], "boardXSize": 5,
         "analyzeTurns": [5]},
        {"moves": []},
        {"id": "q9", "moves": [["B", "C3"], ["W", "C4"]],
         "rules": "japanese", "boardXSize": 5, "maxVisits": 8},
        {"id": "t1", "action": "terminate", "terminateId": "q9"},
        {"id": "t2", "action": "terminate"},
        {"id": "q10", "moves": [["B", "C3"], ["W", "C4"]],
         "rules": "japanese", "boardXSize": 5, "maxVisits": 8,
         "initialStones": [["W", "A1"]], "komi": 6.5,
         "includePolicy": True},
        dict(_Q1, id="q11"),
    ]] + ["{not json", ""])}


# the root extras fixture (tools/make_torch_fixtures.py search_extras)
EXTRAS_MASK_AVOID = [6, 7, 12, 13, 18]     # game 0: avoided root moves
EXTRAS_MASK_ALLOW = [0, 1, 3, 9, 14, 15, 21, 23, 24, 25]   # game 1 only


def extras_mask(size):
    nn = size * size
    mask = np.ones((2, nn + 1), bool)
    mask[0, EXTRAS_MASK_AVOID] = False
    mask[1, :] = False
    mask[1, EXTRAS_MASK_ALLOW] = True
    return mask


def mirror_history(size, n_pairs):
    """tests/test_mirror.py's history: black plays, white mirrors."""
    def mirror_loc(loc):
        return (size - 1 - loc // size) * size + (size - 1 - loc % size)
    cand = [0, 1, 2, 9, 10, 11, 18, 19, 20, 3, 12, 21, 27, 28, 29,
            4, 13, 22, 31, 36, 37]
    moves, plas = [], []
    for i in range(n_pairs):
        b = cand[i % len(cand)]
        moves += [b, mirror_loc(b)]
        plas += [1, 2]
    return moves, plas


# ---- net families (tools/make_torch_fixtures.py models / nets_train /
# desc_tf makers; tests/test_torch_nets.py) -------------------------------

_NET_BASE = dict(trunk_num_channels=12, mid_num_channels=8,
                 gpool_num_channels=4, p1_num_channels=4, g1_num_channels=4,
                 v1_num_channels=4, v2_size=8, sbv2_num_channels=8,
                 num_scorebeliefs=2)
_TF = dict(version=17, transformer_ffn_channels=16, transformer_heads=3,
           transformer_kv_heads=3)
_GAB = dict(gab_num_templates=6, gab_num_fourier_features=4,
            gab_mlp_hidden=10, gab_d1=6, gab_d2=5)

# one small config per block kind and extra: ModelConfig fields (the
# name is the key); head dims are multiples of 4 for the 2-D RoPE
NET_KINDS = {
    "bottle": dict(_NET_BASE,
                   block_kind=("bottle1", "bottle2gpool", "bottle3")),
    "attn_ffn": dict(_NET_BASE, **_TF,
                     block_kind=("attn", "ffng", "attnrope", "ffnsg")),
    "qknorm_gqa": dict(_NET_BASE, **dict(_TF, transformer_heads=4,
                                         transformer_kv_heads=2),
                       trunk_num_channels=16, attention_qk_norm=True,
                       block_kind=("attnrope", "ffnsg", "attnrope", "ffng")),
    "nbttf_rope": dict(_NET_BASE, **dict(_TF, transformer_heads=2,
                                         transformer_kv_heads=2),
                       block_kind=("bottlenest2transformerropesg",
                                   "regulargpool")),
    "nbttf_gab": dict(_NET_BASE, **dict(_TF, transformer_heads=2,
                                        transformer_kv_heads=1), **_GAB,
                      block_kind=("bottlenest2transformergabsg",) * 2),
    "metadata": dict(_NET_BASE, metadata_encoder=True,
                     metadata_encoder_channels=10,
                     block_kind=("regular", "bottlenest2gpool")),
    "intermediate_mid": dict(_NET_BASE, has_intermediate_head=True,
                             intermediate_head_blocks=1,
                             block_kind=("regular", "regulargpool")),
    "intermediate_end": dict(_NET_BASE, has_intermediate_head=True,
                             intermediate_head_blocks=2,
                             block_kind=("regular", "regulargpool")),
}

# the trainer's net family case: nbttf-GAB with QK-norm GQA and a
# mid-trunk intermediate head (its losses, gradients and steps)
NET_TRAIN = dict(_NET_BASE, **dict(_TF, transformer_heads=2,
                                   transformer_kv_heads=1), **_GAB,
                 trunk_num_channels=16, attention_qk_norm=True,
                 has_intermediate_head=True, intermediate_head_blocks=1,
                 block_kind=("bottlenest2transformergabsg", "regulargpool",
                             "attnrope", "ffnsg"))


def net_config(module, kind: str, fields: dict | None = None):
    """A NET_KINDS (or given) config as `module`.ModelConfig."""
    return module.ModelConfig(name=kind, **(fields or NET_KINDS[kind]))


def net_params(cfg, size: int, seed: int) -> dict:
    """Seeded random Flax params of KataGoModel(cfg) (the dict under
    "params"), numpy leaves, shaped by jax.eval_shape: kernels
    N(0, 1/fan_in), gammas and RMSNorm scales 1 + N(0, 0.01), GAB
    frequencies geometric times 1 + N(0, 0.01), biases and betas
    N(0, 0.01)."""
    from katago_tpu.models.model import KataGoModel
    module = KataGoModel(cfg, pos_len=size, dtype=jnp.float32)
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, size, size, 22)),
                            jnp.zeros((1, 19)))["params"]
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        z = rng.standard_normal(leaf.shape).astype(np.float32)
        name = jax.tree_util.keystr(path)
        if len(leaf.shape) >= 2:
            return z / np.float32(np.sqrt(np.prod(leaf.shape[:-1])))
        if name.endswith(("['gamma']", "['scale']")):
            return 1.0 + 0.1 * z
        if name.endswith("['freqs']"):
            geo = np.exp(np.linspace(0.0, np.log(1.0 / 50.0), leaf.shape[0]))
            return (geo * (1.0 + 0.1 * z)).astype(np.float32)
        return 0.1 * z

    return jax.tree_util.tree_map_with_path(fill, shapes)


def net_inputs(size: int, b: int, seed: int):
    """Seeded spatial [b, size, size, 22], global [b, 19], a mask with the
    last row of every board but the first off-board, and metadata
    [b, 192]."""
    rng = np.random.default_rng(seed)
    sp = (rng.random((b, size, size, 22)) < 0.3).astype(np.float32)
    gl = rng.standard_normal((b, 19)).astype(np.float32)
    mask = np.ones((b, size, size, 1), np.float32)
    mask[1:, -1] = 0.0
    sp[..., 0] = mask[..., 0]
    meta = rng.standard_normal((b, 192)).astype(np.float32)
    return sp, gl, mask, meta


# ---- humanSL, V3-V6 and pattern-bonus sessions (tools/make_torch_
# fixtures.py humansl, vnets and pattern_search makers;
# tests/test_torch_humansl.py) ----------------------------------------------

HUMANSL_MODEL = "humansl_b1c6.bin.gz"   # b1c6 + metadata encoder, seeded
HUMANSL_SIZE = 9

HUMANSL_GTP_CONFIG = """# humanSL GTP config: profile and avoid-repeated-shapes
maxVisits = 8
humanSLProfile = rank_5d
avoidRepeatedPatternUtility = 0.3
rootNoiseEnabled = false
"""

HUMANSL_GTP_SCRIPT = "\n".join([
    "boardsize 9", "play b E5", "play w C3", "play b G7", "play w C7",
    "genmove b", "genmove w", "kata-raw-human-nn", "kata-raw-nn",
    "kata-get-models", "undo", "kata-raw-human-nn", "quit"]) + "\n"

HUMANSL_ANALYSIS_SCRIPT = "\n".join(__import__("json").dumps(q) for q in [
    {"id": "h1", "moves": [["B", "E5"], ["W", "C3"]], "boardXSize": 9,
     "maxVisits": 8, "includePolicy": True,
     "overrideSettings": {"humanSLProfile": "rank_5d"}},
    {"id": "h2", "moves": [["B", "E5"]], "boardXSize": 9, "maxVisits": 6,
     "overrideSettings": {"humanSLProfile": "preaz_9d"}},
    {"id": "h3", "moves": [["B", "C3"]], "boardXSize": 9, "maxVisits": 6},
]) + "\n"

_SGFMETA = {"inverseBRank": 5, "inverseWRank": 4, "bIsHuman": True,
            "wIsHuman": True, "gameRatednessIsUnknown": True,
            "tcIsByoYomi": True, "mainTimeSeconds": 1200,
            "periodTimeSeconds": 30, "byoYomiPeriods": 5,
            "gameDate": "2021-03-01", "source": 2}

HUMANSL_SERVER_SCRIPT = "\n".join(__import__("json").dumps(q) for q in [
    {"command": "start", "board_x_size": 9, "board_y_size": 9,
     "rules": "japanese"},
    {"command": "play", "pla": 1, "loc": 40},
    {"command": "play", "pla": 2, "loc": 20},
    {"command": "get_model_outputs", "sgfmeta": _SGFMETA},
    {"command": "undo"},
    {"command": "get_model_outputs", "sgfmeta": dict(
        _SGFMETA, inverseWRank=12, source=1, tcIsByoYomi=False)},
    {"command": "redo"},
    {"command": "get_model_outputs", "sgfmeta": {}},
    {"command": "frobnicate"},
    {"command": "start", "board_x_size": 9, "board_y_size": 7},
]) + "\n"

# tiny reference nets of model versions 3, 5, 6, 7 (input features V3,
# V4, V5, V6; write_tiny_model(path, version, seed=version))
VNET_VERSIONS = (3, 5, 6, 7)
VNET_SIZE = 5
VNET_GTP_SCRIPT = "\n".join([
    "boardsize 5", "play b C3", "play w B2", "genmove b", "genmove w",
    "kata-get-models", "quit"]) + "\n"
VNET_ANALYSIS_SCRIPT = __import__("json").dumps(
    {"id": "v", "moves": [["B", "C3"], ["W", "B2"]], "boardXSize": 5,
     "maxVisits": 8, "reportDuringSearchEvery": 1e-6}) + "\n"

# the pattern-bonus search: one 5x5 game's moves before the root, moves
# the root player made from the root position before (as a table loaded
# from earlier games holds them: on 5x5 the 9x9 window covers the whole
# board, so a game's own earlier shapes never recur), and the
# avoidRepeatedPatternUtility of the table built from both
PATTERN_MOVES = [12, 6, 8, 16, 18, 7, 11, 13, 17]
PATTERN_REPEAT = [23, 0, 21]
PATTERN_UTILITY = 0.5


def pattern_history(boards: list, plas: list, root_board, pla_for: int):
    """(boards before, moves, movers) of the pattern table: the game's
    moves, then PATTERN_REPEAT played by pla_for from the root board."""
    k = len(PATTERN_REPEAT)
    return (boards + [root_board] * k, PATTERN_MOVES + PATTERN_REPEAT,
            plas + [pla_for] * k)


# ---- slice 7: match, gatekeeper and the tools ---------------------------

# both match engines sample their moves at temperature 0.2 / 0.6 from a
# JAX key or a torch generator; the fixtures and the tests replace the
# match module's SearchParams with temperature_zero(SearchParams), so each
# game takes its most visited move and the records can be compared
TEMPERATURE_ZERO = {"chosen_move_temperature": 0.0,
                    "chosen_move_temperature_early": 0.0}


def temperature_zero(search_params_cls):
    def make(**kw):
        return search_params_cls(**dict(kw, **TEMPERATURE_ZERO))
    return make


# b1c6 nets with the weights of these flax_params seeds (3 and 4 are the
# weights_b1c6_s* fixtures; 5 is stored in match.npz)
MATCH_SEEDS = (3, 4, 5)
MATCH_ARGS = {"size": 5, "num_games": 2, "visits": 2, "seed": 0,
              "max_moves": 8}
# play_round_robin has no max_moves: the fixture and the test cut its
# matches by binding max_moves into the module's play_match
ROUND_ROBIN_ARGS = {"size": 5, "games_per_pair": 2, "visits": 2, "seed": 0}
ROUND_ROBIN_MAX_MOVES = 4
# run_gatekeeper calls (candidates, win_threshold): "cand-a" meets an
# empty models dir, "cand-b" and "cand-c" each play the newest champion
# (matches cut at GATE_MAX_MOVES); at temperature 0 both score 0.5, so
# the third call's threshold rejects its candidate
GATE_ARGS = {"size": 5, "config_name": "b1c6", "games": 2, "visits": 2}
GATE_MAX_MOVES = 6
GATE_CANDIDATES = {"cand-a": 3, "cand-b": 4, "cand-c": 5}
GATE_CALLS = [(["cand-a"], 0.5), (["cand-b"], 0.5), (["cand-c"], 0.75)]

# a 9x9 game with a setup stone for forward_cmd -sgf and evalsgf
TOOLS_SGF = ("(;GM[1]FF[4]SZ[9]KM[6.5]AB[ii]"
             ";B[ee];W[cc];B[gc];W[cg];B[gg];W[ce];B[ec];W[dd];B[eg]"
             ";W[ge];B[dg];W[fc];B[cf];W[hd])")
FORWARD_CASES = {"empty": ["-size", "9", "-full"],
                 "sgf": ["-sgf", "{sgf}", "-turn", "10", "-full"]}
EVALSGF_CASES = {"turn10": ["-move-num", "10"], "end": []}
EVALSGF_VISITS = 16
PLAY_ARGS = ["-size", "5", "-visits", "8"]
PLAY_INPUTS = ["C3", "genmove", "policy"]


def scripted_input(lines):
    """An input() that answers with `lines` in turn, echoing prompt and
    answer as a terminal shows them, then raises EOFError."""
    it = iter(lines)

    def fake(prompt=""):
        line = next(it, None)
        if line is None:
            print(prompt)
            raise EOFError
        print(prompt + line)
        return line
    return fake


# ---- SGF corpus of the SGF tools (tests/test_torch_sgftools.py) --------
SGF_SIZE = 7
SGF_SEED = 11


def _random_line(size: int, n_moves: int, rng, pass_at=(), setup=(),
                 prefix=()):
    """n_moves seeded random legal moves on the port's engine (CPU) from
    the setup stones and after the moves of prefix; a pass at each turn
    in pass_at. Returns [(player, loc)] of the new moves, the players
    alternating from black at the first move of prefix."""
    from katago_torch.game import board as TB
    nn = size * size
    gs = TH.new_game(size, TR.Rules.tromp_taylorish(), 2 * nn + 32,
                     device=CPU)
    for color, loc in setup:
        gs = TH.setup_stone(gs, loc, color, size)
    for pla, loc in prefix:
        gs, _ = TH.step(gs, torch.tensor([loc]), size)
    moves = []
    for t in range(len(prefix), len(prefix) + n_moves):
        legal = to_np(TH.legal_moves(gs, size))[0, :nn]
        on_board = np.flatnonzero(legal)
        loc = nn if t in pass_at or not len(on_board) else \
            int(rng.choice(on_board))
        moves.append((TB.BLACK if t % 2 == 0 else TB.WHITE, loc))
        gs, _ = TH.step(gs, torch.tensor([loc]), size)
    return moves


def _sgf_text(size: int, moves, *, result: str, black: str, white: str,
              komi: float = 7.5, comments=None, setup=(), handicap: int = 0,
              branches=()) -> str:
    """An SGF of moves (comment text on the nodes of comments' move
    indices) whose last node splits into the given branches."""
    from katago_torch.dataio import sgf as TS
    head = TS.write_sgf([], size, size, komi=komi, result=result,
                        handicap=handicap, setup=list(setup),
                        black_name=black, white_name=white)[:-1]

    def nodes(line, start=0):
        out = []
        for i, (pla, loc) in enumerate(line):
            c = (comments or {}).get(start + i)
            out.append(f";{'B' if pla == 1 else 'W'}"
                       f"[{TS.write_sgf_loc(loc, size, size)}]"
                       + (f"C[{c}]" if c else ""))
        return "".join(out)

    return head + nodes(moves) + "".join(
        f"({nodes(b, len(moves))})" for b in branches) + ")"


@functools.lru_cache(maxsize=None)
def sgf_corpus(size: int = SGF_SIZE, seed: int = SGF_SEED) -> dict:
    """{file name: SGF text}: seeded random legal games at size x size
    with names, results (B+, W+R, W+ with handicap and setup stones, a
    draw), %SAMPLE% / %NOSAMPLE% comments, a pass, a game with two
    variations, and a 9x9 game the size filters skip. Cached: callers
    must not change it."""
    rng = np.random.default_rng(seed)
    nn = size * size
    out = {}
    out["g0.sgf"] = _sgf_text(size, _random_line(size, 30, rng),
                              result="B+3.5", black="alice", white="bob",
                              comments={5: "%SAMPLE%", 9: "%NOSAMPLE%",
                                        14: "%SAMPLE%"})
    out["g1.sgf"] = _sgf_text(size, _random_line(size, 26, rng,
                                                 pass_at=(11,)),
                              result="W+R", black="bob", white="carol")
    setup = [(1, 8), (1, nn - 9)]
    out["g2.sgf"] = _sgf_text(size, _random_line(size, 22, rng,
                                                 setup=setup),
                              result="W+12", black="carol", white="alice",
                              komi=0.5, setup=setup, handicap=2)
    out["g3.sgf"] = _sgf_text(size, _random_line(size, 28, rng),
                              result="0", black="alice", white="carol")
    trunk = _random_line(size, 24, rng)
    out["g4.sgf"] = _sgf_text(
        size, trunk[:16], result="B+R", black="bob", white="alice",
        branches=[trunk[16:], _random_line(size, 4, rng,
                                           prefix=trunk[:16])])
    out["g5.sgf"] = _sgf_text(9, _random_line(9, 8, rng), result="W+1",
                              black="dave", white="alice")
    return out

# sgf_cmds runs of the sgftools fixture: argv with {sgf} the corpus
# directory, {out} the case's output directory, {model} b1c6_s3.bin.gz
_DM = ["dataminesgfs", "--sgfdir", "{sgf}", "--outdir", "{out}",
       "--model", "{model}", "--size", "7"]
SGF_TOOL_CASES = {
    "writetrainingdata": ["writetrainingdata", "-sgf-dir", "{sgf}",
                          "-output", "{out}/rows.npz", "-size", "7"],
    "writetrainingdata_cut": ["writetrainingdata", "-sgf-dir", "{sgf}",
                              "-output", "{out}/rows.npz", "-size", "7",
                              "-max-rows", "40", "-no-ladders"],
    "startposes": ["startposes", "-sgf-dir", "{sgf}", "-output",
                   "{out}/poses.jsonl", "-sample-prob", "0.2", "-seed",
                   "3"],
    "samplesgfs": ["samplesgfs", "--sgfdir", "{sgf}", "--outdir", "{out}",
                   "--sample-prob", "0.25", "--seed", "1"],
    "samplesgfs_weighted": [
        "samplesgfs", "--sgfdir", "{sgf}", "--outdir", "{out}",
        "--sample-prob", "0.5", "--turn-weight-lambda", "0.05",
        "--after-pass-factor", "0.3", "--min-weight", "0.4",
        "--force-sample-weight", "3", "--min-turn-number-board-area-prop",
        "0.1", "--max-turn-number-board-area-prop", "0.5",
        "--max-handicap", "1", "--seed", "2"],
    "datamine_game": _DM + ["--game-mode", "--seed", "5", "--visits", "8",
                            "--min-turn", "22"],
    "datamine_tree": _DM + ["--tree-mode", "--max-policy", "0.04",
                            "--turn-weight-lambda", "0.01", "--visits",
                            "8", "--min-turn", "20"],
    "datamine_surprise": _DM + ["--surprise-mode", "--surprise-sample-prob",
                                "0.5", "--utility-threshold", "0.02",
                                "--visits", "16", "--min-turn", "16"],
}
# viewstartposes / checksgfhintpolicy on the pose files a case wrote
SGF_VIEW_CASES = {
    "startposes": {"view_startposes": ["viewstartposes", "--min-weight",
                                       "0.5"],
                   "check_startposes": ["viewstartposes",
                                        "--check-legality"]},
    "samplesgfs_weighted": {"view_weighted": ["viewstartposes", "--idx",
                                              "2"]},
}
# checksgfhintpolicy on the hint poses of startposes
SGF_VIEW_CASES["startposes"]["hint_policy"] = [
    "checksgfhintpolicy", "--model", "{model}"]
NPZ_PROFILES = ("", "rank_5d")

# genposes_cmd runs of the genposes fixture (7x7, b1c6_s3.bin.gz)
GENPOSES_ARGS = {"size": 7, "n": 12, "min_moves": 4, "max_moves": 14,
                 "seed": 4, "max_score": 30.0, "pickiness": 0.5}


def genposes_argv(out: str, model: str, mode: str) -> list:
    a = GENPOSES_ARGS
    return ["-out", out, "-n", str(a["n"]), "-size", str(a["size"]),
            "-mode", mode, "-min-moves", str(a["min_moves"]), "-max-moves",
            str(a["max_moves"]), "-model", model, "-seed", str(a["seed"]),
            "-max-score", str(a["max_score"]),
            "-score-rejection-pickiness", str(a["pickiness"])]


# the genboard fixture's net, inputs and training run
GENBOARD_NET = {"size": 7, "channels": 8, "blocks": 5, "seed": 1,
                "batch": 6, "fill_batch": 2, "fill_seed": 3}
GENBOARD_TRAIN = {"size": 7, "channels": 8, "blocks": 4, "steps": 2,
                  "batch": 6, "lr": 0.01, "seed": 2}


def genboard_inputs(size: int, b: int, seed: int) -> dict:
    """Seeded GenBoard inputs: boards, known masks (some unknown),
    inference points, turn / noise / source values and point labels."""
    rng = np.random.default_rng(seed)
    nn = size * size
    stones = rng.integers(0, 3, (b, nn)).astype(np.int32)
    known = rng.random((b, nn)) < 0.6
    points = rng.integers(0, nn, b).astype(np.int32)
    return {"stones": stones, "known": known, "points": points,
            "turn": rng.uniform(0, 80, b).astype(np.float32),
            "stdev": rng.uniform(0, 20, b).astype(np.float32),
            "source": rng.integers(0, 2, b).astype(np.float32),
            "labels": stones[np.arange(b), points]}


def genboard_pattern(size: int, b: int):
    """b copies of a board pattern with a known corner and a known
    centre point and the rest unknown: (stones int32[b, NN],
    known bool[b, NN])."""
    nn = size * size
    stones = np.zeros((b, nn), np.int32)
    known = np.zeros((b, nn), bool)
    known[:, :size + 2] = True
    stones[:, 1], stones[:, size] = 1, 2
    known[:, nn // 2] = True
    stones[:, nn // 2] = 1
    return stones, known


# the book fixture: gen_book at 5x5 and book_cmd's host commands on it
BOOK_ARGS = {"visits": 8, "rounds": 2, "nodes_per_round": 4}
BOOK_CMD_CASES = {
    "checkbook": ["checkbook", "-book", "{book}"],
    "booktoposes": ["booktoposes", "-book", "{book}", "-out-dir", "{out}",
                    "-enable-hints", "-depth-weight", "1.5",
                    "-depth-weight-scale", "2", "-policy-surprise-weight",
                    "0.3", "-min-weight", "1.2"],
    "findbookbottlenecks": ["findbookbottlenecks", "-book", "{book}",
                            "-out", "{out}/bottlenecks.jsonl",
                            "-winloss-delta", "0.01"],
    "comparebooks": ["comparebooks", "-book", "{book}", "-book2",
                     "{book2}"],
}


def book_hash_boards(n: int = 6, seed: int = 9) -> list:
    """[(the 8 dihedral images of a seeded random board, player)]."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        size = (5, 7, 9)[i % 3]
        b = rng.integers(0, 3, (size, size)).astype(np.int8)
        syms = []
        for k in range(4):
            r = np.rot90(b, k)
            syms += [np.ascontiguousarray(r), np.ascontiguousarray(r.T)]
        out.append((syms, 1 + i % 2))
    return out


# the fused fixture: one actor chunk and one learner step at 5x5
FUSED_ARGS = {"games": 4, "over": [1], "max_moves": 24, "komi_stdev": 1.0,
              "komi_seed": 3, "capacity": 8, "visits": 8, "moves": 3,
              "batch": 8, "lr": 1e-3}

# a malformed SGF line (the native scanner of the JAX package accepts it)
SGF_BROKEN = "(;SZ[7]broken"
