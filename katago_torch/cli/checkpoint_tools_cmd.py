"""Checkpoint utilities — clean / show / edit / migrate / import-jax
(python/clean_checkpoint.py, edit_checkpoint.py, migrate_*.py); port of
katago_tpu/cli/checkpoint_tools_cmd.py on the port's own checkpoint
format (train/checkpoint.py: a state.pt of torch.save'd dicts beside
train_metadata.json). A JAX orbax checkpoint is read only through the
npz that tools/jax_checkpoint_to_npz.py writes beside the JAX package.

  clean    strip a full TrainState checkpoint down to a params-only
           export for release (reference clean_checkpoint.py: drop
           optimizer state, keep the EMA or the SWA weights); -bin-gz
           also writes the reference engine's .bin.gz
  show     print metadata, step, and per-tree parameter counts
  edit     set keys in the sidecar train_metadata.json
           (edit_checkpoint.py)
  migrate  upgrade an old-layout checkpoint to the current TrainState
           (the migrate_*.py family): fills fields the old format
           lacked (swa_params := ema_params, a fresh seki_ema) and
           rewrites it
  import-jax  a JAX trainer's checkpoint, flattened by
           tools/jax_checkpoint_to_npz.py (F and its metadata F.json),
           as the port's checkpoint
           D/step_N/{state.pt,train_metadata.json} (N its global_step;
           the metadata, data_serve_state included, carried over, its
           data paths moved to -data-dir when given), from which
           train_cmd -ckpt-dir D resumes

Usage:
  python -m katago_torch.cli.checkpoint_tools_cmd clean -ckpt C -out DIR
      -name NAME [-config b2c16] [-size 19] [-use-swa] [-bin-gz]
  python -m katago_torch.cli.checkpoint_tools_cmd show -ckpt C
  python -m katago_torch.cli.checkpoint_tools_cmd edit -ckpt C -set k=v ...
  python -m katago_torch.cli.checkpoint_tools_cmd migrate -ckpt C
      [-config b2c16] [-size 19]
  python -m katago_torch.cli.checkpoint_tools_cmd import-jax -npz F
      -ckpt-dir D -config C -size S -optimizer K [-data-dir DIR]

The tools move tensors between files only, on the host.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from katago_torch.train import checkpoint as C


def _param_count(tree) -> int:
    """Elements of every tensor in a nested dict (an int counts one)."""
    if isinstance(tree, torch.Tensor):
        return tree.numel()
    if isinstance(tree, dict):
        return sum(_param_count(v) for v in tree.values())
    return 1 if isinstance(tree, (int, float)) else 0


def _template_params(config_name: str, size: int) -> tuple[dict, object]:
    """(the named net's parameters on the CPU, as the trainer's
    checkpoints hold them, and its ModelConfig)."""
    from katago_torch.models import config as MC
    from katago_torch.models import model as M
    cfg = MC.get_config(config_name)
    model = M.KataGoModel(cfg, size, torch.float32)
    return {k: v.detach() for k, v in model.named_parameters()}, cfg


def cmd_show(args):
    tree = C.load_state_tree(args.ckpt)
    out = {"metadata": C.load_metadata(args.ckpt)}
    for k, v in tree.items():
        if k == "step":
            out["step"] = int(v)
        elif k in ("params", "ema_params", "swa_params", "opt_state"):
            out[f"{k}_count"] = _param_count(v)
    print(json.dumps(out, indent=2, default=str))


def cmd_edit(args):
    meta_path = os.path.join(args.ckpt, "train_metadata.json")
    meta = {}
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
    for kv in args.set or []:
        k, v = kv.split("=", 1)
        try:
            meta[k] = json.loads(v)
        except json.JSONDecodeError:
            meta[k] = v
    with open(meta_path, "w") as f:
        json.dump(meta, f)
    print(json.dumps({"edited": meta_path, "metadata": meta}))


def cmd_clean(args):
    template, cfg = _template_params(args.config, args.size)
    tree = C.load_state_tree(args.ckpt)
    params = tree["swa_params" if args.use_swa else "ema_params"]
    C.check_keys("params", template, params)
    path = C.export_params(args.out, args.name, params)
    result = {"export": path, "params": _param_count(params),
              "source_step": int(tree["step"])}
    if args.bin_gz:
        result["bin_gz"] = C.export_bin_gz(args.out, args.name, params, cfg)
    print(json.dumps(result))


def cmd_migrate(args):
    """Fill fields an old checkpoint layout lacked and rewrite in place
    (migrate_*.py family). Currently: missing swa_params -> copy of
    ema_params; missing seki_ema -> fresh; metadata untouched."""
    from katago_torch.train.losses import SekiEma
    from katago_torch.train.train_step import TrainState
    tree = C.load_state_tree(args.ckpt)
    if not isinstance(tree, dict) or "params" not in tree:
        raise SystemExit("not a TrainState checkpoint")
    changed = []
    if tree.get("swa_params") is None:
        tree["swa_params"] = tree.get("ema_params", tree["params"])
        changed.append("swa_params")
    if tree.get("seki_ema") is None:
        tree["seki_ema"] = SekiEma.init()._asdict()
        changed.append("seki_ema")
    if not changed:
        print(json.dumps({"migrated": [], "note": "already current"}))
        return
    # the params must be the named net's
    template, _ = _template_params(args.config, args.size)
    C.check_keys("params", template, tree["params"])
    state = TrainState(
        params=tree["params"], opt_state=tree["opt_state"],
        ema_params=tree["ema_params"], swa_params=tree["swa_params"],
        step=int(tree["step"]),
        seki_ema=SekiEma(sum=tree["seki_ema"]["sum"],
                         weight=tree["seki_ema"]["weight"]))
    meta = C.load_metadata(args.ckpt)
    out_dir = os.path.dirname(os.path.abspath(args.ckpt))
    path = C.save_checkpoint(out_dir, state, state.step,
                             keep=10**9, metadata=meta or None)
    print(json.dumps({"migrated": changed, "rewritten": path}))


def _rebase_serve_state(meta: dict, data_dir: str) -> dict:
    """meta with the paths of its data_serve_state moved from the JAX
    run's data directory (the newest of old_train_data_dirs) to
    data_dir: a run resumed on another machine serves the same files in
    the same order."""
    serve = meta.get("data_serve_state")
    if not serve or not serve.get("old_train_data_dirs"):
        return meta
    old = serve["old_train_data_dirs"][-1]

    def move(path):
        if path == old:
            return data_dir
        if path.startswith(old.rstrip("/") + "/"):
            return os.path.join(data_dir, path[len(old.rstrip("/")) + 1:])
        return path
    return dict(meta, data_serve_state={
        k: [move(p) for p in v] if isinstance(v, list) else v
        for k, v in serve.items()})


def cmd_import_jax(args):
    from katago_torch.train.train_step import (init_train_state,
                                               make_optimizer)
    template, _ = _template_params(args.config, args.size)
    state_template = init_train_state(template, make_optimizer(
        kind=args.optimizer))
    with np.load(args.npz) as z:
        arrays = {k: z[k] for k in z.files}
    state = C.import_jax_state(arrays, state_template)
    with open(args.npz + ".json") as f:
        meta = json.load(f)
    if args.data_dir:
        meta = _rebase_serve_state(meta, os.path.abspath(args.data_dir))
    step = int(meta.get("global_step", state.step))
    path = C.save_checkpoint(args.ckpt_dir, state, step, metadata=meta)
    print(json.dumps({"imported": args.npz, "checkpoint": path,
                      "step": state.step, "global_step": step,
                      "params": _param_count(state.params)}))


def main(argv=None):
    ap = argparse.ArgumentParser()
    sub = ap.add_subparsers(dest="command", required=True)
    p = sub.add_parser("show")
    p.add_argument("-ckpt", required=True)
    p.set_defaults(fn=cmd_show)
    p = sub.add_parser("edit")
    p.add_argument("-ckpt", required=True)
    p.add_argument("-set", action="append")
    p.set_defaults(fn=cmd_edit)
    p = sub.add_parser("clean")
    p.add_argument("-ckpt", required=True)
    p.add_argument("-out", required=True)
    p.add_argument("-name", required=True)
    p.add_argument("-config", default="b2c16")
    p.add_argument("-size", type=int, default=19)
    p.add_argument("-use-swa", action="store_true")
    p.add_argument("-bin-gz", action="store_true")
    p.set_defaults(fn=cmd_clean)
    p = sub.add_parser("migrate")
    p.add_argument("-ckpt", required=True)
    p.add_argument("-config", default="b2c16")
    p.add_argument("-size", type=int, default=19)
    p.set_defaults(fn=cmd_migrate)
    p = sub.add_parser("import-jax")
    p.add_argument("-npz", required=True)
    p.add_argument("-ckpt-dir", required=True)
    p.add_argument("-config", required=True)
    p.add_argument("-size", type=int, default=19)
    p.add_argument("-optimizer", default="sgd",
                   choices=["sgd", "muon", "normuon", "polar"])
    p.add_argument("-data-dir", default=None,
                   help="move the served data paths to this directory")
    p.set_defaults(fn=cmd_import_jax)
    args = ap.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
