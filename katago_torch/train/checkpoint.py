"""Checkpoint save/restore and model exports — port of
katago_tpu/train/checkpoint.py with torch's format in place of orbax.

Reference behavior (python/train.py:579-607): checkpoints hold model
params, SWA/EMA params, optimizer state, and train_state (global step /
samples); plus longterm snapshots and export-for-selfplay copies.

On disk the layout keeps the JAX package's names, so the selfplay and
gatekeeper polling semantics carry over:
  ckpt_dir/step_{step:012d}/state.pt            TrainState (torch.save)
  ckpt_dir/step_{step:012d}/train_metadata.json
  ckpt_dir/longterm_checkpoints/step_{step:012d}/...
  export_dir/<name>/params.pt                   params only (state_dict)
  export_dir/<name>.bin.gz                      reference engine format
A state.pt holds plain dicts of CPU tensors and ints, so it loads with
torch.load(weights_only=True) on any device.

A JAX trainer's orbax checkpoint cannot be read here (orbax is the JAX
package's). tools/jax_checkpoint_to_npz.py, run beside the JAX package,
flattens one into an npz keyed by jax.tree_util.keystr paths;
`import_jax_state` maps that onto the port's TrainState.
"""

from __future__ import annotations

import json
import os
import shutil
import time

import numpy as np
import torch

from katago_torch.train.losses import SekiEma
from katago_torch.train.train_step import TrainState

STATE_FILE = "state.pt"
PARAMS_FILE = "params.pt"


def _to_cpu(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    return tree


def _to_device(tree, device):
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return tree


def _state_dict(state: TrainState) -> dict:
    return _to_cpu({"params": state.params, "opt_state": state.opt_state,
                    "ema_params": state.ema_params,
                    "swa_params": state.swa_params, "step": state.step,
                    "seki_ema": {"sum": state.seki_ema.sum,
                                 "weight": state.seki_ema.weight}})


def _write_state(path: str, state: TrainState, metadata: dict | None):
    os.makedirs(path, exist_ok=True)
    torch.save(_state_dict(state), os.path.join(path, STATE_FILE))
    if metadata is not None:
        with open(os.path.join(path, "train_metadata.json"), "w") as f:
            json.dump(metadata, f)


def save_checkpoint(ckpt_dir: str, state: TrainState, step: int,
                    keep: int = 3, metadata: dict | None = None):
    path = os.path.abspath(os.path.join(ckpt_dir, f"step_{step:012d}"))
    os.makedirs(ckpt_dir, exist_ok=True)
    _write_state(path, state, metadata)
    # prune old checkpoints
    entries = sorted(d for d in os.listdir(ckpt_dir) if d.startswith("step_"))
    for old in entries[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, old), ignore_errors=True)
    return path


def maybe_save_longterm(ckpt_dir: str, state: TrainState, step: int,
                        every_s: float = 12 * 3600.0,
                        metadata: dict | None = None) -> str | None:
    """Periodic never-pruned snapshots (train.py:1358-1885 longterm
    checkpoints, saved every 12h by default): writes into
    ckpt_dir/longterm_checkpoints/ when the newest snapshot there is
    older than every_s. Returns the path when one was written."""
    lt_dir = os.path.join(ckpt_dir, "longterm_checkpoints")
    os.makedirs(lt_dir, exist_ok=True)
    entries = [os.path.join(lt_dir, d) for d in os.listdir(lt_dir)
               if d.startswith("step_")]
    if entries:
        newest = max(os.path.getmtime(e) for e in entries)
        if time.time() - newest < every_s:
            return None
    path = os.path.abspath(os.path.join(lt_dir, f"step_{step:012d}"))
    if os.path.exists(path):
        return None
    _write_state(path, state, metadata)
    return path


def load_metadata(path: str) -> dict:
    """Read the sidecar train_metadata.json of a checkpoint (global step,
    samples, SWA accumulator, data-serving state); {} if absent."""
    meta_path = os.path.join(path, "train_metadata.json")
    if not os.path.exists(meta_path):
        return {}
    with open(meta_path) as f:
        return json.load(f)


def latest_checkpoint(ckpt_dir: str) -> str | None:
    if not os.path.isdir(ckpt_dir):
        return None
    entries = sorted(d for d in os.listdir(ckpt_dir) if d.startswith("step_"))
    return os.path.join(ckpt_dir, entries[-1]) if entries else None


def check_keys(what: str, template: dict, got: dict):
    if set(template) != set(got):
        raise ValueError(f"checkpoint {what} keys differ from the "
                         f"template's: missing "
                         f"{sorted(set(template) - set(got))[:5]}, extra "
                         f"{sorted(set(got) - set(template))[:5]}")


def load_state_tree(path: str) -> dict:
    """The raw dict a checkpoint's state.pt holds (CPU tensors and ints),
    with no template: the keys the saving code wrote, and no others."""
    return torch.load(os.path.join(path, STATE_FILE), map_location="cpu",
                      weights_only=True)


def restore_checkpoint(path: str, template: TrainState) -> TrainState:
    """The TrainState saved at path, on the device of the template's
    params (whose keys it must have)."""
    saved = load_state_tree(path)
    check_keys("params", template.params, saved["params"])
    if isinstance(template.opt_state, dict):
        check_keys("optimizer state", template.opt_state,
                   saved["opt_state"])
    dev = next(iter(template.params.values())).device
    s = _to_device(saved, dev)
    return TrainState(params=s["params"], opt_state=s["opt_state"],
                      ema_params=s["ema_params"],
                      swa_params=s["swa_params"], step=int(s["step"]),
                      seki_ema=SekiEma(sum=s["seki_ema"]["sum"],
                                       weight=s["seki_ema"]["weight"]))


def export_params(export_dir: str, name: str, params: dict) -> str:
    """Write a param-only model export for selfplay/gatekeeper polling.

    Like the reference's export_model_for_selfplay.sh output: a named
    directory whose appearance (atomic rename) signals a new model.
    """
    os.makedirs(export_dir, exist_ok=True)
    tmp = os.path.join(export_dir, f".tmp_{name}")
    final = os.path.join(export_dir, name)
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    torch.save(_to_cpu(dict(params)), os.path.join(tmp, PARAMS_FILE))
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def export_bin_gz(export_dir: str, name: str, params: dict, cfg) -> str:
    """Additionally publish the reference .bin.gz engine format
    (export_model_pytorch.py equivalent; models/export.py)."""
    from katago_torch.models.export import export_model
    from katago_torch.models.weights import to_flax_params
    os.makedirs(export_dir, exist_ok=True)
    path = os.path.join(export_dir, f"{name}.bin.gz")
    return export_model(to_flax_params(params), cfg, path, name=name)


def find_latest_model(models_dir: str) -> str | None:
    """Newest model export by mtime (reference LoadModel::findLatestModel)."""
    if not os.path.isdir(models_dir):
        return None
    entries = [os.path.join(models_dir, d) for d in os.listdir(models_dir)
               if not d.startswith(".")]
    entries = [e for e in entries if os.path.isdir(e)]
    if not entries:
        return None
    return max(entries, key=os.path.getmtime)


def load_params(path: str, template: dict | None = None) -> dict:
    """The params of an export directory (a state_dict of float32
    tensors): with a template, checked against its keys and put on its
    device; else on the CPU."""
    params = torch.load(os.path.join(path, PARAMS_FILE), map_location="cpu",
                        weights_only=True)
    if template is None:
        return params
    check_keys("params", template, params)
    return _to_device(params, next(iter(template.values())).device)


# optax's state paths in the JAX TrainState of train_cmd (an lr schedule):
# chain(clip_by_global_norm, add_decayed_weights, sgd) and
# chain(clip_by_global_norm, muon) with muon = partition(muon, adam)
_SGD = ".opt_state[2]"
_MUON = ".opt_state[1].inner_states['muon'].inner_state"
_ADAM = ".opt_state[1].inner_states['adam'].inner_state"


def _flax_paths(prefix: str, state_dict: dict) -> dict:
    """{keystr path of the Flax leaf: (state_dict key, Flax shape)} for
    the tensors of state_dict under prefix (a TrainState field)."""
    from katago_torch.models.weights import to_flax_params
    out = {}

    def walk(tree, path, names):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, path + f"['{k}']", names + [k])
            else:
                out[f"{prefix}['params']{path}['{k}']"] = (
                    ".".join(names + [k]), tuple(v.shape))
    walk(to_flax_params(state_dict), "", [])
    return out


def _jax_layout(template: TrainState) -> tuple[dict, list]:
    """The JAX TrainState's leaves for template's net and optimizer:
    ({keystr path: (port field, state_dict key, Flax shape)}, the
    scalar paths)."""
    leaves = {}
    for field in ("params", "ema_params", "swa_params"):
        for path, (key, shape) in _flax_paths(
                f".{field}", template.params).items():
            leaves[path] = (field, key, shape)
    opt = template.opt_state
    if "trace" in opt:
        parts = {"trace": f"{_SGD}[0].trace"}
        counts = [f"{_SGD}[1].count"]
    else:
        parts = {"momentum": f"{_MUON}[0].momentum",
                 "normuon_v": f"{_MUON}[0].normuon_v",
                 "mu": f"{_ADAM}[0].mu", "nu": f"{_ADAM}[0].nu"}
        counts = [f"{_MUON}[2].count", f"{_ADAM}[0].count",
                  f"{_ADAM}[2].count"]
    for part, prefix in parts.items():
        # normuon_v holds one entry per row of the Flax matrix: a vector,
        # the same in both layouts
        for path, (key, shape) in _flax_paths(prefix, opt[part]).items():
            leaves[path] = (part, key, shape)
    return leaves, counts + [".step", ".seki_ema.sum", ".seki_ema.weight"]


def import_jax_state(npz, template: TrainState) -> TrainState:
    """The port's TrainState of a JAX trainer's checkpoint flattened by
    tools/jax_checkpoint_to_npz.py. npz: a mapping of keystr paths to
    arrays (an np.load result or a dict). template: a TrainState of the
    same net and optimizer kind (init_train_state(params,
    make_optimizer(kind=...))), on the device the result goes to.

    params, ema_params and swa_params go through
    models/weights.py::from_flax_params. The optimizer state: for SGD,
    optax's trace becomes the momentum buffer (clipping and decayed
    weights carry no state) and the schedule's count the port's count;
    for the Muon family, Muon's momentum and normuon_v, AdamW's mu and
    nu, and the counts (which must agree). step and seki_ema carry over.
    A path missing from npz, one it should not hold, or a leaf of the
    wrong shape raises a ValueError that names it, before anything is
    built."""
    from katago_torch.models.weights import from_flax_params
    leaves, scalars = _jax_layout(template)
    got = set(npz.keys())
    missing = sorted(set(leaves) - got) + sorted(set(scalars) - got)
    extra = sorted(got - set(leaves) - set(scalars))
    if missing or extra:
        raise ValueError(f"JAX checkpoint tree differs from the "
                         f"template's: missing {missing[:5]}, extra "
                         f"{extra[:5]}")
    for path, (_, _, shape) in leaves.items():
        if tuple(np.shape(npz[path])) != shape:
            raise ValueError(f"JAX checkpoint leaf {path} has shape "
                             f"{tuple(np.shape(npz[path]))}, want {shape}")
    for path in scalars:
        if np.shape(npz[path]) != ():
            raise ValueError(f"JAX checkpoint leaf {path} has shape "
                             f"{np.shape(npz[path])}, want ()")
    counts = {int(npz[p]) for p in scalars[:-3]}
    if len(counts) != 1:
        raise ValueError(f"JAX optimizer counts disagree: "
                         f"{dict((p, int(npz[p])) for p in scalars[:-3])}")

    trees: dict = {}
    for path, (part, key, _) in leaves.items():
        *names, leaf = key.split(".")
        node = trees.setdefault(part, {})
        for n in names:
            node = node.setdefault(n, {})
        node[leaf] = np.asarray(npz[path])
    dev = next(iter(template.params.values())).device
    parts = {part: _to_device(from_flax_params(tree), dev)
             for part, tree in trees.items()}
    opt = {"count": counts.pop()}
    for part in template.opt_state:
        if part != "count":
            opt[part] = parts.get(part, {})
    seki = [torch.tensor(float(np.asarray(npz[p])), dtype=torch.float32,
                         device=dev) for p in scalars[-2:]]
    return TrainState(params=parts["params"], opt_state=opt,
                      ema_params=parts["ema_params"],
                      swa_params=parts["swa_params"],
                      step=int(npz[".step"]),
                      seki_ema=SekiEma(sum=seki[0], weight=seki[1]))
