"""Convert a JAX trainer's orbax checkpoint into one npz for the port.

    JAX_PLATFORMS=cpu python tools/jax_checkpoint_to_npz.py \
        -ckpt CKPT_DIR/step_000000001000 -config b18c384nbt -size 19 \
        -optimizer sgd -out state.npz

Runs beside the JAX package on the CPU (katago_torch cannot read orbax).
It builds the template TrainState that katago_tpu/cli/train_cmd.py
builds for -config, -size and -optimizer (the net's parameter shapes
from jax.eval_shape, the optimizer of train_step.make_optimizer with a
learning-rate schedule of schedules.make_lr_schedule, as train_cmd
passes one), restores the step directory into it with
katago_tpu.train.checkpoint.restore_checkpoint, and writes

  OUT         one array per leaf of the TrainState, keyed by its
              jax.tree_util.keystr path (".params['params']['Conv_0']...",
              ".opt_state[2][0].trace[...]", ".step", ...)
  OUT.json    the checkpoint's train_metadata.json ({} when absent)

Then `python -m katago_torch.cli.checkpoint_tools_cmd import-jax -npz OUT
-ckpt-dir D -config C -size S -optimizer K` writes the port's checkpoint
under D, and `python -m katago_torch.cli.train_cmd -ckpt-dir D ...`
resumes from it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

jax.config.update("jax_platforms", "cpu")

from katago_tpu.models import config as JC  # noqa: E402
from katago_tpu.models.model import KataGoModel  # noqa: E402
from katago_tpu.train import checkpoint as JCK  # noqa: E402
from katago_tpu.train import schedules as JSCH  # noqa: E402
from katago_tpu.train import train_step as JSTEP  # noqa: E402


def template_state(config_name: str, size: int, optimizer_kind: str):
    """A TrainState of zeros shaped as train_cmd's for these arguments
    (no compiled init: shapes from jax.eval_shape)."""
    model = KataGoModel(JC.get_config(config_name), pos_len=size,
                        dtype=jnp.float32)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, size, size, 22)),
                            jnp.zeros((1, 19)))
    params = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    optimizer = JSTEP.make_optimizer(
        lr=JSCH.make_lr_schedule(1.0, 1), kind=optimizer_kind)
    return JSTEP.init_train_state(params, optimizer)


def flatten(state) -> dict:
    """{keystr path: numpy array} of every leaf."""
    return {jax.tree_util.keystr(path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(state)[0]}


def convert(ckpt: str, config_name: str, size: int, optimizer_kind: str,
            out: str) -> dict:
    """Restore ckpt and write out and out.json; returns the arrays."""
    state = JCK.restore_checkpoint(
        ckpt, template_state(config_name, size, optimizer_kind))
    arrays = flatten(state)
    np.savez(out, **arrays)
    with open(out + ".json", "w") as f:
        json.dump(JCK.load_metadata(ckpt), f)
    return arrays


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("-ckpt", required=True, help="a step_* directory")
    ap.add_argument("-config", required=True)
    ap.add_argument("-size", type=int, default=19)
    ap.add_argument("-optimizer", default="sgd",
                    choices=["sgd", "muon", "normuon", "polar"])
    ap.add_argument("-out", required=True)
    args = ap.parse_args(argv)
    arrays = convert(args.ckpt, args.config, args.size, args.optimizer,
                     args.out)
    print(json.dumps({"out": args.out, "leaves": len(arrays),
                      "step": int(arrays[".step"])}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
