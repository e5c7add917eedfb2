"""train command — the learner loop (reference python/train.py); port of
katago_tpu/cli/train_cmd.py.

Serves shuffled npz files through a resumable no-repeat generator
(train/datagen.py, the reference's TrainingDataGenerator), runs the train
step on one device, scales the LR by the reference's piecewise-by-samples
schedules (train/schedules.py), keeps SWA weights distinct from the
per-step EMA (train.py:814-818), checkpoints with optimizer+EMA+SWA+
data-serving state, runs periodic validation passes, and exports params
for selfplay — the reference's tfsavedmodels_toexport flow
(train.py:1422-1637, 579-607).

Batches come from the same numpy draws as the JAX package's (a
permutation of each file's rows, then one symmetry per batch from
np.random.default_rng(seed)), so a seed gives the same rows. The net is
float32 with TF32 off (train/train_step.py); fresh weights come from the
port's seeded initializer (models/weights.py), not from JAX's.
`-multi-host` trains data-parallel over a torch.distributed process group
(parallel/mesh.py; NCCL on the card, gloo on the CPU): every rank serves
the same global batches and takes its slice of each, the gradients are
all-reduced, and rank 0 alone writes the metrics, checkpoints and
exports. Give each process `-dist-url tcp://host:port -world-size N
-rank R` (at world size 1 a free localhost port is taken).

Usage: python -m katago_torch.cli.train_cmd -data-dir D -ckpt-dir C
         -export-dir E [-device cpu] [-size 9] [-config b2c16]
         [-batch-size 64] [-steps 100] [-lr 6e-5]
         [-lr-schedule "(0,8.0),(550M,6.0)"] [-swa-period-samples N]
         [-val-dir V] [-multi-host [-dist-url U -world-size N -rank R]]

Runs on CUDA unless `-device cpu` is given; with no CUDA device and no
-device it raises.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import random
import time

import numpy as np
import torch

from katago_torch.dataio import native as NV
from katago_torch.dataio import trainingwrite as TW
from katago_torch.device import resolve_device
from katago_torch.train import checkpoint as C
from katago_torch.train import schedules as SCH
from katago_torch.train.datagen import DataFileServer
from katago_torch.train.train_step import (init_train_state, make_eval_step,
                                           make_optimizer, make_train_step)


def _apply_symmetry(hb: dict, size: int, sym: int) -> dict:
    """Random dihedral symmetry per batch (data_processing_pytorch.py's
    apply_symmetry)."""
    if not sym:
        return hb
    hb = dict(hb)
    hb["binaryInputNCHW"] = NV.apply_symmetry_planes(
        np.ascontiguousarray(hb["binaryInputNCHW"]), sym)
    hb["valueTargetsNCHW"] = NV.apply_symmetry_planes(
        np.ascontiguousarray(hb["valueTargetsNCHW"]), sym)
    for k in ("policyTargetsNCMove", "qValueTargetsNCMove"):
        arr = np.ascontiguousarray(hb[k])
        b, c, a = arr.shape
        hb[k] = NV.apply_symmetry_policy(
            arr.reshape(b * c, a), size, sym).reshape(b, c, a)
    return hb


class _BatchServer:
    """Assemble fixed-size batches from the file generator: pop files,
    shuffle rows within each file, buffer across file boundaries."""

    def __init__(self, gen: DataFileServer, size: int, batch_size: int,
                 rng: np.random.Generator):
        self.gen = gen
        self.size = size
        self.batch_size = batch_size
        self.rng = rng
        self.buf: dict[str, np.ndarray] | None = None

    def _buffered(self) -> int:
        if self.buf is None:
            return 0
        return self.buf[next(iter(self.buf))].shape[0]

    def next_batch(self) -> dict | None:
        while self._buffered() < self.batch_size:
            path = self.gen.pop()
            if path is None:
                return None
            rows = TW.read_npz(path, self.size)
            n = rows[next(iter(rows))].shape[0]
            perm = self.rng.permutation(n)
            rows = {k: v[perm] for k, v in rows.items()}
            if self.buf is None:
                self.buf = rows
            else:
                self.buf = {k: np.concatenate([self.buf[k], rows[k]])
                            for k in rows}
        hb = {k: v[:self.batch_size] for k, v in self.buf.items()}
        self.buf = {k: v[self.batch_size:] for k, v in self.buf.items()}
        return hb


class _ToDevice:
    """Host batches to the device once per step: on CUDA through pinned
    host buffers (one per array, reused) and non_blocking copies. A
    buffer is refilled only after the caller has synchronised on the
    previous step (run_training reads each step's metrics)."""

    def __init__(self, device: torch.device):
        self.device = device
        self.pinned: dict[str, torch.Tensor] = {}

    def __call__(self, hb: dict) -> dict:
        if self.device.type != "cuda":
            return {k: torch.from_numpy(np.ascontiguousarray(v)).to(
                self.device) for k, v in hb.items()}
        out = {}
        for k, v in hb.items():
            buf = self.pinned.get(k)
            if buf is None or tuple(buf.shape) != v.shape:
                buf = torch.empty(v.shape, dtype=torch.float32,
                                  pin_memory=True)
                self.pinned[k] = buf
            buf.copy_(torch.from_numpy(np.ascontiguousarray(v)))
            out[k] = buf.to(self.device, non_blocking=True)
        return out


def make_model(size: int, config_name: str, device, seed: int = 0):
    """The named float32 net with the port's seeded initial weights."""
    from katago_torch.models import config as MC
    from katago_torch.models import model as M
    from katago_torch.models import weights as W
    model = M.KataGoModel(MC.get_config(config_name), size, torch.float32)
    return W.init_weights(model, seed=seed).to(device)


def run_training(data_dir: str, ckpt_dir: str, export_dir: str | None, *,
                 size: int, config_name: str, batch_size: int, steps: int,
                 lr: float, export_every: int = 0, seed: int = 0,
                 optimizer_kind: str = "sgd",
                 lr_schedule: str | None = None,
                 lr_scale: float | None = None,
                 lr_scale_auto: bool = False,
                 lr_scale_auto2: float | None = None,
                 swa_period_samples: float | None = None,
                 swa_scale: float = 8.0,
                 val_dir: str | None = None, val_batches: int = 4,
                 no_repeat_files: bool = False,
                 max_train_per_data: float | None = None,
                 export_swa: bool | None = None,
                 log=print,
                 longterm_hours: float = 12.0,
                 device=None,
                 timings: dict | None = None, mesh=None) -> dict:
    """Returns the JAX package's summary (steps, checkpoint, rows_per_s,
    first_loss, final_loss, val_loss) plus "export" (the export
    directory) and "metrics" (every logged step's metrics).

    timings: optional dict that collects, synchronising the device at
    each boundary, the seconds per phase of the steps: data (next batch
    and symmetry, "data_s"), host to device ("h2d_s"), forward+backward
    ("fwd_bwd_s") and optimizer+EMA ("opt_s").

    mesh: a parallel.mesh.Mesh to train data-parallel over its ranks
    (batch_size is the global batch; it must divide by the ranks); only
    rank 0 writes files."""
    from katago_torch.parallel import mesh as PM
    PM.check_divisible(batch_size, mesh, "batch-size")
    dev = mesh.device if mesh is not None else resolve_device(device)
    writer = mesh is None or mesh.rank == 0
    model = make_model(size, config_name, dev, seed)
    params = PM.replicate(dict(model.named_parameters()), mesh)
    row0, rows = PM.process_batch_slice(batch_size, mesh)
    if mesh is not None and mesh.world_size > 1:
        log(f"data-parallel over {mesh.world_size} ranks ({rows} "
            f"rows/rank)")

    latest = C.latest_checkpoint(ckpt_dir)
    meta = C.load_metadata(latest) if latest else {}
    start_step = int(meta.get("global_step", 0))
    start_samples = start_step * batch_size

    sched = SCH.make_lr_schedule(
        lr, batch_size, lr_scale=lr_scale, lr_scale_auto=lr_scale_auto,
        lr_scale_auto2=lr_scale_auto2, lr_schedule_str=lr_schedule,
        start_samples=start_samples)
    optimizer = make_optimizer(lr=sched, kind=optimizer_kind)
    state = init_train_state(params, optimizer)
    if latest:
        state = C.restore_checkpoint(latest, state)
        start_step = state.step
        log(f"resumed from {latest} at step {start_step}")

    # resumable no-repeat data serving (TrainingDataGenerator semantics);
    # its state rides in the checkpoint metadata
    serve_state = meta.get("data_serve_state",
                           {"data_files_used": [],
                            "rev_data_files_remaining": [],
                            "old_train_data_dirs": []})
    gen = DataFileServer(serve_state, no_repeat_files=no_repeat_files,
                         rng=random.Random(seed * 7919 + start_step))
    if not gen.set_data_dir_if_has_remaining_files(data_dir):
        raise FileNotFoundError(f"no servable npz shards in {data_dir}")

    # train/data rate throttling (train.py:121-124): cap the training
    # done per new data row
    if max_train_per_data is not None:
        new_rows = sum(
            TW.read_npz(f, size)["globalInputNC"].shape[0]
            for f in glob.glob(os.path.join(data_dir, "*.npz")))
        cap = int(max_train_per_data * new_rows / batch_size)
        if cap < steps:
            log(f"throttle: {steps} -> {cap} steps "
                f"({max_train_per_data} train rows per data row)")
            steps = cap

    train_step = make_train_step(model, optimizer, timings=timings,
                                 mesh=mesh)
    eval_step = make_eval_step(model) if val_dir else None
    to_device = _ToDevice(dev)

    rng = np.random.default_rng(seed)
    batches = _BatchServer(gen, size, batch_size, rng)
    swa = SCH.SwaTracker(swa_period_samples or batch_size * max(steps, 1),
                         swa_scale,
                         accum=float(meta.get("swa_sample_accum", 0.0)))
    swa_enabled = swa_period_samples is not None
    if export_swa is None:
        export_swa = swa_enabled

    def clock(key, t0):
        if timings is None:
            return 0.0
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        now = time.perf_counter()
        timings[key] = timings.get(key, 0.0) + now - t0
        return now

    metrics_hist = []
    # anomaly detection + JSON-lines metrics (trainloop_helpers.py:300,
    # metrics_logging.py)
    from katago_torch.train.watchers import GnormWatcher, MetricsLogger
    from katago_torch.utils.signals import GracefulShutdown
    watcher = GnormWatcher(log=log)
    mlog = MetricsLogger(os.path.join(ckpt_dir, "metrics.json")
                         if writer else None)
    t0 = time.time()
    steps_done = 0
    with GracefulShutdown(log) as stop:
        for i in range(steps):
            if stop.requested:
                log(f"train: drain requested, checkpointing at step "
                    f"{start_step + steps_done}")
                break
            t = time.perf_counter()
            hb = batches.next_batch()
            if hb is None:
                log(f"data exhausted after {steps_done} steps "
                    f"(no_repeat_files={no_repeat_files})")
                break
            hb = _apply_symmetry(hb, size, int(rng.integers(0, 8)))
            if mesh is not None:
                hb = {k: v[row0:row0 + rows] for k, v in hb.items()}
            t = clock("data_s", t)
            batch = to_device(hb)
            clock("h2d_s", t)
            state, metrics = train_step(state, batch)
            steps_done += 1
            if swa_enabled and swa.step(batch_size):
                state.swa_params = swa.update(state.swa_params, state.params)
            # one device-to-host copy of every metric per step
            values = torch.stack(list(metrics.values())).cpu().tolist()
            mvals = dict(zip(metrics, values))
            gn = mvals["gnorm"]
            watcher.observe(gn)
            mlog.accumulate(mvals, batch_size=batch_size)
            mlog.clear_nonfinite(log=log)
            if i % max(1, steps // 10) == 0 or i == steps - 1:
                m = mlog.log_line({"step": start_step + i})
                metrics_hist.append(mvals)
                log(f"  step {start_step + i}: loss={m['loss']:.4f} "
                    f"policy={m['policy_loss']:.4f} "
                    f"value={m['value_loss']:.4f} "
                    f"gnorm={gn:.3f} lr={sched(i):.2e}")
            if export_every and export_dir and writer and \
                    (i + 1) % export_every == 0:
                C.export_params(export_dir,
                                f"{config_name}-s{start_step + i + 1}",
                                state.swa_params if export_swa
                                else state.ema_params)
    mlog.close()

    val_metrics = None
    if val_dir and eval_step is not None:
        vals = []
        vfiles = sorted(glob.glob(os.path.join(val_dir, "*.npz")))
        vrng = np.random.default_rng(seed + 1)
        vgen = DataFileServer({}, no_repeat_files=True,
                              rng=random.Random(seed + 1))
        if vgen.set_data_dir_if_has_remaining_files(val_dir):
            vbatches = _BatchServer(vgen, size, batch_size, vrng)
            for _ in range(val_batches):
                vb = vbatches.next_batch()
                if vb is None:
                    break
                vm = eval_step(state.params, to_device(vb), state.seki_ema)
                vals.append(dict(zip(vm, torch.stack(
                    list(vm.values())).cpu().tolist())))
        if vals:
            val_metrics = {k: float(np.mean([v[k] for v in vals]))
                           for k in vals[0]}
            log(f"  val: loss={val_metrics['loss']:.4f} "
                f"policy={val_metrics['policy_loss']:.4f} "
                f"({len(vals)} batches from {len(vfiles)} files)")

    final_step = start_step + steps_done
    meta = {"global_step": final_step,
            "global_step_samples": final_step * batch_size,
            "config": config_name, "size": size,
            "swa_sample_accum": swa.accum,
            "data_serve_state": serve_state,
            "val_metrics": val_metrics}
    path = lt = export_path = None
    if writer:
        path = C.save_checkpoint(ckpt_dir, state, final_step,
                                 metadata=meta)
        # periodic never-pruned snapshots (train.py longterm checkpoints)
        lt = C.maybe_save_longterm(ckpt_dir, state, final_step,
                                   every_s=longterm_hours * 3600.0,
                                   metadata=meta)
    if lt:
        log(f"longterm checkpoint: {lt}")
    if export_dir and writer:
        export_path = C.export_params(
            export_dir, f"{config_name}-s{final_step}",
            state.swa_params if export_swa else state.ema_params)
    dt = time.time() - t0
    out = {"steps": steps_done, "checkpoint": path,
           "rows_per_s": steps_done * batch_size / max(dt, 1e-9)}
    if export_path:
        out["export"] = export_path
    out["metrics"] = metrics_hist
    if metrics_hist:
        out["final_loss"] = metrics_hist[-1]["loss"]
        out["first_loss"] = metrics_hist[0]["loss"]
    if val_metrics:
        out["val_loss"] = val_metrics["loss"]
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("-data-dir", required=True)
    ap.add_argument("-ckpt-dir", required=True)
    ap.add_argument("-export-dir", default=None)
    ap.add_argument("-val-dir", default=None)
    ap.add_argument("-size", type=int, default=9)
    ap.add_argument("-config", default="b2c16")
    ap.add_argument("-batch-size", type=int, default=64)
    ap.add_argument("-steps", type=int, default=100)
    ap.add_argument("-lr", type=float, default=6e-5)
    ap.add_argument("-lr-scale", type=float, default=None,
                    help="constant LR multiplier (train.py -lr-scale)")
    ap.add_argument("-lr-scale-auto", action="store_true",
                    help="the reference's by-samples LR table "
                         "(train.py:504-522)")
    ap.add_argument("-lr-scale-auto2", type=float, default=None,
                    help="small-run LR table times this factor "
                         "(train.py:524-546)")
    ap.add_argument("-lr-schedule", default=None,
                    help="explicit '(0,12.0),(20M,9.0),...' piecewise "
                         "schedule (train.py:86)")
    ap.add_argument("-swa-period-samples", type=float, default=None)
    ap.add_argument("-swa-scale", type=float, default=8.0)
    ap.add_argument("-no-repeat-files", action="store_true",
                    help="never train on a shuffled file twice, even "
                         "across restarts")
    ap.add_argument("-max-train-per-data", type=float, default=None,
                    help="cap train rows per new data row "
                         "(train.py -max-train-bucket-per-new-data)")
    ap.add_argument("-optimizer", default="sgd",
                    choices=["sgd", "muon", "normuon", "polar"])
    ap.add_argument("-longterm-checkpoint-hours", type=float, default=12.0,
                    help="save a never-pruned snapshot into "
                         "ckpt-dir/longterm_checkpoints at this interval "
                         "(train.py:1884)")
    ap.add_argument("-multi-host", action="store_true",
                    help="data-parallel over a torch.distributed process "
                         "group (NCCL on CUDA, gloo on the CPU)")
    ap.add_argument("-dist-url", default=None,
                    help="-multi-host rendezvous, tcp://host:port (default "
                         "at world size 1: a free localhost port)")
    ap.add_argument("-world-size", type=int, default=1,
                    help="-multi-host: the number of ranks")
    ap.add_argument("-rank", type=int, default=0,
                    help="-multi-host: this process's rank")
    ap.add_argument("-device", default=None,
                    help="torch device (default: cuda; 'cpu' to run on "
                         "the CPU)")
    ap.add_argument("-dtype", default="float32", choices=["float32"],
                    help="the net's compute dtype (float32, as the JAX "
                         "trainer's)")
    args = ap.parse_args(argv)
    mesh = None
    if args.multi_host:
        from katago_torch.parallel import mesh as PM
        if args.batch_size % args.world_size != 0:
            raise ValueError(f"batch-size {args.batch_size} not divisible "
                             f"by {args.world_size} ranks")
        mesh = PM.initialize_multihost(args.dist_url, args.world_size,
                                       args.rank, args.device)
    try:
        out = run_training(args.data_dir, args.ckpt_dir, args.export_dir,
                           size=args.size, config_name=args.config,
                           batch_size=args.batch_size, steps=args.steps,
                           lr=args.lr, optimizer_kind=args.optimizer,
                           lr_schedule=args.lr_schedule,
                           lr_scale=args.lr_scale,
                           lr_scale_auto=args.lr_scale_auto,
                           lr_scale_auto2=args.lr_scale_auto2,
                           swa_period_samples=args.swa_period_samples,
                           swa_scale=args.swa_scale,
                           val_dir=args.val_dir,
                           no_repeat_files=args.no_repeat_files,
                           max_train_per_data=args.max_train_per_data,
                           longterm_hours=args.longterm_checkpoint_hours,
                           device=args.device, mesh=mesh)
    finally:
        if mesh is not None:
            PM.shutdown()
    print(json.dumps({k: v for k, v in out.items() if k != "metrics"}))


if __name__ == "__main__":
    main()
