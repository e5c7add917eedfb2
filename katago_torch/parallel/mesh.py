"""Data parallelism over torch.distributed — port of
katago_tpu/parallel/mesh.py.

The JAX package shards the batch-of-games / batch-of-rows axis over a
one-axis jax.sharding.Mesh ("data") and lets XLA insert the gradient
psum. Here that axis is the ranks of the default torch.distributed
process group, one device per rank (the reference's 1-process-per-GPU
DDP, train.py:252-319): NCCL between cards, gloo on the CPU. A `Mesh`
names this process's rank, the world size and its device; each rank
takes its slice of a global batch (`process_batch_slice`), parameters
are replicated (broadcast from rank 0), and gradients are summed over
the ranks with one all-reduce of a flat buffer (`all_reduce_sum`). The
fused actor-learner also gathers every rank's rows (`all_gather`) and
takes rank 0's draws (`broadcast`); each rank but 0 draws from a
generator of its own (`rank_generator`).

Nothing here reads a cluster's environment: the caller gives the
process group its address (tcp://host:port), world size and rank
(`initialize_multihost`). At world size 1 it needs no address and picks
a free port on localhost.
"""

from __future__ import annotations

import dataclasses
import socket

import numpy as np
import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The data axis as seen from this process."""
    rank: int
    world_size: int
    device: torch.device


def free_port() -> int:
    """A TCP port on localhost that is free right now."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def initialize_multihost(init_method: str | None = None,
                         world_size: int = 1, rank: int = 0,
                         device=None) -> Mesh:
    """Join (or create) the default process group and return the mesh.

    device: this rank's device; a CUDA device is made current and the
    group runs NCCL, any other device runs gloo. init_method: the
    rendezvous address, "tcp://host:port"; it may be left out only at
    world size 1 (a free localhost port is taken). Calling it again once
    the group exists returns the existing group's mesh (no-op, as the
    JAX package's initialize_multihost)."""
    from katago_torch.device import resolve_device
    dev = resolve_device(device)
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        if init_method is None:
            if world_size != 1:
                raise ValueError("init_method (tcp://host:port) is needed "
                                 "for more than one rank")
            init_method = f"tcp://127.0.0.1:{free_port()}"
        dist.init_process_group(
            "nccl" if dev.type == "cuda" else "gloo",
            init_method=init_method, world_size=world_size, rank=rank)
    return Mesh(dist.get_rank(), dist.get_world_size(), dev)


def shutdown() -> None:
    """Leave the default process group (when there is one)."""
    if dist.is_initialized():
        dist.destroy_process_group()


def process_batch_slice(global_batch: int, mesh: Mesh | None = None
                        ) -> tuple[int, int]:
    """(start_row, rows) of this process's slice of a global batch — the
    analogue of the reference's per-rank data slicing
    (data_processing_pytorch.py:28 rank slicing). Without a mesh: the
    whole batch."""
    if mesh is None:
        return 0, global_batch
    per = global_batch // mesh.world_size
    return mesh.rank * per, per


def check_divisible(n: int, mesh: Mesh | None, what: str) -> None:
    """ValueError unless n splits evenly over the mesh's ranks."""
    ranks = 1 if mesh is None else mesh.world_size
    if n % ranks != 0:
        raise ValueError(f"{what} {n} not divisible by {ranks} ranks")


def all_reduce_sum(tensors: list, mesh: Mesh | None) -> list:
    """The element-wise sum over all ranks of each tensor (one
    all-reduce of their flat concatenation); the inputs are left as
    they are. Without a mesh: the tensors themselves."""
    if mesh is None or not tensors:
        return list(tensors)
    flat = torch.cat([t.reshape(-1).float() for t in tensors])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM)
    out, i = [], 0
    for t in tensors:
        out.append(flat[i:i + t.numel()].reshape(t.shape).to(t.dtype))
        i += t.numel()
    return out


def all_gather(tensors: list, mesh: Mesh | None) -> list:
    """Each tensor's pieces from every rank, concatenated along dim 0 in
    rank order, on every rank (one all-gather per dtype of their flat
    concatenation; every rank passes the same shapes). Without a mesh or
    at world size 1: the tensors themselves, with no collective."""
    if mesh is None or mesh.world_size == 1 or not tensors:
        return list(tensors)
    out = [None] * len(tensors)
    groups: dict = {}
    for i, t in enumerate(tensors):
        groups.setdefault(t.dtype, []).append(i)
    for dtype, idx in groups.items():
        # bool travels as bytes (gloo has no bool all-gather)
        flat = torch.cat([tensors[i].reshape(-1) for i in idx])
        if dtype == torch.bool:
            flat = flat.view(torch.uint8)
        parts = [torch.empty_like(flat) for _ in range(mesh.world_size)]
        dist.all_gather(parts, flat)
        off = 0
        for i in idx:
            t = tensors[i]
            piece = torch.cat([p[off:off + t.numel()].reshape(t.shape)
                               for p in parts])
            out[i] = piece.view(torch.bool) if dtype == torch.bool else piece
            off += t.numel()
    return out


def broadcast(tensor: torch.Tensor, mesh: Mesh | None) -> torch.Tensor:
    """Rank 0's value of tensor on every rank (a new tensor; every rank
    passes one of the same shape and dtype). Without a mesh or at world
    size 1: the tensor itself, with no collective."""
    if mesh is None or mesh.world_size == 1:
        return tensor
    out = tensor.contiguous().clone()
    dist.broadcast(out, src=0)
    return out


def rank_generator(gen: torch.Generator, seed: int,
                   mesh: Mesh | None) -> torch.Generator:
    """The generator this rank draws its own stream from: gen on rank 0
    (and without a mesh), on every other rank a new generator on gen's
    device seeded from (seed, rank), so ranks do not repeat each other's
    draws."""
    if mesh is None or mesh.rank == 0:
        return gen
    return torch.Generator(device=gen.device).manual_seed(int(
        np.random.SeedSequence((seed, mesh.rank))
        .generate_state(1, np.uint64)[0]))


def replicate(tensors: dict, mesh: Mesh | None) -> dict:
    """Rank 0's values of every tensor on every rank (in place)."""
    if mesh is not None and mesh.world_size > 1:
        for t in tensors.values():
            dist.broadcast(t.data, src=0)
    return tensors


def gather_objects(obj, mesh: Mesh | None) -> list:
    """[obj of rank 0, obj of rank 1, ...] on every rank."""
    if mesh is None:
        return [obj]
    out = [None] * mesh.world_size
    dist.all_gather_object(out, obj)
    return out


def all_true(flag: bool, mesh: Mesh | None) -> bool:
    """flag and-ed over the ranks."""
    if mesh is None:
        return flag
    t = torch.tensor([0 if flag else 1], dtype=torch.int32,
                     device=mesh.device)
    dist.all_reduce(t, op=dist.ReduceOp.SUM)
    return int(t.item()) == 0


def min_int(value: int | None, mesh: Mesh | None, default: int) -> int:
    """The smallest value over the ranks (None: this rank has none);
    default when no rank has one."""
    if mesh is None:
        return default if value is None else value
    big = 2 ** 62
    t = torch.tensor([big if value is None else value], dtype=torch.int64,
                     device=mesh.device)
    dist.all_reduce(t, op=dist.ReduceOp.MIN)
    v = int(t.item())
    return default if v == big else v
