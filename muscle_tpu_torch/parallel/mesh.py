"""Process-group sharding of the MPC pair grid (torch.distributed).

Port of muscle_tpu/parallel/mesh.py. The reference's only parallel axis
is OpenMP over the O(N^2) pair grid (reference: src/mpcflat.cpp:243,
src/consflat.cpp:11). The JAX package shards it over the devices of a
1-D `jax.sharding.Mesh`, and over hosts through `jax.distributed`; the
port runs one process a card in a `torch.distributed` process group
(`torchrun`), which covers one host and many alike. Sharded:

  * the pair batch of every pair-stage chunk (pipeline/posteriors.py):
    each rank runs its contiguous lanes of the chunk through the batch
    function of its device (the CUDA kernels on the card, the scan on
    the CPU), then the ranks all-gather the results, so that every rank
    holds the whole chunk (JAX's `replicate_out=True`, the port's only
    mode: torch has no global arrays);
  * the rectangles of the Gram consistency (ops/consistency.py), dealt
    round-robin by rank, the ranks' output rows summed after each
    iteration.

Every rank runs the host stages itself (trees, progressive alignment,
refinement) on the replicated results. A rank computes each of its lanes
as a world of one computes it: the chunk's bucket length and launch
shapes are the whole chunk's (`ops/wavefront.chunk_pairs`), so the
results are bit-identical to one process.

With no process group (no launcher) the world is 1 and nothing is
sharded: no collective runs. A process group of one still runs every
collective (a NCCL world of one exercises the card's gathers).
"""

from __future__ import annotations

import datetime
import os
from dataclasses import dataclass

import torch
import torch.distributed as dist

# a collective that waits on a rank past this raises rather than hangs
TIMEOUT_S = 900

# since the last reset_counts(): chunks sharded (shard_lanes), gathers
# and sums, and the bytes they deliver to a rank
COUNTS = {"chunks": 0, "gathers": 0, "gathered_bytes": 0, "sums": 0,
          "summed_bytes": 0}

# the device init_distributed bound this process to
_DEVICE: torch.device | None = None


def reset_counts() -> None:
    for k in COUNTS:
        COUNTS[k] = 0


@dataclass(frozen=True)
class Mesh:
    """The process group as the pair grid sees it: `world` ranks laid
    out as `shape` over `axis_names`, this process's `rank` and
    `device`, and the `group` (None without a process group: a world of
    one, nothing sharded). The pair grid is sharded flat over every
    axis."""
    world: int
    rank: int
    device: torch.device
    group: object = None
    axis_names: tuple = ("dp",)
    shape: tuple = (1,)


def _process_device() -> torch.device:
    if _DEVICE is not None:
        return _DEVICE
    if torch.cuda.is_available():
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def make_mesh(group=None) -> Mesh:
    """The 1-D mesh of `group` (default: the process group, when one is
    initialized; else a world of one)."""
    if group is None and dist.is_available() and dist.is_initialized():
        group = dist.group.WORLD
    if group is None:
        return Mesh(1, 0, _process_device())
    world = dist.get_world_size(group)
    return Mesh(world, dist.get_rank(group), _process_device(), group,
                ("dp",), (world,))


def make_mesh_2d(group=None) -> Mesh:
    """The (nodes, per_node) mesh: the outer axis spans hosts, the inner
    one the LOCAL_WORLD_SIZE ranks of a host (torchrun's). The pair grid
    is sharded flat over both axes, as in the JAX package's (dcn, ici)
    mesh; on one host it is (1, world)."""
    mesh = make_mesh(group)
    per_node = int(os.environ.get("LOCAL_WORLD_SIZE", mesh.world))
    if per_node < 1 or mesh.world % per_node:
        raise ValueError(f"LOCAL_WORLD_SIZE {per_node} does not divide the "
                         f"world of {mesh.world}")
    return Mesh(mesh.world, mesh.rank, mesh.device, mesh.group,
                ("nodes", "per_node"), (mesh.world // per_node, per_node))


def init_distributed(coordinator: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None,
                     backend: str | None = None,
                     device=None) -> Mesh | None:
    """Join the process group: call once a process before any device op.

    With the arguments None it reads torchrun's environment (MASTER_ADDR,
    MASTER_PORT, WORLD_SIZE, RANK, LOCAL_RANK), and does nothing where
    none of it is set, as the JAX package's does without its
    coordinator. `coordinator` is an init method ("tcp://host:port",
    "file:///path"; "env://", torchrun's, where MASTER_ADDR is set). The process takes `device`, by default
    cuda:LOCAL_RANK where CUDA is present (raising when the host has
    fewer cards than local ranks), else the CPU; `backend` defaults to
    NCCL on a CUDA device and gloo on the CPU. Returns the mesh, or None
    where nothing was set. A second call returns the mesh of the group
    already joined."""
    global _DEVICE
    env = os.environ
    if dist.is_initialized():
        return make_mesh()
    if coordinator is None and env.get("MASTER_ADDR"):
        coordinator = "env://"
    if coordinator is None:
        return None
    world = (num_processes if num_processes is not None
             else int(env.get("WORLD_SIZE", 1)))
    rank = process_id if process_id is not None else int(env.get("RANK", 0))
    local_rank = int(env.get("LOCAL_RANK", rank))
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", local_rank)
        if device.index >= torch.cuda.device_count():
            raise RuntimeError(
                f"rank {rank} wants cuda:{device.index}, but this host has "
                f"{torch.cuda.device_count()} CUDA device(s)")
        torch.cuda.set_device(device)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    dist.init_process_group(backend, init_method=coordinator,
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=TIMEOUT_S))
    _DEVICE = device
    return make_mesh()


def shutdown() -> None:
    """Leave the process group (a no-op without one)."""
    global _DEVICE
    if dist.is_initialized():
        dist.destroy_process_group()
    _DEVICE = None


def batch_spec(mesh: Mesh, b: int) -> slice:
    """The rank's contiguous lanes of a leading batch axis of b (a
    multiple of the world): rank r takes [r b / W, (r + 1) b / W)."""
    if b % mesh.world:
        raise ValueError(f"{b} lanes do not split over {mesh.world} ranks")
    per = b // mesh.world
    return slice(mesh.rank * per, (mesh.rank + 1) * per)


def global_array(mesh: Mesh, np_value) -> torch.Tensor:
    """The rank's shard (batch_spec lanes) of a host value that every
    rank holds in full, on the rank's device."""
    lanes = batch_spec(mesh, len(np_value))
    return torch.as_tensor(np_value[lanes], device=mesh.device)


def _staged(mesh: Mesh, t: torch.Tensor) -> bool:
    """gloo takes host tensors: a CUDA tensor goes through host memory
    there (the collective's buffer only; no compute moves)."""
    return t.is_cuda and dist.get_backend(mesh.group) == "gloo"


def all_gather(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """Every rank's t (lanes, ...) -> (world * lanes, ...) in rank order,
    on t's device."""
    staged = _staged(mesh, t)
    src = (t.cpu() if staged else t).contiguous()
    parts = [torch.empty_like(src) for _ in range(mesh.world)]
    dist.all_gather(parts, src, group=mesh.group)
    out = torch.cat(parts)
    COUNTS["gathers"] += 1
    COUNTS["gathered_bytes"] += out.numel() * out.element_size()
    return out.to(t.device) if staged else out


def all_sum(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """The sum over ranks of t, on t's device. Exact where each element
    is nonzero on one rank at most."""
    staged = _staged(mesh, t)
    buf = t.cpu() if staged else t.contiguous().clone()
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=mesh.group)
    COUNTS["sums"] += 1
    COUNTS["summed_bytes"] += buf.numel() * buf.element_size()
    return buf.to(t.device) if staged else buf


def shard_lanes(mesh: Mesh, fn):
    """fn(*args) -> outputs, each argument and each output (or None)
    with the chunk's lanes as its leading axis, run by each rank on its
    batch_spec lanes and the outputs all-gathered: every rank gets the
    whole chunk's outputs. A chunk that does not split evenly is filled
    with copies of its first lane, dropped again after the gather. The
    launch shapes stay the whole chunk's (`wavefront.chunk_pairs`).
    Without a process group, fn itself."""
    if mesh.group is None:
        return fn
    from ..ops.wavefront import chunk_pairs

    def run(*args):
        b = args[0].shape[0]
        fill = -b % mesh.world
        if fill:
            args = tuple(torch.cat([a, a[:1].expand(fill, *a.shape[1:])])
                         for a in args)
        lanes = batch_spec(mesh, b + fill)
        with chunk_pairs(b):
            outs = fn(*(a[lanes] for a in args))
        COUNTS["chunks"] += 1
        return tuple(None if o is None else all_gather(mesh, o)[:b]
                     for o in outs)
    return run


def sharded_batch_posteriors(mesh: Mesh, pack, with_mea: bool = True,
                             backend: str | None = None):
    """fn(xb, yb, lxb, lyb) -> (post, ea), the pair axis sharded over the
    mesh: each rank runs its lanes through the port's batch function
    (posteriors._make_batch_fn: "cuda", the kernels on the mesh's CUDA
    device; "scan", the CPU scan; default by the mesh's device) and the
    outputs are all-gathered, replicated on every rank (the JAX
    package's replicate_out=True; torch has no global arrays, so it is
    the only mode)."""
    from ..pipeline.posteriors import _make_batch_fn
    device = mesh.device if backend in (None, "cuda") else torch.device("cpu")
    if backend == "cuda" and device.type != "cuda":
        raise RuntimeError("the cuda backend needs a mesh on a CUDA device")
    return shard_lanes(mesh, _make_batch_fn(pack, with_mea, device))
