"""Process groups, the device mesh and the batch's placement (counterpart of
``ccvs_tpu/parallel/mesh.py``).

The reference scales by data parallelism alone (apex DDP over NCCL,
``tools/engine.py:71-101``, 4 GPUs in ``scripts/bairhd/*.sh``). The port
runs one process a GPU under ``torchrun`` and lays the processes out on a
``("data", "model")`` :class:`~torch.distributed.device_mesh.DeviceMesh`,
rank ``d * model + m``: the batch is split over ``data``, and the GPT may be
split over ``model`` (``parallel/tp.py``, ``sp.py``, ``pp.py``).

The JAX package's GSPMD inserts every collective itself, so a sharded step
computes what the one-device step computes on the global batch. The port
keeps that property with explicit collectives: :class:`DataAxis` averages
the gradients over ``data`` (one flat bucket a step), averages the logged
metrics, and gathers what couples the samples of a batch (the
discriminators' minibatch-stddev feature, the adaptive augmentation's
statistic); the random draws of a step are made at the global batch's shape
and each rank keeps its rows (:meth:`DataAxis.rows`).
"""

import os
import socket
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ccvs_tpu_torch.device import resolve_device


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def init_distributed(device=None) -> torch.device:
    """Join the process group that ``torchrun`` describes (``RANK``,
    ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``, ``LOCAL_RANK``), the
    counterpart of ``jax.distributed.initialize()``: NCCL on the GPU of
    ``LOCAL_RANK``, gloo when ``device`` is ``"cpu"``. Returns this process's
    device. A no-op apart from the device where the group exists already."""
    env = {k: os.environ.get(k) for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")}
    missing = [k for k, v in env.items() if v is None]
    if missing and not dist.is_initialized():
        raise RuntimeError(f"init_distributed: {', '.join(missing)} not set; start the "
                           "processes with torchrun (or set the variables yourself)")
    local = int(os.environ.get("LOCAL_RANK", env["RANK"] or 0))
    if device is not None and torch.device(device).type == "cpu":
        dev = torch.device("cpu")
    else:
        dev = resolve_device(device)
        dev = torch.device("cuda", local if device is None else (dev.index or 0))
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        dist.init_process_group(
            "nccl" if dev.type == "cuda" else "gloo",
            init_method=f"tcp://{env['MASTER_ADDR']}:{env['MASTER_PORT']}",
            rank=int(env["RANK"]), world_size=int(env["WORLD_SIZE"]),
            device_id=dev if dev.type == "cuda" else None)
    return dev


def make_mesh(n_devices: Optional[int] = None, model_parallel: int = 1, device=None):
    """A ``("data", "model")`` ``DeviceMesh`` of ``n_devices`` processes, one
    device each (default: the world), ``model_parallel`` on the model axis.
    Without a process group, ``n_devices`` 1 starts a group of one process
    on a free local port (NCCL on the GPU, gloo when ``device`` is
    ``"cpu"``)."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        if (n_devices or 1) != 1:
            raise RuntimeError(f"make_mesh({n_devices}): no process group; start "
                               f"{n_devices} processes with torchrun and call "
                               "init_distributed() first")
        cpu = device is not None and torch.device(device).type == "cpu"
        dev = torch.device("cpu") if cpu else resolve_device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group("gloo" if cpu else "nccl",
                                init_method=f"tcp://127.0.0.1:{_free_port()}", rank=0,
                                world_size=1, device_id=None if cpu else dev)
    world = dist.get_world_size()
    n = n_devices or world
    if n != world:
        raise ValueError(f"make_mesh({n}): the port runs one device a process, and the "
                         f"world has {world} processes")
    if n % model_parallel:
        raise ValueError(f"model_parallel {model_parallel} does not divide {n} devices")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, (n // model_parallel, model_parallel),
                            mesh_dim_names=("data", "model"))


def mesh_device(mesh) -> torch.device:
    """This process's device on ``mesh``."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def data_sharding(mesh):
    """The batch's placements: split on dim 0 over ``data``, replicated over
    ``model``."""
    from torch.distributed.tensor import Replicate, Shard

    return (Shard(0), Replicate())


def replicate(mesh):
    """The weights' placements: replicated over both axes."""
    from torch.distributed.tensor import Replicate

    return (Replicate(), Replicate())


def _rows(mesh, x):
    n, r = mesh["data"].size(), mesh["data"].get_local_rank()
    if np.ndim(x) == 0:
        return x
    if x.shape[0] % n:
        raise ValueError(f"leading dim {x.shape[0]} does not divide the data axis {n}; pad "
                         "the batch or replicate it yourself")
    b = x.shape[0] // n
    return x[r * b:(r + 1) * b]


def shard_batch(mesh, batch):
    """This rank's rows of a global batch (a dict of arrays or tensors, or
    one): the ``data`` rank's block of ``B / n_data`` rows of each array of
    one dim or more; a leading dim that does not divide raises."""
    if isinstance(batch, dict):
        return {k: _rows(mesh, v) for k, v in batch.items()}
    return _rows(mesh, batch)


def put_batch(mesh, batch, device=None):
    """The loader's batch on this process's device, as tensors. With a mesh
    the batch is this rank's shard already (``data/loader.py`` splits each
    global batch into one block a data rank) and is taken as it is."""
    dev = torch.device(device) if device is not None else (
        mesh_device(mesh) if mesh is not None else resolve_device(None))
    return {k: (torch.from_numpy(np.ascontiguousarray(v)) if isinstance(v, np.ndarray)
                else torch.as_tensor(v)).to(dev)
            for k, v in batch.items()}


def replicate_tree(mesh, tree):
    """Broadcast every tensor of ``tree`` (a module's parameters and buffers,
    or a dict / list of tensors) from rank 0, in place; returns ``tree``."""
    if isinstance(tree, torch.nn.Module):
        tensors = [*tree.parameters(), *tree.buffers()]
    elif isinstance(tree, dict):
        tensors = [v for v in tree.values() if torch.is_tensor(v)]
    else:
        tensors = [v for v in tree if torch.is_tensor(v)]
    with torch.no_grad():
        for t in tensors:
            dist.broadcast(t.data, src=0)
    return tree


def host_local_rows(arr, mesh=None):
    """``(rows, ids)``: this rank's rows of a batch split over ``data`` (the
    tensor or array it holds) on the host, and their global row indices, so
    that the files each rank writes, named by global index, make up the
    whole batch once. Without a mesh: every row, ``0 .. B-1``."""
    rows = arr.detach().cpu().numpy() if torch.is_tensor(arr) else np.asarray(arr)
    r = 0 if mesh is None else mesh["data"].get_local_rank()
    b = rows.shape[0]
    return rows, np.arange(r * b, (r + 1) * b)


def draw_rows(axis, b, draw):
    """This rank's ``b`` rows of a random draw, ``draw(n)`` for ``n`` rows,
    made at the global batch's rows and cut to this rank's (``axis`` a
    :class:`DataAxis`; None: the whole batch is this process's), so that the
    ranks together draw what one process draws on the whole batch."""
    if axis is None:
        return draw(b)
    n, rows = axis.rows(b)
    return draw(n)[rows]


class _AllGather(torch.autograd.Function):
    """The group's ``x`` concatenated along ``dim``; backward, the sum of
    every rank's gradient of this rank's block (:class:`_ReduceScatter`,
    itself differentiable, so a double backward crosses the ranks too)."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, dim)

    @staticmethod
    def backward(ctx, g):
        return _ReduceScatter.apply(g, ctx.group, ctx.dim), None, None


class _ReduceScatter(torch.autograd.Function):
    """The sum over the group of ``x``, cut along ``dim`` into one block a
    rank: this rank's block. Backward: :class:`_AllGather`."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        # an all-reduce: gloo has no reduce-scatter
        y = x.contiguous().clone()
        dist.all_reduce(y, group=group)
        n, r = dist.get_world_size(group), dist.get_rank(group)
        return y.chunk(n, dim)[r].contiguous()

    @staticmethod
    def backward(ctx, g):
        return _AllGather.apply(g, ctx.group, ctx.dim), None, None


def all_gather_cat(x, group, dim=0):
    """Differentiable all-gather of ``x`` over ``group``, concatenated along
    ``dim`` in rank order."""
    return _AllGather.apply(x, group, dim)


def reduce_scatter(x, group, dim=0):
    """Differentiable reduce-scatter: the group's sum of ``x``, this rank's
    block of it along ``dim``."""
    return _ReduceScatter.apply(x, group, dim)


def reduce_grads(grads, group, divisor):
    """Sum the tensors ``grads`` over ``group`` (None: the world) in place
    and divide them by ``divisor``: one flat bucket a dtype, one all-reduce
    each."""
    for dt in sorted({g.dtype for g in grads}, key=str):
        gs = [g for g in grads if g.dtype == dt]
        flat = torch.cat([g.reshape(-1) for g in gs])
        dist.all_reduce(flat, group=group)
        flat /= divisor
        off = 0
        for g in gs:
            g.copy_(flat[off:off + g.numel()].view_as(g))
            off += g.numel()


@dataclass
class DataAxis:
    """The data axis of a mesh as the train steps use it: its process
    group, this process's rank on it and its size."""

    group: object
    rank: int
    size: int

    @staticmethod
    def of(mesh) -> Optional["DataAxis"]:
        if mesh is None:
            return None
        sub = mesh["data"]
        return DataAxis(sub.get_group(), sub.get_local_rank(), sub.size())

    def rows(self, local_b):
        """``(global_b, slice)``: draw per-sample randomness at the global
        batch's ``global_b`` rows and keep ``slice`` of them, so a step draws
        what the one-process step draws."""
        return local_b * self.size, slice(self.rank * local_b, (self.rank + 1) * local_b)

    def all_reduce_grads(self, params):
        """Average the ``.grad`` of ``params`` over the axis."""
        reduce_grads([p.grad for p in params if p.grad is not None], self.group, self.size)

    def mean(self, tensors):
        """The axis mean of each 0-d tensor of a list or dict (one
        all-reduce), in fp32."""
        if isinstance(tensors, dict):
            keys = [k for k, v in tensors.items() if torch.is_tensor(v)]
            vals = self.mean([tensors[k] for k in keys])
            return {**tensors, **dict(zip(keys, vals))}
        if not tensors:
            return tensors
        flat = torch.stack([t.detach().float().reshape(()) for t in tensors])
        dist.all_reduce(flat, group=self.group)
        flat /= self.size
        return list(flat.unbind())

    def gather(self, x):
        """The axis's blocks of ``x`` concatenated along dim 0 (the global
        batch), differentiably: the backward pass returns each rank the sum
        of every rank's gradient of its block."""
        if self.size == 1:
            return x
        return all_gather_cat(x, self.group)
