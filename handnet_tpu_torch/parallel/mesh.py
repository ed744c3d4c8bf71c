"""Data parallelism: the counterpart of ``handnet_tpu/parallel/mesh.py``.

The JAX package builds one ``jax.sharding.Mesh`` with a ``data`` axis,
shards each batch along dim 0 over it and replicates the parameters; under
``jit`` every batch reduction (BatchNorm's statistics, a loss's normalizer,
the gradient) becomes a global collective, so a data-parallel step is the
whole-batch step.

Here a :class:`DataMesh` names the devices one process drives and, for a
multi-process run, its rank in a ``torch.distributed`` process group:

* :func:`init_data_parallel` joins the group of a ``torchrun`` launch (or one
  given by rank, world size and init method); each rank drives one card,
  ``cuda:LOCAL_RANK``, and trains through ``DistributedDataParallel``
  (``train/trainer.py``), whose gradient average the losses are written for
  (:func:`dp_scale`), with BatchNorm's statistics summed over the world
  (``nn/resnet.py``) and the losses' normalizers summed before their clamp;
* :func:`create_mesh` is one process over several devices, which serving
  uses (``apps/serve.py``: one pipeline replica and one set of CUDA graphs
  per card).

Nothing falls back on its own: a trainer given a mesh without a process
group raises, NCCL refuses two ranks on one card, and a failed collective
fails the step.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import datetime
import os
from typing import Any, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn as nn

__all__ = ["DataMesh", "create_mesh", "init_data_parallel", "shard_batch", "replicate",
           "all_reduce_sum", "dp_scale", "barrier", "rank_zero_first", "reduce_mean", "torchrun_mesh"]


@dataclasses.dataclass(frozen=True)
class DataMesh:
    """The data axis as one process sees it.

    ``devices``: the devices this process drives, one per data shard it
    holds; ``rank`` and ``world_size``: its place in ``group``, the process
    group (None for a one-process mesh). ``size`` is the number of data
    shards over all processes, JAX's ``mesh.size``."""

    devices: Tuple[torch.device, ...]
    rank: int = 0
    world_size: int = 1
    group: Optional[Any] = None

    @property
    def size(self) -> int:
        return self.world_size * len(self.devices)

    @property
    def device(self) -> torch.device:
        """The first (for a rank of a process group, the only) device."""
        return self.devices[0]

    @property
    def is_main(self) -> bool:
        """Rank 0: the process that writes files and logs."""
        return self.rank == 0


def create_mesh(n_devices: Optional[int] = None, device: str = "cuda") -> DataMesh:
    """A one-process mesh over the first ``n_devices`` cards (all of them
    when None), or, with ``device="cpu"``, over ``n_devices`` replicas on the
    CPU (one when None), as the JAX package's tests use virtual CPU devices.
    Raises where there are fewer cards than asked for."""
    kind = torch.device(device).type
    if kind == "cpu":
        return DataMesh(tuple(torch.device("cpu") for _ in range(n_devices or 1)))
    if kind != "cuda":
        raise ValueError(f"create_mesh: device {device!r} (cuda or cpu)")
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    n = count if n_devices is None else n_devices
    if n < 1 or n > count:
        raise RuntimeError(f"create_mesh: {n} cards asked for, {count} present; pass "
                           "device=\"cpu\" for a mesh on the CPU")
    return DataMesh(tuple(torch.device("cuda", i) for i in range(n)))


def _env_int(name: str, value: Optional[int]) -> int:
    if value is not None:
        return value
    if name not in os.environ:
        raise ValueError(f"init_data_parallel: {name} is neither given nor set (launch with "
                         "torchrun, or pass rank, world_size and init_method)")
    return int(os.environ[name])


def init_data_parallel(backend: Optional[str] = None, *, rank: Optional[int] = None,
                       world_size: Optional[int] = None, local_rank: Optional[int] = None,
                       init_method: Optional[str] = None, device: Optional[str] = None,
                       timeout: datetime.timedelta = datetime.timedelta(minutes=30)
                       ) -> DataMesh:
    """Join the process group and return this rank's mesh.

    ``rank``, ``world_size`` and ``local_rank`` default to ``torchrun``'s
    ``RANK``, ``WORLD_SIZE`` and ``LOCAL_RANK``; ``init_method`` to its
    ``env://`` rendezvous (else a ``file://`` or ``tcp://`` address).
    ``device``: None is ``cuda:LOCAL_RANK``, which raises where there is no
    such card; ``"cpu"`` trains on the CPU; an explicit card lets several
    ranks share one, which only gloo allows. ``backend``: None is NCCL on a
    card and gloo on the CPU; anything else is asked for explicitly.
    ``timeout`` bounds every collective: a rank that waits longer fails."""
    rank = _env_int("RANK", rank)
    world_size = _env_int("WORLD_SIZE", world_size)
    local_rank = local_rank if local_rank is not None else int(os.environ.get("LOCAL_RANK", rank))
    if device is None:
        if not torch.cuda.is_available() or local_rank >= torch.cuda.device_count():
            raise RuntimeError(f"init_data_parallel: no card cuda:{local_rank} for local rank "
                               f"{local_rank}; pass device=\"cpu\" to train on the CPU")
        device = f"cuda:{local_rank}"
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", local_rank)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if backend == "nccl" and (dev.type != "cuda" or dev.index != local_rank):
        raise ValueError(f"init_data_parallel: NCCL drives one card per rank, cuda:LOCAL_RANK "
                         f"(cuda:{local_rank}), not {dev}; ranks that share a card need "
                         "backend=\"gloo\"")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    kwargs = {"device_id": dev} if backend == "nccl" else {}
    dist.init_process_group(backend, init_method=init_method or "env://", rank=rank,
                            world_size=world_size, timeout=timeout, **kwargs)
    return DataMesh((dev,), rank, world_size, dist.group.WORLD)


def torchrun_mesh(device: Optional[str] = None) -> Optional[DataMesh]:
    """The training CLIs' mesh: :func:`init_data_parallel` on ``device``
    where ``torchrun`` launched this process (``RANK`` and ``WORLD_SIZE``
    are set), else None."""
    if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        return None
    return init_data_parallel(device=device)


def _blocks(mesh: DataMesh, x):
    """``x``'s rows for each device of this process: block ``rank *
    len(devices) + i`` of ``mesh.size`` equal blocks along dim 0."""
    n = x.shape[0]
    if n % mesh.size:
        raise ValueError(f"shard_batch: a batch of {n} does not divide over {mesh.size} shards")
    k = n // mesh.size
    first = mesh.rank * len(mesh.devices)
    return [torch.as_tensor(x[(first + i) * k:(first + i + 1) * k]).to(dev)
            for i, dev in enumerate(mesh.devices)]


def shard_batch(mesh: DataMesh, batch) -> List[Any]:
    """This process's shards of a host batch (a tensor or array, or a dict or
    list of them): one tree per device of ``mesh.devices``, the device's
    contiguous block along dim 0 on it. Block ``r`` of ``mesh.size`` is the
    shard JAX's ``shard_batch`` puts on device ``r``; a batch that does not
    divide raises ``ValueError``. A rank of a process group gets one tree:
    ``(local,) = shard_batch(mesh, batch)``."""
    def walk(node):
        if isinstance(node, dict):
            parts = {k: walk(v) for k, v in node.items()}
            return [{k: v[i] for k, v in parts.items()} for i in range(len(mesh.devices))]
        if isinstance(node, (list, tuple)):
            parts = [walk(v) for v in node]
            return [type(node)(p[i] for p in parts) for i in range(len(mesh.devices))]
        return _blocks(mesh, node)
    return walk(batch)


def replicate(mesh: DataMesh, module: nn.Module) -> List[nn.Module]:
    """One copy of ``module`` per device of ``mesh.devices`` (the first is
    ``module`` itself, moved), after broadcasting rank 0's parameters and
    buffers over the process group, if there is one: JAX's replicated
    parameters."""
    if mesh.group is not None and mesh.world_size > 1:
        tensors = list(module.parameters()) + list(module.buffers())
        with torch.no_grad():
            for dtype in sorted({t.dtype for t in tensors}, key=str):   # one broadcast each
                group = [t for t in tensors if t.dtype == dtype]
                flat = torch.cat([t.reshape(-1) for t in group])
                dist.broadcast(flat, 0, group=mesh.group)
                for t, part in zip(group, flat.split([t.numel() for t in group])):
                    t.copy_(part.view_as(t))
    copies = [module.to(mesh.devices[0])]
    for dev in mesh.devices[1:]:
        copies.append(copy.deepcopy(module).to(dev))
    return copies


class _AllReduceSum(torch.autograd.Function):
    """Sum over the group; the gradient of a sum over ranks is the sum of
    the ranks' gradients."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def all_reduce_sum(x: torch.Tensor, mesh: Optional[DataMesh]) -> torch.Tensor:
    """``x`` summed over the mesh's ranks, differentiably; ``x`` itself for
    no mesh or a world of one. Every rank must call it, in the same order."""
    if mesh is None or mesh.world_size == 1:
        return x
    if mesh.group is None:
        raise ValueError("all_reduce_sum: a mesh with several ranks and no process group")
    return _AllReduceSum.apply(x, mesh.group)


def dp_scale(mesh: Optional[DataMesh]) -> int:
    """The factor of a loss term that is a sum over the batch divided by a
    global normalizer: DDP averages the ranks' gradients, so each rank's
    share is scaled by the world size for the average to be the whole-batch
    gradient. A mean over equal shards needs none."""
    return 1 if mesh is None else mesh.world_size


def barrier(mesh: Optional[DataMesh]) -> None:
    """Wait for every rank (nothing to wait for without a process group)."""
    if mesh is not None and mesh.group is not None and mesh.world_size > 1:
        dist.barrier(group=mesh.group)


@contextlib.contextmanager
def rank_zero_first(mesh: Optional[DataMesh]):
    """Rank 0 runs the block first and the other ranks after it: a file that
    rank 0 writes (a synthetic tree, an index cache) is there for them."""
    if mesh is not None and not mesh.is_main:
        barrier(mesh)
    yield
    if mesh is not None and mesh.is_main:
        barrier(mesh)


def reduce_mean(values: Sequence[torch.Tensor], mesh: Optional[DataMesh]) -> List[torch.Tensor]:
    """The ranks' mean of each scalar in ``values`` (detached), in one
    collective; ``values`` themselves for no mesh or a world of one."""
    if mesh is None or mesh.world_size == 1:
        return [v.detach() for v in values]
    stacked = torch.stack([v.detach().float() for v in values])
    total = all_reduce_sum(stacked, mesh) / mesh.world_size
    return list(total.unbind())
