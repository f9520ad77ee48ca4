"""Meshes over ``torch.distributed`` — the port of ``repro.launch.mesh``.

``repro`` builds ``jax.sharding.Mesh``es over the devices one process
sees; the port runs one process (rank) per device and builds each mesh as
a ``torch.distributed.DeviceMesh`` over the ranks, with ``repro``'s axis
names and shapes:

* ``make_client_mesh(n)``: ``("clients",)`` of n ranks, the K-client axis
  of ``core.sfl.SflLLM(mesh=)``;
* ``make_debug_mesh(data, model)``: ``("data", "model")``;
* ``make_production_mesh(multi_pod=)``: ``("data", "model")`` (16, 16) or
  ``("pod", "data", "model")`` (2, 16, 16).

A mesh's size must equal the world size.  With no process group the
world is one rank: every axis has size 1, no collective is issued, and the
mesh holds no ``DeviceMesh``.

Process groups come from the environment that ``torchrun`` sets
(:func:`init_from_env`: ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``MASTER_ADDR``/``MASTER_PORT``; one card a rank) or, for tests and
spawned workers, from a ``FileStore`` (:func:`init_file_store`), so that
parallel test workers never race for a TCP port; a dry-run joins a fake
world (:func:`init_fake`) and plays one of its ranks.  CUDA tensors go over
NCCL, CPU tensors over gloo.  A gloo group may also carry CUDA tensors
(two ranks sharing one card, where NCCL refuses): the collectives in
``sharding.collectives`` then stage them through host memory, which the
mesh states on a printed line when it is built.
"""
from __future__ import annotations

import math
import os
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist


def default_backend(device) -> str:
    """NCCL for a CUDA device, gloo for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def init_from_env(device="cuda", backend: Optional[str] = None) -> torch.device:
    """Join the process group ``torchrun`` describes in the environment and
    return this rank's device (``cuda:LOCAL_RANK``, or the CPU).  Without
    ``WORLD_SIZE`` in the environment nothing is joined: a world of one."""
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(dev)
    if "WORLD_SIZE" in os.environ and not dist.is_initialized():
        dist.init_process_group(backend or default_backend(dev), init_method="env://",
                                rank=int(os.environ["RANK"]),
                                world_size=int(os.environ["WORLD_SIZE"]))
    return dev


def init_file_store(path: str, rank: int, world_size: int, device="cpu",
                    backend: Optional[str] = None) -> torch.device:
    """Join a process group whose rendezvous is the file ``path`` (a
    ``FileStore``; every rank passes the same path).  Returns this rank's
    device: ``cuda:rank % device_count`` for CUDA, else the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    store = dist.FileStore(path, world_size)
    dist.init_process_group(backend or default_backend(dev), store=store, rank=rank,
                            world_size=world_size)
    return dev


def init_fake(world: int, rank: int = 0) -> None:
    """Join a fake world of ``world`` ranks as ``rank``
    (``torch.distributed``'s "fake" backend over a ``FakeStore``): every
    collective returns at once with its result's shape and no data, so
    one process can evaluate one rank of a production mesh abstractly
    (``launch.dryrun``).  A group already joined is left first; the fake
    group is global to the process."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=rank, world_size=world)


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def global_rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


@dataclass
class Mesh:
    """Named axes over the ranks.  ``shape`` maps axis name -> size in
    order (as ``jax.sharding.Mesh.shape`` does), so the rule table of
    ``sharding.specs`` reads a port mesh and a ``repro`` mesh alike.
    ``device_mesh`` is the ``DeviceMesh`` (None for a world of one),
    ``device`` the card or CPU this rank computes on, ``backend`` the
    process group's backend (None for a world of one)."""

    axis_names: Tuple[str, ...]
    shape: Dict[str, int]
    device: torch.device
    device_mesh: Optional[object] = None
    backend: Optional[str] = None

    def group(self, axis: str):
        """The process group of this rank's line along ``axis``; None in a
        world of one or for an axis the mesh lacks (nothing to exchange).
        A size-1 axis of a real group still has its one-rank group, so its
        collectives go through the backend."""
        if self.device_mesh is None or axis not in self.shape:
            return None
        return self.device_mesh.get_group(axis)

    def axis_rank(self, axis: str) -> int:
        """This rank's coordinate along ``axis`` (0 for a size-1 axis)."""
        if self.device_mesh is None or axis not in self.shape:
            return 0
        return self.device_mesh.get_local_rank(axis)

    def group_over(self, axes) -> Optional[object]:
        """The process group of this rank's block over several ``axes``
        (those the mesh lacks dropped): one axis's group as ``group``
        gives it, or for more than one a group made once by every rank
        (a collective call: each rank must ask for the same axes in the
        same order).  None in a world of one or for no axes."""
        axes = tuple(a for a in axes if a in self.shape)
        if self.device_mesh is None or not axes:
            return None
        if len(axes) == 1:
            return self.group(axes[0])
        cache = self.__dict__.setdefault("_groups", {})
        if axes not in cache:
            ranks = self.device_mesh.mesh
            order = [self.axis_names.index(a) for a in axes]
            rest = [i for i in range(len(self.axis_names)) if i not in order]
            n = math.prod(self.shape[a] for a in axes)
            rows = ranks.permute(rest + order).reshape(-1, n)
            me = global_rank()
            for row in rows.tolist():
                g = dist.new_group(row)
                if me in row:
                    cache[axes] = g
        return cache[axes]

    @property
    def staged(self) -> bool:
        """Collectives stage CUDA tensors through host memory (a gloo group
        carrying card tensors)."""
        return self.backend == "gloo" and self.device.type == "cuda"


def make_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...], device=None) -> Mesh:
    """A mesh of ``shape`` named ``axes`` over every rank of the default
    process group (a world of one without a group).  ``device``: this
    rank's compute device (default: the current CUDA device when the group
    is NCCL, else the CPU)."""
    n = 1
    for s in shape:
        n *= int(s)
    world = world_size()
    if n != world:
        raise ValueError(f"mesh {dict(zip(axes, shape))} has {n} ranks; the world has {world}")
    backend = dist.get_backend() if dist.is_initialized() else None
    if device is None:
        device = (torch.device("cuda", torch.cuda.current_device()) if backend == "nccl"
                  else torch.device("cpu"))
    device = torch.device(device)
    mesh = Mesh(tuple(axes), {a: int(s) for a, s in zip(axes, shape)}, device,
                backend=backend)
    if dist.is_initialized():
        from torch.distributed.device_mesh import init_device_mesh
        # a gloo group communicates through the host whatever the compute
        # device is, so its DeviceMesh is a CPU one
        mesh.device_mesh = init_device_mesh("cuda" if backend == "nccl" else "cpu",
                                            tuple(int(s) for s in shape),
                                            mesh_dim_names=tuple(axes))
        if mesh.staged and global_rank() == 0:
            print(f"[mesh] {dict(mesh.shape)} over gloo with {device.type} tensors: "
                  "collectives stage them through host memory", flush=True)
    return mesh


def make_client_mesh(num_devices: Optional[int] = None, device=None) -> Mesh:
    """1-D ``("clients",)`` mesh for the SFL round: the K-client axis of the
    stacked adapters, optimizer moments, error-feedback accumulators and
    batches is cut over it (K a multiple of its size, else replicated).
    Default size: the world."""
    return make_mesh((num_devices or world_size(),), ("clients",), device)


def make_debug_mesh(data: int = 2, model: int = 2, device=None) -> Mesh:
    """Small ``("data", "model")`` mesh for tests."""
    return make_mesh((data, model), ("data", "model"), device)


def make_production_mesh(*, multi_pod: bool = False, device=None) -> Mesh:
    """``repro``'s pod meshes: (16, 16) ``("data", "model")``, or (2, 16,
    16) ``("pod", "data", "model")`` across two pods."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device)
