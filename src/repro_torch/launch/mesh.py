"""Port of ``repro.launch.mesh``: the trainer's single-axis device mesh.

The reference is single-controller: one host process owns every worker's
environment, replay buffer and RNG stream, and only the device compute is
split over a one-axis ``"data"`` mesh (``shard_map`` inside ``jax.jit``).
The port keeps that program: ONE process drives a list of devices.  Each
shard holds its ``[W_pad / nd, ...]`` slice of the stacked worker state on
its own device, and the reference's ``all_gather`` becomes device-to-device
copies (``DistributedTrainer``).

A ``HostMesh`` may name one device several times.  On the CPU every shard
is a logical shard of ``cpu``; on one GPU an explicit ``pool`` such as four
entries of ``cuda:0`` runs the sharded program, its launches and its bits
on the one card.  That is the counterpart of the reference's forced host
device pool (``--xla_force_host_platform_device_count``): it shows the
sharding's overhead, never a speedup.

``make_production_mesh`` is the dry-run's mesh: the reference's 16 x 16
pod (or two of them) as shapes and axis names, its devices ``meta``
placeholders, as the reference's are host placeholders.  Nothing runs on
it: ``launch/specs.py`` and ``launch/dryrun.py`` read its axes and sizes.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Sequence

import torch

from repro_torch.device import resolve_device


@dataclass(frozen=True)
class HostMesh:
    """Devices along one ``"data"`` axis; shard ``s`` holds workers
    ``shard_slices(W_pad, mesh)[s]`` on ``devices[s]``."""

    devices: tuple[torch.device, ...]
    axis_names: tuple[str, ...] = ("data",)

    def __post_init__(self):
        if not self.devices:
            raise ValueError("a mesh needs at least one device")

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def shape(self) -> dict[str, int]:
        return {"data": self.size}


@dataclass(frozen=True)
class ProductionMesh:
    """A mesh of named axes that only describes a layout: ``shape`` maps
    each axis to its size, ``devices`` are ``meta`` placeholders."""

    axis_names: tuple[str, ...]
    dims: tuple[int, ...]

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.dims))

    @property
    def size(self) -> int:
        return math.prod(self.dims)

    @property
    def devices(self) -> tuple[torch.device, ...]:
        return (torch.device("meta"),) * self.size


def make_production_mesh(*, multi_pod: bool = False) -> ProductionMesh:
    """The reference's production mesh: 16 x 16 = 256 chips per pod
    ("data", "model"), or 2 pods = 512 chips ("pod", "data", "model")."""
    if multi_pod:
        return ProductionMesh(("pod", "data", "model"), (2, 16, 16))
    return ProductionMesh(("data", "model"), (16, 16))


def make_host_mesh(nd: int | None = None, *,
                   device: str | torch.device | None = None,
                   pool: Sequence[str | torch.device] | None = None
                   ) -> HostMesh:
    """The first ``nd`` devices of a pool on one ``"data"`` axis (the RL
    trainer's mesh).

    ``pool`` names the devices explicitly, repeats allowed (four entries of
    ``cuda:0`` shard over one card).  Without it the pool is every visible
    card on CUDA, with ``device`` first, and ``nd`` logical shards of the
    CPU on the CPU.  ``nd=None`` takes the whole pool (one shard on the
    CPU).  ``nd=1`` is ``device`` itself.  An ``nd`` larger than the pool
    raises: more shards than cards needs an explicit ``pool``.
    """
    if pool is not None:
        devices = [resolve_device(d) for d in pool]
    else:
        dev = resolve_device(device)
        if dev.type == "cuda":
            first = dev.index if dev.index is not None \
                else torch.cuda.current_device()
            devices = [torch.device("cuda", first)] + [
                torch.device("cuda", i)
                for i in range(torch.cuda.device_count()) if i != first]
            if nd == 1:
                devices = [dev]
        else:
            devices = [dev] * (1 if nd is None else max(nd, 1))
    if nd is None:
        nd = len(devices)
    if nd <= 0 or nd > len(devices):
        where = "the pool" if pool is not None else "visible devices"
        raise ValueError(f"nd={nd} outside [1, {len(devices)}] {where}; pass "
                         f"an explicit pool to put several shards on a card")
    return HostMesh(tuple(devices[:nd]))


def padded_worker_count(n_workers: int, mesh: HostMesh) -> int:
    """Smallest worker count >= ``n_workers`` that tiles the mesh evenly.

    A fleet whose worker count does not divide the mesh pads to this size
    with DEAD worker slots (no molecules, zero batches, zero gradients,
    masked out of every cross-worker mean): see ``DistributedTrainer``.
    """
    if n_workers <= 0:
        raise ValueError(f"n_workers must be positive, got {n_workers}")
    return -(-n_workers // mesh.size) * mesh.size


def shard_slices(n_rows: int, mesh: HostMesh) -> list[slice]:
    """The leading-axis rows each shard holds (the counterpart of the
    reference's ``fleet_sharding``: the worker axis split over ``"data"``,
    everything else whole)."""
    if n_rows % mesh.size:
        raise ValueError(f"{n_rows} rows do not divide a mesh of {mesh.size}")
    per = n_rows // mesh.size
    return [slice(s * per, (s + 1) * per) for s in range(mesh.size)]


def batch_axes(mesh: HostMesh | ProductionMesh) -> tuple[str, ...]:
    """The data-parallel axes of a mesh (everything except "model")."""
    return tuple(a for a in mesh.axis_names if a != "model")


def mesh_tp(mesh: HostMesh | ProductionMesh) -> int:
    return mesh.shape.get("model", 1)
