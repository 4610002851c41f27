"""A single-controller device mesh: the port's counterpart of
`jax.sharding.Mesh` and of the `lax` collectives that the JAX package's
`shard_map` bodies call.

The JAX package drives every multi-device path from one process: a mesh
of devices, each shard's program issued on its device, collectives
inside the program. The port keeps that design, with no
`torch.distributed`: a mesh is a list of `torch.device`s, each shard's
work is queued on its device by the one host thread, and a collective is
an explicit reduction over the shards' tensors in shard order, on the
mesh's first device. Replicated math (a Schur solve, an LM decision) runs
once, on the first device, and is copied to a shard only where the shard
reads it. Copies between distinct cards are stream-ordered by torch's
cross-device copy, with no host synchronization.

A mesh may repeat a device: `Mesh([cuda:0] * 4)` runs the 4-shard math
on one card (the shards' work then queues one after the other), and a
mesh of repeated `cpu` entries plays the part of XLA's forced host
device count.
"""

from __future__ import annotations

import functools

import torch


class Mesh:
    """An ordered list of devices along one named axis."""

    def __init__(self, devices, axis: str = "shard"):
        self.devices = [torch.device(d) for d in devices]
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        self.axis = axis

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def first(self) -> torch.device:
        """Where collectives land and replicated math runs."""
        return self.devices[0]

    @property
    def distinct(self) -> bool:
        """True when no device repeats."""
        return len(set(self.devices)) == len(self.devices)

    def __repr__(self) -> str:
        return f"Mesh({[str(d) for d in self.devices]}, axis={self.axis!r})"

    def shard(self, x: torch.Tensor, dim: int = 0) -> list:
        """x split into `size` equal blocks along dim, block i on device i
        (a view where it already lies there)."""
        n = x.shape[dim]
        if n % self.size:
            raise ValueError(f"dim {dim} of length {n} does not divide into "
                             f"{self.size} shards")
        m = n // self.size
        return [x.narrow(dim, i * m, m).to(d, non_blocking=True)
                for i, d in enumerate(self.devices)]

    def _gather(self, parts) -> list:
        return [p.to(self.first, non_blocking=True) for p in parts]

    def psum(self, parts) -> torch.Tensor:
        """Sum of the shards' tensors on the first device, added in shard
        order ((p0 + p1) + p2 ...): the same bits on every run."""
        return functools.reduce(torch.add, self._gather(parts))

    def pmin(self, parts) -> torch.Tensor:
        """Elementwise minimum of the shards' tensors, on the first
        device."""
        return functools.reduce(torch.minimum, self._gather(parts))

    def all_gather(self, parts, dim: int = 0) -> torch.Tensor:
        """The shards' tensors concatenated along dim in shard order
        (tiled), on the first device."""
        return torch.cat(self._gather(parts), dim=dim)


def make_mesh(n_devices: int | None = None, device="cuda",
              axis: str = "shard") -> Mesh:
    """A mesh of n distinct devices of `device`'s type (all of them by
    default); ValueError when the machine has fewer. `device="cpu"`
    repeats the CPU n times (1 by default), as XLA's forced host devices
    do. A mesh that repeats a card is built explicitly:
    `Mesh([torch.device("cuda", 0)] * n)`."""
    kind = torch.device(device).type
    if kind == "cpu":
        return Mesh([torch.device("cpu")] * (n_devices or 1), axis)
    have = torch.cuda.device_count() if kind == "cuda" else 0
    n = n_devices or have
    if have < n or n < 1:
        raise ValueError(f"mesh needs {n} {kind} devices, the machine has "
                         f"{have}")
    return Mesh([torch.device(kind, i) for i in range(n)], axis)


def spread_mesh(n: int, device="cuda", axis: str = "shard") -> Mesh:
    """n shards over n distinct devices of `device`'s type where the
    machine has them, else all n on `device` (one card, or the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and torch.cuda.device_count() >= n:
        return make_mesh(n, "cuda", axis)
    return Mesh([dev] * n, axis)

