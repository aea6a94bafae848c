"""Device mesh and distributed initialisation.

Counterpart of ``sparsifyme_tpu.parallel.mesh``. JAX drives a ``Mesh`` of
devices from one controller (``shard_map``); the port does the same in one
process. A :class:`Mesh` is a numpy array of ``torch.device``s with axis
names, one entry per rank. Ranks may share a card: ``["cuda:0"] * 4`` is a
4-rank ring on one card, as JAX's virtual CPU devices share one CPU, and
``["cpu"] * 8`` is the tests' mesh. On a host with several cards the ranks
map onto them and the ring's exchange becomes a peer copy over NVLink.

A multi-process backend (one rank per process, NCCL) is not ported:
:func:`init_distributed` only starts ``torch.distributed``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Start ``torch.distributed`` (NCCL with a card, else gloo) for a
    multi-process run; a no-op for one process. ``coordinator_address`` is
    ``host:port`` or a URL such as ``tcp://localhost:29500``."""
    if num_processes is None or num_processes <= 1:
        return
    import torch.distributed as dist

    if coordinator_address is None:
        raise ValueError("a multi-process run needs coordinator_address")
    url = (coordinator_address if "://" in coordinator_address
           else f"tcp://{coordinator_address}")
    dist.init_process_group(
        backend="nccl" if torch.cuda.is_available() else "gloo",
        init_method=url, world_size=num_processes, rank=process_id)


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """Named device mesh: ``devices`` is an object array of
    ``torch.device``s whose axes are ``axis_names``."""

    devices: np.ndarray
    axis_names: Tuple[str, ...]

    @property
    def shape(self) -> Dict[str, int]:
        """Axis name -> size, as ``jax.sharding.Mesh.shape``."""
        return dict(zip(self.axis_names, self.devices.shape))

    def axis_devices(self, axis: str) -> List[torch.device]:
        """The ranks along ``axis`` at index 0 of every other axis."""
        ax = self.axis_names.index(axis)
        idx = tuple(slice(None) if i == ax else 0
                    for i in range(self.devices.ndim))
        return list(self.devices[idx])


def _device(d) -> torch.device:
    dev = torch.device(d)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def make_mesh(
    shape: Optional[Sequence[int]] = None,
    axis_names: Tuple[str, ...] = ("data", "model"),
    devices: Optional[Sequence] = None,
) -> Mesh:
    """Build a named device mesh.

    ``devices`` defaults to one rank per card (``cuda:0`` ...); with no
    card this raises, as entry points do for ``device=None``. Entries may
    repeat (ranks sharing a device) but may not mix the CPU and cards. The
    default shape puts all ranks on the one axis, or splits them into two
    roughly square factors (data-major) for two or more axes; an explicit
    ``shape`` wins.
    """
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass devices=['cpu'] * n to "
                "run the plain PyTorch versions on the CPU")
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    devs = [_device(d) for d in devices]
    kinds = {d.type for d in devs}
    if not kinds <= {"cpu", "cuda"} or len(kinds) != 1:
        raise ValueError(f"a mesh takes cuda devices or cpu, not {kinds}")
    n = len(devs)
    if shape is None:
        if len(axis_names) == 1:
            shape = (n,)
        else:
            d = 1
            for f in range(int(np.sqrt(n)), 0, -1):
                if n % f == 0:
                    d = f
                    break
            shape = (d, n // d) + (1,) * (len(axis_names) - 2)
    if int(np.prod(shape)) != n:
        raise ValueError(f"mesh shape {shape} != device count {n}")
    arr = np.empty(n, dtype=object)
    arr[:] = devs
    return Mesh(arr.reshape(tuple(shape)), tuple(axis_names))


def shard(x: torch.Tensor, spec: Tuple[Optional[str], ...],
          mesh: Mesh) -> List[torch.Tensor]:
    """One tensor per rank (mesh order): the rank's block of ``x`` on its
    device, a view where ``x`` already lies there. ``spec`` names, for
    each axis of ``x``, the mesh axis it is split over evenly, or None
    where it is whole, as a JAX ``PartitionSpec`` does."""
    if len(spec) != x.ndim:
        raise ValueError(f"spec {spec} does not fit a {x.ndim}-d tensor")
    for ax, name in enumerate(spec):
        if name is not None and x.shape[ax] % mesh.shape[name]:
            raise ValueError(f"axis {ax} of size {x.shape[ax]} not "
                             f"divisible by mesh axis {name!r} of size "
                             f"{mesh.shape[name]}")
    out = []
    for idx in np.ndindex(mesh.devices.shape):
        sl = []
        for ax, name in enumerate(spec):
            if name is None:
                sl.append(slice(None))
                continue
            size = x.shape[ax] // mesh.shape[name]
            i = idx[mesh.axis_names.index(name)]
            sl.append(slice(i * size, (i + 1) * size))
        out.append(x[tuple(sl)].to(mesh.devices[idx]))
    return out


def shard_batch(x: torch.Tensor, mesh: Mesh,
                axis: str = "data") -> List[torch.Tensor]:
    """One tensor per rank (mesh order): the rank's slice of ``x``'s
    leading dim, split evenly over ``axis``, on the rank's device."""
    return shard(x, (axis,) + (None,) * (x.ndim - 1), mesh)


def replicate(x: torch.Tensor, mesh: Mesh) -> List[torch.Tensor]:
    """``x`` on every rank's device (mesh order)."""
    return [x.to(d) for d in mesh.devices.reshape(-1)]
