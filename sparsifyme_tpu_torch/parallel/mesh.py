"""Device mesh and distributed initialisation.

Counterpart of ``sparsifyme_tpu.parallel.mesh``. A :class:`Mesh` is a numpy
array of ``torch.device``s with axis names, one entry per rank. It comes in
two kinds.

* **One process plays every rank** (``make_mesh(devices=[...])``). JAX
  drives a mesh from one controller (``shard_map``); the port does the same
  in one process. Ranks may share a card: ``["cuda:0"] * 4`` is a 4-rank
  ring on one card, as JAX's virtual CPU devices share one CPU, and
  ``["cpu"] * 8`` is the tests' mesh. On a host with several cards the
  ranks map onto them and the ring's exchange becomes a peer copy.
* **One rank per process** (a process mesh). After :func:`init_distributed`
  (or ``torch.distributed.init_process_group``), ``make_mesh()`` with no
  ``devices`` spans the process group, as JAX's ``make_mesh`` over
  ``jax.devices()`` does after ``jax.distributed.initialize``. Process
  ``r`` plays flat rank ``r`` on ``cuda:LOCAL_RANK`` over NCCL, or on the
  CPU over gloo; NCCL takes one card per rank. The mesh holds one process
  group per axis and knows this process's index
  (:attr:`Mesh.process_index`). A rank set gets one group per process,
  shared by every mesh that has it (the default group for the whole world),
  made with ``dist.new_group`` in the same order on every process.

**The process contract.** On a process mesh a function gets and returns
what ``shard_map`` hands its body: this rank's block under the function's
specs. The sharded SpMMs take this rank's block of the planes (a
:class:`~..containers.Sparse24`, :func:`~.spmm_sharded.shard_planes`) and
of B, and return this rank's block of C; the train step takes and returns
this rank's slabs of the parameters and its batch shard. Functions that
take or return one tensor per rank (:func:`shard`, :func:`shard_batch`,
:func:`replicate` and the collectives) take and return one tensor per rank
*that this process plays*: every rank of a one-process mesh, in mesh order
(:attr:`Mesh.local_ranks`), or ``[block]`` on a process mesh. :func:`shard`
gives those ranks' blocks of a whole tensor; ``collectives.unshard``
all-gathers the blocks back into the whole. Nothing else gathers: config 4
times the ring without gathering C, and the train step runs its steps
without gathering the parameters, as JAX's jitted step leaves them
sharded. A CUDA tensor on a gloo mesh raises, and so does a CPU tensor on
an NCCL mesh (:meth:`Mesh.check`).
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    timeout_s: Optional[float] = None,
) -> None:
    """Start ``torch.distributed`` for a run with one rank per process:
    NCCL with a card, gloo without one.

    Called with no arguments under ``torch.distributed.run`` it takes
    ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and
    ``MASTER_PORT`` from the environment (``env://``), also at a world
    size of 1. With ``coordinator_address`` (``host:port`` or a URL such
    as ``tcp://localhost:29500`` or ``file:///path``) and
    ``num_processes``, a ``process_id`` of None is read from ``RANK``;
    where that is unset too this raises ``ValueError``. It is a no-op for
    one process (``num_processes`` of 1 or less, or no arguments outside a
    launcher), as in JAX, and when the group already runs. On a card it
    makes ``cuda:LOCAL_RANK`` (default: the rank modulo the card count)
    the current device and binds the NCCL group to it. ``timeout_s``
    bounds each collective's wait (torch's default otherwise)."""
    import torch.distributed as dist

    if dist.is_initialized():
        return
    env = os.environ
    if coordinator_address is None and num_processes is None:
        if "WORLD_SIZE" not in env or "MASTER_ADDR" not in env:
            return  # no launcher: one process
        num_processes = int(env["WORLD_SIZE"])
        url = "env://"
    else:
        if num_processes is None or num_processes <= 1:
            return
        if coordinator_address is None:
            raise ValueError("a multi-process run needs coordinator_address")
        url = (coordinator_address if "://" in coordinator_address
               else f"tcp://{coordinator_address}")
    if process_id is None:
        if "RANK" not in env:
            raise ValueError(
                f"init_distributed: the rank of this process among "
                f"{num_processes} is missing: pass process_id or set RANK")
        process_id = int(env["RANK"])
    kw = {}
    if timeout_s is not None:
        kw["timeout"] = datetime.timedelta(seconds=timeout_s)
    if torch.cuda.is_available():
        local = int(env.get("LOCAL_RANK",
                            process_id % torch.cuda.device_count()))
        torch.cuda.set_device(local)
        kw.update(backend="nccl", device_id=torch.device("cuda", local))
    else:
        kw.update(backend="gloo")
    dist.init_process_group(init_method=url, world_size=num_processes,
                            rank=process_id, **kw)


def start_processes(cpu: bool = False) -> None:
    """:func:`init_distributed` for an entry point run under
    ``torch.distributed.run``: NCCL ranks on cards, or gloo ranks on the
    CPU only where ``cpu`` asks for them. Raises ``RuntimeError`` outside a
    launcher, without a card unless ``cpu`` is given, and where the group
    runs another backend than the one asked for."""
    import torch.distributed as dist

    if not cpu and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass --cpu to run "
                           "the ranks on the CPU over gloo")
    init_distributed()
    if not dist.is_initialized():
        raise RuntimeError("a run with one rank per process runs under "
                           "torch.distributed.run")
    want = "gloo" if cpu else "nccl"
    if dist.get_backend() != want:
        got = dist.get_backend()
        dist.destroy_process_group()
        raise RuntimeError(
            f"{'--cpu runs gloo ranks' if cpu else 'ranks on cards run NCCL'}"
            f", but the process group runs {got}"
            + ("; hide the cards (CUDA_VISIBLE_DEVICES=) to run on the CPU"
               if cpu else ""))


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """Named device mesh: ``devices`` is an object array of
    ``torch.device``s whose axes are ``axis_names``. A process mesh also
    holds this process's flat rank (``process_index``) and, per axis, the
    process group of this process's ranks along it (``groups``)."""

    devices: np.ndarray
    axis_names: Tuple[str, ...]
    process_index: Optional[int] = None
    groups: Optional[Dict[str, object]] = None

    @property
    def shape(self) -> Dict[str, int]:
        """Axis name -> size, as ``jax.sharding.Mesh.shape``."""
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def is_process_mesh(self) -> bool:
        return self.process_index is not None

    @property
    def local_ranks(self) -> List[int]:
        """Flat ranks (mesh order) that this process plays."""
        if self.is_process_mesh:
            return [self.process_index]
        return list(range(self.devices.size))

    def coords(self, rank: int) -> Tuple[int, ...]:
        """Mesh index of flat rank ``rank``."""
        return tuple(int(i) for i in np.unravel_index(rank,
                                                      self.devices.shape))

    def axis_index(self, axis: str) -> int:
        """This process's index along ``axis`` (``lax.axis_index``)."""
        return self.coords(self.process_index)[self.axis_names.index(axis)]

    def axis_devices(self, axis: str) -> List[torch.device]:
        """The ranks along ``axis`` at index 0 of every other axis."""
        ax = self.axis_names.index(axis)
        idx = tuple(slice(None) if i == ax else 0
                    for i in range(self.devices.ndim))
        return list(self.devices[idx])

    def axis_groups(self, axis: str) -> List[List[int]]:
        """Flat ranks of each group along ``axis`` (ranks that share every
        other mesh index), each group ordered by its index on ``axis``."""
        ax = self.axis_names.index(axis)
        flat = np.arange(self.devices.size).reshape(self.devices.shape)
        return np.moveaxis(flat, ax, -1).reshape(-1, flat.shape[ax]).tolist()

    def group(self, axis: str):
        """The process group of this process's ranks along ``axis``."""
        return self.groups[axis]

    def ring_peers(self, axis: str) -> Tuple[int, int]:
        """Flat ranks (= process ranks) of this process's left and right
        neighbours on the ring along ``axis``."""
        grp = next(g for g in self.axis_groups(axis)
                   if self.process_index in g)
        i, p = grp.index(self.process_index), len(grp)
        return grp[(i - 1) % p], grp[(i + 1) % p]

    @property
    def device(self) -> torch.device:
        """This process's device (a process mesh)."""
        return self.devices.reshape(-1)[self.process_index]

    def check(self, what: str, *tensors: torch.Tensor) -> None:
        """On a process mesh, refuse tensors that do not lie on the kind
        of device the group's backend carries (NCCL: cards, gloo: CPU)."""
        if not self.is_process_mesh:
            return
        want = self.device.type
        for t in tensors:
            if t.device.type != want:
                raise ValueError(
                    f"{what}: a {t.device.type} tensor on a process mesh of "
                    f"{want} ranks (backend "
                    f"{'nccl' if want == 'cuda' else 'gloo'})")


def _device(d) -> torch.device:
    dev = torch.device(d)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _default_shape(n: int, axis_names: Tuple[str, ...]) -> Tuple[int, ...]:
    if len(axis_names) == 1:
        return (n,)
    d = 1
    for f in range(int(np.sqrt(n)), 0, -1):
        if n % f == 0:
            d = f
            break
    return (d, n // d) + (1,) * (len(axis_names) - 2)


def _process_mesh(shape, axis_names: Tuple[str, ...]) -> Mesh:
    import torch.distributed as dist

    backend = dist.get_backend()
    if backend == "nccl":
        dev = torch.device("cuda", torch.cuda.current_device())
    elif backend == "gloo":
        if torch.cuda.is_available():
            raise ValueError("a process mesh on a card runs over NCCL; this "
                             "process group uses gloo")
        dev = torch.device("cpu")
    else:
        raise ValueError(f"a process mesh takes nccl or gloo, not {backend}")
    n = dist.get_world_size()
    shape = tuple(shape) if shape is not None else _default_shape(
        n, axis_names)
    if int(np.prod(shape)) != n:
        raise ValueError(f"mesh shape {shape} != process count {n}")
    names = [None] * n
    dist.all_gather_object(names, str(dev))
    arr = np.empty(n, dtype=object)
    arr[:] = [torch.device(s) for s in names]
    mesh = Mesh(arr.reshape(shape), tuple(axis_names),
                process_index=dist.get_rank(), groups={})
    # every process asks for every group, in one order
    for axis in axis_names:
        for ranks in mesh.axis_groups(axis):
            g = _rank_group(ranks)
            if mesh.process_index in ranks:
                mesh.groups[axis] = g
    return mesh


# rank set -> its process group, under the key None the default group they
# were made in (a new default group starts a new cache)
_GROUPS: Dict[Optional[Tuple[int, ...]], object] = {}


def _rank_group(ranks: Sequence[int]):
    """The one process group of ``ranks`` in this process: the default
    group for the whole world, else made with ``dist.new_group`` on first
    use. Every process asks for the same rank sets in the same order, so
    every process makes the same groups in the same order."""
    import torch.distributed as dist

    world = dist.group.WORLD
    if _GROUPS.get(None) is not world:
        _GROUPS.clear()
        _GROUPS[None] = world
    key = tuple(ranks)
    if key not in _GROUPS:
        _GROUPS[key] = (world if len(key) == dist.get_world_size()
                        else dist.new_group(list(key)))
    return _GROUPS[key]


def make_mesh(
    shape: Optional[Sequence[int]] = None,
    axis_names: Tuple[str, ...] = ("data", "model"),
    devices: Optional[Sequence] = None,
) -> Mesh:
    """Build a named device mesh.

    With ``devices`` one process plays every rank. Entries may repeat
    (ranks sharing a device) but may not mix the CPU and cards. With no
    ``devices`` the mesh spans the process group where
    ``torch.distributed`` runs (a process mesh; every process must call
    this, in the same order as its other meshes), else one rank per card
    (``cuda:0`` ...), and with no card this raises, as entry points do for
    ``device=None``. The default shape puts all ranks on the one axis, or
    splits them into two roughly square factors (data-major) for two or
    more axes; an explicit ``shape`` wins.
    """
    if devices is None:
        import torch.distributed as dist

        if dist.is_available() and dist.is_initialized():
            return _process_mesh(shape, tuple(axis_names))
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
        shape = _default_shape(n, tuple(axis_names))
    if int(np.prod(shape)) != n:
        raise ValueError(f"mesh shape {shape} != device count {n}")
    arr = np.empty(n, dtype=object)
    arr[:] = devs
    return Mesh(arr.reshape(tuple(shape)), tuple(axis_names))


def shard(x: torch.Tensor, spec: Tuple[Optional[str], ...],
          mesh: Mesh) -> List[torch.Tensor]:
    """One tensor per rank that this process plays (mesh order): the
    rank's block of ``x`` on its device, a view where ``x`` already lies
    there. ``spec`` names, for each axis of ``x``, the mesh axis it is
    split over evenly, or None where it is whole, as a JAX
    ``PartitionSpec`` does."""
    if len(spec) != x.ndim:
        raise ValueError(f"spec {spec} does not fit a {x.ndim}-d tensor")
    for ax, name in enumerate(spec):
        if name is not None and x.shape[ax] % mesh.shape[name]:
            raise ValueError(f"axis {ax} of size {x.shape[ax]} not "
                             f"divisible by mesh axis {name!r} of size "
                             f"{mesh.shape[name]}")
    out = []
    for r in mesh.local_ranks:
        idx = mesh.coords(r)
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
    """One tensor per rank that this process plays (mesh order): the
    rank's slice of ``x``'s leading dim, split evenly over ``axis``, on the
    rank's device."""
    return shard(x, (axis,) + (None,) * (x.ndim - 1), mesh)


def replicate(x: torch.Tensor, mesh: Mesh) -> List[torch.Tensor]:
    """``x`` on the device of every rank that this process plays (mesh
    order)."""
    flat = mesh.devices.reshape(-1)
    return [x.to(flat[r]) for r in mesh.local_ranks]
