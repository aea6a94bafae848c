"""Sharding and collectives over a mesh of ranks.

The port's counterparts of what ``shard_map`` does around the sparse MLP's
train step, beside :func:`~.mesh.shard`, which cuts a tensor by a
partition spec: put it back together (:func:`unshard`),
``lax.all_gather(tiled=True)`` with its gradient (:func:`all_gather`) and
``lax.pmean`` (:func:`pmean`).

Every function takes and returns one tensor per rank that this process
plays (:attr:`~.mesh.Mesh.local_ranks`): every rank of a one-process mesh
in the mesh's (row-major) order, or this rank's alone on a process mesh
(the process contract of :mod:`.mesh`), each on its rank's device. A spec
names, for each tensor axis, the mesh axis that axis is split over, or
None where the axis is whole (``(None, "model")``: columns split over
``model``). A collective over ``axis`` runs within each group of ranks
that share every other mesh index. On a one-process mesh the ranks' work
runs on the callers' current streams: ranks that share a card queue in
order, and a copy to another card is ordered by PyTorch. On a process mesh
each collective is one ``torch.distributed`` call over the axis's process
group, ordered after the caller's current stream and before its later
work.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from .mesh import Mesh


def _gather(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The group's blocks concatenated along ``dim``, in group order."""
    import torch.distributed as dist

    x = t.movedim(dim, 0).contiguous()
    out = x.new_empty((dist.get_world_size(group) * x.shape[0],
                       *x.shape[1:]))
    dist.all_gather_into_tensor(out, x, group=group)
    return out.movedim(0, dim)


def _reduce_scatter(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The sum over the group of each rank's ``t``, cut along ``dim``;
    this rank's piece (``psum_scatter``)."""
    import torch.distributed as dist

    x = t.movedim(dim, 0).contiguous()
    out = x.new_empty((x.shape[0] // dist.get_world_size(group),
                       *x.shape[1:]))
    dist.reduce_scatter_tensor(out, x, op=dist.ReduceOp.SUM, group=group)
    return out.movedim(0, dim)


def unshard(parts: Sequence[torch.Tensor], spec, mesh: Mesh,
            device=None) -> torch.Tensor:
    """The whole tensor from its blocks under ``spec`` (the inverse of
    :func:`~.mesh.shard`), read from the ranks at index 0 of every mesh
    axis that ``spec`` does not name, on ``device`` (default: the first
    rank's). On a process mesh every process gets the whole, all-gathered
    over each axis that ``spec`` names."""
    if mesh.is_process_mesh:
        (t,) = parts
        mesh.check("unshard", t)
        for ax, name in enumerate(spec):
            if name is not None:
                t = _gather(t, mesh.group(name), ax)
        return t if device is None else t.to(device)
    dev = torch.device(device) if device is not None else parts[0].device
    arr = np.empty(mesh.devices.shape, dtype=object)
    for idx, t in zip(np.ndindex(mesh.devices.shape), parts):
        arr[idx] = t.to(dev)
    names = list(mesh.axis_names)
    for ax, name in enumerate(spec):
        if name is None:
            continue
        moved = np.moveaxis(arr, names.index(name), -1)
        names.remove(name)
        arr = np.empty(moved.shape[:-1], dtype=object)
        for i in np.ndindex(arr.shape):
            arr[i] = torch.cat(list(moved[i]), dim=ax)
    return arr[(0,) * arr.ndim]


class _AllGather(torch.autograd.Function):
    """One group's tiled all-gather: each rank gets the concatenation of
    the group's parts along ``dim`` on its device. Its backward is the
    transpose JAX takes (``psum_scatter``): part j's cotangent is the sum
    over the group's ranks of their cotangents' j-th slice."""

    @staticmethod
    def forward(ctx, dim, devices, *parts):
        ctx.dim = dim
        ctx.sizes = [p.shape[dim] for p in parts]
        ctx.devices = [p.device for p in parts]
        return tuple(torch.cat([p.to(d) for p in parts], dim=dim)
                     for d in devices)

    @staticmethod
    def backward(ctx, *grads):
        out, start = [], 0
        for size, dev in zip(ctx.sizes, ctx.devices):
            g = None
            for gr in grads:
                piece = gr.narrow(ctx.dim, start, size).to(dev)
                g = piece if g is None else g + piece
            out.append(g)
            start += size
        return (None, None, *out)


class _ProcessAllGather(torch.autograd.Function):
    """:class:`_AllGather` with one rank per process: the forward is
    ``all_gather_into_tensor`` over the axis's group, the backward
    ``reduce_scatter_tensor`` with a sum (JAX's ``psum_scatter``)."""

    @staticmethod
    def forward(ctx, part, group, dim):
        ctx.group, ctx.dim = group, dim
        return _gather(part, group, dim)

    @staticmethod
    def backward(ctx, grad):
        return _reduce_scatter(grad, ctx.group, ctx.dim), None, None


def all_gather(parts: Sequence[torch.Tensor], mesh: Mesh, axis: str,
               dim: int = 0) -> List[torch.Tensor]:
    """``lax.all_gather(x, axis, axis=dim, tiled=True)`` over the ranks:
    each rank's result is its group's parts concatenated along ``dim`` in
    the group's order. Differentiable: as in JAX, the backward sums every
    rank's cotangent into the part it came from, so a loss that each rank
    of a group computes alike reaches the parts once per rank."""
    if mesh.is_process_mesh:
        mesh.check("all_gather", *parts)
        return [_ProcessAllGather.apply(parts[0], mesh.group(axis), dim)]
    out: List[Optional[torch.Tensor]] = [None] * len(parts)
    flat_devs = list(mesh.devices.reshape(-1))
    for grp in mesh.axis_groups(axis):
        res = _AllGather.apply(dim, [flat_devs[r] for r in grp],
                               *[parts[r] for r in grp])
        for r, t in zip(grp, res):
            out[r] = t
    return out


def pmean(values: Sequence[torch.Tensor], mesh: Mesh,
          axis: str) -> List[torch.Tensor]:
    """``lax.pmean`` over ``axis``: each rank gets its group's mean, summed
    in f32 and returned in the values' dtype, on its device."""
    if mesh.is_process_mesh:
        import torch.distributed as dist

        (v,) = values
        mesh.check("pmean", v)
        group = mesh.group(axis)
        total = v.to(torch.float32, copy=True)
        dist.all_reduce(total, op=dist.ReduceOp.SUM, group=group)
        return [(total / dist.get_world_size(group)).to(v.dtype)]
    out: List[Optional[torch.Tensor]] = [None] * len(values)
    for grp in mesh.axis_groups(axis):
        dev = values[grp[0]].device
        total = sum(values[r].to(dev, torch.float32) for r in grp)
        mean = (total / len(grp)).to(values[grp[0]].dtype)
        for r in grp:
            out[r] = mean.to(values[r].device)
    return out
