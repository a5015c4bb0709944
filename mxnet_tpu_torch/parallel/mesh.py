"""The process mesh (counterpart of ``mxnet_tpu/parallel/mesh.py``).

The reference builds a named ``jax.sharding.Mesh`` over devices.  The
port runs one process per device under ``torch.distributed``, so its
mesh is a named grid of process ranks: ``make_mesh`` keeps the reference's
``AXES`` and its rule that ``dp`` absorbs what the other axes leave.  An
axis resolves to the process group of this rank's line along it
(:meth:`Mesh.group`), which ``collectives`` reduce over; every axis,
``tp``, ``sp``, ``ep`` and ``pp`` as well as ``dp`` and ``fsdp``, resolves
the same way.

The reference's ``PartitionSpec`` / ``NamedSharding`` pair is the port's
:class:`PartitionSpec` (a tuple of axis names, ``None`` or tuples of
names, one entry a tensor dim) and :class:`Placement` (a spec on a mesh).
A process holds only its own tile of a placed tensor: ``Placement.shard``
cuts it from the whole tensor, ``Placement.gather`` puts the whole tensor
back together from every rank's tile.
"""
from __future__ import annotations

from collections import OrderedDict

import numpy as _np

from ..base import MXNetError

__all__ = ["make_mesh", "get_default_mesh", "set_default_mesh", "AXES",
           "Mesh", "PartitionSpec", "Placement"]

AXES = ("dp", "fsdp", "tp", "sp", "ep", "pp")

_DEFAULT = None


def _dist():
    import torch.distributed as dist

    return dist if dist.is_available() and dist.is_initialized() else None


def _world():
    d = _dist()
    return (d.get_world_size(), d.get_rank()) if d is not None else (1, 0)


class Mesh:
    """A named grid of process ranks.  ``shape`` maps each axis of
    ``AXES`` to its size (axes of size 1 kept, as in the reference);
    ``devices`` is the rank grid."""

    def __init__(self, ranks, dims):
        self.devices = _np.asarray(ranks, dtype=_np.int64).reshape(dims)
        self.axis_names = AXES
        self.shape = OrderedDict(zip(AXES, (int(d) for d in dims)))
        self._groups = {}

    @property
    def size(self):
        return int(self.devices.size)

    def _coords(self, rank):
        hit = _np.argwhere(self.devices == rank)
        if not len(hit):
            raise MXNetError(f"rank {rank} is not in this mesh "
                             f"({self.devices.ravel().tolist()})")
        return tuple(int(c) for c in hit[0])

    def axis_ranks(self, axis, rank=None):
        """The global ranks of ``rank``'s line along ``axis`` (an axis
        name or a tuple of names), in axis order."""
        rank = _world()[1] if rank is None else rank
        axes = (axis,) if isinstance(axis, str) else tuple(axis)
        idx = self._coords(rank)
        keep = [AXES.index(a) for a in axes]
        # every other axis fixed at this rank's coordinate
        sl = tuple(slice(None) if i in keep else idx[i]
                   for i in range(len(AXES)))
        return [int(r) for r in self.devices[sl].ravel()]

    def axis_size(self, axis):
        axes = (axis,) if isinstance(axis, str) else tuple(axis)
        n = 1
        for a in axes:
            n *= self.shape[a]
        return n

    def axis_index(self, axis):
        """This rank's index along ``axis``."""
        return self.axis_ranks(axis).index(_world()[1])

    def group(self, axis):
        """The process group of this rank's line along ``axis`` (None:
        the default group, when the line is every process).  Subgroups
        are made on first use, every line of the axis at once, so every
        process makes the same ``new_group`` calls in the same order."""
        axes = (axis,) if isinstance(axis, str) else tuple(axis)
        world, rank = _world()
        if self.axis_size(axes) == world:
            return None
        key = tuple(axes)
        if key not in self._groups:
            dist = _dist()
            lines, seen = [], set()
            for r in self.devices.ravel().tolist():
                line = tuple(self.axis_ranks(axes, r))
                if line not in seen:
                    seen.add(line)
                    lines.append(line)
            mine = None
            for line in lines:
                g = dist.new_group(list(line))
                if rank in line:
                    mine = g
            self._groups[key] = mine
        return self._groups[key]

    def __repr__(self):
        dims = "x".join(str(v) for v in self.shape.values())
        return f"Mesh({dims} over ranks {self.devices.ravel().tolist()})"


def make_mesh(dp=None, tp=1, sp=1, ep=1, pp=1, fsdp=1, devices=None):
    """A Mesh over the process group's ranks (or ``devices``, a list of
    ranks); ``dp`` absorbs the ranks the other axes leave.  Example: 8
    processes, fsdp=2 -> ('dp','fsdp','tp','sp','ep','pp') =
    (4,2,1,1,1,1).  Without a process group the mesh is this one
    process."""
    world, _ = _world()
    devices = list(range(world)) if devices is None else \
        [int(d) for d in devices]
    n = len(devices)
    fixed = tp * sp * ep * pp * fsdp
    if n % fixed != 0:
        raise MXNetError(f"{n} devices not divisible by "
                         f"tp*sp*ep*pp*fsdp={fixed}")
    if dp is None:
        dp = n // fixed
    if dp * fixed != n:
        raise MXNetError(f"mesh {dp}x{fsdp}x{tp}x{sp}x{ep}x{pp} != {n} "
                         f"devices")
    return Mesh(devices, (dp, fsdp, tp, sp, ep, pp))


def set_default_mesh(mesh):
    global _DEFAULT
    _DEFAULT = mesh


def get_default_mesh():
    global _DEFAULT
    if _DEFAULT is None or _DEFAULT.size != _world()[0]:
        _DEFAULT = make_mesh()
    return _DEFAULT


class PartitionSpec(tuple):
    """The placement of a tensor's dims on mesh axes: one entry a dim,
    an axis name, ``None`` (not split) or a tuple of names (split over
    their product, the first the major one).  Missing trailing entries
    are ``None``.  ``PartitionSpec()`` is replicated."""

    def __new__(cls, *entries):
        return super().__new__(cls, (tuple(e) if isinstance(e, list) else e
                                     for e in entries))

    def __repr__(self):
        return "PartitionSpec(" + ", ".join(repr(e) for e in self) + ")"


def _entry_axes(entry):
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


class Placement:
    """A :class:`PartitionSpec` on a :class:`Mesh` (the reference's
    ``NamedSharding``)."""

    def __init__(self, mesh, spec):
        self.mesh = mesh
        self.spec = PartitionSpec(*spec)

    def __repr__(self):
        return f"Placement({self.mesh!r}, {self.spec!r})"

    def split_dims(self):
        """``[(dim, axes), ...]`` of the dims that are split, axes a tuple
        of names of size > 1."""
        out = []
        for d, e in enumerate(self.spec):
            axes = tuple(a for a in _entry_axes(e)
                         if self.mesh.shape.get(a, 1) > 1)
            if axes:
                out.append((d, axes))
        return out

    def shard(self, full):
        """This rank's tile of the whole tensor ``full`` (a view)."""
        out = full
        for d, axes in self.split_dims():
            out = out.chunk(self.mesh.axis_size(axes), d)[
                self.mesh.axis_index(axes)]
        return out

    def gather(self, local, host=False):
        """The whole tensor from every rank's tile (a collective over each
        split dim's axes; ``local`` itself when nothing is split)."""
        from . import collectives

        out = local
        for d, axes in reversed(self.split_dims()):
            out = collectives.all_gather(out, axes, axis=d, mesh=self.mesh,
                                         host=host)
        return out
