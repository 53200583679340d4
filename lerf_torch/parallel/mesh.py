"""The device mesh: shards, their streams, and the two collectives.

The port of ``lerf_tpu/parallel/mesh.py``.  lerf_tpu's mesh is
single-controller: one process runs ``shard_map`` over a 1-D
``jax.sharding.Mesh`` of devices.  The port's :class:`Mesh` is one process
too: a list of ``torch.device``s, one shard each, in which a device may
repeat — ``make_mesh(devices=["cuda:0"] * 4)`` puts four shards on one
card, each on a CUDA stream of its own, and ``["cpu"] * 8`` is the CPU
tests' mesh.  Distinct cards copy between them peer to peer.

A sharded call brackets its per-shard work with :meth:`Mesh.enter` (each
shard's stream waits for its device's current stream, where the inputs
were made) and :meth:`Mesh.leave` (each device's current stream waits for
its shards' streams, where the outputs were made), and so do the
collectives around their copies: every tensor handed from one stream to
another crosses such a barrier, so the caching allocator never gives a
block to one stream while another still reads it.

The spatial code (:mod:`lerf_torch.parallel.spatial`) needs two
collectives and nothing else: :func:`all_gather_rows` (each shard's slab
of rows to every shard) and :func:`exchange_halos` (each shard's edge rows
to its neighbours).  Both count in the module counter :data:`transfers`,
as the kernels count ``launches``: one for the call and one for each
tensor it moves between two shards — a move between two shards on one
device is a view, and it still counts, so the structure can be pinned on
one card and on the CPU; :data:`collectives` counts the calls by name.

``torch.distributed`` appears in :func:`maybe_init_distributed` alone,
lerf_tpu's multi-host hook, which lerf_tpu itself documents as plumbing
its single host cannot test: on one card NCCL refuses two ranks on one
GPU, so a multi-process design could never cross a shard boundary there.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import concrete_device

DATA_AXIS = "data"

# collectives run plus tensors they moved between two shards
transfers = 0
# collective calls by name
collectives: collections.Counter = collections.Counter()

_distributed_initialized = False


def maybe_init_distributed() -> bool:
    """``torch.distributed.init_process_group`` (``env://``: the caller
    sets ``MASTER_ADDR``, ``MASTER_PORT``, ``RANK`` and ``WORLD_SIZE``;
    ``nccl`` with a card, ``gloo`` without) when ``LERF_DISTRIBUTED`` is
    ``1`` or ``true``, and True; otherwise a no-op that returns False."""
    global _distributed_initialized
    if _distributed_initialized:
        return True
    if os.environ.get("LERF_DISTRIBUTED", "") not in ("1", "true"):
        return False
    import torch.distributed as dist

    dist.init_process_group(
        backend="nccl" if torch.cuda.is_available() else "gloo",
        init_method="env://")
    _distributed_initialized = True
    return True


class Mesh:
    """A 1-D mesh of shards: ``devices`` in shard order (repeats allowed),
    ``size`` shards, one CUDA stream a shard (``streams``; ``None`` on the
    CPU) even where devices repeat, and ``distinct``, the devices in order
    of first appearance."""

    def __init__(self, devices: Sequence, axis: str = DATA_AXIS):
        devs = tuple(concrete_device(d) for d in devices)
        if not devs:
            raise ValueError("a mesh needs at least one device")
        if len({d.type for d in devs}) != 1:
            raise ValueError(f"a mesh's devices are of one type, not "
                             f"{[str(d) for d in devs]}")
        self.devices = devs
        self.axis_names = (axis,)
        self.size = len(devs)
        self.distinct = tuple(dict.fromkeys(devs))
        self.streams = tuple(torch.cuda.Stream(d) if d.type == "cuda"
                             else None for d in devs)

    def __repr__(self):
        return f"Mesh({[str(d) for d in self.devices]})"

    @contextlib.contextmanager
    def shard(self, i: int):
        """Shard ``i``'s scope: its device and its stream current."""
        dev, stream = self.devices[i], self.streams[i]
        if stream is None:
            yield dev
            return
        with torch.cuda.device(dev), torch.cuda.stream(stream):
            yield dev

    def enter(self):
        """Each shard's stream waits for its device's current stream."""
        for dev, stream in zip(self.devices, self.streams):
            if stream is not None:
                stream.wait_stream(torch.cuda.current_stream(dev))

    def leave(self):
        """Each device's current stream waits for its shards' streams."""
        for dev, stream in zip(self.devices, self.streams):
            if stream is not None:
                torch.cuda.current_stream(dev).wait_stream(stream)

    def map(self, fn, *per_shard):
        """``[fn(i, *args_i)]``: each shard's call in its scope, bracketed
        by :meth:`enter` and :meth:`leave`."""
        self.enter()
        try:
            out = []
            for i in range(self.size):
                with self.shard(i):
                    out.append(fn(i, *(a[i] for a in per_shard)))
            return out
        finally:
            self.leave()

    def record(self, tree, i: int):
        """Mark the tensors of ``tree`` as read on shard ``i``'s stream."""
        stream = self.streams[i]
        if stream is not None:
            for t in _leaves(tree):
                if t.device.type == "cuda":
                    t.record_stream(stream)


def make_mesh(n_devices: Optional[int] = None,
              devices: Optional[Sequence] = None,
              axis: str = DATA_AXIS) -> Mesh:
    """A 1-D mesh over (the first ``n_devices`` of) ``devices``.

    By default every visible card (after :func:`maybe_init_distributed`),
    raising without one; ``devices`` may repeat a device
    (``["cuda:0"] * 4``, ``["cpu"] * 8``) and may not mix device types."""
    if devices is None:
        maybe_init_distributed()
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_mesh: no CUDA card is visible; pass devices=['cpu'] * n "
                "to shard on the CPU")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = list(devices)
    if n_devices is not None:
        if len(devices) < n_devices:
            raise ValueError(f"need {n_devices} devices, have {len(devices)}")
        devices = devices[:n_devices]
    return Mesh(devices, axis)


def row_ranges(n: int, shards: int) -> List[Tuple[int, int]]:
    """``[r0, r1)`` of each shard when ``n`` rows split over ``shards``:
    bands as even as the count allows, the first ``n % shards`` one row
    longer (PyTorch compiles nothing per shape, so bands may differ)."""
    q, r = divmod(int(n), shards)
    bounds = np.cumsum([0] + [q + (i < r) for i in range(shards)])
    return [(int(a), int(b)) for a, b in zip(bounds[:-1], bounds[1:])]


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _leaves(v)]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [t for f in dataclasses.fields(tree)
                for t in _leaves(getattr(tree, f.name))]
    return []


def tree_to(tree, device):
    """``tree`` with every tensor moved to ``device`` (a tensor already
    there is itself): through dicts, lists, tuples and dataclasses (the
    stages' ``FlatTables``)."""
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_to(v, device) for v in tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: tree_to(getattr(tree, f.name), device)
            for f in dataclasses.fields(tree) if f.init})
    return tree


def replicate(tree, mesh: Mesh) -> list:
    """``tree`` on every shard: one copy per DISTINCT device (shards on one
    device share it; the tree itself where it already lies there).
    Returns one entry a shard."""
    copies = {d: tree_to(tree, d) for d in mesh.distinct}
    return [copies[d] for d in mesh.devices]


def _split(leaf, mesh: Mesh):
    b = leaf.shape[0]
    if b % mesh.size:
        raise ValueError(f"batch {b} does not divide over {mesh.size} "
                         "shards")
    step = b // mesh.size
    return [leaf[i * step:(i + 1) * step] for i in range(mesh.size)]


def shard_batch(batch, mesh: Mesh, axis: str = DATA_AXIS) -> list:
    """A batch (a tensor, a numpy array, or a dict / list / tuple of them,
    leading axis the batch) split evenly on its leading axis, one chunk
    per shard on that shard's device (a pinned host chunk copies without
    blocking, on the shard's stream).  Raises when the batch does not
    divide.  Returns one tree a shard."""
    def leaves_of(tree):
        if isinstance(tree, (torch.Tensor, np.ndarray)):
            t = torch.as_tensor(tree)
            return [t]
        if isinstance(tree, dict):
            return [x for v in tree.values() for x in leaves_of(v)]
        return [x for v in tree for x in leaves_of(v)]

    def rebuild(tree, it):
        if isinstance(tree, (torch.Tensor, np.ndarray)):
            return next(it)
        if isinstance(tree, dict):
            return {k: rebuild(v, it) for k, v in tree.items()}
        return type(tree)(rebuild(v, it) for v in tree)

    chunks = [_split(leaf, mesh) for leaf in leaves_of(batch)]

    def place(i):
        dev = mesh.devices[i]
        return rebuild(batch, iter([c[i].to(dev, non_blocking=c[i].is_pinned())
                                    for c in chunks]))

    return mesh.map(lambda i: place(i))


@dataclasses.dataclass
class RowShards:
    """A sharded output: ``slabs[i]`` on shard i's device holds the rows
    ``ranges[i]`` = ``[r0, r1)`` of the whole along ``axis`` (``size``
    rows there).  It stays on its shards; :meth:`to_host` and :meth:`cat`
    gather it when asked."""
    slabs: List[torch.Tensor]
    ranges: List[Tuple[int, int]]
    size: int
    axis: int = -2

    @property
    def shape(self) -> Tuple[int, ...]:
        shape = list(self.slabs[0].shape)
        shape[self.axis] = self.size
        return tuple(shape)

    @property
    def dtype(self) -> torch.dtype:
        return self.slabs[0].dtype

    def to_host(self) -> np.ndarray:
        """Each slab copied down into its rows of one numpy array (on a
        card through one pinned host tensor, the copies without blocking,
        then one wait); bf16 slabs (numpy has no bf16) into that host
        tensor itself."""
        cuda = self.slabs[0].device.type == "cuda"
        host = torch.empty(self.shape, dtype=self.dtype, pin_memory=cuda)
        for slab, (r0, r1) in zip(self.slabs, self.ranges):
            host.narrow(self.axis, r0, r1 - r0).copy_(slab, non_blocking=cuda)
        if cuda:
            for dev in dict.fromkeys(s.device for s in self.slabs):
                torch.cuda.current_stream(dev).synchronize()
        return host if self.dtype == torch.bfloat16 else host.numpy()

    def cat(self, device=None) -> torch.Tensor:
        """The whole output on ``device`` (default: the first shard's)."""
        device = self.slabs[0].device if device is None else device
        return torch.cat([s.to(device) for s in self.slabs], dim=self.axis)


def _count(name: str, moves: int):
    global transfers
    transfers += 1 + moves
    collectives[name] += 1


def all_gather_rows(slabs: Sequence[torch.Tensor], mesh: Mesh,
                    axis: int = -2, then=None) -> list:
    """Each shard's slab of rows (one stacked tensor a shard, the rows on
    ``axis``, in shard order) delivered to every shard: the whole,
    assembled once per distinct device and shared by its shards; with
    ``then``, ``then(whole)`` made there once per device instead (a split
    of the stack, say).  Counts one call and one move for each pair of
    shards.  Returns one entry a shard."""
    n = mesh.size
    if len(slabs) != n:
        raise ValueError(f"{len(slabs)} slabs for {n} shards")
    mesh.leave()
    whole = {}
    for dev in mesh.distinct:
        with (torch.cuda.device(dev) if dev.type == "cuda"
              else contextlib.nullcontext()):
            w = torch.cat([s.to(dev) for s in slabs], dim=axis)
            whole[dev] = w if then is None else then(w)
    mesh.enter()
    out = [whole[d] for d in mesh.devices]
    for i, t in enumerate(out):
        mesh.record(t, i)
    _count("all_gather_rows", n * (n - 1))
    return out


def exchange_halos(slabs: Sequence[torch.Tensor], k: int, mesh: Mesh,
                   axis: int = -2) -> list:
    """The top and bottom ``k`` rows (on ``axis``) of each shard's slab to
    its neighbours: one copy a direction across each boundary between two
    shards, none past the ends.  Returns one ``(above, below)`` a shard:
    the previous shard's last ``k`` rows and the next shard's first ``k``
    (``None`` at the ends), on the shard's device.  Raises when a slab is
    shorter than ``k``: one hop must cover the halo."""
    n = mesh.size
    if len(slabs) != n:
        raise ValueError(f"{len(slabs)} slabs for {n} shards")
    for i, s in enumerate(slabs):
        if s.shape[axis] < k:
            raise ValueError(
                f"slab of {s.shape[axis]} rows < halo {k} (shard {i}): a "
                "single-hop exchange cannot cover the receptive field")
    mesh.leave()
    out = []
    for i, dev in enumerate(mesh.devices):
        above = below = None
        if i > 0:
            prev = slabs[i - 1]
            above = prev.narrow(axis, prev.shape[axis] - k, k).to(dev)
        if i < n - 1:
            below = slabs[i + 1].narrow(axis, 0, k).to(dev)
        out.append((above, below))
    mesh.enter()
    for i, t in enumerate(out):
        mesh.record([x for x in t if x is not None], i)
    _count("exchange_halos", 2 * (n - 1))
    return out
