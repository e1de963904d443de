"""Device meshes, the fake world that counts the production meshes, and
JAX-style sharding specs as DTensor placements.

The port of ``repro.launch.mesh``.  Every mesh is built by
``torch.distributed.device_mesh.init_device_mesh`` inside a default process
group the caller has opened: NCCL on the cards, gloo on CPU processes, or
the ``"fake"`` group of ``fake_world``.  Defined as FUNCTIONS, never
module-level state, so importing this module opens no group and touches no
device.

``fake_world(n)`` is the counterpart of the JAX dry run's
``--xla_force_host_platform_device_count=512``: a process that is rank 0 of
``n`` ranks, whose collectives return at once without sending a byte.  A
step run there on fake tensors has every rank's local shapes and dispatches
every collective, which is what ``launch.cost`` counts.

``mesh_context`` and ``jit_sharded`` have no counterpart: a DTensor carries
its own mesh, so there is no ambient mesh to enter, and PyTorch runs
eagerly, so there is nothing to jit.
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Iterator, Sequence, Tuple, Union

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

SpecEntry = Union[None, str, Tuple[str, ...]]

# set while a redistribute the program asked for runs; ``launch.cost``
# counts the collectives DTensor issues outside it as implicit
_EXPLICIT = contextvars.ContextVar("repro_torch_explicit_redistribute", default=False)


def redistribute(x: DTensor, placements) -> DTensor:
    """``x.redistribute`` to ``placements`` on its own mesh, marked as
    asked for (``redistribute_is_explicit``); ``x`` itself when it has
    them already."""
    placements = tuple(placements)
    if tuple(x.placements) == placements:
        return x
    token = _EXPLICIT.set(True)
    try:
        return x.redistribute(x.device_mesh, placements)
    finally:
        _EXPLICIT.reset(token)


def redistribute_is_explicit() -> bool:
    return _EXPLICIT.get()


@contextlib.contextmanager
def plain_tensors_replicated() -> Iterator[None]:
    """DTensor's ``implicit_replication``: a plain tensor met beside a
    DTensor (a position, a mask, a divisor made inside a sharded step)
    counts as replicated.  Unlike that context it restores the setting it
    found, so the contexts nest."""
    dispatcher = DTensor._op_dispatcher
    before = dispatcher._allow_implicit_replication
    dispatcher._allow_implicit_replication = True
    try:
        yield
    finally:
        dispatcher._allow_implicit_replication = before


def _device_type(device_type) -> str:
    if device_type is not None:
        return torch.device(device_type).type
    return "cuda" if torch.cuda.is_available() else "cpu"


def make_mesh_from_shape(shape: Tuple[int, ...], axes: Tuple[str, ...],
                         device_type=None) -> DeviceMesh:
    """A mesh of ``shape`` named ``axes`` over the default group's ranks
    (``ft.manager.plan_elastic_mesh``'s shape and axes feed it as they
    come).  ``device_type`` defaults to the card where there is one."""
    if not dist.is_initialized():
        raise RuntimeError("a mesh needs a default process group: open one "
                           "(fake_world, or init_process_group) first")
    return init_device_mesh(_device_type(device_type), tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False,
                         device_type=None) -> DeviceMesh:
    """16x16 = 256 ranks per pod ``("data", "model")``; 2 pods = 512 ranks
    ``("pod", "data", "model")``."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh_from_shape(shape, axes, device_type)


def make_host_mesh(model: int = 1, device_type=None) -> DeviceMesh:
    """Whatever this host offers, ``(data, model)``: the cards of the
    machine (``torch.cuda.device_count()``), or the default group's ranks
    when there is no card."""
    dt = _device_type(device_type)
    n = torch.cuda.device_count() if dt == "cuda" else dist.get_world_size()
    if n % model:
        raise ValueError(f"{n} devices do not split into model={model}")
    return make_mesh_from_shape((n // model, model), ("data", "model"), dt)


@contextlib.contextmanager
def fake_world(n: int) -> Iterator[None]:
    """Open a ``"fake"`` default process group of ``n`` ranks (this process
    is rank 0) and destroy it on exit.  Raises if a group is already open
    or the fake backend is missing: there is no fallback to one rank."""
    if dist.is_initialized():
        raise RuntimeError("a default process group is already open; a fake "
                           "world needs a process of its own")
    # the fake backend registers itself when this module is imported
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    try:
        yield
    finally:
        dist.destroy_process_group()


def spec_to_placements(spec: Sequence[SpecEntry], mesh: DeviceMesh) -> Tuple:
    """DTensor placements of a JAX-style spec: one entry per tensor dim,
    each None, a mesh axis name or a tuple of names.  Mesh dim ``m`` gets
    ``Shard(i)`` where its name stands at tensor dim ``i``, else
    ``Replicate()``.

    Where a tuple ``("pod", "data")`` shards one dim, JAX makes its first
    axis the major one.  DTensor splits a dim over its mesh dims in mesh
    order (the lower mesh dim is major), so the names of a tuple must
    appear in mesh order; anything else raises."""
    names = mesh.mesh_dim_names
    placements = [Replicate()] * mesh.ndim
    for i, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        dims = [names.index(a) for a in axes]
        if dims != sorted(dims):
            raise ValueError(f"spec entry {entry} is not in the mesh's axis "
                             f"order {names}: DTensor would make "
                             f"{names[min(dims)]!r} the major axis")
        for m in dims:
            if not isinstance(placements[m], Replicate):
                raise ValueError(f"mesh axis {names[m]!r} appears twice in {spec}")
            placements[m] = Shard(i)
    return tuple(placements)


def local_shape_and_offset(shape: Sequence[int], mesh: DeviceMesh,
                           placements) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
    """This rank's shard of a tensor of global ``shape``: its local shape
    and its offset in the global tensor.  Shards split a dim as
    ``torch.chunk`` does (DTensor's ``Shard``), over its mesh dims in mesh
    order.  Plain integers, so it runs under ``FakeTensorMode`` too."""
    local, offset = list(shape), [0] * len(shape)
    coord = mesh.get_coordinate()
    for m, pl in enumerate(placements):
        if not isinstance(pl, Shard):
            continue
        d = pl.dim % len(shape)
        k = mesh.size(m)
        chunk = -(-local[d] // k)
        start = min(coord[m] * chunk, local[d])
        offset[d] += start
        local[d] = max(0, min(chunk, local[d] - start))
    return tuple(local), tuple(offset)


def grad_placements(ins, outs=()) -> Tuple:
    """The placements of the gradients of a per-shard computation's inputs
    (``ins``: one placements tuple per input; ``outs``: the outputs'): on a
    mesh dim where an input or an output is split (sharded, or a partial
    sum), each shard's gradient of an input replicated there is its own
    part of the sum, a partial sum; elsewhere a gradient has its input's
    placements."""
    ndim = len(ins[0])
    split = [any(not isinstance(p[m], Replicate) for p in (*ins, *outs))
             for m in range(ndim)]
    return tuple(tuple(Partial() if split[m] and isinstance(p[m], Replicate) else p[m]
                       for m in range(ndim)) for p in ins)


def per_shard(fn, *, out, ins, mesh: DeviceMesh, grads=None):
    """``local_map(fn)``: ``fn`` runs on each shard's local tensors; its
    inputs must have the placements ``ins`` (a mismatch raises, nothing is
    redistributed here) and its outputs are taken to have ``out`` (one
    placements tuple per output).  The inputs' gradients have ``grads``,
    by default ``grad_placements(ins, out)``."""
    return local_map(fn, out_placements=out, in_placements=ins,
                     in_grad_placements=grads or grad_placements(ins, out),
                     device_mesh=mesh)
