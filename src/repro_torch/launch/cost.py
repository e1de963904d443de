"""Count a step's FLOPs, bytes and memory without running it.

The port's counterpart of ``repro.launch.hlo_cost``, which re-derives
FLOPs, bytes and collective traffic from compiled XLA HLO text.  The port
makes no HLO: it runs the step eagerly on fake tensors
(``FakeTensorMode``: shapes, dtypes and devices, no storage) and counts
every operator that PyTorch dispatches.

  * FLOPs come from ``torch.utils.flop_counter``'s formulas, the ones
    ``FlopCounterMode`` applies: matrix products and convolutions, as the
    HLO model counts only ``dot`` and ``convolution``, plus the formulas the
    two kernels register (``kernels.ops``).  They are applied here, in the
    same pass as the bytes, rather than through a second dispatch mode,
    which would double the cost of every operator.  A loop of L layers is
    L dispatches: the eager trip count.
  * Bytes: each operator is charged the bytes of its tensor inputs and
    outputs.  Views are free.  An in-place write into part of a buffer
    (``index_put_``, ``index_copy_``, ``copy_`` into a slice, a scatter) is
    charged its update only, read and written (and its indices read): the
    buffer is not streamed.  A kernel operator is charged its inputs and
    outputs, the traffic of the fused kernel.  This is eager PyTorch's
    traffic, operator by operator: it is larger than XLA's post-fusion
    bytes for the same step, because eager PyTorch fuses nothing.
  * Collectives (``repro.launch.hlo_analysis.collective_bytes``): on a
    sharded step (DTensor arguments on a mesh, inside ``launch.mesh.
    fake_world`` for the production meshes) every functional collective
    that DTensor dispatches is counted under its HLO kind (``all-gather``,
    ``all-reduce``, ``reduce-scatter``, ``all-to-all``,
    ``collective-permute``) with its per-device OPERAND bytes, the HLO
    definition: an all-gather is charged its local shard, a reduce-scatter
    its full input.  The operand's read is charged to the bytes too, as
    the JAX cost model does.  A collective issued by a redistribute the
    model asked for (``ShardCtx.act``/``gather``, ``launch.mesh.
    redistribute``) is counted apart from one DTensor inserted on its own
    (``implicit_counts``/``implicit_bytes_by_kind``).  On one card the
    dicts stay empty.
  * Per device: a ``TorchDispatchMode`` sees a DTensor operator first, at
    its global shapes; the counter declines it (``NotImplemented``), so
    DTensor runs it and the counter counts the local operators and the
    collectives DTensor runs for it.  DTensor's own fake run of the
    operator at the global shapes (its output-metadata propagation) is not
    counted.
  * Memory: the same pass follows the storages alive at each operator (by
    weak reference, as ``torch.distributed._tools.mem_tracker`` does): the
    arguments', the outputs' and the temporaries' bytes and their peak, in
    the layout of the JAX package's ``memory_analysis`` record.

Nothing here allocates a tensor's storage or launches a kernel: the step
runs under the fake mode of its arguments (real tensors are faked first).
"""
from __future__ import annotations

import threading
import weakref
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Tuple

import torch
import torch.utils._pytree as pytree
from torch._guards import detect_fake_mode
from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode, unset_fake_temporarily
from torch.distributed.tensor import DTensor
from torch.distributed.tensor import _redistribute, placement_types
from torch.distributed.tensor.placement_types import _StridedShard
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.launch.mesh import redistribute_is_explicit

aten = torch.ops.aten
_DEVICE = torch.ops.prim.device.default

# in-place writes into part of a buffer: (op, the argument holding the update)
_PARTIAL_WRITES = {
    aten.index_put_: 2, aten._index_put_impl_: 2, aten.index_copy_: 3,
    aten.copy_: 1, aten.scatter_: 3, aten.scatter_add_: 3,
    aten.index_add_: 3, aten.scatter_reduce_: 3,
}


# functional collectives DTensor dispatches -> HLO kind; the rest of the
# namespaces' operators (wait_tensor, _wrap_tensor_autograd) move nothing
_COLLECTIVE_NAMESPACES = ("_c10d_functional", "_c10d_functional_autograd",
                          "c10d_functional")
_NOT_COLLECTIVES = ("wait_tensor", "_wrap_tensor_autograd")
_KINDS = (("all_gather", "all-gather"), ("all_reduce", "all-reduce"),
          ("reduce_scatter", "reduce-scatter"), ("all_to_all", "all-to-all"),
          ("permute", "collective-permute"))


def collective_kind(func) -> str:
    """The HLO kind of a functional collective, "" for any other operator.
    A collective of no known kind raises: nothing is left uncounted.
    DTensor's shard-to-shard redistribution on a card is one operator of
    its own (``_dtensor.shard_dim_alltoall``), an all-to-all."""
    if func.namespace == "_dtensor":
        return "all-to-all" if func.overloadpacket.__name__ == "shard_dim_alltoall" else ""
    if func.namespace not in _COLLECTIVE_NAMESPACES:
        return ""
    name = func.overloadpacket.__name__
    if name in _NOT_COLLECTIVES:
        return ""
    for key, kind in _KINDS:
        if key in name:
            return kind
    raise NotImplementedError(f"collective {func} has no HLO kind in launch.cost")


@dataclass
class CostTotals:
    flops: float = 0.0
    bytes: float = 0.0
    coll_bytes_by_kind: Dict[str, float] = field(default_factory=dict)
    coll_counts: Dict[str, float] = field(default_factory=dict)
    # the part of the collectives above that no redistribute of the
    # model's asked for (DTensor inserted them on its own)
    implicit_bytes_by_kind: Dict[str, float] = field(default_factory=dict)
    implicit_counts: Dict[str, float] = field(default_factory=dict)
    # argument_bytes, output_bytes, temp_bytes, alias_bytes,
    # peak_bytes_per_device (the dry-run record's ``memory``)
    memory: Dict[str, int] = field(default_factory=dict)
    # per kernel operator (``repro_torch::*``), each distinct call: its
    # arguments (a tensor as its local shape), its first input's dtype
    # and how often it was made
    kernel_calls: Dict[str, List[Dict]] = field(default_factory=dict)

    @property
    def coll_bytes(self) -> float:
        return sum(self.coll_bytes_by_kind.values())


def _tensors(tree) -> List[torch.Tensor]:
    return [t for t in pytree.tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _flat_tensors(items, out: List[torch.Tensor]) -> List[torch.Tensor]:
    """The tensors of an operator's arguments or results (tensors, lists and
    tuples of them): ``_tensors`` without pytree's cost per operator."""
    for x in items:
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (list, tuple)):
            _flat_tensors(x, out)
    return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _local(t: torch.Tensor) -> torch.Tensor:
    return t._local_tensor if isinstance(t, DTensor) else t


class _Counter(TorchDispatchMode):
    """FLOPs and bytes per operator and the live storages' bytes (see the
    module docstring)."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        # operator -> [FLOPs, bytes, calls]
        self.by_op: Dict[str, List[float]] = defaultdict(lambda: [0, 0, 0])
        # HLO kind -> [calls, operand bytes], all and implicit
        self.coll: Dict[str, List[float]] = defaultdict(lambda: [0, 0])
        self.implicit: Dict[str, List[float]] = defaultdict(lambda: [0, 0])
        self.kernels: Dict[str, Dict[Tuple, int]] = defaultdict(lambda: defaultdict(int))
        self.propagating = 0
        self.live = 0
        self.peak = 0
        self._held: Dict[int, Tuple[int, Any]] = {}
        self._lock = threading.Lock()

    def hold(self, tensors) -> int:
        """Track ``tensors``' storages from now on; returns the bytes of
        those not tracked before."""
        added = 0
        for t in tensors:
            st = _local(t).untyped_storage()
            key = st._cdata
            with self._lock:
                if key in self._held:
                    continue
                n = st.nbytes()
                self._held[key] = (n, weakref.ref(st, self._freed(key)))
                self.live += n
                self.peak = max(self.peak, self.live)
            added += n
        return added

    def _freed(self, key: int):
        def cb(_ref):
            with self._lock:
                n, _ = self._held.pop(key, (0, None))
                self.live -= n
        return cb

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func is _DEVICE or self.propagating:
            return func(*args, **kwargs)
        if any(issubclass(t, DTensor) for t in types):
            # counted as the local operators DTensor runs for it
            return NotImplemented
        kind = collective_kind(func)
        if kind:
            return self._collective(func, kind, args, kwargs)
        # an operator that reaches here undecomposed (``matmul`` under
        # inference mode) is counted as the operators it decomposes into,
        # as FlopCounterMode does
        with self:
            out = func.decompose(*args, **kwargs)
        if out is not NotImplemented:
            return out
        out = func(*args, **kwargs)
        outs = _flat_tensors((out,), [])
        if outs:
            ins = _flat_tensors(kwargs.values(), _flat_tensors(args, []))
            formula = flop_registry.get(func.overloadpacket)
            flops = formula(*args, **kwargs, out_val=out) if formula else 0
            charged = self._charge(func, args, ins, outs)
            if func.namespace == "repro_torch":
                self.kernels[func.overloadpacket.__name__][_signature(args)] += 1
            if flops or charged:
                self.flops += flops
                self.bytes += charged
                row = self.by_op[func.overloadpacket.__name__]
                row[0] += flops
                row[1] += charged
                row[2] += 1
            self.hold(outs)
        return out

    def _collective(self, func, kind, args, kwargs):
        out = func(*args, **kwargs)
        operand = sum(_nbytes(t) for t in _flat_tensors(args[:1], []))
        rows = [self.coll] if redistribute_is_explicit() else [self.coll, self.implicit]
        for row in rows:
            row[kind][0] += 1
            row[kind][1] += operand
        self.bytes += operand
        self.hold(_flat_tensors((out,), []))
        return out

    @staticmethod
    def _charge(func, args, ins, outs) -> int:
        update = _PARTIAL_WRITES.get(func.overloadpacket)
        src = args[update] if update is not None and len(args) > update else None
        if isinstance(src, torch.Tensor):
            rest = [t for t in ins[1:] if t is not src]
            return 2 * _nbytes(src) + sum(_nbytes(t) for t in rest)
        if not func._schema.is_mutable:
            sources = {t.untyped_storage()._cdata for t in ins}
            if all(t.untyped_storage()._cdata in sources for t in outs):
                return 0                      # a view (or an alias) of an input
        return sum(_nbytes(t) for t in ins) + sum(_nbytes(t) for t in outs)


def _signature(args) -> Tuple:
    """A kernel call's arguments, tensors as their shapes, and its first
    input's dtype."""
    return (tuple(tuple(a.shape) if isinstance(a, torch.Tensor) else a for a in args),
            str(args[0].dtype).removeprefix("torch."))


def _faked(args):
    """``args`` with every real tensor made fake, and the fake mode.  A
    DTensor's local tensor must be fake already (build sharded arguments
    under ``FakeTensorMode``)."""
    mode = detect_fake_mode([_local(t) for t in _tensors(args)]) or FakeTensorMode()

    def fake(t):
        if not isinstance(t, torch.Tensor) or isinstance(_local(t), FakeTensor):
            return t
        if isinstance(t, DTensor):
            raise ValueError("count a sharded step on DTensors whose local "
                             "tensors are fake")
        return mode.from_tensor(t)

    return pytree.tree_map(fake, args), mode


def _required(owner, name: str):
    """``owner.name``, a DTensor internal the count replaces for its duration.
    Raises where this torch has no such name: the count would go on
    without its patch and count DTensor's own runs at the global shapes."""
    if not hasattr(owner, name):
        raise RuntimeError(
            f"torch {torch.__version__} has no {getattr(owner, '__name__', type(owner).__name__)}"
            f".{name}, which launch.cost replaces while it counts: update launch.cost")
    return getattr(owner, name)


class NotPropagating:
    """For a dispatch mode that counts operators (``counter.propagating``,
    an int it reads): marks DTensor's sharding propagation (its fake runs
    of an operator, or of its decomposition, at the global shapes, which
    decide the output placements and metadata), its redistribution
    planner and a strided shard's offsets for the counter to skip.  Wraps
    the propagator's entry points on its instance, the planner's function
    in its module and the strided shard's method on its class, for the
    count's duration; each must exist (``_required``), on the card's torch
    (2.11) and this one alike.  Both run outside the count's fake mode:
    they work on shapes and placements, and a strided shard's offsets are
    small real tensors that they read back (the propagator makes its own
    fake mode for its runs)."""

    _PLANNER = "_gen_transform_infos_non_cached"
    _STRIDED = "local_shard_size_and_offset"

    _ENTRY_POINTS = ("propagate", "propagate_op_sharding",
                     "propagate_op_sharding_non_cached",
                     "_propagate_tensor_meta_non_cached")

    def __init__(self, counter):
        self.counter = counter
        self.prop = DTensor._op_dispatcher.sharding_propagator

    def _wrap(self, fn):
        counter = self.counter

        def propagating(*args, **kwargs):
            counter.propagating += 1
            try:
                with unset_fake_temporarily():
                    return fn(*args, **kwargs)
            finally:
                counter.propagating -= 1

        return propagating

    def __enter__(self):
        wrapped = {n: self._wrap(_required(self.prop, n)) for n in self._ENTRY_POINTS}
        self.planner = _required(_redistribute, self._PLANNER)
        # a strided shard's offsets, read back when it is gathered
        self.strided = _required(_StridedShard, self._STRIDED)
        self.saved = {n: self.prop.__dict__.get(n) for n in self._ENTRY_POINTS}
        for n, fn in wrapped.items():
            setattr(self.prop, n, fn)
        setattr(_redistribute, self._PLANNER, self._wrap(self.planner))
        self.strided_own = self._STRIDED in _StridedShard.__dict__
        setattr(_StridedShard, self._STRIDED, self._wrap(self.strided))
        return self

    def __exit__(self, *exc):
        setattr(_redistribute, self._PLANNER, self.planner)
        if self.strided_own:
            setattr(_StridedShard, self._STRIDED, self.strided)
        else:
            delattr(_StridedShard, self._STRIDED)   # back to the base's
        for n, orig in self.saved.items():
            if orig is None:
                delattr(self.prop, n)     # back to the class's method
            else:
                setattr(self.prop, n, orig)


class _AllToAllOnEveryDevice:
    """DTensor's shard-to-shard redistribution as it runs on a card (one
    ``_dtensor.shard_dim_alltoall``, counted as one all-to-all of its
    input) whatever the fakes' device: on a CPU mesh DTensor gathers the
    whole tensor and chunks it instead (gloo has no all-to-all), which
    would count another collective and another peak.  Replaces
    ``placement_types.shard_dim_alltoall`` for the count's duration
    (``_required``)."""

    def __enter__(self):
        self.orig = _required(placement_types, "shard_dim_alltoall")
        placement_types.shard_dim_alltoall = _shard_dim_alltoall
        return self

    def __exit__(self, *exc):
        placement_types.shard_dim_alltoall = self.orig


def _shard_dim_alltoall(input, gather_dim, shard_dim, mesh, mesh_dim):
    return torch.ops._dtensor.shard_dim_alltoall(
        input, gather_dim, shard_dim, mesh.get_group(mesh_dim).group_name)


class LocalFlopCounter:
    """``FlopCounterMode`` on the local operators of a real DTensor run, the
    per-device FLOPs that ``analyze`` counts on fakes, as the count does:
    its dispatch mode declines a DTensor-level call (``NotImplemented``),
    so DTensor runs it and each local operator it runs is counted, and
    DTensor's own runs at the global shapes (``NotPropagating``) are not.
    Plain ``FlopCounterMode`` would count the DTensor-level call at the
    global shapes.  ``get_total_flops`` as ``FlopCounterMode``'s."""

    def __init__(self):
        from torch.utils.flop_counter import FlopCounterMode

        self.counter = FlopCounterMode(display=False)

    def __enter__(self):
        self.counter.__enter__()
        mode = getattr(self.counter, "mode", None)
        if mode is None or not hasattr(type(mode), "__torch_dispatch__"):
            raise RuntimeError("FlopCounterMode has no dispatch mode to wrap: "
                               "update launch.cost.LocalFlopCounter")

        class Local(type(mode)):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                if any(issubclass(t, DTensor) for t in types):
                    return NotImplemented
                if self.propagating:
                    return func(*args, **(kwargs or {}))
                return super().__torch_dispatch__(func, types, args, kwargs)

        mode.__class__ = Local
        mode.propagating = 0
        self.skip = NotPropagating(mode)
        self.skip.__enter__()
        return self

    def __exit__(self, *exc):
        self.skip.__exit__(*exc)
        return self.counter.__exit__(*exc)

    def get_total_flops(self) -> int:
        return self.counter.get_total_flops()


class CollectiveMeter(TorchDispatchMode):
    """The collectives a real sharded run makes on this rank, calls and
    operand bytes by HLO kind (``counts``, ``bytes``), the rules of
    ``analyze``'s count: a DTensor-level call is declined, so the
    collectives DTensor runs for it reach this mode, each under
    ``collective_kind`` with its first argument's bytes.  DTensor's
    shard-to-shard step is one all-to-all of its input, as on a card,
    whatever the mesh does for it (on a CPU mesh DTensor gathers and
    chunks: gloo has no all-to-all); the collectives inside it are not
    counted again."""

    def __init__(self):
        super().__init__()
        self.counts: Dict[str, int] = {}
        self.bytes: Dict[str, int] = {}
        self._inside = 0

    def _add(self, kind: str, t: torch.Tensor) -> None:
        self.counts[kind] = self.counts.get(kind, 0) + 1
        self.bytes[kind] = self.bytes.get(kind, 0) + _nbytes(t)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kind = collective_kind(func)
        if kind and not self._inside:
            self._add(kind, args[0])
        return func(*args, **(kwargs or {}))

    def __enter__(self):
        self._orig = _required(placement_types, "shard_dim_alltoall")
        meter = self

        def alltoall(input, *rest):
            meter._add("all-to-all", input)
            meter._inside += 1
            try:
                return meter._orig(input, *rest)
            finally:
                meter._inside -= 1

        placement_types.shard_dim_alltoall = alltoall
        return super().__enter__()

    def __exit__(self, *exc):
        placement_types.shard_dim_alltoall = self._orig
        return super().__exit__(*exc)


def _run(fn: Callable, args) -> Tuple[CostTotals, _Counter]:
    args, mode = _faked(args)
    counter = _Counter()
    arg_tensors = _tensors(args)
    with mode, NotPropagating(counter), _AllToAllOnEveryDevice(), counter:
        argument = counter.hold(arg_tensors)
        arg_keys = {_local(t).untyped_storage()._cdata for t in arg_tensors}
        result = fn(*args)
        seen, output, alias = set(), 0, 0
        for t in _tensors(result):
            st = _local(t).untyped_storage()
            if st._cdata in seen:
                continue
            seen.add(st._cdata)
            output += st.nbytes()
            if st._cdata in arg_keys:
                alias += st.nbytes()
        peak = counter.peak
    del result
    totals = CostTotals(
        flops=float(counter.flops), bytes=float(counter.bytes),
        coll_counts={k: float(v[0]) for k, v in counter.coll.items()},
        coll_bytes_by_kind={k: float(v[1]) for k, v in counter.coll.items()},
        implicit_counts={k: float(v[0]) for k, v in counter.implicit.items()},
        implicit_bytes_by_kind={k: float(v[1]) for k, v in counter.implicit.items()},
        memory={"argument_bytes": argument, "output_bytes": output,
                "temp_bytes": peak - argument - output + alias,
                "alias_bytes": alias, "peak_bytes_per_device": peak},
        kernel_calls={name: [{"args": [list(a) if isinstance(a, tuple) else a
                                       for a in sig[0]],
                              "dtype": sig[1], "calls": n} for sig, n in calls.items()]
                      for name, calls in counter.kernels.items()})
    return totals, counter


def analyze(fn: Callable, *args) -> CostTotals:
    """Run ``fn(*args)`` on fake tensors and count it (module docstring)."""
    return _run(fn, args)[0]


def analyze_by_op(fn: Callable, *args) -> Tuple[CostTotals, Dict[str, Tuple]]:
    """``analyze`` and, per operator, its (FLOPs, bytes, calls)."""
    totals, counter = _run(fn, args)
    return totals, {name: tuple(row) for name, row in counter.by_op.items()}


def breakdown(fn: Callable, *args, top: int = 25) -> Dict[str, List[Tuple]]:
    """Perf-debugging view: the ``top`` operators by FLOPs and by bytes,
    each row (operator, FLOPs, bytes, calls)."""
    rows = [(name, float(f), float(b), int(n))
            for name, (f, b, n) in _run(fn, args)[1].by_op.items()]
    return {"by_flops": sorted(rows, key=lambda r: -r[1])[:top],
            "by_bytes": sorted(rows, key=lambda r: -r[2])[:top]}
