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
  * Collectives: none on one card (the dicts stay empty).
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
from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

aten = torch.ops.aten
_DEVICE = torch.ops.prim.device.default

# in-place writes into part of a buffer: (op, the argument holding the update)
_PARTIAL_WRITES = {
    aten.index_put_: 2, aten._index_put_impl_: 2, aten.index_copy_: 3,
    aten.copy_: 1, aten.scatter_: 3, aten.scatter_add_: 3,
    aten.index_add_: 3, aten.scatter_reduce_: 3,
}


@dataclass
class CostTotals:
    flops: float = 0.0
    bytes: float = 0.0
    coll_bytes_by_kind: Dict[str, float] = field(default_factory=dict)
    coll_counts: Dict[str, float] = field(default_factory=dict)
    # argument_bytes, output_bytes, temp_bytes, alias_bytes,
    # peak_bytes_per_device (the dry-run record's ``memory``)
    memory: Dict[str, int] = field(default_factory=dict)

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


class _Counter(TorchDispatchMode):
    """FLOPs and bytes per operator and the live storages' bytes (see the
    module docstring)."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        # operator -> [FLOPs, bytes, calls]
        self.by_op: Dict[str, List[float]] = defaultdict(lambda: [0, 0, 0])
        self.live = 0
        self.peak = 0
        self._held: Dict[int, Tuple[int, Any]] = {}
        self._lock = threading.Lock()

    def hold(self, tensors) -> int:
        """Track ``tensors``' storages from now on; returns the bytes of
        those not tracked before."""
        added = 0
        for t in tensors:
            st = t.untyped_storage()
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
        if func is _DEVICE:
            return func(*args, **kwargs)
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
            if flops or charged:
                self.flops += flops
                self.bytes += charged
                row = self.by_op[func.overloadpacket.__name__]
                row[0] += flops
                row[1] += charged
                row[2] += 1
            self.hold(outs)
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


def _faked(args):
    """``args`` with every real tensor made fake, and the fake mode."""
    mode = detect_fake_mode(args) or FakeTensorMode()
    args = pytree.tree_map(
        lambda t: t if not isinstance(t, torch.Tensor) or isinstance(t, FakeTensor)
        else mode.from_tensor(t), args)
    return args, mode


def _run(fn: Callable, args) -> Tuple[CostTotals, _Counter]:
    args, mode = _faked(args)
    counter = _Counter()
    arg_tensors = _tensors(args)
    with mode, counter:
        argument = counter.hold(arg_tensors)
        arg_keys = {t.untyped_storage()._cdata for t in arg_tensors}
        result = fn(*args)
        seen, output, alias = set(), 0, 0
        for t in _tensors(result):
            st = t.untyped_storage()
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
        memory={"argument_bytes": argument, "output_bytes": output,
                "temp_bytes": peak - argument - output + alias,
                "alias_bytes": alias, "peak_bytes_per_device": peak})
    return totals, counter


def analyze(fn: Callable, *args) -> CostTotals:
    """Run ``fn(*args)`` on fake tensors and count it (module docstring)."""
    return _run(fn, args)[0]


def breakdown(fn: Callable, *args, top: int = 25) -> Dict[str, List[Tuple]]:
    """Perf-debugging view: the ``top`` operators by FLOPs and by bytes,
    each row (operator, FLOPs, bytes, calls)."""
    rows = [(name, float(f), float(b), int(n))
            for name, (f, b, n) in _run(fn, args)[1].by_op.items()]
    return {"by_flops": sorted(rows, key=lambda r: -r[1])[:top],
            "by_bytes": sorted(rows, key=lambda r: -r[2])[:top]}
