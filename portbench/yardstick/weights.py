"""Seeded weights drawn on the device in a few large calls.

A spec maps each leaf's path (``"layers/wz"``) to ``(shape, init)``:
``("normal", std, mean)``, ``("log_of_uniform", lo, hi)`` (the log of a
uniform draw on [lo, hi]) or ``("softplus_inv_log_uniform", lo, hi)`` (the
inverse softplus of a log-uniform draw on [lo, hi]).  Every normal leaf
comes from one ``randn`` call and every uniform one from one ``rand`` call
of one generator on the device, in the dtype the weights are served in;
leaves are laid out in sorted path order, so one seed gives one set of
weights."""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

Spec = Dict[str, Tuple[Tuple[int, ...], tuple]]


def draw(spec: Spec, seed: int, device, dtype: torch.dtype) -> Dict:
    """The nested weight dict of ``spec`` (paths split on ``/``)."""
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (2 ** 63))
    paths = sorted(spec)
    normal = [p for p in paths if spec[p][1][0] == "normal"]
    uniform = [p for p in paths if spec[p][1][0] != "normal"]
    out: Dict[str, torch.Tensor] = {}
    for group, fill in ((normal, "randn"), (uniform, "rand")):
        sizes = [math.prod(spec[p][0]) for p in group]
        if not sizes:
            continue
        flat = getattr(torch, fill)(sum(sizes), generator=gen, device=device,
                                    dtype=dtype if fill == "randn" else torch.float32)
        for p, view in zip(group, torch.split(flat, sizes)):
            shape, init = spec[p]
            out[p] = _finish(view.view(shape), init, dtype)
    nested: Dict = {}
    for p in paths:
        node = nested
        *parents, leaf = p.split("/")
        for k in parents:
            node = node.setdefault(k, {})
        node[leaf] = out[p]
    return nested


def _finish(view: torch.Tensor, init: tuple, dtype: torch.dtype) -> torch.Tensor:
    kind = init[0]
    if kind == "normal":
        std, mean = init[1], init[2] if len(init) > 2 else 0.0
        view.mul_(std)
        if mean:
            view.add_(mean)
        return view
    lo, hi = init[1], init[2]
    if kind == "log_of_uniform":
        return torch.log(lo + (hi - lo) * view).to(dtype)
    if kind == "softplus_inv_log_uniform":
        x = torch.exp(math.log(lo) + (math.log(hi) - math.log(lo)) * view)
        return (x + torch.log(-torch.expm1(-x))).to(dtype)
    raise ValueError(f"unknown init {init!r}")
