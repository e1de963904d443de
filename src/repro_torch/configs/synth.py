"""Synthetic placement problems at the planner scalability benchmark's sizes.

``synth`` is ``benchmarks/scheduler_scalability.py``'s generator, kept here
so the port builds the same problems from the same seed without importing
the JAX package: F flavours per service, one ring link per service, an
AvoidNode on every third service and an Affinity on every fifth.  The
benchmark calls (S=500, N=200) its largest dense point and (S=2000, N=200)
its sparse frontier.  ``links=k`` gives every service k outgoing links
instead of one, spread around the ring and over the flavours, so each
(service, flavour) has about k/F outgoing links and each service k
incoming ones: the planner's communication sums then add several terms
per entry.  ``links=1`` is the benchmark's problem.

``to_dyadic`` rounds every float input of such a problem to a multiple of
``2**-bits``, and each node's carbon to a multiple of ``N * 2**-bits``, so
that the mean carbon intensity over the N nodes, which prices every link
(``emission_weight * mean(ci)``), is on the grid too.  Every product and
sum the planner forms is then exact under every profile (the magnitudes
stay far below 2**53 grid steps), so its decisions cannot depend on the
order in which sums are taken.  The same holds for scenario branches whose
carbon is scaled by a dyadic factor.
"""
from __future__ import annotations

import dataclasses
import random
from typing import Dict, List, Tuple

from repro_torch.core.types import (
    Affinity,
    Application,
    AvoidNode,
    Constraint,
    Flavour,
    FlavourRequirements,
    Infrastructure,
    Node,
    NodeCapabilities,
    Service,
)

FLAVOURS = 2

Problem = Tuple[Application, Infrastructure, Dict[Tuple[str, str], float],
                Dict[Tuple[str, str, str], float], List[Constraint]]


def synth(n_services: int, n_nodes: int, seed: int = 0,
          flavours: int = FLAVOURS, links: int = 1) -> Problem:
    """A dense-ish placement problem: F flavours per service, ring links,
    AvoidNode/Affinity soft constraints.  Link j (1..links) of service i
    leaves its flavour ``(j - 1) % F`` for service ``i + 1 + (j - 1) *
    (S // links)`` (mod S)."""
    if not 1 <= links < n_services:
        raise ValueError(f"links must be in [1, {n_services - 1}]")
    step = n_services // links
    rnd = random.Random(seed)
    services = tuple(
        Service(f"s{i}", flavours=tuple(
            Flavour(f"f{k}", requirements=FlavourRequirements(
                cpu=rnd.choice([0.5, 1.0, 2.0]),
                ram_gb=rnd.choice([1.0, 2.0, 4.0])))
            for k in range(flavours)))
        for i in range(n_services)
    )
    nodes = tuple(
        Node(f"n{j}", carbon=rnd.uniform(10.0, 600.0),
             cost_per_cpu_hour=rnd.uniform(0.0, 2.0),
             capabilities=NodeCapabilities(
                 cpu=rnd.choice([8.0, 16.0]), ram_gb=64.0))
        for j in range(n_nodes)
    )
    comp = {
        (f"s{i}", f"f{k}"): rnd.uniform(1.0, 100.0)
        for i in range(n_services) for k in range(flavours)
    }
    comm = {
        (f"s{i}", f"f{(j - 1) % flavours}",
         f"s{(i + 1 + (j - 1) * step) % n_services}"): rnd.uniform(0.1, 20.0)
        for i in range(n_services) for j in range(1, links + 1)
    }
    cs: List[Constraint] = []
    for i in range(0, n_services, 3):
        cs.append(AvoidNode(service=f"s{i}", flavour="f0",
                            node=f"n{rnd.randrange(n_nodes)}",
                            weight=rnd.uniform(0.2, 1.0)))
    for i in range(0, n_services, 5):
        cs.append(Affinity(service=f"s{i}",
                           other=f"s{(i + 1) % n_services}",
                           weight=rnd.uniform(0.2, 1.0)))
    return (Application("synth", services), Infrastructure("synth", nodes),
            comp, comm, cs)


def to_dyadic(problem: Problem, bits: int = 8) -> Problem:
    """The same problem with every float input (cost, energy profiles,
    link energies, constraint weights) rounded to the nearest multiple of
    ``2**-bits``, and carbon to the nearest multiple of ``N * 2**-bits``
    (N nodes), so that the mean carbon is a multiple of ``2**-bits``.
    Requirements and capacities are already dyadic."""
    q = float(2 ** bits)

    def r(x: float, unit: float = 1.0) -> float:
        return round(x * q / unit) * unit / q

    app, infra, comp, comm, cs = problem
    n_nodes = float(len(infra.nodes))
    nodes = tuple(dataclasses.replace(
        n, carbon=None if n.carbon is None else r(n.carbon, n_nodes),
        cost_per_cpu_hour=r(n.cost_per_cpu_hour)) for n in infra.nodes)
    cs = [dataclasses.replace(c, weight=r(c.weight),
                              memory_weight=r(c.memory_weight))
          for c in cs]
    return (app, infra.with_nodes(nodes),
            {k: r(v) for k, v in comp.items()},
            {k: r(v) for k, v in comm.items()}, cs)
