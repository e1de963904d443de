"""Fault tolerance: restart manager, straggler detection, elastic re-mesh.

Designed for 1000+ node operation:
  * RestartManager — checkpoint/restore loop driver: any step failure rolls
    back to the last complete checkpoint and replays the (deterministic,
    step-keyed) data stream; bounded retries distinguish transient faults
    from systematic ones.
  * StragglerDetector — per-host step-time EWMA vs. fleet median; hosts
    exceeding ``ratio`` x median for ``patience`` consecutive windows are
    flagged for demotion.
  * plan_elastic_mesh — given the surviving device count, re-plan the
    (pod, data, model) mesh: model axis is preserved (parameter layout
    survives), the data axis shrinks/grows, and the step-keyed data pipeline
    re-shards deterministically.

Port of ``repro.ft.manager`` over the port's checkpoint store.  (The
reference's docstring also says the new placement is routed through the
green scheduler; its code returns the mesh shape only, and so does this.)
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

from repro_torch.checkpoint import store


@dataclass
class RestartManager:
    directory: str
    checkpoint_every: int = 50
    max_failures: int = 3
    keep: int = 3

    # ``failures`` counts CONSECUTIVE failures since the last successful
    # checkpoint and is what ``max_failures`` bounds: a long healthy run
    # peppered with occasional transient faults must not accumulate
    # toward the cap the way a systematically-crashing step does.
    # ``total_failures`` keeps the lifetime count for reporting.
    failures: int = 0
    total_failures: int = 0

    def resume_or_init(self, init_fn: Callable[[], Any]) -> Tuple[Any, int]:
        """Returns (state, start_step): restores the latest complete
        checkpoint when one exists, else calls init_fn."""
        step = store.latest_step(self.directory)
        if step is None:
            return init_fn(), 0
        state, _ = store.restore(self.directory, step, init_fn())
        return state, step

    def run(
        self,
        init_fn: Callable[[], Any],
        step_fn: Callable[[Any, int], Any],
        num_steps: int,
        on_step: Optional[Callable[[int, Any], None]] = None,
    ) -> Any:
        """Drive the loop with checkpoint/restart semantics.  ``step_fn`` may
        raise; we roll back and replay.  Data must be step-keyed (it is:
        ``data.pipeline.batch_for_step``)."""
        state, start = self.resume_or_init(init_fn)
        step = start
        while step < num_steps:
            try:
                state = step_fn(state, step)
                step += 1
                if on_step:
                    on_step(step, state)
                if step % self.checkpoint_every == 0:
                    store.save(self.directory, step, state, keep=self.keep)
                    # a successful checkpointed step proves the loop is
                    # healthy again: the transient-failure budget resets
                    self.failures = 0
            except Exception:
                self.failures += 1
                self.total_failures += 1
                if self.failures > self.max_failures:
                    raise
                ck = store.latest_step(self.directory)
                if ck is None:
                    state, step = init_fn(), 0
                else:
                    state, _ = store.restore(self.directory, ck, init_fn())
                    step = ck
        store.save(self.directory, step, state, keep=self.keep)
        return state


@dataclass
class StragglerDetector:
    ratio: float = 1.5          # flagged when EWMA > ratio * fleet median
    alpha: float = 0.2          # EWMA smoothing
    patience: int = 3

    ewma: Dict[str, float] = field(default_factory=dict)
    strikes: Dict[str, int] = field(default_factory=dict)

    def observe(self, host: str, step_time_s: float) -> None:
        prev = self.ewma.get(host, step_time_s)
        self.ewma[host] = (1 - self.alpha) * prev + self.alpha * step_time_s

    def stragglers(self) -> List[str]:
        if len(self.ewma) < 2:
            return []
        med = sorted(self.ewma.values())[len(self.ewma) // 2]
        out = []
        for host, v in self.ewma.items():
            if v > self.ratio * med:
                self.strikes[host] = self.strikes.get(host, 0) + 1
                if self.strikes[host] >= self.patience:
                    out.append(host)
            else:
                self.strikes[host] = 0
        return out


def plan_elastic_mesh(
    n_devices: int, *, model: int = 16, min_data: int = 1
) -> Optional[Tuple[int, int, int]]:
    """(pod, data, model) for the largest usable subset of ``n_devices``.

    The model axis is pinned (parameter layout survives re-meshing); the
    data axis absorbs the loss; whole pods are preferred for the pod axis.
    Returns None when fewer than model * min_data devices survive.  The
    shape is what ``launch.mesh.make_mesh_from_shape(shape, ("pod",
    "data", "model"))`` takes.
    """
    if n_devices < model * min_data:
        return None
    data_total = n_devices // model
    # prefer an even pod split when possible
    for pod in (4, 2, 1):
        if data_total % pod == 0 and data_total // pod >= min_data:
            return (pod, data_total // pod, model)
    return (1, data_total, model)
