"""The port's TimeShift module (the batch-processing extension) against the
JAX package's, on the CPU.

tests/test_timeshift.py's cases run against ``repro_torch`` on the same
inputs (its ``_setup`` app, infrastructure and monitoring, carried across
with ``to_port``), and every constraint, candidate, forecast, KB file and
adapter dict must equal the reference's with no tolerance.  The
batch-extension pipeline on ``_setup(8)`` and ``_setup(3)`` gives the same
constraints, Prolog text and report in both packages.
"""
import filecmp
import os

import pytest

from repro.core import adapter as jadapter
from repro.core.energy import EnergyMixGatherer as JGatherer
from repro.core.generator import ConstraintGenerator as JGenerator
from repro.core.kb import KBEnricher as JEnricher
from repro.core.kb import KnowledgeBase as JKB
from repro.core.library import ConstraintLibrary as JLibrary
from repro.core.library import TimeShiftModule as JTimeShiftModule
from repro.core.pipeline import GreenConstraintPipeline as JPipeline
from repro.core.types import Infrastructure, Node
from repro.core.types import TimeShift as JTimeShift
from repro_torch.core import adapter as tadapter
from repro_torch.core.energy import EnergyMixGatherer as TGatherer
from repro_torch.core.generator import ConstraintGenerator as TGenerator
from repro_torch.core.kb import KBEnricher as TEnricher
from repro_torch.core.kb import KnowledgeBase as TKB
from repro_torch.core.library import ConstraintLibrary as TLibrary
from repro_torch.core.library import TimeShiftModule as TTimeShiftModule
from repro_torch.core.pipeline import GreenConstraintPipeline as TPipeline
from repro_torch.core.types import TimeShift as TTimeShift

from test_timeshift import _setup
from test_torch_planner import to_port


def _both_setup(tolerance_h=8):
    j = _setup(tolerance_h)
    return j, to_port(j)


def _timeshifts(gen_cls, lib_cls, ts_cls, app, infra, mon):
    gen = gen_cls(library=lib_cls.with_batch_extension(), alpha=0.5)
    return [c for c in gen.generate(app, infra, mon) if isinstance(c, ts_cls)]


def test_batch_extension_library_matches():
    jlib, tlib = JLibrary.with_batch_extension(), TLibrary.with_batch_extension()
    assert [m.name for m in tlib] == [m.name for m in jlib]
    assert [type(m).__name__ for m in tlib] == [type(m).__name__ for m in jlib]


def test_timeshift_generated_for_delay_tolerant_service_matches():
    j, t = _both_setup()
    jc = _timeshifts(JGenerator, JLibrary, JTimeShift, *j)
    tc = _timeshifts(TGenerator, TLibrary, TTimeShift, *t)
    assert tc == to_port(jc)
    [c] = tc
    assert (c.service, c.node, c.shift_h) == ("batch-train", "n-dirty", 6)
    assert c.impact_g == 500.0 * (400.0 - 60.0)
    assert c.explanation == jc[0].explanation
    assert c.render() == jc[0].render() == \
        "timeShift(d(batch-train, perf), n-dirty, 6, 1.0)."


@pytest.mark.parametrize("tolerance_h,profiles", [
    (8, {("batch-train", "perf"): 500.0, ("web", "perf"): 500.0}),
    (3, {("batch-train", "perf"): 500.0}),
], ids=["time_critical_and_flat", "tolerance_truncates"])
def test_timeshift_candidates_match(tolerance_h, profiles):
    (japp, jinfra, _), (tapp, tinfra, _) = _both_setup(tolerance_h)
    jc = JTimeShiftModule().candidates(japp, jinfra, profiles, {}, "current")
    tc = TTimeShiftModule().candidates(tapp, tinfra, profiles, {}, "current")
    assert [(c.payload, c.impact_g) for c in tc] == \
        [(c.payload, c.impact_g) for c in jc]
    assert all(c.payload[0] != "web" for c in tc)
    assert all(c.payload[2] != "n-flat" for c in tc)
    if tolerance_h == 3:
        assert [c.payload[4] for c in tc] == [3]


def test_gatherer_persistence_forecast_matches():
    sig = lambda region: [300.0, 200.0, 100.0] * 8  # noqa: E731
    jinfra = JGatherer(signal=sig, window=24).enrich(
        Infrastructure("i", (Node("n"),)))
    tinfra = TGatherer(signal=sig, window=24).enrich(
        to_port(Infrastructure("i", (Node("n"),))))
    assert tinfra == to_port(jinfra)
    assert tinfra.node("n").carbon == 200.0
    assert len(tinfra.node("n").carbon_forecast) == 24


def test_timeshift_kb_round_trip_and_adapter_match(tmp_path):
    j, t = _both_setup()
    jc = _timeshifts(JGenerator, JLibrary, JTimeShift, *j)
    tc = _timeshifts(TGenerator, TLibrary, TTimeShift, *t)
    jkb, tkb = JKB(), TKB()
    JEnricher().update(jkb, jc, {}, {}, j[1], iteration=1)
    TEnricher().update(tkb, tc, {}, {}, t[1], iteration=1)
    jkb.save(str(tmp_path / "jax"))
    tkb.save(str(tmp_path / "port"))
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "port"))
    _, mismatch, errors = filecmp.cmpfiles(
        tmp_path / "jax", tmp_path / "port", names, shallow=False)
    assert not mismatch and not errors, mismatch
    restored = [sc.constraint
                for sc in TKB.load(str(tmp_path / "port")).ck.values()]
    assert restored == to_port(
        [sc.constraint for sc in JKB.load(str(tmp_path / "jax")).ck.values()])
    assert any(isinstance(c, TTimeShift) and c.shift_h == 6 for c in restored)
    assert tadapter.to_dicts(tc) == jadapter.to_dicts(jc)
    assert tadapter.to_dicts(tc)[0]["kind"] == "timeShift"


@pytest.mark.parametrize("tolerance_h", [8, 3])
def test_full_pipeline_with_batch_extension_matches(tolerance_h):
    (japp, jinfra, jmon), (tapp, tinfra, tmon) = _both_setup(tolerance_h)
    jout = JPipeline(library=JLibrary.with_batch_extension(),
                     alpha=0.5).run(japp, jinfra, jmon)
    tout = TPipeline(library=TLibrary.with_batch_extension(), alpha=0.5,
                     device="cpu").run(tapp, tinfra, tmon)
    assert list(tout.constraints) == to_port(list(jout.constraints))
    assert tout.prolog == jout.prolog
    assert tout.dicts == jout.dicts
    assert tout.report.render() == jout.report.render()
    kinds = {c.kind for c in tout.constraints}
    assert "timeShift" in kinds and "avoidNode" in kinds
    shift = {8: 6, 3: 3}[tolerance_h]
    assert any(c.kind == "timeShift" and c.shift_h == shift
               for c in tout.constraints)
