"""The port's Kubernetes dialect and ``KubernetesAdapter`` against the JAX
package's, on the CPU.

tests/test_adapter_k8s.py's cases run against ``repro_torch``: each
fragment must equal the reference's ``to_kubernetes`` output on the same
constraints, with no tolerance (the weights are integers and formatted
strings).  The adapter's sidecar serves the port's registry over
Prometheus on an ephemeral localhost port.
"""
import urllib.request

import pytest

from repro.configs import boutique as jboutique
from repro.core import adapter as jadapter
from repro.core.pipeline import GreenConstraintPipeline as JPipeline
from repro.core.types import Affinity, AvoidNode, TimeShift
from repro_torch.configs import boutique as tboutique
from repro_torch.core import KubernetesAdapter
from repro_torch.core import adapter as tadapter
from repro_torch.core.pipeline import GreenConstraintPipeline as TPipeline
from repro_torch.obs import MetricsRegistry, prometheus_text

from test_torch_planner import to_port


def _both(constraints):
    """The reference's fragments and the port's, on the same constraints
    (carried across as ``repro_torch`` objects)."""
    want = jadapter.to_kubernetes(constraints)
    got = tadapter.to_kubernetes(to_port(list(constraints)))
    assert got == want
    return got


def test_avoidnode_maps_to_node_anti_affinity():
    k8s = _both([AvoidNode(service="frontend", flavour="large", node="italy",
                           weight=1.0),
                 AvoidNode(service="frontend", flavour="large",
                           node="greatbritain", weight=0.636)])
    prefs = k8s["frontend"]["affinity"]["nodeAffinity"][
        "preferredDuringSchedulingIgnoredDuringExecution"]
    assert [p["weight"] for p in prefs] == [100, 64]
    expr = prefs[0]["preference"]["matchExpressions"][0]
    assert expr["operator"] == "NotIn" and expr["values"] == ["italy"]


def test_affinity_maps_to_pod_affinity():
    k8s = _both([Affinity(service="prefill", flavour="perf", other="decode",
                          weight=0.34)])
    prefs = k8s["prefill"]["affinity"]["podAffinity"][
        "preferredDuringSchedulingIgnoredDuringExecution"]
    assert prefs[0]["weight"] == 34
    assert prefs[0]["podAffinityTerm"]["labelSelector"]["matchLabels"] == \
        {"app": "decode"}


def test_timeshift_maps_to_suspend_annotations():
    k8s = _both([TimeShift(service="batch", flavour="perf", node="texas",
                           shift_h=6, weight=0.73)])
    ann = k8s["batch"]["annotations"]
    assert ann["greenops/suspend"] == "true"
    assert ann["greenops/not-before-offset-hours"] == "6"


def test_memory_weight_attenuates_k8s_weight():
    k8s = _both([AvoidNode(service="s", flavour="f", node="n", weight=1.0,
                           memory_weight=0.5)])
    prefs = k8s["s"]["affinity"]["nodeAffinity"][
        "preferredDuringSchedulingIgnoredDuringExecution"]
    assert prefs[0]["weight"] == 50


@pytest.mark.parametrize("n", [1, 2, 3])
def test_end_to_end_scenario_to_k8s(n):
    jout = JPipeline().run(*jboutique.scenario(n), use_kb=False)
    tout = TPipeline(device="cpu").run(*tboutique.scenario(n), use_kb=False)
    assert list(tout.constraints) == to_port(list(jout.constraints))
    k8s = tadapter.to_kubernetes(tout.constraints)
    assert k8s == jadapter.to_kubernetes(jout.constraints)
    assert "frontend" in k8s and "productcatalog" in k8s
    for frag in k8s.values():
        for pref in frag["affinity"].get("nodeAffinity", {}).get(
                "preferredDuringSchedulingIgnoredDuringExecution", []):
            assert 1 <= pref["weight"] <= 100


def test_adapter_renders_counts_and_serves_metrics():
    """The adapter starts its scrape endpoint on an ephemeral port, counts
    what it renders by kind, serves that registry, and closes twice."""
    jout = JPipeline().run(*jboutique.scenario(1), use_kb=False)
    constraints = to_port(list(jout.constraints))
    reg = MetricsRegistry()
    adapter = KubernetesAdapter(registry=reg, metrics_port=0)
    assert not adapter.running and adapter.metrics_port is None
    with adapter as ad:
        assert ad.start() is ad                 # idempotent
        port = ad.metrics_port
        assert ad.running and port > 0
        frags = ad.render(constraints)
        assert frags == jadapter.to_kubernetes(jout.constraints)
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                    timeout=10) as resp:
            body = resp.read().decode()
    assert body == prometheus_text(reg)
    kinds = {}
    for c in constraints:
        kinds[c.kind] = kinds.get(c.kind, 0) + 1
    for kind, count in kinds.items():
        assert reg.value("adapter.constraints",
                         labels={"kind": kind}) == count
        assert f'kind="{kind}"' in body
    assert not adapter.running and adapter.metrics_port is None
    adapter.close()                             # a second close is a no-op
    assert not adapter.running
