"""The frozen yardstick against hand counts at small shapes: the kernel's
bound, the model-FLOP count, the device-trace reduction, the traffic
generator and the seeded weights."""
import math

import numpy as np
import pytest
import torch

import portbench_twin  # noqa: F401  (puts the checkout on sys.path)
from portbench.yardstick import bounds, device, stats, traffic, weights
from portbench.yardstick.peaks import Peaks, card_peaks

PEAKS = Peaks(bf16_flops=100.0, f32_flops=10.0, mem_bytes=1000.0)


def test_attention_work_counts_causal_pairs_once():
    # S = 4: rows see 1, 2, 3, 4 keys -> 10 pairs; 4 * hd FLOPs a pair a head
    flops, nbytes = bounds.attention_work(1, 4, 4, 2, 1, 8, True, 2)
    assert flops == 4 * 2 * 8 * 10
    assert nbytes == 2 * 8 * (2 * 4 * 2 + 2 * 4 * 1)     # q, o; k, v
    assert bounds.attention_work(2, 3, 5, 1, 1, 4, False, 4)[0] == 4 * 2 * 4 * 15
    # a slice of rows starting at position 2: rows see 3, 4 keys
    assert bounds.attention_work(1, 2, 4, 1, 1, 1, True, 2, q_offset=2)[0] == 4 * 7


def test_attention_bound_takes_the_larger_term():
    flops, nbytes = bounds.attention_work(1, 4, 4, 2, 1, 8, True, 2)
    assert bounds.attention_bound_s(1, 4, 4, 2, 1, 8, True, 2, PEAKS) == \
        max(flops / 100.0, nbytes / 1000.0)
    flops, nbytes = bounds.attention_work(1, 4, 4, 2, 1, 8, True, 4)
    assert bounds.attention_bound_s(1, 4, 4, 2, 1, 8, True, 4, PEAKS) == \
        max(flops / 10.0, nbytes / 1000.0)


def test_moe_prefill_flops_hand_count():
    from portbench.counts import granite_moe as counts

    cfg = dict(n_layers=2, d_model=4, n_heads=2, n_kv_heads=1, d_ff=3, vocab=10,
               moe_n_experts=5, moe_top_k=2)
    S, d, hd = 6, 4, 2
    # q, o: 2 heads of 2; k, v: 1 head of 2; causal pairs 21; router; 2 experts x 3 products
    layer = 2 * S * d * 2 * hd * 2 + 2 * S * d * 1 * hd * 2 + 4 * 2 * hd * 21 \
        + 2 * S * d * 5 + 2 * 3 * 2 * S * d * 3
    assert counts.prefill_flops(cfg, S) == 2 * layer + 2 * d * 10
    assert counts.attention_calls(cfg, S) == [(1, S, S, 2, 1, hd, True)] * 2


def test_card_peaks_prefers_the_named_part():
    assert card_peaks("NVIDIA H100 80GB HBM3").bf16_flops == 989e12
    assert card_peaks("NVIDIA H100 PCIe").bf16_flops == 756e12
    with pytest.raises(KeyError):
        card_peaks("a card nobody listed")


def test_reduce_busy_union_launches_and_idle_by_host_span():
    ops = [("k1", 1.0, 2.0), ("k2", 1.5, 2.5), ("k1", 4.0, 5.0), ("k3", 9.5, 11.0)]
    host = [("decode", 0.0, 3.0), ("wait", 3.0, 8.0)]
    out = device.reduce(ops, 0.0, 10.0, host)
    assert out["busy_s"] == pytest.approx(1.5 + 1.0 + 0.5)   # k3 clipped at 10
    assert out["launches"] == 4
    assert out["by_name"]["k1"] == {"count": 2, "seconds": 2.0}
    idle = dict(out["idle_gaps"])
    # gaps: [0,1] decode; [2.5,4] decode 0.5 / wait 1.0 -> wait; [5,9.5] wait
    assert idle == pytest.approx({"decode": 1.0, "wait": 1.5 + 4.5})
    assert out["device_ops"][0][0] == "k1"
    assert device.kernel_seconds(out["by_name"], ("k1", "k2")) == (3, 3.0)


def test_short_name_drops_shared_qualifiers():
    assert device.short_name("void at::native::vectorized_elementwise_kernel<4, "
                             "at::native::CUDAFunctor_add<float> >(int)") == \
        "vectorized_elementwise_kernel<4, CUDAFunctor_add<float> >(int)"
    assert device.short_name("void (anonymous namespace)::ssd_cb<float>(float const*)", 9) == \
        "ssd_cb<fl"


def test_percentile_needs_its_samples():
    assert stats.percentile(list(range(1, 101)), 95, min_count=20) == pytest.approx(95.05)
    assert stats.percentile([1.0] * 19, 95, min_count=20) is None


TRAFFIC = {"loop": "open", "rate_per_s": 5.0, "shape_seed": 11,
           "prompt": {"dist": "lognormal", "median": 100, "sigma": 0.5, "min": 20, "max": 400},
           "output": {"dist": "uniform", "min": 2, "max": 9}}


def _shape(reqs):
    return [(len(r.prompt), r.max_new_tokens) for r in reqs]


def test_traffic_seed_deals_one_set_of_sizes_and_gaps_in_its_own_order():
    a = traffic.requests(TRAFFIC, 10.0, 2 ** 33 + 5, vocab=50)
    b = traffic.requests(TRAFFIC, 10.0, 7, vocab=50)
    assert len(a) == len(b) == 50
    # the same work at the same load: one multiset of sizes and of gaps
    assert sorted(_shape(a)) == sorted(_shape(b))
    gaps = [np.diff([0.0] + [r.arrival_s for r in x]) for x in (a, b)]
    assert np.allclose(sorted(gaps[0]), sorted(gaps[1]))
    assert a[-1].arrival_s == pytest.approx(10.0) and b[-1].arrival_s == pytest.approx(10.0)
    # dealt in another order, with other tokens
    assert _shape(a) != _shape(b)
    assert not np.allclose(gaps[0], gaps[1])
    assert not all(np.array_equal(x.prompt, y.prompt) for x, y in zip(a, b))
    assert all(20 <= len(r.prompt) <= 400 and 2 <= r.max_new_tokens <= 9 for r in a)
    assert len({len(r.prompt) for r in a}) > 10            # lengths do vary
    again = traffic.requests(TRAFFIC, 10.0, 2 ** 33 + 5, vocab=50)
    assert _shape(a) == _shape(again)
    assert all(np.array_equal(x.prompt, y.prompt) for x, y in zip(a, again))


def test_in_flight_clients_keep_a_share_of_their_output():
    t = dict(TRAFFIC, loop="closed", clients=20, pool=60, shape_seed=3,
             output={"dist": "uniform", "min": 100, "max": 100})
    reqs = traffic.requests(dict(t, in_flight=True), 10.0, 1, vocab=50)
    cold = traffic.requests(t, 10.0, 1, vocab=50)
    first = [r.max_new_tokens for r in reqs[:20]]
    assert all(1 <= m <= 100 for m in first) and len(set(first)) > 10
    assert [r.max_new_tokens for r in reqs[20:]] == [100] * 40
    assert [r.max_new_tokens for r in cold] == [100] * 60
    assert _shape(reqs)[20:] == _shape(cold)[20:]


def test_closed_traffic_draws_the_pool():
    t = dict(TRAFFIC, loop="closed", clients=3, pool=7)
    reqs = traffic.requests(t, 10.0, 1, vocab=50)
    assert len(reqs) == 7 and all(r.arrival_s is None for r in reqs)


def test_weights_are_seeded_and_shaped():
    spec = {"a/w": ((64, 32), ("normal", 0.5)), "a/s": ((1000,), ("normal", 0.1, 1.0)),
            "b": ((4000,), ("log_of_uniform", 1.0, 16.0)),
            "c": ((4000,), ("softplus_inv_log_uniform", 1e-3, 1e-1))}
    w = weights.draw(spec, 2 ** 40 + 3, "cpu", torch.float32)
    again = weights.draw(spec, 2 ** 40 + 3, "cpu", torch.float32)
    other = weights.draw(spec, 5, "cpu", torch.float32)
    assert torch.equal(w["a"]["w"], again["a"]["w"]) and not torch.equal(w["a"]["w"], other["a"]["w"])
    assert w["a"]["w"].shape == (64, 32)
    assert w["a"]["w"].std().item() == pytest.approx(0.5, rel=0.1)
    assert w["a"]["s"].mean().item() == pytest.approx(1.0, abs=0.02)
    assert math.log(1.0) <= w["b"].min().item() and w["b"].max().item() <= math.log(16.0)
    dt = torch.nn.functional.softplus(w["c"])
    assert 1e-3 * 0.99 <= dt.min().item() and dt.max().item() <= 1e-1 * 1.01
