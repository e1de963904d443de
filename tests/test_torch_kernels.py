"""The port's kernels on the CPU (each operator's CPU route is its kernel
module's one plain version: ``attention_reference`` for both attention
operators, ``ssd_chunked`` for the scan, equal to it bit for bit) against
the JAX package's Pallas kernels in interpret mode, on the same numpy
inputs.

Flash attention: the tolerances of tests/test_kernels.py, f32 2e-5
(summation order differs), bf16 2e-2 (both sides take the same bf16 inputs
and compute in f32; the output is rounded to bf16 once, which is within one
bf16 ulp at |o| < 1), and 1e-4 for logits around 40.  The JAX wrapper runs
at its default blocks (one block per sequence at these sizes) to keep
interpret mode fast; its tiling is covered by tests/test_kernels.py.

Decode attention (one query row a slot against the first ``kv_len`` keys
of its cache lane): its CPU route is ``attention_reference`` itself, so it
equals it exactly; against the JAX package's ``attention_reference`` f32
1e-5 (another order of sums) and bf16 2e-2 (both round a float32 result to
bf16 once: within one bf16 ulp at |o| < 1).

SSD scan: f32 5e-4 and bf16 5e-2, as tests/test_kernels.py holds the TPU
kernel to its oracle (float32 cumulative sums over a chunk, exponentiated,
in another order); ``ssd_chunked`` at 1e-4 against the port's own step
oracle, as tests/test_kernels.py pins the kernel to the chunked path.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ops import flash_attention as jax_flash
from repro.kernels.ops import ssd_scan as jax_ssd_scan
from repro.models.ops import attention_reference as jax_attention_reference
from repro_torch.kernels import (
    LAUNCHES,
    decode_attention,
    flash_attention,
    reset_launches,
    ssd_scan,
)
from repro_torch.kernels.decode_attention import decode_attention_cuda
from repro_torch.kernels.flash_attention import attention_reference, flash_attention_cuda
from repro_torch.kernels.ref import attention_ref, ssd_ref
from repro_torch.kernels.ssd_scan import ssd_chunked, ssd_scan_cuda

# the shape list of tests/test_kernels.py: (B, S, H, KV, hd)
ATTN_SHAPES = [
    (1, 128, 4, 4, 32),      # MHA
    (2, 256, 8, 2, 64),      # GQA 4:1
    (1, 192, 6, 1, 16),      # MQA
    (2, 64, 4, 4, 128),      # single block
    (1, 512, 2, 2, 8),       # long seq, tiny heads
]


def _tol(dtype):
    return dict(atol=2e-2, rtol=2e-2) if dtype == "bfloat16" \
        else dict(atol=2e-5, rtol=2e-5)


def _inputs(B, Sq, Sk, H, KV, hd, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    q = scale * rng.standard_normal((B, Sq, H, hd), dtype=np.float32)
    k = scale * rng.standard_normal((B, Sk, KV, hd), dtype=np.float32)
    v = rng.standard_normal((B, Sk, KV, hd), dtype=np.float32)
    return q, k, v


def _both(q, k, v, *, causal, dtype="float32"):
    """(port output, JAX output) as float32 numpy arrays."""
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    ours = flash_attention(*(torch.from_numpy(a).to(td) for a in (q, k, v)),
                           causal=causal)
    ref = jax_flash(*(jnp.asarray(a, jd) for a in (q, k, v)), causal=causal,
                    interpret=True)
    assert ours.dtype == td
    return ours.float().numpy(), np.asarray(ref, np.float32)


@pytest.mark.parametrize("B,S,H,KV,hd", ATTN_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_matches_jax_kernel(B, S, H, KV, hd, dtype, causal):
    q, k, v = _inputs(B, S, S, H, KV, hd, seed=S + H)
    ours, ref = _both(q, k, v, causal=causal, dtype=dtype)
    np.testing.assert_allclose(ours, ref, **_tol(dtype))


def test_flash_attention_s96():
    q, k, v = _inputs(1, 96, 96, 2, 2, 16, seed=0)
    ours, ref = _both(q, k, v, causal=True)
    np.testing.assert_allclose(ours, ref, atol=2e-5, rtol=2e-5)


def test_flash_attention_cross_lengths_non_causal():
    q, k, v = _inputs(2, 64, 128, 4, 4, 32, seed=3)
    ours, ref = _both(q, k, v, causal=False)
    np.testing.assert_allclose(ours, ref, atol=2e-5, rtol=2e-5)


def test_flash_attention_large_logits():
    q, k, v = _inputs(1, 128, 128, 2, 2, 32, seed=5, scale=8.0)
    ours, ref = _both(q, k, v, causal=True)
    assert np.isfinite(ours).all()
    np.testing.assert_allclose(ours, ref, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("causal", [True, False])
def test_plain_version_matches_naive_oracle(causal):
    """The plain version against the port's independent oracle."""
    q, k, v = (torch.from_numpy(a) for a in _inputs(2, 80, 80, 6, 2, 16, seed=7))
    np.testing.assert_allclose(
        attention_reference(q, k, v, causal=causal).numpy(),
        attention_ref(q, k, v, causal=causal).numpy(), atol=2e-5, rtol=2e-5)


def test_cpu_call_leaves_launch_count_at_zero():
    reset_launches()
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, 32, 32, 2, 1, 16, seed=1))
    flash_attention(q, k, v, causal=True)
    decode_attention(q[:, :1], k, v, torch.tensor([9]))
    ssd_scan(*(torch.from_numpy(a) for a in _ssd_inputs(1, 20, 2, 8, 4, seed=1)),
             chunk=8)
    assert LAUNCHES == {"flash_attention": 0, "decode_attention": 0, "ssd_scan": 0}


def test_causal_needs_equal_lengths():
    """A causal q is rows [q_offset, q_offset + Sq) of the square product
    over the keys: rows past the last key, or an offset without a causal
    mask, raise."""
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, 32, 16, 2, 2, 8, seed=2))
    with pytest.raises(ValueError, match="q_offset \\+ Sq <= Sk"):
        flash_attention(q, k, v, causal=True)
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, 16, 32, 2, 2, 8, seed=2))
    with pytest.raises(ValueError, match="q_offset \\+ Sq <= Sk"):
        flash_attention(q, k, v, causal=True, q_offset=17)
    with pytest.raises(ValueError, match="without a causal mask"):
        flash_attention(q, k, v, causal=False, q_offset=4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("lo,hi", [(0, 40), (40, 80), (64, 128), (100, 128)])
def test_causal_query_slice_is_rows_of_the_square_product(lo, hi, dtype):
    """q rows [lo, hi) with ``q_offset=lo`` against every key: the same rows
    of the JAX kernel's square causal product (a shard of a
    sequence-sharded q)."""
    q, k, v = _inputs(2, 128, 128, 6, 2, 16, seed=lo + hi)
    td = getattr(torch, dtype)
    ours = flash_attention(torch.from_numpy(q[:, lo:hi]).to(td),
                           *(torch.from_numpy(a).to(td) for a in (k, v)),
                           causal=True, q_offset=lo)
    ref = jax_flash(*(jnp.asarray(a, getattr(jnp, dtype)) for a in (q, k, v)),
                    causal=True, interpret=True)
    np.testing.assert_allclose(ours.float().numpy(),
                               np.asarray(ref, np.float32)[:, lo:hi], **_tol(dtype))


def test_kernel_wrapper_refuses_cpu_tensors():
    """The CUDA wrapper never runs the plain version: CPU input raises."""
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, 16, 16, 2, 2, 8, seed=4))
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_cuda(q, k, v, causal=True)


# --------------------------------------------------------------------------
# Decode attention
# --------------------------------------------------------------------------

# (H, KV, hd): granite-moe-3b's GQA 3, qwen2's GQA 6 at hd 128, whisper's
# (and zamba2's) MHA
DECODE_LAYOUTS = [(24, 8, 64), (12, 2, 128), (20, 20, 64)]


def _kv_len(kind, B, Sk, seed):
    """None (the whole lane), one 0-d length, or (B,) ragged lengths with 1
    and Sk among them."""
    if kind == "none":
        return None
    if kind == "scalar":
        return torch.tensor(Sk // 2 + 1, dtype=torch.int32)
    lens = np.random.default_rng(seed).integers(1, Sk + 1, size=B)
    lens[0], lens[-1] = 1, Sk
    return torch.as_tensor(lens, dtype=torch.int32)


@pytest.mark.parametrize("H,KV,hd", DECODE_LAYOUTS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["ragged", "scalar", "none"])
def test_decode_attention_matches_reference_and_jax(H, KV, hd, dtype, kind):
    B, Sk = 4, 40
    q, k, v = _inputs(B, 1, Sk, H, KV, hd, seed=H + hd)
    td = getattr(torch, dtype)
    qt, kt, vt = (torch.from_numpy(a).to(td) for a in (q, k, v))
    kv_len = _kv_len(kind, B, Sk, seed=hd)
    ours = decode_attention(qt, kt, vt, kv_len)
    assert ours.dtype == td and ours.shape == (B, 1, H, hd)
    assert torch.equal(ours, attention_reference(qt, kt, vt, causal=False, kv_len=kv_len))
    jd = getattr(jnp, dtype)
    ref = jax_attention_reference(
        *(jnp.asarray(a, jd) for a in (q, k, v)), causal=False,
        kv_len=None if kv_len is None else jnp.asarray(kv_len.numpy()))
    np.testing.assert_allclose(ours.float().numpy(), np.asarray(ref, np.float32),
                               **(dict(atol=2e-2, rtol=2e-2) if dtype == "bfloat16"
                                  else dict(atol=1e-5, rtol=1e-5)))


@pytest.mark.parametrize("device", ["cpu", "cuda"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_fake_shapes(device, dtype):
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        q = torch.empty(5, 1, 12, 128, dtype=dtype, device=device)
        k = torch.empty(5, 300, 2, 128, dtype=dtype, device=device)
        kv_len = torch.empty(5, dtype=torch.int32, device=device)
        out = decode_attention(q, k, k, kv_len)
        whole = decode_attention(q, k, k)
    for o in (out, whole):
        assert o.shape == (5, 1, 12, 128) and o.dtype == dtype
        assert o.device.type == device and o.is_contiguous()


@pytest.mark.parametrize("H,KV,hd", DECODE_LAYOUTS)
def test_decode_attention_flops_equal_the_plain_route(H, KV, hd):
    from torch.utils.flop_counter import FlopCounterMode

    B, Sk = 3, 50
    q, k, v = (torch.from_numpy(a) for a in _inputs(B, 1, Sk, H, KV, hd, seed=1))
    kv_len = _kv_len("ragged", B, Sk, seed=2)
    with FlopCounterMode(display=False) as op:
        decode_attention(q, k, v, kv_len)
    with FlopCounterMode(display=False) as plain:
        attention_reference(q, k, v, causal=False, kv_len=kv_len)
    assert op.get_total_flops() == plain.get_total_flops() == 4 * B * H * Sk * hd


def test_decode_attention_checks_its_inputs():
    q, k, v = (torch.from_numpy(a) for a in _inputs(2, 2, 16, 4, 2, 16, seed=6))
    with pytest.raises(ValueError, match="one query row"):
        decode_attention(q, k, v)
    with pytest.raises(ValueError, match="0-d or"):
        decode_attention(q[:, :1], k, v, torch.tensor([3, 4, 5]))
    with pytest.raises(TypeError, match="integer"):
        decode_attention(q[:, :1], k, v, torch.tensor([3.0, 4.0]))


def test_decode_kernel_wrapper_refuses_cpu_tensors():
    """The CUDA wrapper never runs the plain version: CPU input raises."""
    q, k, v = (torch.from_numpy(a) for a in _inputs(2, 1, 16, 4, 2, 16, seed=4))
    with pytest.raises(ValueError, match="CUDA"):
        decode_attention_cuda(q, k, v, torch.tensor([3, 16]))


# --------------------------------------------------------------------------
# SSD scan (mamba2)
# --------------------------------------------------------------------------

# the shape list of tests/test_kernels.py: (B, S, nh, hp, n, chunk)
SSD_SHAPES = [
    (1, 64, 2, 16, 8, 32),
    (2, 128, 4, 32, 16, 64),
    (1, 200, 4, 16, 8, 64),      # S not a chunk multiple -> ragged last chunk
    (2, 96, 1, 64, 32, 32),      # single head, wide state
    (1, 256, 8, 8, 4, 256),      # single chunk
]


def _ssd_inputs(B, S, nh, hp, n, seed):
    """x, dt = softplus(normal), A = -exp(normal), Bc, Cc, as the inputs of
    tests/test_kernels.py (drawn with numpy here)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, nh, hp), dtype=np.float32)
    dt = np.logaddexp(0.0, rng.standard_normal((B, S, nh))).astype(np.float32)
    A = -np.exp(rng.standard_normal(nh)).astype(np.float32)
    Bc = rng.standard_normal((B, S, n), dtype=np.float32)
    Cc = rng.standard_normal((B, S, n), dtype=np.float32)
    return x, dt, A, Bc, Cc


def _ssd_tol(dtype):
    return dict(atol=5e-2, rtol=5e-2) if dtype == "bfloat16" \
        else dict(atol=5e-4, rtol=5e-4)


@pytest.mark.parametrize("B,S,nh,hp,n,chunk", SSD_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_scan_matches_jax_kernel(B, S, nh, hp, n, chunk, dtype):
    x, dt, A, Bc, Cc = _ssd_inputs(B, S, nh, hp, n, seed=S + nh)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    y, h = ssd_scan(*(torch.from_numpy(a).to(td) for a in (x, dt)),
                    torch.from_numpy(A),
                    *(torch.from_numpy(a).to(td) for a in (Bc, Cc)), chunk=chunk)
    yj, hj = jax_ssd_scan(*(jnp.asarray(a, jd) for a in (x, dt)), jnp.asarray(A),
                          *(jnp.asarray(a, jd) for a in (Bc, Cc)),
                          chunk=chunk, interpret=True)
    assert y.dtype == h.dtype == torch.float32
    assert y.shape == (B, S, nh, hp) and h.shape == (B, nh, hp, n)
    np.testing.assert_allclose(y.numpy(), np.asarray(yj), **_ssd_tol(dtype))
    np.testing.assert_allclose(h.numpy(), np.asarray(hj), **_ssd_tol(dtype))


@pytest.mark.parametrize("B,S,nh,hp,n,chunk", SSD_SHAPES)
def test_ssd_plain_matches_sequential_oracle(B, S, nh, hp, n, chunk):
    args = [torch.from_numpy(a) for a in _ssd_inputs(B, S, nh, hp, n, seed=7)]
    y, h = ssd_chunked(*args, chunk)
    yr, hr = ssd_ref(*args)
    np.testing.assert_allclose(y.numpy(), yr.numpy(), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(h.numpy(), hr.numpy(), atol=1e-4, rtol=1e-4)


def test_ssd_plain_matches_sequential_oracle_at_granite_4_h_ratios():
    """granite-4.0-h-small's scan cut in width: a state twice the head
    dim, many heads, several chunks with a ragged last one."""
    args = [torch.from_numpy(a) for a in _ssd_inputs(1, 300, 16, 8, 16, seed=11)]
    y, h = ssd_chunked(*args, 64)
    yr, hr = ssd_ref(*args)
    np.testing.assert_allclose(y.numpy(), yr.numpy(), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(h.numpy(), hr.numpy(), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("S,chunk", [(128, 32), (100, 32), (20, 64)])
def test_ssd_plain_matches_chunked_path(S, chunk):
    """The operator's CPU route is ``ssd_chunked``, bit for bit, a ragged
    last chunk (and one chunk longer than S) included."""
    args = [torch.from_numpy(a) for a in _ssd_inputs(2, S, 4, 16, 8, seed=9)]
    y1, h1 = ssd_scan(*args, chunk=chunk)
    y2, h2 = ssd_chunked(*args, chunk)
    assert torch.equal(y1, y2) and torch.equal(h1, h2)


def test_ssd_ragged_chunk_equals_dt0_padding():
    """A partial last chunk gives what the JAX wrapper's dt = 0 padding
    gives: the same outputs on the first S steps and the same final state."""
    x, dt, A, Bc, Cc = _ssd_inputs(1, 45, 3, 8, 4, seed=3)
    pad = [(0, 0), (0, 19)]
    padded = [np.pad(a, pad + [(0, 0)] * (a.ndim - 2)) for a in (x, dt, Bc, Cc)]
    y, h = ssd_chunked(*(torch.from_numpy(a) for a in (x, dt, A, Bc, Cc)), 16)
    yp, hp_ = ssd_chunked(*(torch.from_numpy(a) for a in padded[:2]),
                          torch.from_numpy(A),
                          *(torch.from_numpy(a) for a in padded[2:]), 16)
    np.testing.assert_allclose(y.numpy(), yp[:, :45].numpy(), atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(h.numpy(), hp_.numpy(), atol=1e-6, rtol=1e-6)


def _operator_and_plain(op):
    """(the operator's CPU outputs, its plain version's) on one input:
    causal GQA flash with a scale, decode over ragged lengths, an SSD scan
    with a ragged last chunk in bfloat16."""
    q, k, v = (torch.from_numpy(a) for a in _inputs(2, 40, 40, 6, 2, 16, seed=12))
    if op == "flash":
        return ((flash_attention(q, k, v, causal=True, scale=0.3),),
                (attention_reference(q, k, v, causal=True, scale=0.3),))
    if op == "decode":
        lens = torch.tensor([1, 40], dtype=torch.int32)
        return ((decode_attention(q[:, :1], k, v, lens),),
                (attention_reference(q[:, :1], k, v, causal=False, kv_len=lens),))
    args = [torch.from_numpy(a) for a in _ssd_inputs(2, 70, 3, 8, 5, seed=12)]
    args = [a if i == 2 else a.to(torch.bfloat16) for i, a in enumerate(args)]
    return ssd_scan(*args, chunk=16), ssd_chunked(*args, 16)


@pytest.mark.parametrize("op", ["flash", "decode", "ssd"])
def test_operator_cpu_route_is_its_plain_version(op):
    """Each operator's CPU implementation is its kernel module's one plain
    version: the same function, so the same bits."""
    for ours, plain in zip(*_operator_and_plain(op)):
        assert ours.dtype == plain.dtype and torch.equal(ours, plain)


def test_ssd_kernel_wrapper_refuses_cpu_tensors():
    """The CUDA wrapper never runs the plain version: CPU input raises."""
    args = [torch.from_numpy(a) for a in _ssd_inputs(1, 16, 2, 8, 4, seed=4)]
    with pytest.raises(ValueError, match="CUDA"):
        ssd_scan_cuda(*args, chunk=8)


def test_ssd_scan_checks_shapes():
    x, dt, A, Bc, Cc = (torch.from_numpy(a) for a in _ssd_inputs(1, 16, 2, 8, 4, seed=5))
    with pytest.raises(ValueError, match="does not match"):
        ssd_scan(x, dt[:, :8], A, Bc, Cc, chunk=8)


def test_head_dim_sharded_cache_keeps_the_plain_route(monkeypatch):
    """``_attend_cache`` on the kernel route: plain tensors and a cache
    whose head dim no mesh axis shards take the operator; a cache sharded
    on its head dim (``ShardCtx.tp`` on a mesh) keeps ``attention_reference``,
    whose shards each hold part of every dot product."""
    import dataclasses

    from torch.distributed.tensor import DTensor, Replicate

    import repro_torch.kernels.ops as kops
    from repro_torch.launch.mesh import fake_world, make_mesh_from_shape
    from repro_torch.models import model as tmodel
    from repro_torch.models.ops import ShardCtx

    routes = []

    def record(name):
        def fn(q, *args, **kwargs):
            routes.append(name)
            return q
        return fn

    monkeypatch.setattr(tmodel, "attention_reference", record("plain"))
    monkeypatch.setattr(kops, "decode_attention", record("kernel"))
    q, k, v = (torch.from_numpy(a) for a in _inputs(2, 1, 16, 4, 2, 16, seed=8))
    kv_len = torch.tensor([3, 16])
    tmodel._attend_cache(q, k, v, ShardCtx(), kv_len)
    tmodel._attend_cache(q, k, v, ShardCtx(attention_impl="torch"), kv_len)
    assert routes == ["kernel", "plain"]
    with fake_world(2):
        mesh = make_mesh_from_shape((1, 2), ("data", "model"), "cpu")
        q, k, v = (DTensor.from_local(t, mesh, (Replicate(), Replicate()))
                   for t in (q, k, v))
        kv_len = DTensor.from_local(kv_len, mesh, (Replicate(), Replicate()))
        ctx = ShardCtx(enabled=True)
        routes.clear()
        tmodel._attend_cache(q, k, v, ctx, kv_len)
        assert routes == ["plain"]
        tmodel._attend_cache(q, k, v, dataclasses.replace(ctx, tp=None), kv_len)
        assert routes == ["plain", "kernel"]


@pytest.mark.parametrize("kind", ["ragged", "scalar", "none"])
def test_decode_attention_runs_per_shard_of_the_batch(kind):
    """On DTensors the operator runs per shard with the batch sharded (a
    0-d ``kv_len`` replicated) or everything replicated; a head-dim shard
    has no rule and raises."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.launch.mesh import fake_world, make_mesh_from_shape

    B, Sk = 4, 24
    q, k, v = (torch.from_numpy(a) for a in _inputs(B, 1, Sk, 4, 2, 16, seed=9))
    kv_len = _kv_len(kind, B, Sk, seed=3)
    want = attention_reference(q, k, v, causal=False, kv_len=kv_len)
    with fake_world(2):
        mesh = make_mesh_from_shape((2,), ("data",), "cpu")
        for place in (Shard(0), Replicate()):
            def dt(t, p=place):
                return DTensor.from_local(
                    t[:B // 2] if p == Shard(0) else t, mesh, (p,), run_check=False,
                    shape=t.shape, stride=t.stride())
            lens = None if kv_len is None else \
                dt(kv_len, place if kv_len.ndim else Replicate())
            out = decode_attention(dt(q), dt(k), dt(v), lens)
            assert out.placements == (place,) and out.shape == q.shape
            rows = B // 2 if place == Shard(0) else B
            torch.testing.assert_close(out.to_local(), want[:rows], atol=0, rtol=0)
        sharded = [DTensor.from_local(t[..., :8], mesh, (Shard(3),), run_check=False,
                                      shape=t.shape, stride=t.stride()) for t in (q, k, v)]
        with pytest.raises(ValueError, match="no sharding rule"):
            decode_attention(*sharded)
