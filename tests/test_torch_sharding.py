"""The port's sharding layer against the JAX package, in one process on the CPU.

  * ``models.sharding.default_rules``: the rules equal the reference's, dict
    for dict, for every registry arch, on both production meshes' parameters
    (``model_size`` 16; ``fsdp_total`` 16 over ``data``, 32 over
    ``("pod", "data")``), with ``seq_shard_cache`` on and off (the
    counterpart of tests/test_sharding.py's ``test_rules_respect_divisibility``).
  * ``schema_to_pspecs``: every parameter and cache leaf's spec equals the
    reference's ``PartitionSpec`` entry for entry (``test_every_param_gets_a_spec``).
  * ``launch.plan.build_plan(multi_pod=False/True)``: rules, the sharded
    context, in and out specs, chips, model FLOPs and the optimizer config
    equal the reference ``build_plan``'s for every supported cell.
  * ``launch.mesh.spec_to_placements`` (a tuple of axes in mesh order, the
    pod axis major) and ``make_mesh_from_shape`` fed by
    ``ft.manager.plan_elastic_mesh``.
  * ``launch.cost``'s collective counter on hand-derived programs on a fake
    4x2 mesh: an FSDP weight gather, a row-parallel matmul's all-reduce, a
    reduce-scatter, each with its HLO kind and its per-device operand
    bytes, the local (per-device) FLOPs, and DTensor's own redistribution
    counted as implicit; ``CommDebugMode`` agrees on the counts.
  * ``dryrun.run_cell(multi_pod=True)`` on CPU fakes for one reduced cell
    per family (the registry arch shrunk as ``models.testing.reduced``, the
    shape cut to 256 positions), and ``ShardCtx.act``'s no-op cases.
"""
import dataclasses
import math

import jax
import pytest
import torch
from jax.sharding import PartitionSpec as P
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.debug import CommDebugMode

from repro.configs.registry import ARCHS as JAX_ARCHS
from repro.launch import plan as jplan
from repro.models.model import cache_schema as jax_cache_schema
from repro.models.schema import build_schema as jax_build_schema
from repro.models.sharding import default_rules as jax_default_rules
from repro.models.sharding import schema_to_pspecs as jax_pspecs
from repro_torch.configs.registry import ARCHS
from repro_torch.ft.manager import plan_elastic_mesh
from repro_torch.launch import cost, dryrun
from repro_torch.launch import plan as tplan
from repro_torch.launch.mesh import (
    fake_world, local_shape_and_offset, make_mesh_from_shape, make_production_mesh,
    redistribute, spec_to_placements,
)
from repro_torch.models.config import SHAPES, cell_is_supported
from repro_torch.models.model import cache_schema
from repro_torch.models.ops import NOSHARD, ShardCtx
from repro_torch.models.schema import build_schema
from repro_torch.models.sharding import default_rules, schema_to_pspecs
from repro_torch.models.testing import reduced

CELLS = [(a, s) for a in sorted(ARCHS) for s in SHAPES
         if cell_is_supported(ARCHS[a], SHAPES[s])[0]]
# (fsdp_axes, fsdp_total, batch_axes) of the 16x16 and the 2x16x16 mesh
MESH_PARAMS = {"16x16": (("data",), 16, ("data",)),
               "2x16x16": (("pod", "data"), 32, ("pod", "data"))}


def _names(spec):
    """A spec as a tuple of axis-name tuples (None for a replicated dim):
    JAX stores a one-name tuple entry as the name."""
    return tuple(None if e is None else (e,) if isinstance(e, str) else tuple(e)
                 for e in spec)


def _port_specs(tree):
    """Spec tuples in ``jax.tree`` order: dicts by sorted key, NamedTuples
    and containers in order, a spec (a tuple of None / names / tuples of
    names) as one leaf."""
    if isinstance(tree, dict):
        return [s for k in sorted(tree) for s in _port_specs(tree[k])]
    if tplan._is_spec(tree):
        return [_names(tree)]
    return [s for v in tree for s in _port_specs(v)]


def _jax_specs(tree):
    return [_names(s) for s in jax.tree.leaves(tree, is_leaf=lambda s: isinstance(s, P))]


# -- rules and specs -----------------------------------------------------------

@pytest.mark.parametrize("seq_shard_cache", [False, True])
@pytest.mark.parametrize("mesh", sorted(MESH_PARAMS))
@pytest.mark.parametrize("name", sorted(ARCHS))
def test_default_rules_equal_the_reference(name, mesh, seq_shard_cache):
    fsdp_axes, fsdp_total, batch_axes = MESH_PARAMS[mesh]
    kw = dict(model_size=16, fsdp_axes=fsdp_axes, fsdp_total=fsdp_total,
              batch_axes=batch_axes, seq_shard_cache=seq_shard_cache)
    mine = default_rules(ARCHS[name], **kw).rules
    assert mine == jax_default_rules(JAX_ARCHS[name], **kw).rules
    # the divisibility the rules promise
    cfg = ARCHS[name]
    for rule, n in (("heads_q", cfg.n_heads), ("heads_kv", cfg.n_kv_heads),
                    ("embed_vocab", cfg.vocab_padded), ("d_ff", cfg.d_ff)):
        if mine.get(rule):
            assert n % 16 == 0, rule
    if mine.get("d_model"):
        assert cfg.d_model % fsdp_total == 0
    if cfg.moe is not None and mine.get("experts"):
        assert cfg.moe.n_experts_padded % 16 == 0 and mine["d_ff"] is None


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_every_param_and_cache_leaf_spec_equals_the_reference(name):
    for seq_shard_cache in (False, True):
        rules = default_rules(ARCHS[name], seq_shard_cache=seq_shard_cache)
        jrules = jax_default_rules(JAX_ARCHS[name], seq_shard_cache=seq_shard_cache)
        mine = _port_specs(schema_to_pspecs(build_schema(ARCHS[name]), rules))
        theirs = _jax_specs(jax_pspecs(jax_build_schema(JAX_ARCHS[name]), jrules))
        assert mine == theirs and len(mine) > 0
        cfg, jcfg = ARCHS[name], JAX_ARCHS[name]
        mine = _port_specs(schema_to_pspecs(cache_schema(cfg, 4, 64, enc_len=cfg.enc_len),
                                            rules))
        theirs = _jax_specs(jax_pspecs(jax_cache_schema(jcfg, 4, 64, enc_len=jcfg.enc_len),
                                       jrules))
        assert mine == theirs and len(mine) > 0


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("arch,shape", CELLS)
def test_plan_specs_equal_the_reference(arch, shape, multi_pod):
    ref = jplan.build_plan(arch, shape, multi_pod=multi_pod)
    plan = tplan.build_plan(arch, shape, multi_pod=multi_pod, device="cpu")
    assert plan.multi_pod is multi_pod
    assert plan.chips == ref.chips == (512 if multi_pod else 256)
    assert plan.model_flops == ref.model_flops
    assert plan.rules.rules == ref.rules.rules
    assert _port_specs(plan.in_specs) == _jax_specs(ref.in_specs)
    assert _port_specs(plan.out_specs) == _jax_specs(ref.out_specs)
    for field in ("enabled", "dp", "tp", "heads_sharded", "ff_sharded",
                  "seq_parallel_attn", "seq_parallel_residual", "remat_chunk_attn",
                  "moe_row_dispatch"):
        assert getattr(plan.ctx, field) == getattr(ref.ctx, field), field
    if ref.opt_cfg is not None:
        assert dataclasses.asdict(plan.opt_cfg) == dataclasses.asdict(ref.opt_cfg)


def test_one_card_plan_has_no_mesh():
    plan = tplan.build_plan("qwen2-1.5b", "decode_32k", device="cpu")
    assert plan.chips == 1 and plan.rules is None and plan.multi_pod is None
    assert plan.in_specs is None and plan.out_specs is None
    assert not plan.ctx.enabled


# -- meshes and placements -------------------------------------------------------

def test_spec_to_placements_in_mesh_order():
    with fake_world(8):
        mesh = make_mesh_from_shape((2, 2, 2), ("pod", "data", "model"), "cpu")
        assert spec_to_placements((("pod", "data"), None, "model"), mesh) == \
            (Shard(0), Shard(0), Shard(2))
        assert spec_to_placements((None, "data"), mesh) == \
            (Replicate(), Shard(1), Replicate())
        assert spec_to_placements((), mesh) == (Replicate(),) * 3
        # JAX makes the first axis of a tuple the major one; DTensor the
        # lower mesh dim, so only the mesh's own order can be expressed
        with pytest.raises(ValueError, match="major"):
            spec_to_placements((("data", "pod"),), mesh)
        with pytest.raises(ValueError, match="twice"):
            spec_to_placements(("data", "data"), mesh)
        # rank 0's shard of (("pod", "data"),): pod-major block 0 of 4
        assert local_shape_and_offset((8, 3), mesh, (Shard(0), Shard(0), Replicate())) \
            == ((2, 3), (0, 0))
        t = DTensor.from_local(torch.zeros(2, 3), mesh, (Shard(0), Shard(0), Replicate()),
                               run_check=False, shape=torch.Size((8, 3)), stride=(3, 1))
        assert t.shape == (8, 3) and t.to_local().shape == (2, 3)


def test_production_meshes_and_the_fake_world():
    for multi_pod, shape, axes in ((False, (16, 16), ("data", "model")),
                                   (True, (2, 16, 16), ("pod", "data", "model"))):
        with fake_world(math.prod(shape)):
            mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
            assert tuple(mesh.shape) == shape and mesh.mesh_dim_names == axes
            assert torch.distributed.get_world_size() == math.prod(shape)
            with pytest.raises(RuntimeError, match="already open"):
                with fake_world(2):
                    pass
        assert not torch.distributed.is_initialized()
    with pytest.raises(RuntimeError, match="process group"):
        make_production_mesh(device_type="cpu")


@pytest.mark.parametrize("n_devices,model", [(8, 2), (512, 16), (480, 16), (96, 16)])
def test_plan_elastic_mesh_feeds_make_mesh_from_shape(n_devices, model):
    shape = plan_elastic_mesh(n_devices, model=model)
    with fake_world(math.prod(shape)):
        mesh = make_mesh_from_shape(shape, ("pod", "data", "model"), "cpu")
        assert tuple(mesh.shape) == shape and shape[-1] == model
        assert mesh.size() <= n_devices


def test_act_is_a_no_op_off_the_mesh():
    x = torch.randn(2, 4, 8)
    ctx = ShardCtx(enabled=True)
    assert ctx.act(x, "data", None, "model") is x
    assert ctx.batch(x) is x and ctx.res(x) is x and ctx.gather(x) is x
    with fake_world(8):
        mesh = make_mesh_from_shape((4, 2), ("data", "model"), "cpu")
        with FakeTensorMode():
            d = DTensor.from_local(torch.empty(2, 4, 8), mesh, (Shard(0), Replicate()),
                                   run_check=False, shape=torch.Size((8, 4, 8)),
                                   stride=(32, 8, 1))
            assert NOSHARD.act(d, None, None, "model") is d
            assert ShardCtx(enabled=False).batch(d) is d
            assert ctx.batch(d) is d         # already (data, None, None)
            moved = ctx.act(d, "data", None, "model")
            assert moved.placements == (Shard(0), Shard(2))
            assert moved.to_local().shape == (2, 4, 4)


# -- the collective counter --------------------------------------------------------

def _dt(mesh, local_shape, placements, global_shape):
    strides, n = [], 1
    for size in reversed(global_shape):
        strides.append(n)
        n *= size
    return DTensor.from_local(torch.empty(local_shape), mesh, placements, run_check=False,
                              shape=torch.Size(global_shape), stride=tuple(reversed(strides)))


def _count(fn, *args):
    with CommDebugMode() as cdm:
        totals = cost.analyze(fn, *args)
    names = {op.__name__.split(".")[-1]: n for op, n in cdm.get_comm_counts().items()}
    return totals, names


def test_fsdp_gather_is_one_all_gather_of_the_local_shard():
    """W (64, 32) f32 sharded over data (4) on d_model: the gather at its
    point of use moves the 16 x 32 local shard."""
    with fake_world(8):
        mesh = make_mesh_from_shape((4, 2), ("data", "model"), "cpu")
        ctx = ShardCtx(enabled=True)
        with FakeTensorMode():
            w = _dt(mesh, (16, 32), (Shard(0), Replicate()), (64, 32))
        totals, cdm = _count(ctx.gather, w)
    assert totals.coll_counts == {"all-gather": 1.0}
    assert totals.coll_bytes_by_kind == {"all-gather": 16 * 32 * 4.0}
    assert totals.implicit_counts == {}
    assert cdm == {"all_gather_into_tensor": 1}
    assert totals.coll_bytes == 2048.0


def test_row_parallel_matmul_all_reduces_its_local_output():
    """x (8, 64) @ W (64, 32), both sharded over model (2) on the contracted
    dim: each device multiplies (8, 32) by (32, 32), a partial sum whose
    reduction moves the local (8, 32) output.  FLOPs are the local ones."""
    with fake_world(8):
        mesh = make_mesh_from_shape((4, 2), ("data", "model"), "cpu")
        with FakeTensorMode():
            x = _dt(mesh, (8, 32), (Replicate(), Shard(1)), (8, 64))
            w = _dt(mesh, (32, 32), (Replicate(), Shard(0)), (64, 32))

        def row_parallel(x, w):
            y = x @ w
            assert y.placements == (Replicate(), Partial())
            return redistribute(y, (Replicate(), Replicate()))

        totals, cdm = _count(row_parallel, x, w)
    assert totals.flops == 2 * 8 * 32 * 32
    assert totals.coll_counts == {"all-reduce": 1.0}
    assert totals.coll_bytes_by_kind == {"all-reduce": 8 * 32 * 4.0}
    assert totals.implicit_counts == {}
    assert cdm == {"all_reduce": 1}


def test_reduce_scatter_is_charged_its_full_input():
    with fake_world(8):
        mesh = make_mesh_from_shape((4, 2), ("data", "model"), "cpu")
        with FakeTensorMode():
            y = _dt(mesh, (8, 32), (Replicate(), Partial()), (8, 32))
        totals, cdm = _count(lambda t: redistribute(t, (Replicate(), Shard(0))), y)
    assert totals.coll_counts == {"reduce-scatter": 1.0}
    assert totals.coll_bytes_by_kind == {"reduce-scatter": 8 * 32 * 4.0}
    assert cdm == {"reduce_scatter_tensor": 1}


def test_shard_to_shard_is_one_all_to_all_of_the_local_shard():
    """Shard(0) -> Shard(1) over model (2): one all-to-all of the (4, 32)
    local shard, as on a card, though a CPU mesh's DTensor would gather
    the whole tensor instead."""
    with fake_world(8):
        mesh = make_mesh_from_shape((4, 2), ("data", "model"), "cpu")
        with FakeTensorMode():
            y = _dt(mesh, (4, 32), (Replicate(), Shard(0)), (8, 32))
        totals = cost.analyze(lambda t: redistribute(t, (Replicate(), Shard(1))), y)
    assert totals.coll_counts == {"all-to-all": 1.0}
    assert totals.coll_bytes_by_kind == {"all-to-all": 4 * 32 * 4.0}
    assert totals.memory["output_bytes"] == 8 * 16 * 4


def test_a_redistribution_nobody_asked_for_is_implicit():
    """A nonlinear op on a partial sum: DTensor reduces it on its own."""
    with fake_world(8):
        mesh = make_mesh_from_shape((4, 2), ("data", "model"), "cpu")
        with FakeTensorMode():
            y = _dt(mesh, (8, 32), (Replicate(), Partial()), (8, 32))
        totals, _ = _count(torch.exp, y)
    assert totals.coll_counts == {"all-reduce": 1.0}
    assert totals.implicit_counts == {"all-reduce": 1.0}
    assert totals.implicit_bytes_by_kind == {"all-reduce": 8 * 32 * 4.0}
    assert totals.flops == 0 and totals.bytes > 0


def test_local_flop_counter_counts_the_local_product():
    """``launch.cost.LocalFlopCounter`` on a real DTensor run counts each
    device's product, as the fake count does; plain FlopCounterMode counts
    the global one."""
    from torch.utils.flop_counter import FlopCounterMode

    with fake_world(8):
        mesh = make_mesh_from_shape((4, 2), ("data", "model"), "cpu")
        x = _dt(mesh, (8, 32), (Replicate(), Shard(1)), (8, 64))
        w = _dt(mesh, (32, 32), (Replicate(), Shard(0)), (64, 32))
        with cost.LocalFlopCounter() as local:
            x @ w
        with FlopCounterMode(display=False) as whole:
            x @ w
        with FakeTensorMode():
            fx = _dt(mesh, (8, 32), (Replicate(), Shard(1)), (8, 64))
            fw = _dt(mesh, (32, 32), (Replicate(), Shard(0)), (64, 32))
        counted = cost.analyze(lambda a, b: a @ b, fx, fw).flops
    assert local.get_total_flops() == counted == 2 * 8 * 32 * 32
    assert whole.get_total_flops() == 2 * 8 * 64 * 32


@pytest.mark.parametrize("owner,name", [
    ("placement_types", "shard_dim_alltoall"),
    ("_redistribute", "_gen_transform_infos_non_cached"),
    ("propagator", "propagate_op_sharding_non_cached"),
])
def test_count_raises_without_a_dtensor_internal_it_replaces(monkeypatch, owner, name):
    """Each DTensor internal the count replaces must exist: without one the
    count would go on unpatched, at DTensor's global shapes."""
    from torch.distributed.tensor import _redistribute, placement_types

    target = {"placement_types": placement_types, "_redistribute": _redistribute,
              "propagator": DTensor._op_dispatcher.sharding_propagator}[owner]
    monkeypatch.delattr(type(target) if owner == "propagator" else target, name)
    with fake_world(8):
        mesh = make_mesh_from_shape((4, 2), ("data", "model"), "cpu")
        with FakeTensorMode():
            y = _dt(mesh, (8, 32), (Replicate(), Partial()), (8, 32))
        with pytest.raises(RuntimeError, match="update launch.cost"):
            cost.analyze(torch.exp, y)


def test_collective_kinds():
    ops = torch.ops._c10d_functional
    assert cost.collective_kind(ops.all_gather_into_tensor.default) == "all-gather"
    assert cost.collective_kind(ops.all_reduce.default) == "all-reduce"
    assert cost.collective_kind(ops.reduce_scatter_tensor.default) == "reduce-scatter"
    assert cost.collective_kind(ops.all_to_all_single.default) == "all-to-all"
    assert cost.collective_kind(ops.wait_tensor.default) == ""
    assert cost.collective_kind(torch.ops.aten.mm.default) == ""


# -- the dry run on a mesh ---------------------------------------------------------

FAMILY_CELLS = [("yi-6b", "prefill_32k"), ("phi3.5-moe-42b-a6.6b", "decode_32k"),
                ("falcon-mamba-7b", "long_500k"), ("zamba2-1.2b", "prefill_32k"),
                ("whisper-large-v3", "decode_32k")]


@pytest.mark.parametrize("arch,shape", FAMILY_CELLS)
def test_reduced_cell_counts_on_the_multi_pod_mesh(monkeypatch, arch, shape):
    monkeypatch.setitem(ARCHS, arch, reduced(ARCHS[arch]))
    full = SHAPES[shape]
    monkeypatch.setitem(SHAPES, shape, dataclasses.replace(full, seq_len=256))
    rec = dryrun.run_cell(arch, shape, multi_pod=True, device="cpu")
    assert rec["status"] == "ok", rec
    assert rec["multi_pod"] is True and rec["mesh"] == "2x16x16"
    r = rec["roofline"]
    assert r["chips"] == 512 and r["flops_per_device"] > 0
    assert r["collective_bytes_per_device"] == sum(rec["collectives"]["bytes_by_kind"].values()) > 0
    assert r["collective_s"] > 0
    assert set(rec["collectives"]["counts"]) <= {
        "all-gather", "all-reduce", "reduce-scatter", "all-to-all", "collective-permute"}
    assert "2x16x16" in dryrun.summary(rec)
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "whisper-large-v3"])
def test_sequence_parallel_kernel_route_runs_the_kernel(monkeypatch, arch):
    """An optimized cell whose heads do not divide the model axis shards q's
    rows over it: the kernel route calls the flash operator on each shard's
    rows against every key (never the plain masked product), once per
    attention, and counts the FLOPs the plain route counts."""
    monkeypatch.setitem(ARCHS, arch, reduced(ARCHS[arch]))
    monkeypatch.setitem(SHAPES, "prefill_32k",
                        dataclasses.replace(SHAPES["prefill_32k"], seq_len=256))
    counted = {}
    for impl in ("kernel", "torch"):
        plan = tplan.build_plan(arch, "prefill_32k", multi_pod=False, optimized=True,
                                tuning_overrides={"attention_impl": impl}, device="cpu")
        assert plan.ctx.seq_parallel_attn and plan.ctx.heads is None
        with fake_world(plan.chips):
            mesh = make_production_mesh(device_type="cpu")
            with FakeTensorMode():
                args = plan.abstract_args(mesh=mesh)
            counted[impl] = cost.analyze_by_op(plan.step_fn, *args)
    cfg = plan.arch
    (kernel, by_op), (plain, plain_by_op) = counted["kernel"], counted["torch"]
    flops, _, calls = by_op["flash_attention"]
    assert "flash_attention" not in plain_by_op
    if not cfg.enc_len:
        # one causal self-attention a layer: 2 rows of the batch, 16 of
        # the 256 positions against every key
        assert calls == cfg.n_layers
        assert flops == cfg.n_layers * 4 * 2 * cfg.n_heads * 16 * 256 * cfg.hd
    else:
        assert calls >= cfg.n_layers and flops > 0
    assert kernel.flops == plain.flops
    assert kernel.coll_counts == plain.coll_counts


def test_cli_both_meshes_writes_a_record_per_mesh(monkeypatch, tmp_path, capsys):
    """``--both-meshes``: each cell on the 16x16 and the 2x16x16 mesh, the
    summary line naming the mesh, the records and the spans carrying it."""
    import json
    import sys

    monkeypatch.setitem(ARCHS, "zamba2-1.2b", reduced(ARCHS["zamba2-1.2b"]))
    monkeypatch.setitem(SHAPES, "decode_32k",
                        dataclasses.replace(SHAPES["decode_32k"], seq_len=256))
    out, trace = tmp_path / "rec.jsonl", tmp_path / "trace.jsonl"
    monkeypatch.setattr(sys, "argv", [
        "dryrun", "--arch", "zamba2-1.2b", "--shape", "decode_32k", "--device", "cpu",
        "--both-meshes", "--out", str(out), "--trace-out", str(trace)])
    dryrun.main()
    lines = [line for line in capsys.readouterr().out.splitlines() if line.startswith("[")]
    assert len(lines) == 2 and "x 16x16:" in lines[0] and "x 2x16x16:" in lines[1]
    recs = [json.loads(line) for line in out.read_text().splitlines()]
    assert [(r["multi_pod"], r["mesh"], r["roofline"]["chips"]) for r in recs] == \
        [(False, "16x16", 256), (True, "2x16x16", 512)]
    assert all(r["status"] == "ok" and r["collectives"]["bytes_by_kind"] for r in recs)
    cells = [json.loads(line) for line in trace.read_text().splitlines()
             if json.loads(line)["name"] == "dryrun.cell"]
    assert [c["attrs"]["mesh"] for c in cells] == ["16x16", "2x16x16"]
