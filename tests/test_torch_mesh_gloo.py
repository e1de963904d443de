"""The port's sharded steps on a real 4x2 ``("data", "model")`` mesh of 8 gloo
processes on the CPU, against the unsharded port (and, for one arch, the JAX
package), the counterpart of tests/test_sharding.py's
``test_mini_multidevice_dryrun_all_families`` on the same five reduced archs.

One spawn runs everything (the module-scoped ``run`` fixture): 8 gloo
processes and, beside them, one that counts the same steps in a fake world,
one torch thread each.  Per arch, on the same weights (the port's seeded init, attention
rescaled to its contracted width) and the same numpy batch (B 8, S 16):
  * the loss and every gradient leaf of ``loss_fn`` (plain attention and
    SSD, as training runs) on the train step's first micro-batch (the
    first half of each data shard's rows);
  * one ``make_train_step`` (2 micro-batches, remat): updated parameters,
    moments and metrics, against the unsharded step on the batch's rows
    reordered so that its micro-batches hold the same rows (the sharded
    step's micro-batch is a slice of each data shard's rows);
  * a prefill step and a decode step through the kernel route (the kernels'
    plain versions on CPU shards, through their DTensor strategies): last
    logits and every cache leaf;
each after ``full_tensor()`` within float32 1e-5 of the leaf's magnitude
(floored at 1e-2 of the tree's largest entry), the tolerance of
tests/test_torch_train.py.  With capacity factor 4 the reduced MoE drops no
token and the routing is compared flip for flip.

Also: a GQA config whose q heads shard while its kv heads do not (6 q heads,
3 kv heads, a model axis of 2), held to the unsharded port, and the kernel
called on the unsliced local kv heads, which must disagree (the slicing in
``models.model._attend`` is what makes it right); a config whose heads do not
divide the model axis (3 q heads, 1 kv head) with sequence-parallel attention,
its rows sharded over the model axis, held to the unsharded port, and the
kernel called without each shard's row offset, which must disagree; every
rank's collectives (``launch.cost.CollectiveMeter``: calls and operand bytes
by kind) equal to ``launch.cost``'s count of the same steps in a fake 8-rank
world, and ``CommDebugMode``'s calls by operator, named here, equal to that
count with each all-to-all run as the one all-gather a CPU mesh runs for it;
the sharded fleet (``plan_many`` with the app axis over the 8 ranks) against
the sequential plan of the port and of the JAX package, with no tolerance.

The fixture runs ``python tests/test_torch_mesh_gloo.py OUT_DIR WEIGHTS``
(``WEIGHTS``: the JAX package's reduced yi-6b init as an ``.npz``, and
``OUT_DIR/fleet_problems.pkl``, both written by the fixture).
"""
import dataclasses
import datetime
import json
import math
import os
import pickle
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

# imported by the spawned workers too: the modules that need JAX (the JAX
# package, the planner tests' helpers) are imported inside the functions
# that run in the pytest process

HERE = Path(__file__).resolve().parent
SRC = HERE.parent / "src"
ARCHS_UNDER_TEST = ("yi-6b", "phi3.5-moe-42b-a6.6b", "falcon-mamba-7b",
                    "zamba2-1.2b", "whisper-large-v3")
GQA = "gqa-6q-3kv"
SEQPAR = "seqpar-3q-1kv"
WORLD, MESH, AXES = 8, (4, 2), ("data", "model")
B, S, MAX_LEN = 8, 16, 32
F32 = 1e-5
JAX_ARCH = "yi-6b"
# micro-batch i of 2 on the data axis: the i-th half of each shard's rows
MICRO_ROWS = tuple(r * (B // MESH[0]) + i * (B // MESH[0] // 2) + j
                   for i in range(2) for r in range(MESH[0])
                   for j in range(B // MESH[0] // 2))
MB0_ROWS = MICRO_ROWS[:B // 2]
FLEET_APPS = 4
CASES = ARCHS_UNDER_TEST + (GQA, SEQPAR)


# -- the workers (run in the spawned processes) -------------------------------

def _cfg(name):
    from repro_torch.configs.registry import ARCHS
    from repro_torch.models.testing import reduced

    if name == GQA:
        return dataclasses.replace(reduced(ARCHS["yi-6b"]), n_heads=6, n_kv_heads=3)
    if name == SEQPAR:
        return dataclasses.replace(reduced(ARCHS["yi-6b"]), n_heads=3, n_kv_heads=1,
                                   head_dim=16)
    return reduced(ARCHS[name])


def _weights(name, cfg, jax_weights):
    from repro_torch.launch.train import rescale_attention
    from repro_torch.models.convert import params_from_numpy
    from repro_torch.models.schema import build_schema
    from repro_torch.models.sharding import init_from_schema

    if name == JAX_ARCH and jax_weights is not None:
        return params_from_numpy(dict(np.load(jax_weights, allow_pickle=True))["p"].item(), "cpu")
    params = init_from_schema(0, build_schema(cfg), torch.float32, "cpu")
    rescale_attention(params)
    return params


def _batch(cfg, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, size=(B, S + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.enc_len:
        batch["enc_embeds"] = rng.standard_normal((B, cfg.enc_len, cfg.d_model),
                                                  dtype=np.float32)
    return batch


def _contexts(cfg, rules):
    from repro_torch.models.ops import ShardCtx

    shard = dict(enabled=True, dp=("data",), tp="model",
                 heads_sharded=rules.rules.get("heads_q") is not None,
                 ff_sharded=rules.rules.get("d_ff") is not None,
                 seq_parallel_attn=cfg.n_heads % MESH[1] != 0)
    return (ShardCtx("torch", "torch", **shard), ShardCtx("kernel", "kernel", **shard))


def _sharded_inputs(name, mesh, jax_weights):
    """Everything both the gloo ranks and the fake count need for one arch:
    (cfg, rules, unsharded params/batch, DTensor params/batch, contexts)."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.models.schema import build_schema
    from repro_torch.models.sharding import default_rules, distribute_params, schema_to_pspecs

    cfg = _cfg(name)
    rules = default_rules(cfg, model_size=MESH[1], fsdp_total=MESH[0],
                          batch_axes=("data",))
    params = _weights(name, cfg, jax_weights)
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg).items()}
    specs = schema_to_pspecs(build_schema(cfg), rules)
    dparams = distribute_params(params, specs, mesh)
    dbatch = {k: distribute_tensor(v, mesh, [Shard(0), Replicate()])
              for k, v in batch.items()}
    return cfg, rules, params, batch, dparams, dbatch, _contexts(cfg, rules)


def _steps(cfg, ctx_train, ctx_serve):
    from repro_torch.models.config import CellTuning
    from repro_torch.optim import adamw
    from repro_torch.train import steps

    tuning = CellTuning(num_microbatches=2, remat=True, compute_dtype="float32",
                        param_dtype="float32", accum_dtype="float32")
    opt_cfg = adamw.OptimizerConfig(eps=1e-3)
    return (tuning, opt_cfg, steps.make_train_step(cfg, opt_cfg, tuning, ctx_train),
            steps.make_prefill_step(cfg, ctx_serve), steps.make_serve_step(cfg, ctx_serve))


def _decode_cache(cfg, prefill_cache):
    """A zero cache of MAX_LEN positions holding the prefill's S."""
    from repro_torch.models.model import SEQ_KEYS, cache_schema
    from repro_torch.models.sharding import init_from_schema

    cache = init_from_schema(0, cache_schema(cfg, B, MAX_LEN, enc_len=cfg.enc_len),
                             torch.float32, "cpu")
    for key, val in prefill_cache.items():
        if key == "pos":
            cache[key] = val.clone()
        elif key in SEQ_KEYS:
            cache[key][:, :, :S] = val
        else:
            cache[key].copy_(val)
    return cache


def _full(tree):
    from torch.distributed.tensor import DTensor

    if isinstance(tree, dict):
        return {k: _full(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(*[_full(v) for v in tree]) if hasattr(tree, "_fields") \
            else type(tree)(_full(v) for v in tree)
    return tree.full_tensor() if isinstance(tree, DTensor) else tree


def _errors(mine, ref):
    """Per leaf: max |mine - ref| over the leaf's magnitude, floored at 1e-2
    of the tree's largest entry."""
    from repro_torch.tree import leaves

    a = [t.detach().double() for t in leaves(mine)]
    b = [t.detach().double() for t in leaves(ref)]
    assert len(a) == len(b), (len(a), len(b))
    top = max(float(t.abs().max()) if t.numel() else 0.0 for t in b)
    return [float((x - y).abs().max()) / max(float(y.abs().max()), 1e-2 * top, 1e-30)
            if y.numel() else 0.0 for x, y in zip(a, b)]


# CommDebugMode's operators by HLO kind, named here apart from launch.cost
_CDM_KINDS = {"all_gather_into_tensor": "all-gather", "all_reduce": "all-reduce",
              "reduce_scatter_tensor": "reduce-scatter", "all_to_all_single": "all-to-all"}


def _measured(fn, *args):
    """Run ``fn`` under ``launch.cost.CollectiveMeter`` (calls and operand
    bytes by kind, the count's rules) and ``CommDebugMode`` (the calls the
    mesh ran, by operator)."""
    from torch.distributed.tensor.debug import CommDebugMode

    from repro_torch.launch.cost import CollectiveMeter

    with CommDebugMode() as cdm, CollectiveMeter() as meter:
        out = fn(*args)
    ran = {}
    for op, n in cdm.get_comm_counts().items():
        kind = _CDM_KINDS[op.__name__.split(".")[-1]]
        ran[kind] = ran.get(kind, 0) + n
    return out, {"counts": meter.counts, "bytes": meter.bytes, "ran": ran}


def _arch_case(name, mesh, rank, jax_weights, out_dir):
    from repro_torch.optim import adamw
    from repro_torch.train import steps

    cfg, rules, params, batch, dparams, dbatch, (ctx_t, ctx_s) = \
        _sharded_inputs(name, mesh, jax_weights)
    tuning, opt_cfg, train, prefill, serve = _steps(cfg, ctx_t, ctx_s)
    res = {}

    # gradients of the loss
    def grads_of(p, b, ctx):
        from repro_torch.tree import leaves, unflatten

        flat = leaves(p)
        req = [x.detach().requires_grad_() for x in flat]
        loss, metrics = steps.loss_fn(unflatten(p, req), cfg, b, ctx, tuning)
        return metrics, unflatten(p, list(torch.autograd.grad(loss, req)))

    from repro_torch.launch.mesh import plain_tensors_replicated

    # the gradients of the train step's first micro-batch: each rank's first
    # half of its local rows (global rows MB0_ROWS)
    with plain_tensors_replicated():
        mb0 = {k: steps._micro_batch(v, 0, 2) for k, v in dbatch.items()}
        smetrics, sgrads = grads_of(dparams, mb0, ctx_t)
    sgrads, smetrics = _full(sgrads), _full(smetrics)
    # the train step
    opt = adamw.init(opt_cfg, params)
    from repro_torch.launch.plan import _opt_specs  # the plan's optimizer specs
    from repro_torch.models.schema import build_schema
    from repro_torch.models.sharding import distribute_params, schema_to_pspecs

    specs = schema_to_pspecs(build_schema(cfg), rules)
    ospecs = _opt_specs(specs, opt_cfg)
    dopt = adamw.OptState(
        step=distribute_params(opt.step, (), mesh),
        mu=distribute_params(opt.mu, ospecs.mu, mesh),
        nu=distribute_params(opt.nu, ospecs.nu, mesh),
        error=distribute_params(opt.error, ospecs.error, mesh))
    (sp, sopt, sm), train_comm = _measured(train, dparams, dopt, dbatch)
    sp, sopt, sm = _full(sp), _full(sopt), _full(sm)
    # serving: prefill, then one decode step
    serve_batch = {k: v for k, v in dbatch.items() if k != "labels"}
    (slog, scache), prefill_comm = _measured(prefill, dparams, serve_batch)
    slog, scache = _full(slog), _full(scache)
    from repro_torch.launch.plan import _place
    from repro_torch.models.model import cache_schema

    cache_specs = schema_to_pspecs(cache_schema(cfg, B, MAX_LEN, enc_len=cfg.enc_len), rules)
    dcache = _place(distribute_params(_decode_cache(cfg, scache), cache_specs, mesh),
                    cache_specs)
    step_tokens = torch.from_numpy(
        np.random.default_rng(1).integers(0, cfg.vocab, (B, 1)).astype(np.int32))
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    dtok = distribute_tensor(step_tokens, mesh, [Shard(0), Replicate()])
    (sdlog, sdcache), decode_comm = _measured(serve, dparams, dcache, dtok)
    sdlog, sdcache = _full(sdlog), _full(sdcache)
    res["comm"] = {"train": train_comm, "prefill": prefill_comm, "decode": decode_comm}

    if rank == 0:
        umetrics, ugrads = grads_of(params, {k: v[list(MB0_ROWS)] for k, v in batch.items()},
                                    steps.TRAIN_CTX)
        # the unsharded step's contiguous micro-batches hold the rows of the
        # sharded step's (each rank's slice of its local rows): the same
        # tokens in each, as the MoE aux losses are not sums over tokens
        up, uopt, um = train(params, adamw.init(opt_cfg, params),
                             {k: v[list(MICRO_ROWS)] for k, v in batch.items()})
        plain_serve = {k: v for k, v in batch.items() if k != "labels"}
        ulog, ucache = steps.make_prefill_step(cfg)(params, plain_serve)
        udlog, udcache = steps.make_serve_step(cfg)(params, _decode_cache(cfg, ucache),
                                                    step_tokens)
        res["loss"] = _errors([smetrics["loss"]], [umetrics["loss"]])[0]
        res["grads"] = max(_errors(sgrads, ugrads))
        res["params"] = max(_errors(sp, up))
        res["moments"] = max(_errors([sopt.mu, sopt.nu], [uopt.mu, uopt.nu]))
        res["step_equal"] = int(sopt.step) == int(uopt.step)
        res["metrics"] = max(_errors([sm[k] for k in sorted(um)], [um[k] for k in sorted(um)]))
        res["prefill_logits"] = max(_errors([slog], [ulog]))
        res["prefill_cache"] = max(_errors({k: v for k, v in scache.items() if k != "pos"},
                                           {k: v for k, v in ucache.items() if k != "pos"}))
        res["decode_logits"] = max(_errors([sdlog], [udlog]))
        res["decode_cache"] = max(_errors({k: v for k, v in sdcache.items() if k != "pos"},
                                          {k: v for k, v in udcache.items() if k != "pos"}))
        if cfg.moe is not None:
            res["routing_flips"] = _routing_flips(cfg, sp, up)
        if name == JAX_ARCH:
            np.savez(os.path.join(out_dir, "sharded_yi.npz"),
                     loss=smetrics["loss"].detach().numpy(),
                     **{f"g{i}": g.numpy() for i, g in enumerate(_leaves(sgrads))},
                     logits=slog.numpy())
    if name == GQA:
        # a sharded step: every rank runs it
        res["unsliced_kernel_err"] = _unsliced_error(cfg, dparams, serve_batch, ctx_s, slog)
    if name == SEQPAR:
        res["unshifted_kernel_err"] = _unshifted_error(cfg, dparams, serve_batch, ctx_s, slog)
    return res


def _leaves(tree):
    from repro_torch.tree import leaves

    return [t.detach() for t in leaves(tree)]


def _routing_flips(cfg, sp, up):
    """Top-k expert choices of the first MoE layer that differ between the
    sharded and the unsharded updated routers on the test batch (the
    comparison above holds only where routing agrees)."""
    x = torch.randn(B * S, cfg.d_model, generator=torch.Generator().manual_seed(2))
    pick = [torch.sort(torch.softmax(x @ p["layers"]["moe"]["router"][0], -1),
                       descending=True, stable=True).indices[:, :cfg.moe.top_k]
            for p in (sp, up)]
    return int((pick[0] != pick[1]).any(-1).sum())


def _unsliced_error(cfg, dparams, batch, ctx, good_logits):
    """The GQA prefill with ``_attend``'s slicing switched off: each shard's
    kernel pairs local q head h with local kv head h // G of ALL kv heads."""
    from repro_torch.models import model as tm
    from repro_torch.train import steps

    orig = tm._attend

    def unsliced(q, k, v, causal, ctx_, scale=None):
        from torch.distributed.tensor import DTensor
        from torch.distributed.tensor.experimental import local_map

        mesh = q.device_mesh
        return local_map(lambda a, b, c: tm._attention_core(a, b, c, causal, ctx_, scale),
                         out_placements=(q.placements,),
                         in_placements=(q.placements, k.placements, v.placements),
                         device_mesh=mesh)(q, k, v) if isinstance(q, DTensor) \
            else orig(q, k, v, causal, ctx_, scale)

    tm._attend = unsliced
    try:
        bad, _ = steps.make_prefill_step(cfg, ctx)(dparams, batch)
    finally:
        tm._attend = orig
    bad = _full(bad)
    return max(_errors([bad], [good_logits]))


def _unshifted_error(cfg, dparams, batch, ctx, good_logits):
    """The sequence-parallel prefill with every shard's kernel call given
    row offset 0: each shard's causal mask then starts at its own first
    row, as if its rows were the sequence's first."""
    from repro_torch.kernels import ops
    from repro_torch.train import steps

    orig = ops.flash_attention

    def unshifted(q, k, v, *, causal=True, q_offset=0, scale=None):
        return orig(q, k, v, causal=causal, scale=scale)

    ops.flash_attention = unshifted
    try:
        bad, _ = steps.make_prefill_step(cfg, ctx)(dparams, batch)
    finally:
        ops.flash_attention = orig
    return max(_errors([_full(bad)], [good_logits]))


def _pod_major_rows():
    """This rank's rows of an (8, 3) tensor sharded on dim 0 over
    ("pod", "data") of a 2x2x2 mesh, and the rows JAX gives the device at
    this rank's coordinate (block pod * 2 + data of 4)."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.launch.mesh import make_mesh_from_shape, spec_to_placements

    mesh = make_mesh_from_shape((2, 2, 2), ("pod", "data", "model"), "cpu")
    full = torch.arange(24.0).reshape(8, 3)
    local = distribute_tensor(full, mesh, spec_to_placements((("pod", "data"), None), mesh))
    pod, data, _ = mesh.get_coordinate()
    block = pod * 2 + data
    return local.to_local().tolist(), full[2 * block:2 * block + 2].tolist()


def _fleet_case(out_dir):
    """plan_many over this world, the app axis split over the 8 ranks."""
    import pickle

    from repro_torch.core.scheduler import GreenScheduler, SchedulerConfig
    from repro_torch.fleet import FleetProblem, plan_many

    with open(os.path.join(out_dir, "fleet_problems.pkl"), "rb") as fh:
        probs, names = pickle.load(fh)
    res = plan_many(FleetProblem(apps=tuple(probs), names=names),
                    GreenScheduler(SchedulerConfig(emission_weight=0.25), device="cpu"))
    return {"sharded": bool(res.stats.sharded), "devices": res.stats.devices,
            "plans": [_plan_summary(r.plans[0]) for r in res.results],
            "emissions_g": [float(e) for e in res.emissions_g]}


def _plan_summary(plan):
    return {"feasible": bool(plan.feasible), "notes": list(plan.notes),
            "placements": [str(pl) for pl in plan.placements],
            "skipped": sorted(str(x) for x in plan.skipped_services),
            "total_emissions_g": float(plan.total_emissions_g)}


def _worker(rank, port, out_dir, jax_weights):
    torch.set_num_threads(1)
    sys.path.insert(0, str(SRC))
    if rank == WORLD:
        # the launch.cost count of the same steps, beside the gloo world
        with open(os.path.join(out_dir, "fake.json"), "w") as fh:
            json.dump(_fake_counts(jax_weights), fh)
        return
    import torch.distributed as dist

    # a rank that fails leaves the others waiting: give up within minutes
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=WORLD,
                            timeout=datetime.timedelta(seconds=300))
    try:
        from repro_torch.launch.mesh import make_mesh_from_shape

        mesh = make_mesh_from_shape(MESH, AXES, "cpu")
        out = {name: _arch_case(name, mesh, rank, jax_weights, out_dir) for name in CASES}
        mine = {"comm": {n: r["comm"] for n, r in out.items()},
                "pod_major": _pod_major_rows(), "fleet": _fleet_case(out_dir)}
        gathered = [None] * WORLD
        dist.all_gather_object(gathered, mine)
        if rank == 0:
            for name in out:
                out[name]["comm_by_rank"] = [g["comm"][name] for g in gathered]
            out["pod_major_by_rank"] = [g["pod_major"] for g in gathered]
            out["fleet_by_rank"] = [g["fleet"] for g in gathered]
            with open(os.path.join(out_dir, "gloo.json"), "w") as fh:
                json.dump(out, fh)
    finally:
        dist.destroy_process_group()


def _fake_counts(jax_weights):
    """launch.cost's count of the same steps in a fake 8-rank world."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.launch import cost
    from repro_torch.launch.mesh import fake_world, make_mesh_from_shape
    from repro_torch.launch.plan import _opt_specs, _place
    from repro_torch.models.model import cache_schema
    from repro_torch.models.schema import build_schema
    from repro_torch.models.sharding import distribute_params, init_from_schema, schema_to_pspecs
    from repro_torch.optim import adamw

    out = {}
    with fake_world(WORLD):
        mesh = make_mesh_from_shape(MESH, AXES, "cpu")
        for name in CASES:
            with FakeTensorMode():
                cfg, rules, params, batch, dparams, dbatch, (ctx_t, ctx_s) = \
                    _sharded_inputs(name, mesh, None)
                specs = schema_to_pspecs(build_schema(cfg), rules)
                _, opt_cfg, train, prefill, serve = _steps(cfg, ctx_t, ctx_s)
                opt = adamw.init(opt_cfg, params)
                ospecs = _opt_specs(specs, opt_cfg)
                dopt = adamw.OptState(
                    step=distribute_params(opt.step, (), mesh),
                    mu=distribute_params(opt.mu, ospecs.mu, mesh),
                    nu=distribute_params(opt.nu, ospecs.nu, mesh),
                    error=distribute_params(opt.error, ospecs.error, mesh))
                cspecs = schema_to_pspecs(cache_schema(cfg, B, MAX_LEN, enc_len=cfg.enc_len),
                                          rules)
                cache = distribute_params(init_from_schema(
                    0, cache_schema(cfg, B, MAX_LEN, enc_len=cfg.enc_len),
                    torch.float32, "cpu"), cspecs, mesh)
                cache = _place(cache, cspecs)
                tok = distribute_tensor(torch.zeros((B, 1), dtype=torch.int32), mesh,
                                        [Shard(0), Replicate()])
                serve_batch = {k: v for k, v in dbatch.items() if k != "labels"}
            counts = {}
            for label, fn, args in (("train", train, (dparams, dopt, dbatch)),
                                    ("prefill", prefill, (dparams, serve_batch)),
                                    ("decode", serve, (dparams, cache, tok))):
                totals = cost.analyze(fn, *args)
                counts[label] = {"counts": {k: int(v) for k, v in totals.coll_counts.items()},
                                 "bytes": {k: int(v) for k, v in totals.coll_bytes_by_kind.items()}}
            out[name] = counts
    return out


def _launch(out_dir, jax_weights):
    import torch.multiprocessing as mp

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    # ranks 0..WORLD-1 form the gloo world; process WORLD counts on fakes
    mp.start_processes(_worker, args=(port, out_dir, jax_weights), nprocs=WORLD + 1,
                       join=True, start_method="spawn")


# -- the tests ----------------------------------------------------------------

@pytest.fixture(scope="module")
def run(tmp_path_factory):
    import jax.numpy as jnp

    from repro.configs.registry import ARCHS as JAX_ARCHS
    from repro.models.schema import build_schema as jax_build_schema
    from repro.models.sharding import init_from_schema as jax_init
    from repro.models.testing import reduced as jax_reduced

    import jax

    from test_torch_planner import to_port

    out = tmp_path_factory.mktemp("gloo")
    probs, names = _jax_fleet()
    with open(out / "fleet_problems.pkl", "wb") as fh:
        pickle.dump((to_port(list(probs)), names), fh)
    jcfg = jax_reduced(JAX_ARCHS[JAX_ARCH])
    npp = jax.tree.map(np.asarray, jax_init(jax.random.PRNGKey(0),
                                            jax_build_schema(jcfg), jnp.float32))
    _rescale_numpy(npp)
    weights = out / "jax_weights.npz"
    np.savez(weights, p=np.array(npp, dtype=object))
    env = {**os.environ, "PYTHONPATH": f"{SRC}{os.pathsep}{os.environ.get('PYTHONPATH', '')}",
           "OMP_NUM_THREADS": "1"}
    proc = subprocess.run([sys.executable, __file__, str(out), str(weights)],
                          capture_output=True, text=True, timeout=600, env=env)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with open(out / "gloo.json") as fh:
        gloo = json.load(fh)
    with open(out / "fake.json") as fh:
        fake = json.load(fh)
    return {"gloo": gloo, "fake": fake, "dir": out, "jax": (jcfg, npp)}


def _jax_fleet():
    """test_fleet.py's 4 dyadic apps on one shared infrastructure."""
    import jax
    import jax.experimental

    from test_fleet import _fleet_problems

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.experimental, "enable_x64", lambda: jax.enable_x64(True),
                   raising=False)
        return _fleet_problems(FLEET_APPS)


def _rescale_numpy(npp):
    for group in ("layers", "shared", "enc_layers"):
        for blk in ("attn", "cross"):
            attn = npp.get(group, {}).get(blk)
            if attn is None:
                continue
            d, H, hd = attn["wq"].shape[-3:]
            KV = attn["wk"].shape[-2]
            attn["wq"] = attn["wq"] * math.sqrt(H / d)
            attn["wk"] = attn["wk"] * math.sqrt(KV / d)
            attn["wv"] = attn["wv"] * math.sqrt(KV / d)
            attn["wo"] = attn["wo"] * math.sqrt(1.0 / H)


QUANTITIES = ("loss", "grads", "params", "moments", "metrics", "prefill_logits",
              "prefill_cache", "decode_logits", "decode_cache")


@pytest.mark.parametrize("quantity", QUANTITIES)
@pytest.mark.parametrize("name", CASES)
def test_sharded_equals_unsharded(run, name, quantity):
    res = run["gloo"][name]
    assert res[quantity] <= F32, (name, quantity, res[quantity])
    assert res["step_equal"]
    if "routing_flips" in res:
        assert res["routing_flips"] == 0


def test_gqa_needs_its_kv_slicing(run):
    """The kernel on the unsliced local kv heads pairs q heads with the
    wrong kv heads: the check above would fail without the slicing."""
    assert run["gloo"][GQA]["unsliced_kernel_err"] > 1e-2


def test_sequence_parallel_kernel_needs_its_row_offset(run):
    """The kernel on each shard's rows with its causal mask starting at 0
    (no ``q_offset``) disagrees: the check above would fail without the
    offset."""
    assert run["gloo"][SEQPAR]["unshifted_kernel_err"] > 1e-2


@pytest.mark.parametrize("step", ("train", "prefill", "decode"))
@pytest.mark.parametrize("name", CASES)
def test_every_rank_collectives_equal_the_fake_count(run, name, step):
    fake = run["fake"][name][step]
    assert fake["counts"], "a sharded step moves something"
    # what the CPU mesh ran: an all-gather for each all-to-all
    ran = dict(fake["counts"])
    if "all-to-all" in ran:
        ran["all-gather"] = ran.get("all-gather", 0) + ran.pop("all-to-all")
    for rank, comm in enumerate(run["gloo"][name]["comm_by_rank"]):
        assert comm[step]["counts"] == fake["counts"], (rank, comm[step], fake)
        assert comm[step]["bytes"] == fake["bytes"], (rank, comm[step], fake)
        assert comm[step]["ran"] == ran, (rank, comm[step], fake)


def test_pod_axis_is_the_major_one(run):
    """DTensor's split of one dim over ("pod", "data") gives every rank of
    a 2x2x2 mesh the rows JAX gives the device at its coordinate."""
    for rank, (got, want) in enumerate(run["gloo"]["pod_major_by_rank"]):
        assert got == want, rank


@pytest.fixture
def x64(monkeypatch):
    """The JAX planner's ``enable_x64`` import, aliased as the planner tests
    alias it (tests/test_torch_planner.py)."""
    import jax
    import jax.experimental

    monkeypatch.setattr(jax.experimental, "enable_x64",
                        lambda: jax.enable_x64(True), raising=False)


def test_sharded_fleet_equals_the_sequential_plans(run, x64):
    """The counterpart of tests/test_fleet.py's
    ``test_sharded_fleet_matches_sequential_subprocess``: plan_many with the
    app axis over the 8 gloo ranks against the port's and the JAX package's
    sequential plans, with no tolerance, on every rank."""
    from repro.core.scheduler import GreenScheduler as JScheduler
    from repro.core.scheduler import SchedulerConfig as JConfig
    from repro_torch.core.scheduler import GreenScheduler, SchedulerConfig
    from test_torch_planner import to_port

    probs, _ = _jax_fleet()
    jseq = [JScheduler(JConfig(emission_weight=0.25)).plan(p) for p in probs]
    tseq = [GreenScheduler(SchedulerConfig(emission_weight=0.25), device="cpu").plan(p)
            for p in to_port(list(probs))]
    for rank, got in enumerate(run["gloo"]["fleet_by_rank"]):
        assert got["sharded"] is True and got["devices"] == WORLD, rank
        for i, (plan, j, t) in enumerate(zip(got["plans"], jseq, tseq)):
            assert plan == _plan_summary(t.plans[0]) == _plan_summary(j.plans[0]), (rank, i)
            if plan["feasible"]:
                assert got["emissions_g"][i] == float(t.emissions_g[0]) \
                    == float(j.emissions_g[0]), (rank, i)


def test_one_arch_equals_the_jax_package(run):
    """yi-6b's sharded loss and gradients (the first micro-batch) and
    prefill logits (the whole batch) against the JAX package's unsharded
    step on the same weights and rows."""
    import jax
    import jax.numpy as jnp

    from repro.models import model as jmodel
    from repro.models.config import CellTuning as JaxTuning
    from repro.train import steps as jsteps

    jcfg, npp = run["jax"]
    cfg = _cfg(JAX_ARCH)
    batch = {k: v[list(MB0_ROWS)] for k, v in _batch(cfg).items()}
    tuning = JaxTuning(compute_dtype="float32", param_dtype="float32")
    (loss, _), grads = jax.value_and_grad(
        lambda p: jsteps.loss_fn(p, jcfg, {k: jnp.asarray(v) for k, v in batch.items()},
                                 jsteps.ShardCtx(enabled=False), tuning),
        has_aux=True)(jax.tree.map(jnp.asarray, npp))
    logits, _, _ = jmodel.forward(jax.tree.map(jnp.asarray, npp), jcfg,
                                  {"tokens": jnp.asarray(_batch(cfg)["tokens"])},
                                  mode=jmodel.PREFILL, compute_dtype=jnp.float32)
    got = np.load(run["dir"] / "sharded_yi.npz")
    assert abs(float(got["loss"]) - float(loss)) <= F32 * abs(float(loss))
    ref = [np.asarray(g, np.float64) for g in jax.tree.leaves(grads)]
    top = max(float(np.abs(g).max()) for g in ref)
    for i, g in enumerate(ref):
        scale = max(float(np.abs(g).max()), 1e-2 * top)
        assert float(np.abs(got[f"g{i}"] - g).max()) <= F32 * scale, i
    last = np.asarray(logits[:, -1], np.float64)
    assert float(np.abs(got["logits"] - last).max()) <= F32 * float(np.abs(last).max())


if __name__ == "__main__":
    sys.path.insert(0, str(SRC))
    _launch(sys.argv[1], sys.argv[2])
