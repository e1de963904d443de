"""Training driver, on the card by default.

Without ``--full`` it trains the REDUCED twin of the architecture; with it,
the full config (qwen2-1.5b: 1.54 B parameters in float32 with remat, one
H100).

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b \\
      --steps 200 --seq-len 128 --batch 8 --ckpt-dir /tmp/ckpt
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu --steps 20
  PYTHONPATH=src python -m repro_torch.launch.train --full --steps 6 \\
      --seq-len 512 --batch 8

``--device cpu`` runs on the CPU; without a card and without that flag it
raises.  The weights are random, seeded by ``--seed``; at full width each
attention block's projections are rescaled to their contracted width (the
reference init scales them by the head count, which saturates the softmax
at full width).  There is no ``--attention-impl``: the JAX driver's flag
of that name goes into a ``CellTuning`` that its train step never reads
(the step's attention always runs in XLA), and the port's step likewise
always runs the plain paths (``train.steps.TRAIN_CTX``): the hand-written
kernels have no backward.

Fault tolerance is on by default: atomic checkpoints every
``--ckpt-every`` steps, restart-deterministic data, resume from the latest
complete checkpoint.
"""
from __future__ import annotations

import argparse
import math
import time
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.registry import ARCHS, get_arch
from repro_torch.data.pipeline import DataConfig, batch_for_step
from repro_torch.ft.manager import RestartManager, StragglerDetector
from repro_torch.models.config import CellTuning
from repro_torch.models.schema import build_schema
from repro_torch.models.sharding import init_from_schema
from repro_torch.models.testing import reduced
from repro_torch.optim import adamw
from repro_torch.train.steps import make_train_step


def build(arch: str, *, full: bool, seq_len: int, batch: int,
          lr: float, microbatches: int):
    cfg = get_arch(arch)
    if not full:
        cfg = reduced(cfg)
    tuning = CellTuning(num_microbatches=microbatches, remat=True,
                        compute_dtype="float32")
    opt_cfg = adamw.OptimizerConfig(lr=lr, warmup_steps=20, decay_steps=2000)
    step_fn = make_train_step(cfg, opt_cfg, tuning)
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=seq_len, global_batch=batch,
                      enc_len=cfg.enc_len, d_model=cfg.d_model)
    return cfg, opt_cfg, step_fn, dcfg


def rescale_attention(params: Dict) -> None:
    """Scale every attention block's projections (stacked layers', zamba2's
    shared block, whisper's encoder and cross blocks), in place, from the
    reference init's 1/sqrt(shape[-2]) to 1/sqrt(contracted width)."""
    for group in ("layers", "shared", "enc_layers"):
        for blk in ("attn", "cross"):
            attn = params.get(group, {}).get(blk)
            if attn is None:
                continue
            d, H, hd = attn["wq"].shape[-3:]
            KV = attn["wk"].shape[-2]
            attn["wq"].mul_(math.sqrt(H / d))
            attn["wk"].mul_(math.sqrt(KV / d))
            attn["wv"].mul_(math.sqrt(KV / d))
            attn["wo"].mul_(math.sqrt(1.0 / H))


def to_device(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


def main(argv: Optional[list] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=sorted(ARCHS), default="qwen2-1.5b")
    ap.add_argument("--full", action="store_true",
                    help="full config; default is the reduced twin")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--microbatches", type=int, default=2)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", choices=("cuda", "cpu"), default=None)
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg, opt_cfg, step_fn, dcfg = build(
        args.arch, full=args.full, seq_len=args.seq_len, batch=args.batch,
        lr=args.lr, microbatches=args.microbatches,
    )
    n_params = cfg.param_count()
    where = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"arch={cfg.name} family={cfg.family.value} params~{n_params/1e6:.1f}M "
          f"seq={args.seq_len} batch={args.batch} device={where}", flush=True)

    def init_fn():
        params = init_from_schema(args.seed, build_schema(cfg), torch.float32, device)
        if args.full:
            rescale_attention(params)
        return {"params": params, "opt": adamw.init(opt_cfg, params)}

    detector = StragglerDetector()
    losses = []
    t_last = [time.perf_counter()]

    def train_one(state, step):
        batch = to_device(batch_for_step(dcfg, step), device)
        params, opt, metrics = step_fn(state["params"], state["opt"], batch)
        loss = float(metrics["loss"])
        if not np.isfinite(loss):
            raise RuntimeError(f"non-finite loss at step {step}")
        losses.append(loss)
        now = time.perf_counter()
        detector.observe("host0", now - t_last[0])
        t_last[0] = now
        if (step + 1) % args.log_every == 0:
            print(f"step {step + 1:>5}  loss {loss:.4f}  "
                  f"lr {float(metrics['lr']):.2e}  "
                  f"gnorm {float(metrics['grad_norm']):.2f}", flush=True)
        return {"params": params, "opt": opt}

    if args.ckpt_dir:
        mgr = RestartManager(args.ckpt_dir,
                             checkpoint_every=args.ckpt_every)
        mgr.run(init_fn, train_one, num_steps=args.steps)
    else:
        state = init_fn()
        for step in range(args.steps):
            state = train_one(state, step)

    print(f"done: first-10 mean loss {np.mean(losses[:10]):.4f} -> "
          f"last-10 mean loss {np.mean(losses[-10:]):.4f}", flush=True)


if __name__ == "__main__":
    main()
