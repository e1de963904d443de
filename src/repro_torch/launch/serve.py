"""Serving entry point: batched prefill + decode loop, on the card by default.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b \
      --full --batch 4 --prompt-len 32 --gen 16
  PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-1.2b --full
  PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-moe-3b-a800m --full
  PYTHONPATH=src python -m repro_torch.launch.serve --arch falcon-mamba-7b --full
  PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-large-v3 --full

Without ``--full`` it serves the reduced twin of the architecture.
``--device cpu`` runs on the CPU; without a card and without that flag it
raises.  The weights are random, seeded by ``--seed``; so are whisper's
frame embeddings (its audio frontend is a stub).
"""
from __future__ import annotations

import argparse
import time
from typing import Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.registry import ARCHS, get_arch
from repro_torch.models.model import SEQ_KEYS, cast_params
from repro_torch.models.ops import NOSHARD, ShardCtx
from repro_torch.models.schema import build_schema
from repro_torch.models.sharding import init_from_schema
from repro_torch.models.testing import reduced
from repro_torch.train.steps import make_prefill_step, make_serve_step


def serve_batch(cfg, params, prompts, gen_tokens, *, enc_embeds=None, seed=0,
                ctx: ShardCtx = NOSHARD, device=None) -> torch.Tensor:
    """prompts: (B, S) integer tokens.  Returns (B, S + gen_tokens) int64 on
    the device; greedy decoding in lockstep, float32 as in
    ``repro.launch.serve.serve_batch``.

    The encoder-decoder family reads ``enc_embeds`` (B, enc_len, d), a numpy
    array or a tensor; without it the frames are 0.02 N(0, 1) drawn from a
    ``torch.Generator`` seeded with ``seed`` (the JAX function draws the same
    distribution from ``jax.random``, which gives other numbers)."""
    device = resolve_device(device)
    params = cast_params(params, torch.float32, device)
    prompts = torch.as_tensor(np.asarray(prompts), device=device).long()
    B, S = prompts.shape
    prefill = make_prefill_step(cfg, ctx)
    decode = make_serve_step(cfg, ctx)

    max_len = S + gen_tokens
    batch = {"tokens": prompts}
    if cfg.enc_len:
        if enc_embeds is None:
            enc_embeds = 0.02 * torch.randn(
                B, cfg.enc_len, cfg.d_model,
                generator=torch.Generator().manual_seed(seed))
        batch["enc_embeds"] = torch.as_tensor(enc_embeds, dtype=torch.float32,
                                              device=device)
    # allocate the sequence leaves at full serving length, then splice the
    # prefill output; state leaves (mamba conv/SSM) and the cross K/V carry
    # through as they are
    last_logits, cache = prefill(params, batch)
    for key in SEQ_KEYS:
        if key in cache:
            pre = cache[key]
            buf = torch.zeros(*pre.shape[:2], max_len, *pre.shape[3:],
                              dtype=pre.dtype, device=device)
            buf[:, :, :S] = pre
            cache[key] = buf

    out = [prompts]
    tok = torch.argmax(last_logits[:, : cfg.vocab], dim=-1)[:, None]
    for i in range(gen_tokens):
        out.append(tok)
        if i == gen_tokens - 1:
            break
        logits, cache = decode(params, cache, tok)
        tok = torch.argmax(logits[:, : cfg.vocab], dim=-1)[:, None]
    return torch.cat(out, dim=1)


def main(argv: Optional[list] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=sorted(ARCHS), default="qwen2-1.5b")
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", choices=("cuda", "cpu"), default=None)
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_arch(args.arch)
    if not args.full:
        cfg = reduced(cfg)
    params = init_from_schema(args.seed, build_schema(cfg), torch.float32, device)
    prompts = np.random.default_rng(args.seed + 1).integers(
        0, cfg.vocab, size=(args.batch, args.prompt_len))

    t0 = time.perf_counter()
    seqs = serve_batch(cfg, params, prompts, args.gen, seed=args.seed, device=device)
    seqs = seqs.cpu()
    dt = time.perf_counter() - t0
    if seqs.shape != (args.batch, args.prompt_len + args.gen):
        raise RuntimeError(f"served shape {tuple(seqs.shape)}")
    toks = args.batch * args.gen
    where = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"arch={cfg.name} on {where}: prefilled {args.batch}x{args.prompt_len}, "
          f"decoded {toks} tokens in {dt:.2f}s ({toks / dt:.1f} tok/s, "
          f"including the first call's kernel build on a card)", flush=True)
    print("sample continuation:", seqs[0, args.prompt_len:].numpy())


if __name__ == "__main__":
    main()
