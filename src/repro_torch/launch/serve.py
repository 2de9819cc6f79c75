"""Batched serving from the command line: prefill a batch of random
prompts, then step the greedy decode loop against the cache.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-0.5b
  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-2.7b \
      --smoke --device cpu --batch 4 --prompt-len 32 --gen 32

On the card the config's own dtypes are used; under ``--smoke`` or on the
CPU, float32.  Weights and prompts are random, drawn from seed 0.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs.base import ARCH_IDS, get_config, smoke_config
from repro_torch.device import resolve
from repro_torch.models import api
from repro_torch.models.layers import cdtype
from repro_torch.train.step import make_decode_step, make_prefill_step


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="qwen2-0.5b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--device", default=None,
                    help="cpu, cuda, cuda:N (default: the current card)")
    args = ap.parse_args(argv)

    dev = resolve(args.device)
    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if args.smoke or dev.type == "cpu":
        cfg = cfg.replace(param_dtype="float32", compute_dtype="float32")

    b, pl_, gen = args.batch, args.prompt_len, args.gen
    max_len = pl_ + gen
    g = torch.Generator(device=dev).manual_seed(0)
    params = api.init(cfg, generator=g, device=dev)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (b, pl_),
                                     generator=g, device=dev)}
    if cfg.family == "vlm":
        batch["patch_embeds"] = torch.randn(
            (b, cfg.n_frontend_tokens, cfg.d_model), generator=g,
            device=dev).to(cdtype(cfg))
    if cfg.family == "audio":
        batch["frames"] = torch.randn(
            (b, cfg.encoder_len, cfg.d_model), generator=g,
            device=dev).to(cdtype(cfg))

    sync(dev)
    t0 = time.perf_counter()
    logits, cache = make_prefill_step(cfg, max_len)(params, batch)
    next_tok = torch.argmax(logits[:, -1, :], -1)[:, None].to(torch.int32)
    sync(dev)
    t_prefill = time.perf_counter() - t0
    print(f"prefill {b}x{pl_} in {t_prefill * 1e3:.1f}ms on {dev}")

    serve_step = make_decode_step(cfg)
    out = [next_tok]
    t0 = time.perf_counter()
    for i in range(gen - 1):
        next_tok, _, cache = serve_step(params, cache, next_tok, pl_ + i)
        out.append(next_tok)
    sync(dev)
    dt = time.perf_counter() - t0
    toks = torch.cat(out, dim=1)
    print(f"generated {gen} tokens/seq x {b} seqs in {dt * 1e3:.1f}ms "
          f"({b * (gen - 1) / max(dt, 1e-9):.1f} tok/s)")
    print("sample:", toks[0, :16].tolist())
    return {"tokens": toks.cpu(), "prefill_s": t_prefill, "decode_s": dt}


if __name__ == "__main__":
    main()
