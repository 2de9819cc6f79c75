"""Training from the command line.

Runs any registered arch (or its reduced smoke config) on one card, or on
the CPU when asked, with the full substrate engaged: the deterministic
data pipeline (its quality filter through ``select_scan``), the train
step, checkpoint/restart (atomic + async), and the straggler watchdog.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \
      --smoke --steps 50 --batch 8 --seq 128 --ckpt-dir /tmp/ckpt \
      --ckpt-every 20
  PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu

Restart the same command after a kill: it resumes from the latest
checkpoint (data cursor = step, so the stream continues exactly).  On
the card the config's own dtypes and microbatches are used; under
``--smoke`` or on the CPU, float32 and one microbatch.  Weights are
random, drawn from seed 0 on the device.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs.base import ARCH_IDS, get_config, smoke_config
from repro_torch.data.pipeline import DataConfig, TokenPipeline
from repro_torch.device import resolve
from repro_torch.models import api
from repro_torch.train.optim import AdamWConfig, init_opt_state
from repro_torch.train.step import make_train_step
from repro_torch.train.watchdog import StepWatchdog


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="qwen2-0.5b")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU-friendly)")
    ap.add_argument("--d-model", type=int, default=0,
                    help="override width (e.g. ~100M custom run)")
    ap.add_argument("--n-layers", type=int, default=0)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--ckpt-keep", type=int, default=3)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="cpu, cuda, cuda:N (default: the current card)")
    args = ap.parse_args(argv)

    dev = resolve(args.device)
    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    overrides = {}
    if args.d_model:
        overrides.update(d_model=args.d_model,
                         head_dim=max(args.d_model // cfg.n_heads, 8),
                         d_ff=4 * args.d_model)
    if args.n_layers:
        overrides["n_layers"] = args.n_layers
    if overrides:
        cfg = cfg.replace(**overrides)
    if args.smoke or dev.type == "cpu":
        cfg = cfg.replace(param_dtype="float32", compute_dtype="float32",
                          train_microbatches=1)

    print(f"arch={cfg.name} layers={cfg.n_layers} d={cfg.d_model} "
          f"params~{cfg.param_count()/1e6:.1f}M devices=1 ({dev})")

    opt_cfg = AdamWConfig(lr=args.lr, total_steps=args.steps,
                          warmup_steps=max(args.steps // 20, 5))
    pipeline = TokenPipeline(cfg, DataConfig(batch=args.batch, seq=args.seq))
    step_fn = make_train_step(cfg, opt_cfg)

    params = api.init(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    opt_state = init_opt_state(params)
    start = 0

    mgr = None
    if args.ckpt_dir:
        mgr = CheckpointManager(args.ckpt_dir, keep=args.ckpt_keep,
                                async_save=True)
        latest = mgr.latest_step()
        if latest is not None:
            tree = mgr.restore(latest, {"params": params, "opt": opt_state})
            params, opt_state = tree["params"], tree["opt"]
            start = latest
            print(f"resumed from step {start}")

    dog = StepWatchdog(on_straggler=lambda s, dt, p50: print(
        f"[watchdog] step {s} straggled: {dt*1e3:.0f}ms vs p50 "
        f"{p50*1e3:.0f}ms"))

    for step in range(start, args.steps):
        dog.start()
        batch = pipeline.batch_at(step, dev)
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        loss = float(metrics["loss"])
        dt = dog.stop(step)
        if step % args.log_every == 0 or step == args.steps - 1:
            print(f"step {step:5d} loss {loss:.4f} "
                  f"gnorm {float(metrics['grad_norm']):.3f} "
                  f"lr {float(metrics['lr']):.2e} {dt*1e3:.0f}ms")
        if mgr and (step + 1) % args.ckpt_every == 0:
            mgr.save(step + 1, {"params": params, "opt": opt_state},
                     extra={"loss": loss})
    if mgr:
        mgr.save(args.steps, {"params": params, "opt": opt_state})
        mgr.wait()
    print("done")


if __name__ == "__main__":
    main()
