"""Training launcher, the port of ``repro.launch.train``: config -> model
-> train step -> checkpoint -> restore, on the synthetic token stream,
on the card unless ``--device cpu`` is given.

    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
        --reduced --steps 50 --batch 8 --seq 128
    PYTHONPATH=src python -m repro_torch.launch.train --no-reduced

Takes the reference CLI's flags and defaults (qwen3-0.6b, 100 steps,
batch 8, seq 128, ``adamw`` over ``cosine_warmup(lr, steps // 10 + 1,
steps)``, clip 1.0, a checkpoint every ``steps // 4`` steps under
``--ckpt-dir`` and a restart from its latest) and prints the same lines,
closing with ``loss a -> b (LEARNING | check hyperparams)``.  Two of its
flags are repaired, as in ``launch/serve.py``: ``--reduced`` (the CPU-
smoke variant in float32, the default) can be turned off with
``--no-reduced`` (the published width in the config's dtype), and
``--device`` picks the card (default) or the CPU.

The step is ``core.trainer.make_train_step`` over ``Model.loss``, with
params and optimizer state donated (updated in place, as the reference
jits its step with ``donate_argnums=(0, 1)``).  Its forward runs the
reference's training path: attention in ``attn_apply``'s q-chunked
branch, which launches no kernel, as the reference's reaches no Pallas
kernel; rwkv6's and mamba's recurrences through ``ops.rwkv6_scan`` and
``ops.ssm_scan``, whose autograd Functions run the ``rwkv6_scan`` /
``ssm_scan`` kernels forward and the ``rwkv6_scan_bwd`` /
``ssm_scan_bwd`` kernels backward on the card (their plain versions on
the CPU).  Weights are drawn from ``--seed`` by the port's own
initialiser.

Refused, before any step: configs the port's ``Model`` refuses, and
``--device cuda`` without a card.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs.base import ModelConfig, get_config
from repro_torch.core.trainer import make_train_step
from repro_torch.data.tokens import make_stream
from repro_torch.models.api import Model
from repro_torch.optim import adamw, cosine_warmup
from repro_torch.optim.optimizers import tree_leaves


def make_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="train the CPU-smoke variant (default); "
                         "--no-reduced trains the published width")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    return ap


def config_for(args) -> ModelConfig:
    cfg = get_config(args.arch)
    return cfg.reduced() if args.reduced else cfg


def optimizer_for(args):
    """The reference CLI's optimizer: adamw over a cosine schedule with a
    warm-up of a tenth of the steps."""
    return adamw(cosine_warmup(args.lr, args.steps // 10 + 1, args.steps))


def check_args(args) -> None:
    """Refuse a run the port cannot carry, before any weight is drawn."""
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: torch.cuda.is_available() is "
                         "False (pass --device cpu to run on the CPU)")


def run(args, cfg: ModelConfig = None, log=print) -> dict:
    """Train as the reference CLI does; ``cfg`` replaces the config of
    ``--arch`` / ``--reduced`` (for a depth-cut one).  -> {"losses",
    "grad_norms", "aux" (the router loss) and "step_seconds" (wall time
    from each step's start to its loss on the host), one a step run;
    "start" (the restored step, or 0), "first", "last", "verdict",
    "params", "opt_state"}."""
    cfg = cfg or config_for(args)
    check_args(args)
    model = Model(cfg, device=args.device)
    log(f"arch={cfg.name} layers={cfg.num_layers} d={cfg.d_model} "
        f"vocab={cfg.vocab_size}")

    params = model.init(args.seed)
    n_params = sum(p.numel() for p in tree_leaves(params))
    log(f"params: {n_params/1e6:.2f}M")

    opt = optimizer_for(args)
    opt_state = opt.init(params)
    step_fn = make_train_step(lambda p, b: model.loss(p, b), opt, clip=1.0)

    stream = make_stream(cfg.vocab_size, args.seq, args.batch, args.seed)
    ckpt = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    start = 0
    if ckpt:
        restored = ckpt.restore_latest({"params": params, "opt": opt_state})
        if restored[0] is not None:
            start = restored[0]
            params = restored[1]["params"]
            opt_state = restored[1]["opt"]
            log(f"restored step {start}")

    t0 = time.time()
    losses, step_seconds, on_device = [], [], {"grad_norms": [], "aux": []}
    for step in range(start, args.steps):
        t_step = time.perf_counter()
        batch = {k: torch.from_numpy(v).to(model.device)
                 for k, v in stream.batch(step).items()}
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        losses.append(float(metrics["loss"]))
        step_seconds.append(time.perf_counter() - t_step)
        on_device["grad_norms"].append(metrics["grad_norm"])
        on_device["aux"].append(metrics["aux"])
        if step % args.log_every == 0 or step == args.steps - 1:
            dt = time.time() - t0
            log(f"step {step:5d} loss={losses[-1]:.4f} "
                f"xent={float(metrics['xent']):.4f} ({dt:.1f}s)")
        if ckpt and (step + 1) % max(args.steps // 4, 1) == 0:
            ckpt.save(step + 1, {"params": params, "opt": opt_state})

    first = np.mean(losses[:5])
    last = np.mean(losses[-5:])
    verdict = "LEARNING" if last < first - 0.2 else "check hyperparams"
    log(f"loss {first:.4f} -> {last:.4f} ({verdict})")
    return {"losses": losses, "step_seconds": step_seconds,
            **{k: torch.stack(v).tolist() if v else []
               for k, v in on_device.items()},
            "start": start, "first": first,
            "last": last, "verdict": verdict, "params": params,
            "opt_state": opt_state}


def main(argv=None):
    args = make_parser().parse_args(argv)
    run(args, log=lambda line: print(line, flush=True))


if __name__ == "__main__":
    main()
