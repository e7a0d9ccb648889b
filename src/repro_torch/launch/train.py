"""Training driver (`repro.launch.train`).

On the card (granite-moe-1b-a400m by default; `--arch` also takes the
dense configs qwen2.5-32b, qwen1.5-32b and mistral-large-123b, each with
its config's optimizer; `--layers` cuts the depth, which one card needs
for those: it holds about 4 of qwen2.5-32b's 64 layers in bf16 with
AdamW; the reference's `launch.train` has no such option):
  PYTHONPATH=src python3 -m repro_torch.launch.train --steps 20 \
      --batch 8 --seq 256 --microbatch 4
  PYTHONPATH=src python3 -m repro_torch.launch.train --arch qwen2.5-32b \
      --layers 4 --steps 5 --batch 8 --seq 256 --microbatch 4

On the CPU, at the reduced same-family config:
  PYTHONPATH=src python3 -m repro_torch.launch.train --smoke --steps 5 \
      --device cpu [--arch qwen2.5-32b]

Prints one JSON line per logged step, then the first and last loss and
the restart count.  Only `--mesh none`: sharded training waits for a
four-card cell (ROADMAP Queue A 15).
"""
from __future__ import annotations

import argparse
import dataclasses
import json

from repro_torch.kernels import common
from repro_torch.models.registry import get_config
from repro_torch.train.trainer import TrainConfig, Trainer, deterministic


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-moe-1b-a400m")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced same-family config")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatch", type=int, default=None)
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the config's depth to this many layers")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--mesh", default="none",
                    choices=["none", "debug", "single", "multi"])
    ap.add_argument("--fail-at", type=int, default=None,
                    help="inject a failure at this step (FT demo)")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; cpu runs the plain "
                         "versions of the kernels)")
    args = ap.parse_args(argv)

    if args.mesh != "none":
        raise NotImplementedError(
            f"--mesh {args.mesh}: sharded training is not ported, one card "
            f"has no mesh (ROADMAP Queue A 15)")
    device = common.resolve_device(args.device)
    if device.type == "cuda":
        deterministic()
    cfg = get_config(args.arch, smoke=args.smoke)
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    tcfg = TrainConfig(steps=args.steps, batch=args.batch, seq=args.seq,
                       lr=args.lr, ckpt_dir=args.ckpt_dir,
                       microbatch=args.microbatch)
    trainer = Trainer(cfg, tcfg, device=device)
    trainer.run(fail_at=args.fail_at)
    for m in trainer.metrics_log:
        print(json.dumps(m))
    if trainer.metrics_log:
        first = trainer.metrics_log[0].get("loss")
        last = trainer.metrics_log[-1].get("loss")
        print(f"loss {first:.4f} -> {last:.4f}  restarts={trainer.restarts}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
