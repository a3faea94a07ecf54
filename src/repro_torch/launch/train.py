"""Training launcher of the port (counterpart of the JAX package's
``launch/train.py``), on one device::

    PYTHONPATH=src python -m repro_torch.launch.train --arch granite-8b \\
        --steps 50 --reduced --device cpu      # CPU-scale smoke
    PYTHONPATH=src python -m repro_torch.launch.train --arch granite-8b \\
        --steps 50 --reduced                   # the same on the card

The reference's flags, plus ``--device`` (default ``cuda``, which raises
where CUDA is absent).  Like the reference's, it trains on one device: a
published config trains only where it fits one card.  The sharded step
over a device mesh is ``train.train_step.make_train_step`` on DTensor
trees (``dist.sharding``; ``tests/test_torch_dist.py`` runs it on gloo
ranks).
"""

from __future__ import annotations

import argparse
import os
import tempfile

import repro_torch.configs as RC
from repro_torch.data.synthetic import DataConfig, SyntheticTokens
from repro_torch.train.optim import AdamW, AdamWConfig
from repro_torch.train.trainer import Trainer, TrainerConfig


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-8b", choices=RC.ARCH_IDS)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--reduced", action="store_true",
                    help="smoke-scale config")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without CUDA) or cpu")
    args = ap.parse_args(argv)

    cfg = RC.get_config(args.arch)
    if args.reduced:
        cfg = RC.reduced_config(cfg)
    if cfg.family in ("encdec", "vlm") and args.reduced:
        raise SystemExit("use examples/train_tiny_lm_torch.py for frontend "
                         "archs")
    model = RC.build_model(cfg, device=args.device, seed=0)
    data = SyntheticTokens(DataConfig(vocab_size=cfg.vocab_size,
                                      seq_len=args.seq,
                                      global_batch=args.batch))
    opt = AdamW(AdamWConfig(lr=args.lr, warmup_steps=10,
                            total_steps=args.steps))
    trainer = Trainer(model, opt, data, TrainerConfig(
        steps=args.steps, ckpt_every=args.ckpt_every,
        ckpt_dir=args.ckpt_dir, microbatches=args.microbatches,
        compress_grads=args.compress_grads))
    trainer.install_signal_handlers()
    trainer.run(model.params)
    print(f"[train] done on {model.device}; stragglers={trainer.stragglers}, "
          f"median step "
          f"{sorted(trainer.step_times)[len(trainer.step_times)//2]:.2f}s")


if __name__ == "__main__":
    main()
