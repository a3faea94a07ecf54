"""Train a small LM of the pool for a few hundred steps with the port's
full loop: microbatched AdamW, checkpoints, resume (the counterpart of
``examples/train_tiny_lm.py``).

    python examples/train_tiny_lm_torch.py [--steps 120] [--device cpu]

Runs on the card unless ``--device cpu`` is given; checkpoints go under
the temporary directory (``TMPDIR``), and a second run resumes there.
"""
import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

import repro_torch.configs as RC  # noqa: E402
from repro_torch.data.synthetic import DataConfig, SyntheticTokens  # noqa: E402
from repro_torch.train.optim import AdamW, AdamWConfig  # noqa: E402
from repro_torch.train.trainer import Trainer, TrainerConfig  # noqa: E402

ap = argparse.ArgumentParser()
ap.add_argument("--steps", type=int, default=120)
ap.add_argument("--arch", default="zamba2-2.7b", choices=RC.ARCH_IDS)
ap.add_argument("--device", default="cuda",
                help="cuda (default; raises without CUDA) or cpu")
args = ap.parse_args()

cfg = RC.reduced_config(RC.get_config(args.arch))
model = RC.build_model(cfg, device=args.device, seed=0)
data = SyntheticTokens(DataConfig(vocab_size=cfg.vocab_size, seq_len=64,
                                  global_batch=8))
opt = AdamW(AdamWConfig(lr=1e-3, warmup_steps=20, total_steps=args.steps))
trainer = Trainer(model, opt, data, TrainerConfig(
    steps=args.steps, ckpt_every=40,
    ckpt_dir=os.path.join(tempfile.gettempdir(), "repro_torch_tiny_ckpt"),
    microbatches=2, log_every=20))
trainer.install_signal_handlers()
trainer.run(model.params)
first = trainer.history[0]["loss"] if trainer.history else float("nan")
last = trainer.history[-1]["loss"] if trainer.history else float("nan")
print(f"[example] {args.arch} loss {first:.3f} -> {last:.3f} over "
      f"{len(trainer.history)} steps on {model.device}")
