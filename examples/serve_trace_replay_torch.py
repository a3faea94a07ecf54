"""END-TO-END DRIVER on the PyTorch/CUDA port: serve a generated-image
corpus with batched requests through the ``LatentBox`` facade's engine
backend — consistent-hash router, dual-format cache, adaptive tuner,
spillover — with decodes on the card microbatched through the engine's
bucketed DecodeBatcher, replaying a synthetic production trace in
8-request windows (the launcher it calls, ``repro_torch.launch.serve``,
goes through the facade only: ``put`` for corpus ingest, windowed
``get_many`` for serving).

    python examples/serve_trace_replay_torch.py                # on the card
    python examples/serve_trace_replay_torch.py --device cpu   # plain path
"""
import argparse
import os
import subprocess
import sys
from pathlib import Path

SRC = Path(__file__).resolve().parents[1] / "src"

if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    # the launcher is the production entry point; the example pins a scale
    sys.exit(subprocess.call(
        [sys.executable, "-m", "repro_torch.launch.serve",
         "--objects", "50", "--requests", "600", "--nodes", "2",
         "--batch", "8", "--device", args.device],
        env={**os.environ, "PYTHONPATH": str(SRC)}))
