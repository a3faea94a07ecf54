#!/usr/bin/env python3
"""Compare checkouts of the repository on one GPU, kernel by kernel and
end to end, without running all of ``chip_smoke.py``.

    python3 chip_compare.py [--kernels K,...] [--phases P,...] TREE...

for example

    python3 chip_compare.py --kernels gn_silu_conv3x3,output_epilogue \\
        --phases vae_times,invariance PARENT CHANGE CHANGE PARENT

Each TREE is the root of a checkout (for example an unpacked ``git
archive`` of a commit).  For each in turn, in a process of its own, this
puts that checkout's ``src`` first on the path, so the program and its
kernels' sources are the checkout's, and measures it with the
``chip_smoke.py`` beside this script, so every checkout is held to the
same checks and timed by the same code:

- the device phase (the kernels' build from the checkout's sources);
- ``--kernels``: ``chip_smoke.vae_kernel_checks`` for the named kernels,
  every shape that one 512x512 uint8 decode, encode and float decode of
  the SD3.5-width VAE give them, each against its plain version, its
  times and bounds (a ``kernel`` line per shape, ``kernel_quant`` lines
  for the quantized weight cases);
- ``--phases``, in order: ``vae_times`` (below), a serving phase of
  ``chip_smoke.SERVE`` (``lm``, ``ssm``, ``hybrid``, ``moe``, ``vlm``,
  ``encdec``, ``kimi``), ``rwkv6`` or
  ``lm_attention`` (``chip_smoke.<name>_checks``), or any other
  ``chip_smoke.phase_<name>`` (``invariance``, ``slice``, ...).

It prints one JSON line per run with the numbers of each line logged.
Alternate the order, as above, so that a card that warms up or slows
down favours neither side.  Every line of each run also goes to
``chiprun_out/compare_<n>.jsonl`` here.  Exits non-zero if any run
fails.  Needs one CUDA device.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
OUT_DIR = HERE / "chiprun_out"
BUCKETS = (1, 2, 4, 8)


def vae_times(smoke, torch, log, state):
    """Device ms per image of the uint8 decode per bucket and of the
    encode, CUDA events around ``decode_u8`` and ``encode_mean`` on the
    seeded SD3.5-width VAE."""
    np = state["np"]
    vae = state.setdefault("vae", smoke.sd35_vae(torch, "cuda"))[0]
    hw = smoke.LATENT_HW
    rng = np.random.default_rng(5)
    z = torch.from_numpy(rng.standard_normal(
        (max(BUCKETS), hw, hw, 16)).astype("float32")).cuda()
    decode = {str(b): smoke.cuda_ms(torch, lambda: vae.decode_u8(z[:b]), 3)
              / b for b in BUCKETS}
    x = torch.from_numpy(rng.uniform(
        -1, 1, (1, 8 * hw, 8 * hw, 3)).astype("float32")).cuda()
    encode = smoke.cuda_ms(torch, lambda: vae.encode_mean(x), 3)
    smoke.emit(log, "vae_times", decode_per_image_ms=decode, encode_ms=encode)


def run_phase(smoke, torch, log, state, name: str) -> None:
    """Run the phase ``name`` (see the module's docstring)."""
    if name == "vae_times":
        smoke.run_phase(log, name, vae_times, smoke, torch, log, state)
    elif name in smoke.SERVE:
        smoke.run_phase(log, name, smoke.phase_serve, torch, log, state, name)
    elif name in ("rwkv6", "lm_attention"):
        totals = {p: {k: dict.fromkeys(smoke.TOTAL_FIELDS, 0.0)
                      for k in smoke.KERNELS} for p in smoke.PASSES}
        max_err = dict.fromkeys(smoke.KERNELS, 0.0)
        smoke.run_phase(log, name, getattr(smoke, f"{name}_checks"), torch,
                        log, state, totals, max_err)
    else:
        smoke.run_phase(log, name, getattr(smoke, f"phase_{name}"), torch,
                        log, state)


def run_one(tree: Path, log_path: Path, kernels, phases) -> None:
    """Measure ``tree``'s program in this process."""
    sys.path.insert(0, str(tree / "src"))
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  HERE / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_compare.py: no CUDA device")
    smoke.OUT_DIR.mkdir(exist_ok=True)
    state = {"np": np, "cold": {}, "launches": {}}
    with open(log_path, "w") as log:
        smoke.run_phase(log, "device", smoke.phase_device, torch, log, state)
        if kernels:
            smoke.run_phase(log, "kernels", smoke.vae_kernel_checks, torch,
                            log, state, kernels)
        for name in phases:
            run_phase(smoke, torch, log, state, name)


def flat(row: dict) -> dict:
    """``row``'s scalars, and its lists and dicts of scalars."""
    def scalar(v):
        return v is None or isinstance(v, (bool, int, float, str))
    return {k: v for k, v in row.items()
            if scalar(v) or (isinstance(v, (list, dict)) and all(
                scalar(x) for x in (v.values() if isinstance(v, dict)
                                    else v)))}


def summary(log_path: Path) -> dict:
    """The numbers of one run's log: the card, then each line's scalars
    under its phase (a list where a phase logs more than one line)."""
    out = {}
    for line in log_path.read_text().splitlines():
        row = json.loads(line)
        phase = row.pop("phase", None)
        if phase == "device":
            out["card"] = row["nvidia_smi"]
        elif phase not in (None, "timing"):
            out.setdefault(phase, []).append(
                {k: v for k, v in flat(row).items()
                 if k not in ("design", "tol_reason")})
    return {k: v[0] if isinstance(v, list) and len(v) == 1 else v
            for k, v in out.items()}


def main(argv) -> int:
    if len(argv) == 5 and argv[0] == "--run":
        run_one(Path(argv[1]).resolve(), Path(argv[2]),
                [k for k in argv[3].split(",") if k],
                [p for p in argv[4].split(",") if p])
        return 0
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--kernels", default="",
                    help="comma-separated VAE kernels to check and time")
    ap.add_argument("--phases", default="",
                    help="comma-separated phases to run, in order")
    ap.add_argument("trees", nargs="+", help="checkout roots")
    args = ap.parse_args(argv)
    if not args.kernels and not args.phases:
        ap.error("name --kernels, --phases or both")
    OUT_DIR.mkdir(exist_ok=True)
    failed = 0
    for n, tree in enumerate(args.trees, 1):
        log_path = OUT_DIR / f"compare_{n}.jsonl"
        t0 = time.perf_counter()
        rc = subprocess.run([sys.executable, __file__, "--run", tree,
                             str(log_path), args.kernels,
                             args.phases]).returncode
        line = {"run": n, "tree": tree, "rc": rc,
                "wall_s": time.perf_counter() - t0}
        if log_path.exists():
            line.update(summary(log_path))
        failed += rc != 0
        print(json.dumps(line), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
