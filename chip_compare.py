#!/usr/bin/env python3
"""Compare checkouts of the repository on one GPU, kernel by kernel and
end to end, without running all of ``chip_smoke.py``.

    python3 chip_compare.py PARENT CHANGE CHANGE PARENT

Each argument is the root of a checkout (for example an unpacked ``git
archive`` of a commit).  For each in turn, in a process of its own, this
imports that checkout's ``chip_smoke.py`` and runs its device phase (the
kernels' build from that checkout's sources), its ``rwkv6_scan`` checks
at the rwkv6-7b prefill and decode-step shapes, and its rwkv6-7b serving
phase (``ssm``), with the same checks and tolerances as a full smoke run;
then it prints one JSON line of the numbers to compare.  Alternate the
order, as above, so that a card that warms up or slows down favours
neither side.  Every line of each run also goes to
``chiprun_out/compare_<n>.jsonl`` here.  Exits non-zero if any run
fails.  Needs one CUDA device.
"""

from __future__ import annotations

import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

OUT_DIR = Path(__file__).resolve().parent / "chiprun_out"


def run_one(tree: Path, log_path: Path) -> None:
    """Run ``tree``'s chip_smoke phases in this process."""
    sys.path.insert(0, str(tree / "src"))
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  tree / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_compare.py: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smoke.OUT_DIR.mkdir(exist_ok=True)
    state = {"np": np, "cold": {}, "launches": {}}
    totals = {p: {k: dict.fromkeys(smoke.TOTAL_FIELDS, 0.0)
                  for k in smoke.KERNELS} for p in smoke.PASSES}
    max_err = dict.fromkeys(smoke.KERNELS, 0.0)
    with open(log_path, "w") as log:
        smoke.run_phase(log, "device", smoke.phase_device, torch, log, state)
        smoke.run_phase(log, "rwkv6", smoke.rwkv6_checks, torch, log, state,
                        totals, max_err)
        smoke.run_phase(log, "ssm", smoke.phase_serve, torch, log, state,
                        "ssm")


def summary(log_path: Path) -> dict:
    """The numbers of one run's log to compare across checkouts."""
    out = {"kernels": []}
    for line in log_path.read_text().splitlines():
        row = json.loads(line)
        phase = row.get("phase")
        if phase == "device":
            out["card"] = row["nvidia_smi"]
        elif phase == "kernel" and row.get("name") == "rwkv6_scan":
            out["kernels"].append({k: row[k] for k in (
                "shape", "ms", "event_ms", "plain_ms", "bound_ms",
                "bound_by", "max_abs_err", "tol", "state_max_abs_err",
                "state_tol")})
        elif phase == "ssm":
            out["ssm"] = {k: row[k] for k in (
                "warm_prefill_ms", "warm_prefill_tokens_per_s",
                "decode_step_ms_median", "max_memory_allocated",
                "launches_per_prefill", "launches_per_step",
                "consistency_rel_err", "consistency_tol",
                "fp32_consistency_rel_err")}
            for key in ("profile_prefill", "profile_decode_step"):
                prof = row[key]
                out["ssm"][key] = {k: prof[k] for k in (
                    "wall_ms", "device_ms", "busy_share", "device_launches")}
                out["ssm"][key]["top"] = prof["top"][:4]
    return out


def main(argv) -> int:
    if len(argv) == 3 and argv[0] == "--run":
        run_one(Path(argv[1]).resolve(), Path(argv[2]))
        return 0
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    OUT_DIR.mkdir(exist_ok=True)
    failed = 0
    for n, tree in enumerate(argv, 1):
        log_path = OUT_DIR / f"compare_{n}.jsonl"
        t0 = time.perf_counter()
        rc = subprocess.run([sys.executable, __file__, "--run", tree,
                             str(log_path)]).returncode
        line = {"run": n, "tree": tree, "rc": rc,
                "wall_s": time.perf_counter() - t0}
        if rc == 0:
            line.update(summary(log_path))
        failed += rc != 0
        print(json.dumps(line), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
