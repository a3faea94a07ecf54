"""Roofline analysis on the H100: three terms per (arch x shape x mesh).

    compute term    = FLOPs / (chips * peak)
    memory term     = HBM bytes / (chips * 3.35e12)
    collective term = wire bytes per chip / 450e9        [NVLink, one way]

The peak is that of the precision the port runs the cell in
(:mod:`repro_torch.launch.mesh`): for an LM cell its config's ``dtype``,
``PEAK_FLOPS_BF16`` (989e12, dense tensor cores) for bf16 or fp16 and
``PEAK_FLOPS_FP32`` (67e12) for fp32, whose matmuls PyTorch runs on the
CUDA cores with TF32 off; for ``sd35_vae`` ``PEAK_FLOPS_TF32 / 3``
(165e12), since its fp32 decode runs each product as three TF32 ones.

FLOPs and HBM bytes come from the analytic model (``launch/costs.py``;
see its header for why not cost_analysis on rolled loops) — global,
divided by chip count.  Collective bytes, peak memory and the chip count
come from the port's dry-run artifacts under ``ART_DIR`` (JSON files, one
per cell, in the JAX package's format, already per device), which
``python -m repro_torch.launch.dryrun`` writes (:mod:`repro_torch.launch.
dryrun`: collectives counted as the traced step issues them, at the
config's full depth).  A cell without an artifact has no row.
The dominant term is the projected step bottleneck; roofline fraction =
compute term / max(all terms).

    PYTHONPATH=src python -m repro_torch.launch.roofline [--mesh multi]
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Any, Dict, List, Optional

import repro_torch.configs as RC
from repro_torch.configs.shapes import LM_SHAPES, VAE_SHAPES
from repro_torch.launch.costs import _dtype_size, cell_cost
from repro_torch.launch.mesh import (HBM_BW, ICI_BW, PEAK_FLOPS_BF16,
                                     PEAK_FLOPS_FP32, PEAK_FLOPS_TF32)

ART_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "artifacts", "dryrun_torch")


def analyze_cell(arch: str, shape_name: str, mesh: str = "single",
                 art_dir: str = ART_DIR,
                 flash_attention: bool = False) -> Optional[Dict[str, Any]]:
    path = os.path.join(art_dir, f"{arch}__{shape_name}__{mesh}.json")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        art = json.load(f)
    if art.get("status") != "ok":
        return {"arch": arch, "shape": shape_name, "mesh": mesh,
                "status": art.get("status"),
                "reason": art.get("reason") or art.get("error")}

    chips = art["devices"]
    if arch == "sd35_vae":
        from repro_torch.vae.serve import vae_cell_cost
        cost = vae_cell_cost(VAE_SHAPES[shape_name])
        peak = PEAK_FLOPS_TF32 / 3             # fp32 decode on 3xTF32
    else:
        cfg = RC.get_config(arch)
        cost = cell_cost(cfg, LM_SHAPES[shape_name])
        peak = PEAK_FLOPS_BF16 if _dtype_size(cfg) == 2 else PEAK_FLOPS_FP32

    flops = cost.flops
    hbm = cost.hbm_bytes_flash if flash_attention else cost.hbm_bytes
    wire = art["collectives"]["total_wire_bytes"]      # per device

    t_comp = flops / (chips * peak)
    t_mem = hbm / (chips * HBM_BW)
    t_coll = wire / ICI_BW
    terms = {"compute_s": t_comp, "memory_s": t_mem, "collective_s": t_coll}
    dominant = max(terms, key=terms.get)
    bound = max(terms.values())
    out = {
        "arch": arch, "shape": shape_name, "mesh": mesh, "status": "ok",
        "chips": chips,
        **{k: round(v, 4) for k, v in terms.items()},
        "dominant": dominant.replace("_s", ""),
        "roofline_fraction": round(t_comp / bound, 4) if bound else 0.0,
        "model_flops": cost.model_flops,
        "hlo_flops_analytic": flops,
        "useful_flops_ratio": round(cost.model_flops / flops, 4),
        "params_b": round(cost.params / 1e9, 2),
        "active_params_b": round(cost.active_params / 1e9, 2),
        "peak_hbm_gb": round(
            art.get("memory_analysis", {}).get("peak_memory_in_bytes", 0)
            / 2 ** 30, 2),
        "compile_s": art.get("compile_s"),
        "collective_gb_per_chip": round(wire / 2 ** 30, 2),
    }
    return out


def full_table(mesh: str = "single", art_dir: str = ART_DIR,
               flash_attention: bool = False) -> List[Dict[str, Any]]:
    rows = []
    for arch in list(RC.ARCH_IDS) + ["sd35_vae"]:
        shapes = VAE_SHAPES if arch == "sd35_vae" else LM_SHAPES
        for sname in shapes:
            r = analyze_cell(arch, sname, mesh, art_dir, flash_attention)
            if r is not None:
                rows.append(r)
    return rows


def format_table(rows: List[Dict[str, Any]]) -> str:
    hdr = (f"{'arch':22s} {'shape':14s} {'mesh':6s} {'comp_s':>9s} "
           f"{'mem_s':>9s} {'coll_s':>9s} {'dominant':>10s} {'frac':>6s} "
           f"{'useful':>7s} {'hbm_gb':>7s}")
    lines = [hdr, "-" * len(hdr)]
    for r in rows:
        if r.get("status") != "ok":
            lines.append(f"{r['arch']:22s} {r['shape']:14s} {r['mesh']:6s} "
                         f"   -- {r.get('status')}: "
                         f"{str(r.get('reason'))[:60]}")
            continue
        lines.append(
            f"{r['arch']:22s} {r['shape']:14s} {r['mesh']:6s} "
            f"{r['compute_s']:9.3f} {r['memory_s']:9.3f} "
            f"{r['collective_s']:9.3f} {r['dominant']:>10s} "
            f"{r['roofline_fraction']:6.3f} {r['useful_flops_ratio']:7.3f} "
            f"{r['peak_hbm_gb']:7.1f}")
    return "\n".join(lines)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", default="single", choices=["single", "multi"])
    ap.add_argument("--flash-attention", action="store_true",
                    help="memory term with the flash attention kernel")
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)
    rows = full_table(args.mesh, flash_attention=args.flash_attention)
    print(format_table(rows))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(rows, f, indent=1)


if __name__ == "__main__":
    main()
