"""The port's dry run (``repro_torch.launch.dryrun``) and the roofline
reading its artifacts, on the CPU.

Each case runs in a child process (``OMP_NUM_THREADS=2``, a timeout): the
fake process group is global to a process, and the reference's dry-run
module sets ``XLA_FLAGS`` when it is imported.

- (a) :func:`wire_bytes` against the reference's ``_wire_bytes_of_line``
  on synthetic HLO lines of each collective kind at group sizes 2, 4 and
  16;
- (b) per-device FLOPs of a reduced dense prefill on a fake (1, 1) mesh
  equal the unsharded step's; on (2, 2), four times them are within 1 %
  of it;
- (c) a cell is traced at its config's full depth, and one layer
  period less gives fewer FLOPs and a lower peak, lower by at least the
  bytes of the arguments (parameters, optimizer state, cache) that the
  cut layers hold through the whole step, for a reduced config of each
  family (prefill; decode for the attention families; train steps);
- (d) a cell the CLI writes is read by the port's and the reference's
  ``roofline.analyze_cell`` alike, and the port's ``main`` prints its
  row;
- (e) skipped cells carry the reference's ``cell_applicable`` reasons.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
#: seconds a child may take
TIMEOUT = 600


def run(code: str, *args: str) -> dict:
    """Run ``code`` (or, with ``args``, ``python -m`` args) in a child
    with ``src`` on the path; return the JSON its last line prints."""
    env = dict(os.environ, OMP_NUM_THREADS="2", JAX_PLATFORMS="cpu",
               PYTHONPATH=str(ROOT / "src"))
    cmd = [sys.executable, *args] if args else [sys.executable, "-c", code]
    out = subprocess.run(cmd, env=env, cwd=ROOT, capture_output=True,
                         text=True, timeout=TIMEOUT)
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.strip().splitlines()[-1]) if not args \
        else {"stdout": out.stdout}


#: (kind, result type text, result bytes) of the synthetic lines
LINES = [("all-reduce", "f32[16,128]{1,0}", 16 * 128 * 4),
         ("all-gather", "bf16[64,32]{1,0}", 64 * 32 * 2),
         ("reduce-scatter", "f32[8,256]{1,0}", 8 * 256 * 4),
         ("all-to-all", "bf16[32,32]{1,0}", 32 * 32 * 2),
         ("collective-permute", "s32[100]{0}", 100 * 4)]


def test_wire_formula_matches_the_reference():
    """(a)"""
    from repro_torch.launch.dryrun import wire_bytes
    lines = [(kind, n, f"  %x.{i} = {ty} {kind}(%p), "
                       f"replica_groups=[{64 // n},{n}]<=[64]")
             for i, (kind, ty, _) in enumerate(LINES) for n in (2, 4, 16)]
    want = run("import json\n"
               "from repro.launch.dryrun import _wire_bytes_of_line\n"
               f"lines = {lines!r}\n"
               "print(json.dumps([_wire_bytes_of_line(l, k, 64) "
               "for k, n, l in lines]))")
    nbytes = {kind: b for kind, _, b in LINES}
    got = [wire_bytes(kind, nbytes[kind], n) for kind, n, _ in lines]
    assert got == want and all(w > 0 for w in want)


FLOPS_CODE = """
import dataclasses, json, torch
import repro_torch.configs as RC
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.launch import dryrun as DR
cfg = RC.reduced_config(RC.get_config("qwen2-7b"))
shape = ShapeSpec("prefill_64", "prefill", 64, 4)
from repro_torch.models import lm as M
# the unsharded prefill on the same shapes, counted by the same recorder
# (under no_grad: inference mode bypasses a dispatch mode)
model = RC.build_model(cfg, device="cpu", seed=0)
rec = DR.Recorder()
with rec, torch.no_grad():
    M.prefill(model.params, torch.zeros((4, 64), dtype=torch.long), cfg)
out = {"plain": rec.flops}
for mesh in ((1, 1), (2, 2)):
    counts, _ = DR.trace("qwen2-7b", shape, DR.fake_mesh(mesh), cfg=cfg)
    out[str(mesh)] = counts["flops"]
print(json.dumps(out))
"""


def test_per_device_flops_sum_to_the_unsharded_count():
    """(b)"""
    got = run(FLOPS_CODE)
    assert got["plain"] > 0
    assert got["(1, 1)"] == got["plain"]
    assert abs(4 * got["(2, 2)"] - got["plain"]) <= 0.01 * got["plain"], got


DEPTH_CODE = """
import dataclasses, json
import repro_torch.configs as RC
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.launch import dryrun as DR
arch, kind = {arch!r}, {kind!r}
cfg = RC.reduced_config(RC.get_config(arch))
# 32 tokens (after a VLM's 256 vision embeds)
shape = ShapeSpec("small", kind, 32 + DR.VISION_PREFIX * (cfg.family == "vlm"),
                  8)
mesh = DR.fake_mesh((2, 2))
# one period of the layer pattern less: zamba2's attn_every, else 1
p = cfg.attn_every if cfg.family == "hybrid" else 1
full, _ = DR.trace(arch, shape, mesh, cfg=cfg)
cut, _ = DR.trace(arch, shape, mesh,
                  cfg=dataclasses.replace(cfg, n_layers=cfg.n_layers - p))
keys = ("flops", "peak_memory_in_bytes", "argument_size_in_bytes")
print(json.dumps({{"full": {{k: full[k] for k in keys}},
                  "cut": {{k: cut[k] for k in keys}}}}))
"""

DEPTH_CASES = [("qwen2-7b", "prefill"), ("qwen2-7b", "decode"),
               ("qwen2-7b", "train"), ("mixtral-8x7b", "prefill"),
               ("rwkv6-7b", "prefill"), ("zamba2-2.7b", "prefill"),
               ("zamba2-2.7b", "decode"), ("qwen2-vl-72b", "prefill"),
               ("whisper-large-v3", "prefill"),
               ("whisper-large-v3", "decode"), ("phi4-mini-3.8b", "train")]


@pytest.mark.parametrize("arch,kind", DEPTH_CASES)
def test_cells_are_traced_at_full_depth(arch, kind):
    """(c)"""
    got = run(DEPTH_CODE.format(arch=arch, kind=kind))
    full, cut = got["full"], got["cut"]
    assert full["flops"] > cut["flops"] > 0
    held = full["argument_size_in_bytes"] - cut["argument_size_in_bytes"]
    assert held > 0
    assert full["peak_memory_in_bytes"] - cut["peak_memory_in_bytes"] \
        >= held, got
    assert full["peak_memory_in_bytes"] >= full["argument_size_in_bytes"]


def test_roofline_reads_a_port_artifact(tmp_path):
    """(d): one decode cell over the production mesh, written by the CLI,
    read by both ``analyze_cell``s; the port's table prints its row."""
    from repro.launch import roofline as jroof
    from repro_torch.launch import roofline
    run("", "-m", "repro_torch.launch.dryrun", "--arch", "qwen2-7b",
        "--shape", "decode_32k", "--mesh", "single", "--out", str(tmp_path))
    art = json.loads((tmp_path / "qwen2-7b__decode_32k__single.json")
                     .read_text())
    assert art["status"] == "ok" and art["devices"] == 256
    assert art["layers"] == 28
    assert art["cost_analysis"]["flops"] > 0
    assert art["collectives"]["total_wire_bytes"] > 0
    mem = art["memory_analysis"]
    assert mem["peak_memory_in_bytes"] > mem["argument_size_in_bytes"] > 0
    got = roofline.analyze_cell("qwen2-7b", "decode_32k", "single",
                                str(tmp_path))
    want = jroof.analyze_cell("qwen2-7b", "decode_32k", "single",
                              str(tmp_path))
    assert got["status"] == want["status"] == "ok"
    assert list(got) == list(want)
    assert got["chips"] == want["chips"] == 256
    assert got["collective_gb_per_chip"] == want["collective_gb_per_chip"]
    assert got["peak_hbm_gb"] == want["peak_hbm_gb"]
    rows = roofline.full_table("single", str(tmp_path))
    assert [(r["arch"], r["shape"]) for r in rows] == \
        [("qwen2-7b", "decode_32k")]
    line = roofline.format_table(rows).splitlines()[2]
    assert line.split()[:3] == ["qwen2-7b", "decode_32k", "single"]


@pytest.mark.parametrize("arch", ["qwen2-7b", "whisper-large-v3"])
def test_skipped_cells_carry_the_reference_reasons(arch, tmp_path):
    """(e)"""
    import repro.configs as JC
    run("", "-m", "repro_torch.launch.dryrun", "--arch", arch, "--shape",
        "long_500k", "--mesh", "single", "--out", str(tmp_path))
    art = json.loads((tmp_path / f"{arch}__long_500k__single.json")
                     .read_text())
    ok, why = JC.cell_applicable(JC.get_config(arch),
                                 JC.LM_SHAPES["long_500k"])
    assert not ok and art["status"] == "skipped" and art["reason"] == why
