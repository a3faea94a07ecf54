"""The port's launch layer and cost model on the CPU against the JAX
package's: ``launch/costs.cell_cost`` field for field at every (arch,
LM shape) cell; the analytic decoder FLOP and byte model and
``vae_cell_cost`` at 512 and 1024; ``decode_ms_estimate`` with the
reference's constants passed in, and at the H100 defaults; the roofline
rows on synthetic dry-run artifacts (each term the reference's scaled by
the ratio of the constants); ``make_decode_step`` on a bridged VAE, and
on a (1, 1) mesh; the serving launcher against the JAX launcher on the
same weights; the mesh constructors; and both examples with ``--device
cpu``."""

import contextlib
import dataclasses
import io
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import repro.configs as JRC
from repro.configs.shapes import LM_SHAPES as JLM_SHAPES
from repro.configs.shapes import VAE_SHAPES as JVAE_SHAPES
from repro.launch import costs as jcosts
from repro.launch import mesh as jmesh
from repro.launch import roofline as jroof
from repro.launch import serve as jserve
from repro.vae import model as JM
from repro.vae import serve as jvserve
import repro_torch.configs as RC
from repro_torch.configs.shapes import LM_SHAPES, VAE_SHAPES
from repro_torch.launch import costs, mesh, roofline
from repro_torch.launch import serve as tserve
from repro_torch.vae import model as M
from repro_torch.vae import serve as vserve
from repro_torch.vae.bridge import vae_from_numpy

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parents[1]
CELLS = [(a, s) for a in JRC.ARCH_IDS for s in JLM_SHAPES]
#: the reference's TPU v5e constants, passed in explicitly
V5E = dict(peak_flops=197e12, hbm_bw=819e9)


def test_every_cell_is_covered():
    assert len(CELLS) == 40
    assert tuple(RC.ARCH_IDS) == tuple(JRC.ARCH_IDS)
    assert [dataclasses.astuple(s) for s in LM_SHAPES.values()] == \
        [dataclasses.astuple(s) for s in JLM_SHAPES.values()]


@pytest.mark.parametrize("arch,shape", CELLS)
def test_cell_cost_equals_the_reference(arch, shape):
    want = jcosts.cell_cost(JRC.get_config(arch), JLM_SHAPES[shape])
    got = costs.cell_cost(RC.get_config(arch), LM_SHAPES[shape])
    assert got.as_dict() == want.as_dict()
    assert want.flops > 0 and want.hbm_bytes > 0


@pytest.mark.parametrize("dtype,size", [(torch.bfloat16, 2),
                                        (torch.float32, 4)])
def test_dtype_size_reads_torch_dtypes(dtype, size):
    cfg = dataclasses.replace(RC.get_config("qwen2-7b"), dtype=dtype)
    assert costs._dtype_size(cfg) == size


@pytest.mark.parametrize("res", [512, 1024])
@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("u8", [True, False])
def test_decoder_model_equals_the_reference(res, fused, u8):
    assert vserve.decoder_flops_per_image(
        M.SD35_VAE, res, fused_upsampler=fused) == \
        jvserve.decoder_flops_per_image(JM.SD35_VAE, res,
                                        fused_upsampler=fused)
    for dsz in (2, 4):
        assert vserve.decoder_bytes_per_image(
            M.SD35_VAE, res, dtype_size=dsz, fused_upsampler=fused,
            uint8_output=u8) == jvserve.decoder_bytes_per_image(
                JM.SD35_VAE, res, dtype_size=dsz, fused_upsampler=fused,
                uint8_output=u8)


def test_decoder_model_defaults_equal_the_references():
    assert vserve.decoder_flops_per_image() == \
        jvserve.decoder_flops_per_image()
    assert vserve.decoder_bytes_per_image() == \
        jvserve.decoder_bytes_per_image()


@pytest.mark.parametrize("shape", sorted(JVAE_SHAPES))
def test_vae_cell_cost_equals_the_reference(shape):
    got = vserve.vae_cell_cost(VAE_SHAPES[shape])
    want = jvserve.vae_cell_cost(JVAE_SHAPES[shape])
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


@pytest.mark.parametrize("res", [512, 1024])
@pytest.mark.parametrize("fused,u8", [(True, True), (False, False)])
def test_decode_ms_estimate(res, fused, u8):
    kw = dict(fused_upsampler=fused, uint8_output=u8)
    assert vserve.decode_ms_estimate(res, **V5E, **kw) == \
        jvserve.decode_ms_estimate(res, **V5E, **kw)
    got = vserve.decode_ms_estimate(res, **kw)
    fl = vserve.decoder_flops_per_image(M.SD35_VAE, res,
                                        fused_upsampler=fused)
    by = vserve.decoder_bytes_per_image(M.SD35_VAE, res,
                                        fused_upsampler=fused,
                                        uint8_output=u8)
    t_comp = fl / (mesh.PEAK_FLOPS_TF32 / 3 * 0.55)
    t_mem = by / mesh.HBM_BW
    assert got == {"flops": fl, "bytes": by, "compute_ms": t_comp * 1e3,
                   "memory_ms": t_mem * 1e3,
                   "decode_ms": max(t_comp, t_mem) * 1e3}


def test_h100_constants():
    assert (mesh.PEAK_FLOPS_BF16, mesh.HBM_BW, mesh.ICI_BW) == \
        (989e12, 3.35e12, 450e9)
    assert (mesh.PEAK_FLOPS_TF32, mesh.PEAK_FLOPS_FP32) == (495e12, 67e12)
    fp32, hbm, _, bf16, tf32 = mesh.card_peaks("NVIDIA H100 80GB HBM3")
    assert (fp32, hbm, bf16, tf32) == (mesh.PEAK_FLOPS_FP32, mesh.HBM_BW,
                                       mesh.PEAK_FLOPS_BF16,
                                       mesh.PEAK_FLOPS_TF32)
    assert mesh.card_peaks("NVIDIA H100 PCIe")[1] == 2.0e12
    assert mesh.card_peaks("NVIDIA H100 NVL")[1] == 3.9e12


@pytest.fixture
def no_world():
    """Whatever process group the test makes is destroyed after it."""
    import torch.distributed as dist
    had = dist.is_initialized()
    yield
    if not had and dist.is_initialized():
        dist.destroy_process_group()


@pytest.mark.parametrize("kw,want", [({}, "256 ranks"),
                                     ({"multi_pod": True}, "512 ranks"),
                                     (None, None)])
def test_mesh_functions(no_world, monkeypatch, kw, want):
    """The production meshes refuse a world of another size, naming both
    numbers (this process is a world of 1); the local mesh is (1, 1)
    ("data", "model") over a world-size-1 gloo group it makes itself."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    if kw is not None:
        with pytest.raises(ValueError, match=f"needs {want}, and the world "
                                             "has 1"):
            mesh.make_production_mesh(**kw)
        return
    m = mesh.make_local_mesh(device="cpu")
    assert m.mesh_dim_names == ("data", "model") and m.shape == (1, 1)
    assert m.device_type == "cpu"
    assert mesh.make_local_mesh(device="cpu").shape == (1, 1)   # reuses it


@dataclasses.dataclass
class _MeshType:
    device_type: str


def test_sharded_decode_step_on_a_local_mesh(no_world, demo_pair):
    """``make_decode_step(cfg, mesh)`` on the (1, 1) mesh: the pixels of
    the unsharded step bit for bit, as a DTensor with the batch's
    placements; a mesh of another device type raises."""
    from torch.distributed.tensor import Shard
    _, tv = demo_pair
    m = mesh.make_local_mesh(device="cpu")
    z = np.random.default_rng(5).standard_normal((2, 8, 8, 4)).astype(
        np.float32)
    got = vserve.make_decode_step(M.DEMO_VAE, m, device="cpu")(tv.decoder, z)
    want = vserve.make_decode_step(M.DEMO_VAE, device="cpu")(tv.decoder, z)
    assert list(got.placements) == [Shard(0), Shard(0)]
    assert torch.equal(got.full_tensor(), want)
    with pytest.raises(ValueError, match="mesh on 'cuda', decode on 'cpu'"):
        vserve.make_decode_step(M.DEMO_VAE, _MeshType("cuda"), device="cpu")


# ---------------------------------------------------------------------------
# the roofline on synthetic dry-run artifacts
# ---------------------------------------------------------------------------

#: (arch, shape, artifact): an LM cell, the VAE cell, a failed cell
ARTIFACTS = [
    ("qwen2-7b", "train_4k", {
        "status": "ok", "devices": 4, "compile_s": 12.5,
        "collectives": {"total_wire_bytes": 3.0e11},
        "memory_analysis": {"peak_memory_in_bytes": 40 * 2 ** 30}}),
    ("sd35_vae", "decode_1k_b256", {
        "status": "ok", "devices": 2, "compile_s": 3.0,
        "collectives": {"total_wire_bytes": 2.0e9},
        "memory_analysis": {"peak_memory_in_bytes": 7 * 2 ** 30}}),
    ("mixtral-8x7b", "long_500k", {"status": "skipped",
                                   "reason": "needs sub-quadratic state"}),
]
#: the peak each cell's compute term divides by: the LM's bf16 on the
#: tensor cores, the VAE's fp32 decode on 3xTF32
CELL_PEAKS = {"qwen2-7b": mesh.PEAK_FLOPS_BF16,
              "sd35_vae": mesh.PEAK_FLOPS_TF32 / 3}


@pytest.fixture
def art_dir(tmp_path):
    for arch, shape, art in ARTIFACTS:
        (tmp_path / f"{arch}__{shape}__single.json").write_text(
            json.dumps(art))
    return str(tmp_path)


@pytest.mark.parametrize("arch,shape", [(a, s) for a, s, _ in ARTIFACTS])
@pytest.mark.parametrize("flash", [False, True])
def test_analyze_cell_scales_the_references_terms(art_dir, arch, shape,
                                                  flash):
    want = jroof.analyze_cell(arch, shape, "single", art_dir, flash)
    got = roofline.analyze_cell(arch, shape, "single", art_dir, flash)
    assert list(got) == list(want)
    assert got["status"] == want["status"]
    if want["status"] != "ok":
        assert got == want
        return
    ratios = {"compute_s": jmesh.PEAK_FLOPS_BF16 / CELL_PEAKS[arch],
              "memory_s": jmesh.HBM_BW / mesh.HBM_BW,
              "collective_s": jmesh.ICI_BW / mesh.ICI_BW}
    for term, ratio in ratios.items():
        # both rounded to 4 decimals: the reference's error scales
        assert got[term] == pytest.approx(want[term] * ratio,
                                          abs=5e-5 * (1 + ratio) + 1e-12)
        assert got[term] > 1e-3                 # not vacuous
    for key in ("chips", "model_flops", "hlo_flops_analytic",
                "useful_flops_ratio", "params_b", "active_params_b",
                "peak_hbm_gb", "compile_s", "collective_gb_per_chip"):
        assert got[key] == want[key], key


def test_peaks_per_cell(art_dir, monkeypatch):
    """The compute term divides by the peak of the cell's precision: the
    VAE's 3xTF32, an LM config's dtype (bf16 on the tensor cores; fp32
    on the CUDA cores, TF32 off)."""
    def compute_s(arch, shape):
        return roofline.analyze_cell(arch, shape, "single",
                                     art_dir)["compute_s"]

    vae = vserve.vae_cell_cost(VAE_SHAPES["decode_1k_b256"])
    assert compute_s("sd35_vae", "decode_1k_b256") == \
        round(vae.flops / (2 * mesh.PEAK_FLOPS_TF32 / 3), 4)
    cfg = RC.get_config("qwen2-7b")
    fp32 = dataclasses.replace(cfg, dtype=torch.float32)
    for c, peak in ((cfg, mesh.PEAK_FLOPS_BF16),
                    (fp32, mesh.PEAK_FLOPS_FP32)):
        monkeypatch.setattr(roofline.RC, "get_config", lambda arch, c=c: c)
        flops = costs.cell_cost(c, LM_SHAPES["train_4k"]).flops
        assert compute_s("qwen2-7b", "train_4k") == \
            round(flops / (4 * peak), 4)


def test_full_and_formatted_table(art_dir):
    want = jroof.full_table("single", art_dir)
    got = roofline.full_table("single", art_dir)
    assert [(r["arch"], r["shape"], r["status"]) for r in got] == \
        [(r["arch"], r["shape"], r["status"]) for r in want]
    assert len(got) == len(ARTIFACTS)
    gl = roofline.format_table(got).splitlines()
    wl = jroof.format_table(want).splitlines()
    assert len(gl) == len(wl) == 2 + len(ARTIFACTS)
    assert gl[:2] == wl[:2]
    for g, w, r in zip(gl[2:], wl[2:], got):
        assert g.split()[:3] == w.split()[:3]
        if r["status"] != "ok":
            assert g == w
    assert roofline.full_table("single", str(pathlib.Path(art_dir) / "x")) \
        == []


def test_roofline_main_prints_the_header(capsys):
    roofline.main([])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].split()[:3] == ["arch", "shape", "mesh"]
    assert set(lines[1]) == {"-"}


# ---------------------------------------------------------------------------
# the decode step and the launcher
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def demo_pair():
    jv = JM.demo_vae(seed=0)
    tree = jax.tree_util.tree_map(np.asarray, jv.decoder)
    return jv, vae_from_numpy(M.DEMO_VAE, tree, device="cpu")


@pytest.mark.parametrize("b,hw", [(1, 8), (2, 8), (3, 5)])
def test_make_decode_step_matches_the_reference(demo_pair, b, hw):
    jv, tv = demo_pair
    z = np.random.default_rng(b * hw).standard_normal(
        (b, hw, hw, 4)).astype(np.float32)
    want = np.asarray(jvserve.make_decode_step(JM.DEMO_VAE)(
        jv.decoder, jnp.asarray(z)))
    got = vserve.make_decode_step(M.DEMO_VAE, device="cpu")(tv.decoder, z)
    assert got.device.type == "cpu" and got.dtype == torch.float32
    assert tuple(got.shape) == want.shape == (b, 2 * hw, 2 * hw, 3)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=2e-5)


def test_entry_points_need_cuda_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    with pytest.raises(RuntimeError, match="CUDA"):
        vserve.make_decode_step(M.DEMO_VAE)
    with pytest.raises(RuntimeError, match="CUDA"):
        tserve.main(["--objects", "2", "--requests", "2"])


#: below the tuner's window of 100 requests, so no window closes: the
#: tuner steps alpha on measured decode and fetch times, so after a
#: window the two launchers' cache partitions, and with them the hit
#: classes, may part ways on timing alone
SMALL = ["--objects", "12", "--requests", "96", "--nodes", "2", "--res",
         "16", "--batch", "8"]


@pytest.fixture(scope="module")
def launched():
    """The JAX launcher and the port's on the same decoder and encoder
    weights (the reference's seed-0 demo VAE, bridged), at ``SMALL``:
    (printed lines, every request's result, the box's summary) of each."""
    mp = pytest.MonkeyPatch()
    boxes, recorded = [], []

    class Recording(jserve.LatentBox):
        def __init__(self, backend):
            super().__init__(backend)
            boxes.append(self)

        def get_many(self, oids):
            out = super().get_many(oids)
            recorded.extend(out)
            return out

    jv = JM.VAE(JM.DEMO_VAE, seed=0)
    mp.setattr(jserve, "LatentBox", Recording)
    mp.setattr(jserve, "VAE", lambda cfg, seed: jv)
    mp.setattr(sys, "argv", ["serve"] + SMALL)
    jout = io.StringIO()
    try:
        with contextlib.redirect_stdout(jout):
            jserve.main()
    finally:
        mp.undo()
    tv = vae_from_numpy(M.DEMO_VAE,
                        jax.tree_util.tree_map(np.asarray, jv.decoder),
                        jax.tree_util.tree_map(np.asarray, jv.encoder),
                        device="cpu")
    tout = io.StringIO()
    with contextlib.redirect_stdout(tout):
        box, results = tserve.run(
            tserve.parse_args(SMALL + ["--device", "cpu"]), vae=tv)
    return ((jout.getvalue().splitlines(), recorded, boxes[0].summary()),
            (tout.getvalue().splitlines(), results, box.summary()))


def test_launcher_serves_the_same_trace(launched):
    (_, want, _), (_, got, _) = launched
    assert len(got) == len(want) == 96
    assert [r.oid for r in got] == [r.oid for r in want]
    assert [(r.hit_class, r.node) for r in got] == \
        [(r.hit_class, r.node) for r in want]
    assert len({r.hit_class for r in got}) >= 2


def test_launcher_counts_equal_the_references(launched):
    (jlines, _, js), (tlines, _, ts) = launched
    assert ts["decodes"] > 0
    for key in ("decodes", "decode_batches", "coalesced_decodes",
                "image_hit", "latent_hit", "full_miss", "spilled", "alpha",
                "image_hit_frac", "decode_frac"):
        assert ts[key] == js[key], key
    # the put line, the hit line and the decode line; the timing line
    # names the device and its own wall time
    assert len(tlines) == len(jlines) == 5
    for i in (0, 3, 4):
        assert tlines[i] == jlines[i]
    assert "ms/req on CPU, window=8" in tlines[2]


def test_launcher_stores_the_references_latent_bytes(launched):
    """Recipe puts encode on each side: the port's latents may differ
    from the reference's by one fp16 ulp at rounding edges (ROADMAP C),
    which can move a compressed blob by a few bytes."""
    (jlines, _, _), (tlines, _, _) = launched
    mean = [float(ln.split()[4]) for ln in (jlines[1], tlines[1])]
    assert tlines[1].split()[5:] == jlines[1].split()[5:]
    assert mean[1] == pytest.approx(mean[0], rel=0.01)


def test_launcher_pixels_within_one_lsb(launched):
    (_, want, _), (_, got, _) = launched
    for a, b in zip(want, got):
        assert b.payload.shape == (16, 16, 3) and b.payload.dtype == np.uint8
        assert np.abs(np.asarray(a.payload).astype(np.int16)
                      - b.payload.astype(np.int16)).max() <= 1


def test_launcher_prints_the_references_lines(capsys):
    tserve.main(["--objects", "4", "--requests", "16", "--res", "16",
                 "--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 5 and all(ln.startswith("[serve] ")
                                   for ln in lines)
    assert "ms/req on CPU, window=8" in lines[2]


def run_example(name, *args):
    return subprocess.run([sys.executable, str(ROOT / "examples" / name),
                           *args], capture_output=True, text=True,
                          timeout=300, cwd=ROOT,
                          env={**os.environ,
                               "PYTHONPATH": str(ROOT / "src"),
                               # this module's thread cap, for the child
                               # and the launcher it starts
                               "OMP_NUM_THREADS": "2"})


def test_quickstart_example_on_the_cpu():
    out = run_example("quickstart_torch.py", "--device", "cpu")
    assert out.returncode == 0, out.stderr
    assert "regenerated bit-exactly" in out.stdout
    assert out.stdout.strip().endswith("latent-first roundtrip OK on cpu")


def test_adaptive_cache_demo_is_the_reference_example():
    """``examples/adaptive_cache_demo_torch.py`` is the JAX package's
    example with its imports rewritten (``repro.`` -> ``repro_torch.``)
    and nothing else, and prints what the reference's prints."""
    ref = (ROOT / "examples" / "adaptive_cache_demo.py").read_text()
    port = (ROOT / "examples" / "adaptive_cache_demo_torch.py").read_text()
    assert "from repro." in ref
    assert port == ref.replace("from repro.", "from repro_torch.")
    got = run_example("adaptive_cache_demo_torch.py")
    want = run_example("adaptive_cache_demo.py")
    assert got.returncode == want.returncode == 0, got.stderr + want.stderr
    assert got.stdout == want.stdout
    assert got.stdout.splitlines()[0].startswith("phase 1:")


def test_serve_trace_replay_example_on_the_cpu():
    out = run_example("serve_trace_replay_torch.py", "--device", "cpu")
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert lines[0] == "[serve] putting 50 generated images -> latents"
    assert "600 requests" in lines[2]
