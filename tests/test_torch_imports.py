"""Import guards of the port: ``repro_torch`` imports neither JAX nor the
JAX package, and its copies of the JAX-free modules stay verbatim copies
with only their import paths rewritten."""

import pathlib
import re
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
REF = ROOT / "src" / "repro"

#: modules the port copies from the JAX package with imports rewritten
COPIED = ["compression/latentcodec.py", "compression/ladder.py",
          "core/latent_store.py", "core/dual_cache.py", "core/tuner.py",
          "core/router.py", "core/regen_tier.py", "core/cost_model.py",
          "core/autoscale.py", "store/api.py", "store/tiers.py",
          "store/walk.py", "configs/shapes.py", "configs/granite_8b.py",
          "configs/kimi_k2.py", "configs/mixtral_8x7b.py",
          "configs/phi4_mini.py", "configs/qwen2_7b.py",
          "configs/qwen2_vl_72b.py", "configs/qwen3_14b.py",
          "configs/rwkv6_7b.py", "configs/whisper_large_v3.py",
          "configs/zamba2_2p7b.py"]
FORBIDDEN = re.compile(r"^\s*(import jax|from jax|import repro\.|from repro\.|"
                       r"import repro\s*$|from repro import)", re.M)


def port_modules():
    for f in sorted(PORT.rglob("*.py")):
        rel = f.relative_to(PORT.parent).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        yield ".".join(parts)


def test_every_module_imports_without_jax_or_repro():
    mods = list(port_modules())
    assert len(mods) > 20
    code = ("import sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['repro'] = None\n"
            "import importlib\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "loaded = [k for k, v in sys.modules.items() if v is not None]\n"
            "assert not any(k == 'jax' or k.startswith(('jax.', 'repro.'))\n"
            "               for k in loaded)\n"
            "print('ok')\n")
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"}
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


@pytest.mark.parametrize("path", sorted(
    [str(p.relative_to(ROOT)) for p in PORT.rglob("*.py")]
    + ["chip_smoke.py", "chip_compare.py"]))
def test_no_jax_or_repro_import_in_source(path):
    text = (ROOT / path).read_text()
    assert not FORBIDDEN.search(text), path


@pytest.mark.parametrize("rel", COPIED)
def test_copied_module_is_verbatim_with_rewritten_imports(rel):
    ref = (REF / rel).read_text()
    rewritten = re.sub(r"^(\s*)(from|import) repro\.", r"\1\2 repro_torch.",
                       ref, flags=re.M)
    assert (PORT / rel).read_text() == rewritten
