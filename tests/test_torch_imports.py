"""Import guards of the port: ``repro_torch`` imports neither JAX nor the
JAX package, and its copies of the JAX-free modules stay verbatim copies
with only their import paths rewritten.  ``store/sharding.py`` is a copy
with one classmethod adapted (``ShardedLatentBox.engine`` takes
``device=``): it is held to the reference function by function."""

import ast
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
          "compression/lossy.py", "compression/metrics.py",
          "compression/png_proxy.py", "launch/costs.py",
          "core/latent_store.py", "core/dual_cache.py", "core/tuner.py",
          "core/router.py", "core/regen_tier.py", "core/cost_model.py",
          "core/autoscale.py", "core/policies.py", "core/metrics.py",
          "core/cluster.py", "core/replay.py", "store/api.py",
          "store/tiers.py",
          "store/walk.py", "store/faults.py", "store/replication.py",
          "store/durable/__init__.py", "store/durable/segment.py",
          "store/durable/log.py", "store/durable/compact.py",
          "store/durable/backend.py", "trace/__init__.py", "trace/synth.py",
          "serve/runtime/__init__.py", "serve/runtime/events.py",
          "serve/runtime/qos.py", "serve/runtime/admission.py",
          "serve/runtime/runtime.py", "configs/shapes.py",
          "configs/granite_8b.py",
          "configs/kimi_k2.py", "configs/mixtral_8x7b.py",
          "configs/phi4_mini.py", "configs/qwen2_7b.py",
          "configs/qwen2_vl_72b.py", "configs/qwen3_14b.py",
          "configs/rwkv6_7b.py", "configs/whisper_large_v3.py",
          "configs/zamba2_2p7b.py", "data/__init__.py",
          "data/synthetic.py"]
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
    assert {"repro_torch.models.encdec", "repro_torch.models.blocks",
            "repro_torch.models.lm", "repro_torch.models.bridge",
            "repro_torch.data.synthetic", "repro_torch.train.optim",
            "repro_torch.train.train_step", "repro_torch.train.trainer",
            "repro_torch.train.grad_compress", "repro_torch.train.tree",
            "repro_torch.ckpt.checkpoint",
            "repro_torch.launch.train", "repro_torch.dist",
            "repro_torch.dist.sharding"} <= set(mods)
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
    + ["chip_smoke.py", "chip_compare.py", "examples/quickstart_torch.py",
       "examples/serve_trace_replay_torch.py",
       "examples/train_tiny_lm_torch.py",
       "examples/adaptive_cache_demo_torch.py"]))
def test_no_jax_or_repro_import_in_source(path):
    text = (ROOT / path).read_text()
    assert not FORBIDDEN.search(text), path


def rewritten(rel):
    """The reference module's text with ``repro.`` imports rewritten."""
    return re.sub(r"^(\s*)(from|import) repro\.", r"\1\2 repro_torch.",
                  (REF / rel).read_text(), flags=re.M)


@pytest.mark.parametrize("rel", COPIED)
def test_copied_module_is_verbatim_with_rewritten_imports(rel):
    assert (PORT / rel).read_text() == rewritten(rel)


#: the one function of ``store/sharding.py`` the port adapts
ADAPTED = "ShardedLatentBox.engine"


def functions(text):
    """Every function of a module (methods by ``Class.name``) -> its
    node."""
    out = {}
    for node in ast.parse(text).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out[node.name] = node
        elif isinstance(node, ast.ClassDef):
            for sub in node.body:
                if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    out[f"{node.name}.{sub.name}"] = sub
    return out


SHARDING = "store/sharding.py"
SHARDING_FUNCTIONS = sorted(functions(rewritten(SHARDING)))


@pytest.mark.parametrize("name", SHARDING_FUNCTIONS)
def test_sharding_function_matches_the_reference(name):
    ref = functions(rewritten(SHARDING))[name]
    port = functions((PORT / SHARDING).read_text()).get(name)
    assert port is not None, name
    if name != ADAPTED:
        assert ast.dump(port) == ast.dump(ref), name
        return
    # the adapted classmethod: the reference's, plus a ``device`` keyword
    # passed on to every shard's EngineBackend
    assert [a.arg for a in port.args.kwonlyargs] == \
        [a.arg for a in ref.args.kwonlyargs] + ["device"]
    calls = [n for n in ast.walk(port) if isinstance(n, ast.Call)
             and getattr(n.func, "id", None) == "EngineBackend"]
    assert calls and all(any(k.arg == "device" for k in c.keywords)
                         for c in calls)


def test_sharding_differs_only_inside_the_adapted_function():
    """Outside ``ShardedLatentBox.engine`` the text is the reference's,
    comments and docstrings included, and no function was added."""
    def cut(text):
        node = functions(text)[ADAPTED]
        lines = text.splitlines()
        first = min([node.lineno] + [d.lineno for d in node.decorator_list])
        return lines[:first - 1] + lines[node.end_lineno:]
    port = (PORT / SHARDING).read_text()
    assert sorted(functions(port)) == SHARDING_FUNCTIONS
    assert cut(port) == cut(rewritten(SHARDING))
