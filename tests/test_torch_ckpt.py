"""The port's checkpoints (``repro_torch.ckpt.checkpoint``) on the CPU:
round trip and resume, atomicity, pruning, the async snapshot, shape
and key checks, the injectable clock, and files read across the two
packages (a flat tree with a bf16 leaf written by the JAX package's
``CheckpointManager`` reads back in the port, and the other way round),
with the JAX package's key strings."""

import json
import os
from typing import NamedTuple

import ml_dtypes
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro.ckpt.checkpoint import CheckpointManager as JaxCheckpointManager
from repro_torch.ckpt.checkpoint import CheckpointManager
from repro_torch.train.tree import flatten_with_paths, leaves, treedef_str

torch.set_num_threads(2)


class State(NamedTuple):
    step: object
    m: object


def tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"params": {"embed": torch.randn((5, 3), generator=g),
                       "layers": [{"w": torch.randn((3, 3), generator=g)
                                   .to(torch.bfloat16)} for _ in range(2)]},
            "opt": State(torch.tensor(seed, dtype=torch.int32),
                         {"m": torch.randn((4,), generator=g)})}


def same(a, b):
    assert [p for p, _ in flatten_with_paths(a)] == \
        [p for p, _ in flatten_with_paths(b)]
    for x, y in zip(leaves(a), leaves(b)):
        assert x.dtype == y.dtype and torch.equal(x, y)


def test_keys_are_jax_keystrs():
    t = tree()
    jt = {"params": {"embed": jnp.zeros((5, 3)),
                     "layers": [{"w": jnp.zeros((3, 3))} for _ in range(2)]},
          "opt": State(jnp.zeros((), jnp.int32), {"m": jnp.zeros(4)})}
    flat, treedef = jax.tree_util.tree_flatten_with_path(jt)
    assert [p for p, _ in flatten_with_paths(t)] == \
        [jax.tree_util.keystr(p) for p, _ in flat]
    assert treedef_str(t) == str(treedef)


def test_round_trip_and_resume(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep_last=3)
    assert mgr.latest_step() is None
    with pytest.raises(FileNotFoundError):
        mgr.restore(tree())
    mgr.save(5, tree(5), extra={"data_step": 5})
    mgr.save(7, tree(7), blocking=False)
    mgr.wait()
    assert mgr.all_steps() == [5, 7]
    got, step = mgr.restore(tree(0))
    assert step == 7
    same(got, tree(7))
    got, step = mgr.restore(tree(0), step=5)
    same(got, tree(5))
    with open(tmp_path / "step_000000005" / "manifest.json") as f:
        man = json.load(f)
    assert man["extra"] == {"data_step": 5} and man["step"] == 5
    by_key = {e["key"]: e for e in man["leaves"]}
    assert [e["key"] for e in man["leaves"]] == \
        [p for p, _ in flatten_with_paths(tree())]
    assert by_key["['opt'].step"]["dtype"] == "int32"
    bf16 = by_key["['params']['layers'][1]['w']"]
    assert bf16["dtype"] == "bfloat16" and bf16["file"] == "arr_00004.npy"
    assert np.load(tmp_path / "step_000000005" / bf16["file"]).dtype == \
        np.uint16


def test_restore_casts_to_the_template_and_checks_it(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"a": torch.arange(6.0).reshape(2, 3)})
    got, _ = mgr.restore({"a": torch.zeros((2, 3), dtype=torch.float64)},
                         device="cpu")
    assert got["a"].dtype == torch.float64 and got["a"].device.type == "cpu"
    with pytest.raises(ValueError, match=r"shape mismatch for \['a'\]"):
        mgr.restore({"a": torch.zeros((3, 2))})
    with pytest.raises(KeyError, match=r"missing leaf \['b'\]"):
        mgr.restore({"a": torch.zeros((2, 3)), "b": torch.zeros(1)})
    got, _ = mgr.restore({"a": np.zeros((2, 3), np.float32)})
    assert isinstance(got["a"], np.ndarray)


def test_uncommitted_and_tmp_dirs_are_ignored(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(3, tree(3))
    # a writer stopped before its rename, and one before its marker
    os.makedirs(tmp_path / "step_000000009.tmp")
    os.makedirs(tmp_path / "step_000000008")
    np.save(tmp_path / "step_000000008" / "arr_00000.npy", np.zeros(1))
    assert mgr.all_steps() == [3] and mgr.latest_step() == 3
    same(mgr.restore(tree(0))[0], tree(3))
    # a save over a stale tmp dir replaces it
    mgr.save(9, tree(9))
    assert mgr.all_steps() == [3, 9]
    assert not (tmp_path / "step_000000009.tmp").exists()


def test_keep_last_prunes(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep_last=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, {"x": torch.full((2,), float(s))}, blocking=s % 2 == 0)
    mgr.wait()
    assert mgr.all_steps() == [3, 4]
    assert sorted(os.listdir(tmp_path)) == ["step_000000003",
                                            "step_000000004"]


def test_async_save_snapshots_before_the_next_update(tmp_path):
    """The next step updates the parameters in place while the write
    runs: the checkpoint holds the values at ``save``."""
    mgr = CheckpointManager(str(tmp_path))
    t = {"w": torch.ones(1000), "b": torch.ones(10).to(torch.bfloat16)}
    mgr.save(1, t, blocking=False)
    with torch.no_grad():
        t["w"].mul_(5.0)
        t["b"].add_(3.0)
    mgr.wait()
    got, _ = mgr.restore(t)
    assert torch.equal(got["w"], torch.ones(1000))
    assert torch.equal(got["b"], torch.ones(10).to(torch.bfloat16))


def test_clock_stamps_manifest_and_marker(tmp_path):
    ticks = iter([100.0, 101.5])
    mgr = CheckpointManager(str(tmp_path), clock=lambda: next(ticks))
    mgr.save(2, {"x": torch.zeros(1)})
    d = tmp_path / "step_000000002"
    assert json.loads((d / "manifest.json").read_text())["created"] == 100.0
    assert (d / "_COMMITTED").read_text() == "101.5"


def flat_values():
    r = np.random.default_rng(4)
    return {"a": r.standard_normal((3, 4)).astype(np.float32),
            "b": r.standard_normal((5,)).astype(np.float32),
            "c": np.arange(6, dtype=np.int32).reshape(2, 3)}


def test_reference_checkpoint_reads_in_the_port(tmp_path):
    v = flat_values()
    jtree = {"a": jnp.asarray(v["a"]),
             "b": jnp.asarray(v["b"]).astype(jnp.bfloat16),
             "c": jnp.asarray(v["c"])}
    JaxCheckpointManager(str(tmp_path)).save(11, jtree)
    template = {"a": torch.zeros((3, 4)),
                "b": torch.zeros((5,), dtype=torch.bfloat16),
                "c": torch.zeros((2, 3), dtype=torch.int32)}
    got, step = CheckpointManager(str(tmp_path)).restore(template)
    assert step == 11
    assert torch.equal(got["a"], torch.from_numpy(v["a"]))
    assert torch.equal(got["b"], torch.from_numpy(v["b"]).to(torch.bfloat16))
    assert torch.equal(got["c"], torch.from_numpy(v["c"]))


def test_port_checkpoint_reads_in_the_reference(tmp_path):
    v = flat_values()
    ttree = {"a": torch.from_numpy(v["a"]),
             "b": torch.from_numpy(v["b"]).to(torch.bfloat16),
             "c": torch.from_numpy(v["c"])}
    CheckpointManager(str(tmp_path)).save(12, ttree)
    template = {"a": jnp.zeros((3, 4)), "b": jnp.zeros((5,), jnp.bfloat16),
                "c": jnp.zeros((2, 3), jnp.int32)}
    got, step = JaxCheckpointManager(str(tmp_path)).restore(template)
    assert step == 12
    np.testing.assert_array_equal(np.asarray(got["a"]), v["a"])
    assert got["b"].dtype == jnp.bfloat16
    np.testing.assert_array_equal(np.asarray(got["b"]),
                                  v["b"].astype(ml_dtypes.bfloat16))
    np.testing.assert_array_equal(np.asarray(got["c"]), v["c"])
