"""The port's durable store on the CPU: the segment log, its recovery and
``LatentBox.open``, held to the JAX package's.

The log modules are verbatim copies of the reference's
(``tests/test_torch_imports.py``), so these cases check what a copy
alone does not: the port writes the reference's bytes (record by record
and segment file by segment file), it recovers every acknowledged put
after a torn tail, a lost manifest, a compaction or a real process kill,
its engine box reopens bit-exact on its own decode path, and a box the
JAX package wrote and closed opens in the port with every blob
byte-equal and every read within +-1 LSB of the reference's reads of it.
The kill-mid-write property covers ``n_acked = 0`` with its own helper
(no segment is open before the first put).
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

import jax
import torch

from hypothesis import given, settings
from hypothesis import strategies as st

from repro.store import LatentBox as JaxBox
from repro.store import StoreConfig as JaxStoreConfig
from repro.store.durable import SegmentLog as JaxSegmentLog
from repro.store.durable import segment as jseg
from repro.vae.model import demo_vae as jax_demo_vae
from repro_torch.compression.latentcodec import compress_latent
from repro_torch.core.regen_tier import Recipe
from repro_torch.store import LatentBox, StoreConfig
from repro_torch.store.durable import (BLOB, RSTATE, SIZE, TOMB, Compactor,
                                       SegmentLog, SegmentLogBackend,
                                       pack_record, scan_records)
from repro_torch.store.durable.log import MANIFEST
from repro_torch.vae import model as M
from repro_torch.vae.bridge import vae_from_numpy

torch.set_num_threads(2)

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")
LATENT_HWC = (8, 8, 4)


def blob_of(oid: int) -> bytes:
    return np.random.default_rng(oid).bytes(40 + (oid * 13) % 64)


def latent_of(oid: int) -> np.ndarray:
    rng = np.random.default_rng(1000 + oid)
    return rng.standard_normal(LATENT_HWC).astype(np.float16)


def small_cfg(**kw):
    return StoreConfig(n_nodes=2, cache_bytes_per_node=2e4,
                       image_bytes=768.0, latent_bytes=6e2, **kw)


@pytest.fixture(scope="module")
def vaes():
    jv = jax_demo_vae(seed=0)
    return jv, vae_from_numpy(
        M.DEMO_VAE, jax.tree_util.tree_map(np.asarray, jv.decoder),
        jax.tree_util.tree_map(np.asarray, jv.encoder), device="cpu")


def seg_files(path):
    return sorted(f for f in os.listdir(path) if f.startswith("seg-"))


# ---------------------------------------------------------------------------
# the record format: the reference's bytes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind,payload", [
    (BLOB, b"payload-bytes"), (SIZE, b"12345678"), (TOMB, b""),
    (RSTATE, b'{"recipe": null}')])
def test_record_roundtrip_is_the_reference_bytes(kind, payload):
    raw = pack_record(7, kind, 42, payload)
    assert raw == jseg.pack_record(7, kind, 42, payload)
    (r,), end = scan_records(raw)
    assert end == len(raw)
    assert (r.lsn, r.kind, r.oid, r.payload) == (7, kind, 42, payload)


@pytest.mark.parametrize("damage", ["flip", "cut1", "cut10", "cut_last",
                                    "magic"])
def test_scan_stops_at_a_torn_or_corrupt_tail(damage):
    a = pack_record(1, SIZE, 1, b"12345678")
    b = bytearray(pack_record(2, BLOB, 2, b"x" * 100))
    if damage == "flip":
        b[-1] ^= 0xFF
    elif damage == "magic":
        b[:4] = b"NOPE"
    else:
        b = b[:{"cut1": 1, "cut10": 10, "cut_last": len(b) - 1}[damage]]
    recs, end = scan_records(bytes(a + b))
    assert [r.lsn for r in recs] == [1] and end == len(a)
    jrecs, jend = jseg.scan_records(bytes(a + b))
    assert [dataclasses.astuple(r) for r in recs] == \
        [dataclasses.astuple(r) for r in jrecs] and jend == end


def churn(log):
    """Overwrites, size registrations, a tombstone and recipe records
    over several small segments."""
    for rnd in range(3):
        for oid in range(10):
            log.put_blob(oid, blob_of(oid) + bytes([rnd]))
    log.put_size(20, 999.0)
    log.tombstone(3)
    log.put_recipe_state(5, {"recipe": {"seed": 5}, "recipe_nbytes": 44.0,
                             "latent_bytes": None, "last_access_mo": 2.0})


@pytest.mark.parametrize("compact", [False, True])
def test_segment_files_byte_equal_to_the_reference(tmp_path, compact):
    """The same operations through both packages leave the same files:
    every segment, and the manifest, byte for byte."""
    dirs = []
    for name, cls in (("jax", JaxSegmentLog), ("port", SegmentLog)):
        path = str(tmp_path / name)
        log = cls(path, segment_bytes=256, checkpoint_every=10**9)
        churn(log)
        log.flush()
        if compact:
            from repro.store.durable import Compactor as JaxCompactor
            comp = Compactor if cls is SegmentLog else JaxCompactor
            assert comp(log, live_frac_threshold=1.0).compact_all() > 0
        log.close()
        dirs.append(path)
    names = sorted(os.listdir(dirs[0]))
    assert names == sorted(os.listdir(dirs[1])) and MANIFEST in names
    assert len(seg_files(dirs[0])) > 1
    for f in names:
        with open(os.path.join(dirs[0], f), "rb") as a, \
                open(os.path.join(dirs[1], f), "rb") as b:
            assert a.read() == b.read(), f


# ---------------------------------------------------------------------------
# recovery of the segment log
# ---------------------------------------------------------------------------

def check_recovery(path: str, acked) -> None:
    log = SegmentLog(path)
    for oid in acked:
        assert log.get_blob(oid) == blob_of(oid), f"oid {oid} corrupted"
    log.close()


@pytest.mark.parametrize("loss", ["missing", "corrupt"])
def test_manifest_loss_recovers_by_full_scan(tmp_path, loss):
    path = str(tmp_path / "log")
    log = SegmentLog(path, segment_bytes=256)
    for oid in range(8):
        log.put_blob(oid, blob_of(oid))
    log.close()
    man = os.path.join(path, MANIFEST)
    if loss == "missing":
        os.remove(man)
    else:
        with open(man, "w") as f:
            f.write("{not json")
    log2 = SegmentLog(path)
    assert not log2.recovery_stats["from_manifest"]
    assert log2.recovery_stats["scanned_records"] == 8
    log2.close()
    check_recovery(path, range(8))


@pytest.mark.parametrize("sweep", ["online", "all"])
def test_compaction_keeps_every_live_record(tmp_path, sweep):
    """Online steps (the serving loop's, until no segment is under the
    live-fraction threshold) or one full sweep."""
    path = str(tmp_path / "log")
    log = SegmentLog(path, segment_bytes=256, checkpoint_every=10**9)
    churn(log)
    log.flush()
    before = {oid: log.get_blob(oid) for oid in log.object_oids()}
    disk = log.on_disk_bytes
    if sweep == "online":
        comp = Compactor(log, live_frac_threshold=0.6)
        steps = [comp.step() for _ in range(40)]
        assert steps[-1] == 0          # it reaches its steady state
    else:
        comp = Compactor(log, live_frac_threshold=1.0)
        comp.compact_all()
    assert comp.stats.segments_compacted > 0
    assert log.on_disk_bytes < disk and log.write_amplification >= 1.0
    assert {oid: log.get_blob(oid) for oid in log.object_oids()} == before
    assert log.recipe_states()[5]["recipe"]["seed"] == 5
    log.close()
    log2 = SegmentLog(path)
    assert {oid: log2.get_blob(oid) for oid in log2.object_oids()} == before
    assert not log2.contains_object(3) and log2.size_of(20) == 999.0
    log2.close()


def acked_then_torn(path: str, n_acked: int, n_unacked: int) -> int:
    """Flush ``n_acked`` puts, append ``n_unacked`` more, drop the file
    handle without a seal or a manifest (a hard kill), and return the
    acknowledged byte length of the last segment: 0 when nothing was
    acknowledged, since then no segment was open at the flush."""
    log = SegmentLog(path, segment_bytes=10**9, checkpoint_every=10**9)
    for oid in range(n_acked):
        log.put_blob(oid, blob_of(oid))
    log.flush()
    acked_len = log._seg_len.get(log._active_id, 0)
    for oid in range(n_acked, n_acked + n_unacked):
        log.put_blob(oid, blob_of(oid))
    log.flush()
    if log._active_f is not None:
        log._active_f.close()
    return acked_len


def cut_tail(path: str, frac: float, acked_len: int) -> None:
    segs = seg_files(path)
    if not segs:
        return
    tail = os.path.join(path, segs[-1])
    total = os.path.getsize(tail)
    with open(tail, "r+b") as f:
        f.truncate(acked_len + int(frac * (total - acked_len)))


@given(n_acked=st.integers(0, 8), n_unacked=st.integers(0, 4),
       frac=st.floats(0.0, 1.0))
@settings(max_examples=40, deadline=None)
def test_property_kill_mid_write_keeps_every_acked_put(tmp_path_factory,
                                                       n_acked, n_unacked,
                                                       frac):
    path = str(tmp_path_factory.mktemp("crash") / "log")
    acked_len = acked_then_torn(path, n_acked, n_unacked)
    cut_tail(path, frac, acked_len)
    check_recovery(path, range(n_acked))
    log = SegmentLog(path)             # the torn tail is gone, not served
    assert set(log.object_oids()) <= set(range(n_acked + n_unacked))
    log.close()


@pytest.mark.parametrize("n_acked", [0, 1, 6])
def test_kill_mid_write_every_cut(tmp_path, n_acked):
    """The property's corners, one by one: nothing acked, one, several;
    cut at the acked prefix, inside the next header, and mid-record."""
    for frac in (0.0, 0.01, 0.5, 0.99, 1.0):
        path = str(tmp_path / f"log{frac}")
        acked_len = acked_then_torn(path, n_acked, 3)
        cut_tail(path, frac, acked_len)
        check_recovery(path, range(n_acked))


_CHILD = r"""
import os, sys
sys.path.insert(0, {src!r})
import numpy as np
from repro_torch.store.durable import SegmentLog

def blob_of(oid):
    return np.random.default_rng(oid).bytes(40 + (oid * 13) % 64)

log = SegmentLog({path!r}, segment_bytes=10**9)
for oid in range(6):
    log.put_blob(oid, blob_of(oid))
log.flush()
print("ACKED", flush=True)
for oid in range(6, 400):
    log.put_blob(oid, blob_of(oid))
os._exit(9)
"""


def test_real_process_kill_mid_stream(tmp_path):
    path = str(tmp_path / "log")
    code = _CHILD.format(src=os.path.abspath(SRC), path=path)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120)
    assert "ACKED" in proc.stdout and proc.returncode == 9, proc.stderr
    check_recovery(path, range(6))


def test_segment_backend_acks_each_put(tmp_path):
    b = SegmentLogBackend.open(str(tmp_path / "d"), flush_each_put=True)
    b.put_blob(1, b"abc")
    b.put_size(2, 55.0)
    b.delete(2)
    cold = SegmentLog(str(tmp_path / "d"))   # a restarted reader
    assert cold.get_blob(1) == b"abc" and not cold.contains_object(2)
    cold.close()
    b.close()


# ---------------------------------------------------------------------------
# LatentBox.open on the port's engine
# ---------------------------------------------------------------------------

def test_engine_box_hard_kill_reopens_bit_exact(tmp_path, vaes):
    """No close, the manifest lost, garbage after the last record: every
    acknowledged object decodes to the same pixels on reopen."""
    _, tv = vaes
    path = str(tmp_path / "box")
    box = LatentBox.open(path, vae=tv, config=small_cfg(), device="cpu")
    for oid in range(6):
        r = box.put(oid, recipe=Recipe(seed=700 + oid, height=16, width=16))
        assert r.durable
    box.put(6, latent=latent_of(6))
    assert box.demote(2)
    baseline = {oid: box.get(oid).payload for oid in range(7)}
    assert box.demote(2)               # recipe-only again at the kill
    ddir = box.backend.durable_log.path
    with open(os.path.join(ddir, seg_files(ddir)[-1]), "ab") as f:
        f.write(b"LBS1" + b"\x99" * 17)
    if os.path.exists(os.path.join(ddir, MANIFEST)):
        os.remove(os.path.join(ddir, MANIFEST))
    del box

    box2 = LatentBox.open(path, vae=tv, config=small_cfg(), device="cpu")
    rs = box2.backend.durable_log.recovery_stats
    assert rs["torn_tail_bytes"] == 21 and not rs["from_manifest"]
    assert box2.stat(2).demoted
    for oid in range(7):
        r = box2.get(oid)
        assert r.hit_class == ("regen_miss" if oid == 2 else "full_miss")
        np.testing.assert_array_equal(r.payload, baseline[oid])
    box2.close()


def test_close_and_reopen_serves_the_same_bytes(tmp_path, vaes):
    """A clean close and reopen: the same blobs and pixels; a lossy
    demotion still pending at the close stays pending and is transcoded
    by the reopened box's first compaction (the active segment was
    sealed by the close)."""
    _, tv = vaes
    path = str(tmp_path / "box")
    with LatentBox.open(path, vae=tv, config=small_cfg(),
                        device="cpu") as box:
        for oid in range(5):
            box.put(oid, latent=latent_of(oid))
        assert box.demote(4, "low")
        box.flush()
        first = {r.oid: r.payload for r in box.get_many(list(range(5)))}
        blobs = {oid: box.backend.store.get(oid) for oid in range(5)}
        assert box.stat(4).rung == 0 and box.stat(4).target_rung == 3
        summ = box.summary()
    assert summ["durable_disk_bytes"] >= summ["durable_live_bytes"] > 0
    assert summ["pending_rungs"] == 1
    with LatentBox.open(path, vae=tv, config=small_cfg(),
                        device="cpu") as box:
        assert box.backend.durable_log.recovery_stats["from_manifest"]
        assert {oid: box.backend.store.get(oid) for oid in range(5)} == blobs
        assert box.stat(4).target_rung == 3
        for r in box.get_many(list(range(4))):
            np.testing.assert_array_equal(r.payload, first[r.oid])
        assert box.stat(4).rung == 3 and box.stat(4).rung_name == "low"
        assert box.summary()["reencoded_records"] == 1
        assert box.backend.store.get(4) != blobs[4]


def test_write_behind_acks_at_flush(tmp_path, vaes):
    _, tv = vaes
    path = str(tmp_path / "box")
    box = LatentBox.open(path, vae=tv, config=small_cfg(write_behind=True),
                         device="cpu")
    assert not box.put(0, latent=latent_of(0)).durable
    box.flush()
    log = box.backend.durable_log
    acked_len = log._seg_len[log._active_id]
    box.put(1, latent=latent_of(1))
    log._active_f.flush()
    cut_tail(log.path, 0.0, acked_len)  # the unflushed put never landed
    del box
    box2 = LatentBox.open(path, vae=tv, config=small_cfg(), device="cpu")
    assert 0 in box2 and 1 not in box2
    box2.close()


def test_box_written_by_the_jax_package_opens_in_the_port(tmp_path, vaes):
    """The reference writes, serves, closes; the port reopens the same
    directory: every blob byte-equal, every read within +-1 LSB."""
    jv, tv = vaes
    path = str(tmp_path / "box")
    jcfg = JaxStoreConfig(n_nodes=2, cache_bytes_per_node=2e4,
                          image_bytes=768.0, latent_bytes=6e2)
    with JaxBox.open(path, vae=jv, config=jcfg) as jbox:
        for oid in range(6):
            jbox.put(oid, latent=latent_of(oid))
        jbox.put(6, recipe=Recipe(seed=7, height=16, width=16))
        assert jbox.demote(6)
        jblobs = {oid: jbox.backend.store.get(oid) for oid in range(6)}
        jpix = {r.oid: r.payload for r in jbox.get_many(list(range(7)))}
        assert jbox.demote(6)
    with LatentBox.open(path, vae=tv, config=small_cfg(),
                        device="cpu") as box:
        assert box.stat(6).demoted
        for oid in range(6):
            assert box.backend.store.get(oid) == jblobs[oid]
            assert jblobs[oid] == compress_latent(latent_of(oid))
        for r in box.get_many(list(range(7))):
            d = np.abs(r.payload.astype(np.int16)
                       - jpix[r.oid].astype(np.int16))
            assert r.payload.shape == (16, 16, 3) and d.max() <= 1, r.oid


def test_bf16_pixels_identical_across_flush_and_reopen(tmp_path):
    """Counterpart of ``tests/test_quantize.py``'s
    ``TestQuantizedPersistence``: a bf16-weight box (behind its gate)
    serves the same bytes before and after a reopen."""
    vae = M.demo_vae(seed=0, device="cpu", weight_dtype="bfloat16")
    cfg = StoreConfig(n_nodes=1, cache_bytes_per_node=1e5, adaptive=False,
                      decode_buckets=(1, 2), weight_dtype="bfloat16")
    rng = np.random.default_rng(0)
    with LatentBox.open(tmp_path / "box", vae=vae, config=cfg,
                        device="cpu") as box:
        for oid in range(4):
            box.put(oid, latent=rng.standard_normal(LATENT_HWC)
                    .astype(np.float16))
        box.flush()
        before = [np.asarray(r.payload).copy()
                  for r in box.get_many([0, 1, 2, 3])]
    with LatentBox.open(tmp_path / "box", vae=vae, config=cfg,
                        device="cpu") as box:
        after = [np.asarray(r.payload) for r in box.get_many([0, 1, 2, 3])]
        assert box.summary()["weight_dtype"] == "bfloat16"
    for a, b in zip(before, after):
        np.testing.assert_array_equal(a, b)


def test_sim_box_reopen_keeps_recipes_demotions_and_deletes(tmp_path):
    cfg = StoreConfig(n_nodes=2)
    with LatentBox.open(str(tmp_path / "box"), mode="sim",
                        config=cfg) as box:
        for oid in range(8):
            assert box.put(oid, recipe=Recipe(seed=oid, height=16,
                                              width=16)).durable
        assert box.demote(3)
        box.delete(7)
    box2 = LatentBox.open(str(tmp_path / "box"), mode="sim", config=cfg)
    assert box2.stat(3).demoted and box2.stat(3).residency == ["recipe"]
    assert box2.stat(7) is None
    assert box2.get(3).hit_class == "regen_miss"
    assert box2.get(0).hit_class == "full_miss"
    box2.close()


def test_open_refuses_an_unknown_mode(tmp_path):
    with pytest.raises(ValueError, match="mode"):
        LatentBox.open(tmp_path / "box", mode="disk")
