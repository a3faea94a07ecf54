"""The port's kernel autotuner on the CPU (``repro_torch.kernels.autotune``):
the cache's round trip and versioned fall-back, the launch-side lookup
(a miss, a malformed entry or an entry of the JAX package gives the
default), ``decode_shapes`` equal to the JAX package's, the candidate
lists (default first, none twice, none the card lacks), the sweep's
winner under a scripted timer and its bit check, the tune-on-first-miss
tuner and an engine that reopens with its winners active, tuning files
read across the two packages, and the offline CLI on the CPU.  The
sweep's CPU path times the kernels' plain versions, which take no knobs;
the layouts themselves are held bit for bit on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py`` phase ``autotune``)."""

import json
import os

import numpy as np
import pytest
import torch

from repro.kernels import autotune as jat
from repro.vae import model as JM
from repro_torch.kernels import autotune as at
from repro_torch.kernels import ops
from repro_torch.store import LatentBox, StoreConfig
from repro_torch.vae.model import DEMO_VAE, SD35_VAE

torch.set_num_threads(2)

LATENT_HWC = (8, 8, 4)
SD35_LATENT = (64, 64, 16)


def entry(layout=at.WIDE8, **kw):
    e = {"layout": layout, "us": 10.0, "default_us": 20.0, "candidates": 3,
         "impl": "cuda", "weight_dtype": "float32"}
    e.update(kw)
    return e


def spec_of(kernel, n, h, w, cin, cout, groups=4):
    return {"kernel": kernel, "n": n, "h": h, "w": w, "cin": cin,
            "cout": cout, "groups": groups}


class ScriptedTimer:
    """Replays a fixed sequence of clock readings (2 per timed rep)."""

    def __init__(self, durations, reps=1):
        self.reads = []
        for d in durations:
            for _ in range(reps):
                self.reads += [0.0, d]
        self.i = 0

    def __call__(self):
        v = self.reads[self.i]
        self.i += 1
        return v


@pytest.fixture(autouse=True)
def no_active_cache():
    """Every test starts and ends with no process-wide cache."""
    at.set_active_cache(None)
    jat.set_active_cache(None)
    yield
    at.set_active_cache(None)
    jat.set_active_cache(None)


# ---------------------------------------------------------------------------
# the persistent cache
# ---------------------------------------------------------------------------

class TestTuningCache:
    def test_roundtrip(self, tmp_path):
        path = str(tmp_path / "tuning_cache.json")
        cache = at.TuningCache(path, device="NVIDIA H100 80GB HBM3")
        key = at.cache_key("conv3x3", 2, 8, 8, 4, 32, "float32")
        cache.put(key, entry())
        cache.save()
        loaded = at.TuningCache.load(path)
        assert len(loaded) == 1 and key in loaded
        assert loaded.get(key) == entry()
        assert loaded.device == "NVIDIA H100 80GB HBM3"
        assert not (tmp_path / "tuning_cache.json.tmp").exists()
        doc = json.loads((tmp_path / "tuning_cache.json").read_text())
        assert doc["schema_version"] == at.SCHEMA_VERSION == 2
        assert set(doc) == {"schema_version", "device", "entries"}

    def test_missing_file_is_empty(self, tmp_path):
        cache = at.TuningCache.load(str(tmp_path / "nope.json"))
        assert len(cache) == 0

    def test_pathless_cache_never_writes(self):
        cache = at.TuningCache(None)
        cache.put("k", entry())
        cache.save()                      # no-op, must not raise
        assert "k" in cache

    def test_schema_version_bump_invalidates(self, tmp_path):
        path = str(tmp_path / "tuning_cache.json")
        with open(path, "w") as f:
            json.dump({"schema_version": at.SCHEMA_VERSION + 1,
                       "entries": {"k": entry()}}, f)
        assert len(at.TuningCache.load(path)) == 0

    @pytest.mark.parametrize("blob", [b"{not json", b"", b"[1, 2, 3]",
                                      b'{"entries": "nope"}'])
    def test_corrupt_file_falls_back_clean(self, tmp_path, blob):
        path = str(tmp_path / "tuning_cache.json")
        with open(path, "wb") as f:
            f.write(blob)
        assert len(at.TuningCache.load(path)) == 0

    def test_key_format_is_the_reference_one(self):
        args = ("gn_silu_conv3x3", 8, 64, 64, 512, 512, "int8")
        assert at.cache_key(*args) == jat.cache_key(*args)


# ---------------------------------------------------------------------------
# launch-side lookup
# ---------------------------------------------------------------------------

class TestTunedParams:
    def test_no_active_cache_means_defaults(self):
        assert at.get_active_cache() is None
        assert at.tuned_params("conv3x3", (1, 8, 8, 4), 64, "float32") == {}

    def test_hit_and_miss(self):
        cache = at.TuningCache(None)
        cache.put(at.cache_key("conv3x3", 1, 8, 8, 4, 64, "float32"),
                  entry(layout=at.HALF8))
        cache.put(at.cache_key("output_epilogue", 1, 16, 16, 16, 3, "int8"),
                  {"tile_h": 8})
        with at.active_cache(cache):
            assert at.tuned_params("conv3x3", (1, 8, 8, 4), 64,
                                   "float32") == {"layout": at.HALF8}
            assert at.tuned_params("conv3x3", (2, 8, 8, 4), 64,
                                   "float32") == {}          # other bucket
            assert at.tuned_params("conv3x3", (1, 8, 8, 4), 64,
                                   "bfloat16") == {}         # other dtype
            assert at.tuned_params("output_epilogue", (1, 16, 16, 16), 3,
                                   "int8") == {"tile_h": 8}
        assert at.get_active_cache() is None                 # scope restored

    @pytest.mark.parametrize("bad", [
        {"layout": 1.0}, {"layout": 9}, {"layout": -1}, {"layout": True},
        {"layout": "2"}, {}, {"tile_h": 8},
        {"rows": 8, "block_cout": 32, "us": 1.0}])     # a JAX-package entry
    def test_malformed_entry_means_defaults(self, bad):
        cache = at.TuningCache(None)
        cache.put(at.cache_key("conv3x3", 1, 8, 8, 4, 64, "float32"), bad)
        with at.active_cache(cache):
            assert at.tuned_params("conv3x3", (1, 8, 8, 4), 64,
                                   "float32") == {}

    @pytest.mark.parametrize("bad", [{"tile_h": 12}, {"tile_h": 32},
                                     {"layout": 1}])
    def test_epilogue_heights_outside_the_grid_mean_defaults(self, bad):
        cache = at.TuningCache(None)
        cache.put(at.cache_key("output_epilogue", 1, 16, 16, 16, 3,
                               "float32"), bad)
        with at.active_cache(cache):
            assert at.tuned_params("output_epilogue", (1, 16, 16, 16), 3,
                                   "float32") == {}

    def test_launch_knob_is_the_entry_or_the_default(self):
        taps = torch.zeros(2, 2, 2, 2, 8, 64, dtype=torch.int16)
        assert at.launch_knob("upsample_conv3x3", (1, 8, 8, 8), 64,
                              taps) == at.RULE
        assert at.launch_knob("output_epilogue", (1, 8, 8, 8), 3,
                              taps) == 0
        cache = at.TuningCache(None)
        cache.put(at.cache_key("upsample_conv3x3", 1, 8, 8, 8, 64, "int8"),
                  entry(layout=at.ROWS2))
        with at.active_cache(cache):
            assert at.launch_knob("upsample_conv3x3", (1, 8, 8, 8), 64,
                                  taps) == at.ROWS2
            assert at.launch_knob("upsample_conv3x3", (1, 8, 8, 8), 64,
                                  taps.float()) == at.RULE

    def test_weight_tag_keys_upsampler_taps_as_int8(self):
        assert at.weight_tag(torch.zeros(1, dtype=torch.int16)) == "int8"
        for dt, tag in ((torch.float32, "float32"),
                        (torch.bfloat16, "bfloat16"), (torch.int8, "int8")):
            assert at.weight_tag(torch.zeros(1, dtype=dt)) == tag
            assert at.weight_tag(torch.zeros(1, dtype=dt)) == \
                ops.weight_dtype_of(torch.zeros(1, dtype=dt))

    def test_dispatch_numerically_invariant(self, rng):
        """A tuned launch changes the schedule, never the math (on the CPU
        the plain version takes no knob at all)."""
        x = torch.from_numpy(rng.standard_normal((1, 8, 8, 8))
                             .astype(np.float32))
        w = torch.from_numpy((rng.standard_normal((3, 3, 8, 64)) / 8)
                             .astype(np.float32))
        b = torch.from_numpy((rng.standard_normal((64,)) * 0.01)
                             .astype(np.float32))
        base = ops.conv3x3(x, w, b)
        cache = at.TuningCache(None)
        cache.put(at.cache_key("conv3x3", 1, 8, 8, 8, 64, "float32"),
                  entry(layout=at.HALF8))
        with at.active_cache(cache):
            assert torch.equal(ops.conv3x3(x, w, b), base)


# ---------------------------------------------------------------------------
# shape derivation + candidate lists
# ---------------------------------------------------------------------------

def sig_set(shapes):
    return {(s["kernel"], s["h"], s["w"], s["cin"], s["cout"])
            for s in shapes}


class TestDecodeShapes:
    def test_demo_decoder_shape_set(self):
        shapes = at.decode_shapes(DEMO_VAE, LATENT_HWC, bucket=2)
        assert sig_set(shapes) == {
            ("conv3x3", 8, 8, 4, 32),            # conv_in
            ("gn_silu_conv3x3", 8, 8, 32, 32),   # mid + top level
            ("upsample_conv3x3", 8, 8, 32, 32),
            ("gn_silu_conv3x3", 16, 16, 32, 16),
            ("gn_silu_conv3x3", 16, 16, 16, 16),
            ("output_epilogue", 16, 16, 16, 3),  # fused epilogue @ 2x
        }
        assert all(s["n"] == 2 and s["groups"] == 4 for s in shapes)

    def test_sd35_decoder_has_eleven_keys_per_bucket(self):
        shapes = at.decode_shapes(SD35_VAE, SD35_LATENT, bucket=1)
        kinds = [s["kernel"] for s in shapes]
        assert len(shapes) == 11
        assert (kinds.count("conv3x3"), kinds.count("gn_silu_conv3x3"),
                kinds.count("upsample_conv3x3"),
                kinds.count("output_epilogue")) == (1, 6, 3, 1)

    @pytest.mark.parametrize("bucket", [1, 2, 8])
    @pytest.mark.parametrize("cfgs", [(DEMO_VAE, JM.DEMO_VAE, LATENT_HWC),
                                      (SD35_VAE, JM.SD35_VAE, SD35_LATENT)],
                             ids=["demo", "sd35"])
    def test_equals_the_reference(self, cfgs, bucket):
        mine, theirs, latent = cfgs
        assert at.decode_shapes(mine, latent, bucket) == \
            jat.decode_shapes(theirs, latent, bucket)


class TestCandidates:
    def test_default_first_and_deduplicated(self):
        for spec in at.decode_shapes(SD35_VAE, SD35_LATENT, 1) + \
                at.decode_shapes(SD35_VAE, SD35_LATENT, 8):
            for wd in ("float32", "bfloat16", "int8"):
                cands = at.candidates(spec["kernel"], spec,
                                      weight_dtype=wd)
                assert len(cands) == len({tuple(sorted(c.items()))
                                          for c in cands})
                assert cands[0] == self.default(spec)

    @staticmethod
    def default(spec):
        if spec["kernel"] == "output_epilogue":
            return {"tile_h": 16}
        if spec["kernel"] in at.WG_KERNELS:
            return {"layout": at.RULE}
        return {"layout": at.rule_layout(spec["kernel"], spec, at.H100_SMS)}

    def test_rule_by_grid_size(self):
        """conv3x3's mma.sync tile: the decoder's conv_in (64 x 64, 16 ->
        512) at bucket 1 is 128 blocks of the 128-wide tile: 16 warps; at
        bucket 8, 1024 blocks: 8 warps.  The warpgroup tile of the fused
        GN conv and the upsampler has one layout at every grid size."""
        c1 = spec_of("conv3x3", 1, 64, 64, 16, 512)
        c8 = dict(c1, n=8)
        assert at.candidates("conv3x3", c1) == [
            {"layout": at.WIDE16}, {"layout": at.WIDE8},
            {"layout": at.HALF8}]
        assert at.candidates("conv3x3", c8) == [
            {"layout": at.WIDE8}, {"layout": at.WIDE16},
            {"layout": at.HALF8}]
        # the SM count is an input: a 100-SM part runs 8 warps at bucket 1
        assert at.candidates("conv3x3", c1, sms=100)[0] == \
            {"layout": at.WIDE8}
        gn1 = spec_of("gn_silu_conv3x3", 1, 64, 64, 512, 512, 32)
        up1 = spec_of("upsample_conv3x3", 1, 64, 64, 512, 512, 32)
        for kernel, spec in (("gn_silu_conv3x3", gn1),
                             ("gn_silu_conv3x3", dict(gn1, n=8)),
                             ("upsample_conv3x3", up1)):
            for sms in (at.H100_SMS, 100):
                assert at.candidates(kernel, spec, sms=sms) == [
                    {"layout": at.RULE}]

    @pytest.mark.parametrize("kernel,cout", [("conv3x3", 32), ("conv3x3", 4),
                                             ("conv3x3", 3),
                                             ("gn_silu_conv3x3", 4)])
    def test_single_launch_routes(self, kernel, cout):
        spec = spec_of(kernel, 1, 16, 16, 16, cout)
        assert at.candidates(kernel, spec) == [{"layout": at.RULE}]

    def test_vectorised_only_variants_leave_other_shapes(self):
        # Cin % 4: no 64-wide layout, no 8-row epilogue
        c6 = spec_of("conv3x3", 1, 9, 9, 6, 64)
        assert {"layout": at.HALF8} not in at.candidates("conv3x3", c6)
        epi = spec_of("output_epilogue", 1, 9, 9, 6, 3, 2)
        assert at.candidates("output_epilogue", epi) == [{"tile_h": 16}]
        # int8 weights copy 16 per 16 bytes: Cout 520 is not vectorised
        conv = spec_of("conv3x3", 1, 9, 9, 20, 520)
        assert {"layout": at.HALF8} in at.candidates("conv3x3", conv)
        assert {"layout": at.HALF8} in at.candidates(
            "conv3x3", conv, weight_dtype="bfloat16")
        assert {"layout": at.HALF8} not in at.candidates(
            "conv3x3", conv, weight_dtype="int8")
        # the warpgroup tile has no vectorised-only variant: the
        # upsampler's int8 taps (int16) and a Cin % 4 take its one layout
        up = spec_of("upsample_conv3x3", 1, 9, 9, 20, 520)
        for wd in ("float32", "int8"):
            for spec in (up, dict(up, cin=6)):
                assert at.candidates("upsample_conv3x3", spec,
                                     weight_dtype=wd) == [
                    {"layout": at.RULE}]

    def test_every_candidate_fits_the_card(self):
        """The largest blocks: 128 wide in fp32 (85,504 bytes) and the
        16-row epilogue at Cin = 128 (134,784)."""
        for spec in at.decode_shapes(SD35_VAE, SD35_LATENT, 8):
            for c in at.candidates(spec["kernel"], spec):
                assert at._fits(spec["kernel"], spec, c, "float32")
        big = spec_of("output_epilogue", 1, 64, 64, 4096, 3)
        assert at.candidates("output_epilogue", big) == [
            {"tile_h": 16}, {"tile_h": 8}]

    def test_unknown_kernel_raises(self):
        with pytest.raises(ValueError, match="unknown kernel"):
            at.candidates("flash_attention", spec_of("conv3x3", 1, 8, 8, 4,
                                                     64))


# ---------------------------------------------------------------------------
# the timed sweep (injected timer => fully deterministic)
# ---------------------------------------------------------------------------

SWEEP_SPEC = spec_of("conv3x3", 1, 8, 8, 16, 64)


class TestTuneDeterminism:
    def test_injected_timer_picks_scripted_winner(self):
        cands = at.candidates("conv3x3", SWEEP_SPEC)
        assert len(cands) == 3
        durations = [10.0] * len(cands)
        durations[2] = 1.0                       # candidate 2 is fastest
        e = at.tune(SWEEP_SPEC, reps=1, timer=ScriptedTimer(durations))
        assert {"layout": e["layout"]} == cands[2]
        assert e["us"] == pytest.approx(1e6)     # 1.0 s -> us
        assert e["default_us"] == pytest.approx(10e6)
        assert e["candidates"] == len(cands)
        assert e["candidate_us"] == pytest.approx([10e6, 10e6, 1e6])
        assert e["impl"] == "plain" and e["weight_dtype"] == "float32"

    def test_tie_keeps_the_default(self):
        cands = at.candidates("conv3x3", SWEEP_SPEC)
        e = at.tune(SWEEP_SPEC, reps=1,
                    timer=ScriptedTimer([5.0] * len(cands)))
        assert {"layout": e["layout"]} == cands[0]
        assert e["us"] == e["default_us"]

    def test_winner_never_worse_than_default(self):
        cands = at.candidates("conv3x3", SWEEP_SPEC)
        rng = np.random.default_rng(0)
        for _ in range(3):
            durations = list(rng.uniform(1.0, 10.0, len(cands)))
            e = at.tune(SWEEP_SPEC, reps=1, timer=ScriptedTimer(durations))
            assert e["us"] <= e["default_us"]

    @pytest.mark.parametrize("kernel,wd", [("conv3x3", "int8"),
                                           ("upsample_conv3x3", "int8"),
                                           ("upsample_conv3x3", "bfloat16"),
                                           ("output_epilogue", "float32")])
    def test_every_kernel_and_dtype_sweeps(self, kernel, wd):
        spec = spec_of(kernel, 2, 6, 10, 16, 3 if kernel ==
                       "output_epilogue" else 64)
        e = at.tune(spec, weight_dtype=wd, reps=1)
        knob = at.KNOBS[kernel][0]
        assert {knob: e[knob]} in at.candidates(kernel, spec,
                                                weight_dtype=wd)
        assert e["weight_dtype"] == wd and len(e["candidate_us"]) == \
            e["candidates"]

    def test_time_call_reads_the_clock_twice_per_rep_around_a_sync(self):
        events = []

        def timer():
            events.append("t")
            return float(len(events))

        us = at.time_call(lambda: events.append("run"), reps=3, timer=timer,
                          sync=lambda: events.append("sync"))
        assert events == ["run", "sync"] + ["t", "run", "sync", "t"] * 3
        assert us == pytest.approx(3e6)          # every rep reads 3 ticks

    def test_a_candidate_that_changes_bits_raises(self, monkeypatch):
        real = at._make_thunk

        def skewed(spec, o, cand):
            thunk = real(spec, o, cand)
            if cand != at.candidates(spec["kernel"], spec)[0]:
                return lambda: thunk() + 1e-7
            return thunk

        monkeypatch.setattr(at, "_make_thunk", skewed)
        with pytest.raises(RuntimeError, match="changes the bits"):
            at.tune(SWEEP_SPEC, reps=1)


# ---------------------------------------------------------------------------
# tune-on-first-miss in the engine
# ---------------------------------------------------------------------------

class TestKernelAutotuner:
    def make_tuner(self, tmp_path):
        cache = at.TuningCache(str(tmp_path / at.CACHE_FILENAME))
        return at.KernelAutotuner(cache, DEMO_VAE, device="cpu", reps=1,
                                  timer=ScriptedTimer([1.0] * 4096))

    def test_note_bucket_queues_only_missing(self, tmp_path):
        tuner = self.make_tuner(tmp_path)
        n = tuner.note_bucket(1, LATENT_HWC)
        assert n == tuner.pending == 6           # the demo shape set
        assert tuner.note_bucket(1, LATENT_HWC) == 0     # already queued
        assert tuner.note_bucket(2, LATENT_HWC) == 6     # new bucket = new keys

    def test_step_is_bounded_and_persists(self, tmp_path):
        tuner = self.make_tuner(tmp_path)
        tuner.note_bucket(1, LATENT_HWC)
        keys = tuner.step(2)
        assert len(keys) == 2 and tuner.pending == 4
        assert all(k in tuner.cache for k in keys)
        assert len(tuner.step_ms) == 1
        # each step persists: a fresh load already sees the first wins
        loaded = at.TuningCache.load(tuner.cache.path)
        assert set(loaded.entries) == set(keys) and loaded.device == "cpu"
        while tuner.pending:
            tuner.step(4)
        assert len(tuner.cache) == 6
        assert tuner.step(1) == []               # drained queue is a no-op
        assert tuner.note_bucket(1, LATENT_HWC) == 0     # all covered
        # tuned keys are exactly what the wrappers will look up
        assert at.tuned_params("conv3x3", (1,) + LATENT_HWC, 32,
                               "float32") == {}  # no active cache yet
        with at.active_cache(tuner.cache):
            got = at.tuned_params("conv3x3", (1,) + LATENT_HWC, 32,
                                  "float32")
            assert got == {"layout": at.RULE}    # the 32-wide tile's one
            got = at.tuned_params("output_epilogue", (1, 16, 16, 16), 3,
                                  "float32")
            assert set(got) == {"tile_h"}

    def test_foreign_entries_count_as_missing(self, tmp_path):
        """A key the JAX package tuned (``rows``/``block_cout``) gives this
        package no launch, so the port tunes it again."""
        tuner = self.make_tuner(tmp_path)
        spec = at.decode_shapes(DEMO_VAE, LATENT_HWC, 1)[0]
        key = at.cache_key(spec["kernel"], 1, spec["h"], spec["w"],
                           spec["cin"], spec["cout"], "float32")
        tuner.cache.put(key, {"rows": 8, "block_cout": 32})
        assert tuner.note_bucket(1, LATENT_HWC) == 6
        tuner.step(1)
        assert set(tuner.cache.get(key)) >= {"layout", "us"}

    def test_default_device_is_the_card(self):
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present")
        with pytest.raises(RuntimeError, match="CUDA"):
            at.KernelAutotuner(at.TuningCache(None), DEMO_VAE)

    def test_engine_tunes_one_key_per_batch(self, tmp_path):
        cfg = StoreConfig(n_nodes=1, cache_bytes_per_node=1e5,
                          adaptive=False, autotune=True,
                          decode_buckets=(1, 2))
        box = LatentBox.open(tmp_path / "box", config=cfg, device="cpu")
        eng = box.backend.engine
        rng = np.random.default_rng(0)
        for oid in range(4):
            box.put(oid, latent=rng.standard_normal(LATENT_HWC)
                    .astype(np.float16))
        box.get_many([0, 1, 2, 3])               # two bucket-2 batches
        s = box.summary()
        assert s["tuned_kernel_keys"] == 1 and s["tuning_pending"] == 5
        box.close()
        assert at.get_active_cache() is None     # the hook is released
        assert len(at.TuningCache.load(eng.tuning_cache.path)) == 1

    def test_engine_restart_honors_cache(self, tmp_path, rng):
        cfg = StoreConfig(n_nodes=1, cache_bytes_per_node=1e5,
                          adaptive=False, autotune=True,
                          decode_buckets=(1, 2))
        with LatentBox.open(tmp_path / "box", config=cfg,
                            device="cpu") as box:
            eng = box.backend.engine
            assert at.get_active_cache() is eng.tuning_cache
            for oid in range(4):
                box.put(oid, latent=rng.standard_normal(LATENT_HWC)
                        .astype(np.float16))
            for _ in range(30):                  # maintenance drains the queue
                box.get_many([0, 1, 2, 3])
                if eng.autotuner.pending == 0 and len(eng.tuning_cache):
                    break
            assert len(eng.tuning_cache) == 6    # bucket 2's keys
            tuned_before = dict(eng.tuning_cache.entries)
            pixels = [np.asarray(r.payload).copy()
                      for r in box.get_many([0, 1])]
        with LatentBox.open(tmp_path / "box", config=cfg,
                            device="cpu") as box:
            eng = box.backend.engine
            assert eng.tuning_cache.entries == tuned_before   # survived
            assert at.get_active_cache() is eng.tuning_cache  # and honored
            s = box.summary()
            assert s["tuned_kernel_keys"] == len(tuned_before)
            again = [np.asarray(r.payload) for r in box.get_many([0, 1])]
            for a, b in zip(pixels, again):
                np.testing.assert_array_equal(a, b)

    def test_sharded_box_keeps_a_cache_per_shard(self, tmp_path):
        cfg = StoreConfig(n_nodes=2, cache_bytes_per_node=1e5,
                          adaptive=False, autotune=True, decode_buckets=(1,))
        box = LatentBox.open(tmp_path / "box", config=cfg, shards=2,
                             device="cpu")
        rng = np.random.default_rng(1)
        for oid in range(6):
            box.put(oid, latent=rng.standard_normal(LATENT_HWC)
                    .astype(np.float16))
        box.get_many(list(range(6)))
        box.close()
        for sid in range(2):
            path = tmp_path / "box" / f"shard{sid:03d}" / at.CACHE_FILENAME
            assert path.exists()
        assert at.get_active_cache() is None


# ---------------------------------------------------------------------------
# files across the two packages
# ---------------------------------------------------------------------------

class TestCrossPackageFiles:
    KEY = ("gn_silu_conv3x3", 1, 8, 8, 32, 32, "float32")

    def test_reference_file_loads_here_as_defaults(self, tmp_path):
        """The reference writes schema version 1, which the port's
        version 2 (the warpgroup tile's codes) reads as an empty cache."""
        path = str(tmp_path / "tuning_cache.json")
        theirs = jat.TuningCache(path)
        theirs.put(jat.cache_key(*self.KEY),
                   {"rows": 8, "block_cout": 32, "us": 1.0,
                    "default_us": 2.0, "candidates": 4,
                    "impl": "pallas_interpret", "weight_dtype": "float32"})
        theirs.save()
        assert jat.SCHEMA_VERSION != at.SCHEMA_VERSION
        mine = at.TuningCache.load(path)
        assert len(mine) == 0
        with at.active_cache(mine):
            kernel, n, h, w, cin, cout, wd = self.KEY
            assert at.tuned_params(kernel, (n, h, w, cin), cout, wd) == {}

    def test_port_file_loads_in_the_reference_as_defaults(self, tmp_path):
        path = str(tmp_path / "tuning_cache.json")
        mine = at.TuningCache(path)
        mine.put(at.cache_key(*self.KEY), entry(layout=at.ROWS2))
        mine.save()
        theirs = jat.TuningCache.load(path)
        assert len(theirs) == 0                  # another schema version
        with jat.active_cache(theirs):
            kernel, n, h, w, cin, cout, wd = self.KEY
            assert jat.tuned_params(kernel, (n, h, w, cin), cout, wd) == {}


# ---------------------------------------------------------------------------
# the offline CLI
# ---------------------------------------------------------------------------

class TestCli:
    def test_smoke_on_the_cpu(self, tmp_path, capsys):
        path = str(tmp_path / "tc.json")
        assert at.main(["--cache", path, "--smoke", "--device", "cpu"]) == 0
        cache = at.TuningCache.load(path)
        # buckets 1 and 2 x 6 demo shapes x float32 and bfloat16
        assert len(cache) == 24 and cache.device == "cpu"
        assert {e["impl"] for e in cache.entries.values()} == {"plain"}
        assert "tuned 24 new keys" in capsys.readouterr().out
        # a second run finds everything covered
        assert at.main(["--cache", path, "--smoke", "--device", "cpu"]) == 0
        assert "tuned 0 new keys" in capsys.readouterr().out

    def test_defaults_to_the_card(self, tmp_path):
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present")
        with pytest.raises(RuntimeError, match="CUDA"):
            at.main(["--cache", str(tmp_path / "tc.json"), "--smoke"])
        assert not os.path.exists(tmp_path / "tc.json")
