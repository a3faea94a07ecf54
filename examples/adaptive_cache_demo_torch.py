"""The dual-format cache + marginal-hit tuner reacting to a workload shift
(paper §4.2/4.3 in isolation, no cluster).

    PYTHONPATH=src python examples/adaptive_cache_demo.py

Phase 1: a small hot set -> image hits dominate -> alpha climbs.
Phase 2: catalog explodes past the cache -> coverage matters -> alpha falls.
"""
import numpy as np

from repro_torch.core.dual_cache import DualFormatCache
from repro_torch.store.api import DEFAULT_OBJECT_BYTES
from repro_torch.core.tuner import MarginalHitTuner, TunerConfig

rng = np.random.default_rng(0)
cache = DualFormatCache(400 * 1.4e6, alpha=0.5, promote_threshold=4,
                        image_size_fn=lambda _: 1.4e6,
                        latent_size_fn=lambda _: DEFAULT_OBJECT_BYTES)
tuner = MarginalHitTuner(cache, TunerConfig(window=4000, step=0.03))

def serve(ids):
    for oid in ids:
        r = cache.lookup(int(oid))
        if r.outcome == "full_miss":
            cache.admit_latent(int(oid))
        tuner.on_request()

print("phase 1: hot catalog of 300 objects (fits as images)")
serve(rng.zipf(1.2, 60_000) % 300)
print(f"  alpha -> {cache.alpha:.2f}  (image tier favored)")

print("phase 2: catalog jumps to 50k objects (coverage wins)")
serve(rng.zipf(1.05, 120_000) % 50_000)
print(f"  alpha -> {cache.alpha:.2f}  (latent tier favored)")

for r in tuner.history[:: max(1, len(tuner.history) // 10)]:
    print(f"  window {r.window_index:3d}  alpha={r.alpha_after:.2f} "
          f"D={r.gradient:+.4f}  E[T]={r.expected_latency_ms:.1f} ms")
