"""Quickstart on the PyTorch/CUDA port: the latent-first storage idea
through the LatentBox API, on the card.

    python examples/quickstart_torch.py
    python examples/quickstart_torch.py --device cpu

One facade, four durability classes.  ``put`` encodes an image into a
compressed latent (the only durable bytes); ``get`` walks
pixel cache -> latent cache -> durable store -> recipe regeneration and
reports which class answered plus the latency breakdown; ``demote`` drops
the latent down to recipe-only storage, and the next read regenerates it
bit-exactly.  ``--device`` defaults to ``cuda`` and raises where CUDA is
absent.
"""
import argparse
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
from repro_torch.core.regen_tier import Recipe, synthesize_image  # noqa: E402
from repro_torch.store import LatentBox, StoreConfig  # noqa: E402


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu' (the plain path)")
    args = ap.parse_args(argv)
    box = LatentBox.engine(device=args.device, config=StoreConfig(
        n_nodes=2, cache_bytes_per_node=2e5, image_bytes=12e3,
        latent_bytes=1e3))

    # 1. "generate" an image (seeded recipe = reproducibility contract) and
    #    persist it latent-first: encode -> lossless compress -> durable store
    recipe = Recipe(seed=0, height=64, width=64, scale=0.3)
    img = synthesize_image(recipe)
    put = box.put(42, image=img, recipe=recipe, meta={"model": recipe.model})
    print(f"raw pixels     : {img.nbytes:6d} B")
    print(f"stored latent  : {put.stored_bytes:6.0f} B  (the only durable bytes)")
    print(f"recipe         : {put.recipe_bytes:6.0f} B  (coldest durability class)")

    # 2. read path: durable fetch -> decompress (bit-exact) -> decode on
    #    the device
    r1 = box.get(42)
    print(f"get #1         : {r1.hit_class:11s} decode {tuple(r1.payload.shape)} "
          f"({r1.latency_ms['fetch']:.1f} ms fetch + "
          f"{r1.latency_ms['decode']:.1f} ms decode)")
    r2 = box.get(42)
    assert np.array_equal(r1.payload, r2.payload), \
        "decode is deterministic: same latent -> bit-identical pixels"
    print(f"get #2         : {r2.hit_class:11s} (served from cache, same bits)")

    # 3. durability-class demotion: drop the latent, keep the recipe; the
    #    next cold read regenerates the latent bit-exactly and re-admits it
    box.demote(42)
    r3 = box.get(42)
    assert r3.regenerated and np.array_equal(r1.payload, r3.payload), \
        "recipe regenerates the exact same object"
    print(f"get #3 (demoted): {r3.hit_class:10s} regenerated bit-exactly")

    print(f"stat           : {box.stat(42).residency}")
    print(f"latent-first roundtrip OK on {args.device}")


if __name__ == "__main__":
    main()
