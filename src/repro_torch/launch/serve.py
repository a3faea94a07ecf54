"""Serving launcher — the paper's end-to-end path on the card, through
the ``LatentBox`` object-store facade (counterpart of the JAX package's
``launch/serve.py``).

Builds a corpus of generated images, ``put``s them by recipe (synthesize
-> encode -> compress -> durable latent write), then replays a trace
slice with windowed ``get_many`` — consistent-hash routing, dual-format
caching, adaptive tuning, and microbatched decodes through the Hopper
kernels, all behind the one facade.

    PYTHONPATH=src python -m repro_torch.launch.serve --requests 800 --objects 60
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu   # plain path

``--device`` defaults to ``cuda`` and raises where CUDA is absent.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.core.regen_tier import Recipe
from repro_torch.core.tuner import TunerConfig
from repro_torch.device import resolve_device
from repro_torch.store import LatentBox, StoreConfig
from repro_torch.trace.synth import TraceConfig, generate_trace
from repro_torch.vae.model import DEMO_VAE, VAE


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--objects", type=int, default=60)
    ap.add_argument("--requests", type=int, default=800)
    ap.add_argument("--nodes", type=int, default=2)
    ap.add_argument("--res", type=int, default=32)
    ap.add_argument("--batch", type=int, default=8,
                    help="request window size fed to the microbatching "
                         "decode scheduler (1 = sequential gets)")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu' (the plain path)")
    return ap.parse_args(argv)


def run(args: argparse.Namespace, vae=None):
    """Put the corpus, serve the trace, print the ``[serve]`` lines;
    returns the box and every request's ``GetResult`` in trace order.
    ``vae`` (default: the demo decoder and encoder from seed 0) must live
    on ``args.device``."""
    dev = resolve_device(args.device)
    if vae is None:
        vae = VAE(DEMO_VAE, seed=0, device=dev)
    img_bytes = args.res * args.res * 3
    box = LatentBox.engine(vae=vae, device=dev, config=StoreConfig(
        n_nodes=args.nodes,
        cache_bytes_per_node=args.objects * img_bytes * 0.15,
        image_bytes=float(img_bytes), latent_bytes=float(img_bytes) / 5,
        tuner=TunerConfig(window=100, step=0.02)))

    print(f"[serve] putting {args.objects} generated images -> latents")
    lat_bytes = []
    for oid in range(args.objects):
        res = box.put(oid, recipe=Recipe(seed=oid, height=args.res,
                                         width=args.res))
        lat_bytes.append(res.stored_bytes)
    print(f"[serve] mean compressed latent {np.mean(lat_bytes):.0f} B "
          f"vs raw pixels {img_bytes} B")

    tr = generate_trace(TraceConfig(n_objects=args.objects,
                                    n_requests=args.requests * 2,
                                    span_days=5, seed=3))
    ids = tr.object_ids[:args.requests]

    t0 = time.perf_counter()
    window = max(1, args.batch)
    results = []
    for start in range(0, len(ids), window):
        results += box.get_many([int(oid) for oid in ids[start:start + window]])
    dt = time.perf_counter() - t0
    where = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
             else "CPU")
    s = box.summary()
    print(f"[serve] {len(ids)} requests in {dt:.1f}s "
          f"({1e3 * dt / len(ids):.1f} ms/req on {where}, "
          f"window={window})")
    print(f"[serve] image-hit {s['image_hit_frac']:.1%}, "
          f"decode fraction {s['decode_frac']:.1%}, "
          f"spilled {s['spilled']}, alpha per node {s['alpha']}")
    batches = max(1, s['decode_batches'])
    print(f"[serve] {s['decodes']} decodes in {s['decode_batches']} batches "
          f"(mean batch {s['decodes'] / batches:.1f}, "
          f"{s['coalesced_decodes']} coalesced in-flight)")
    return box, results


def main(argv=None) -> None:
    run(parse_args(argv))


if __name__ == "__main__":
    main()
