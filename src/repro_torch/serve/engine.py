"""The ENGINE backend of the LatentBox object-store API in PyTorch: real
encode and decode on the card behind the shared tier-walk read path
(counterpart of the JAX package's ``serve/engine.py``).

The read path is :class:`repro_torch.store.walk.TierWalk` (pixel cache ->
latent cache -> durable latent -> recipe regeneration), copied from the
JAX package, so this engine classifies a shared trace exactly as the
JAX engine does.  Misses accumulate in a :class:`DecodeBatcher` queue
where duplicate in-flight object ids coalesce into one decode
(single-flight), then flush as batches padded up to a small set of
bucketed batch sizes (default 1/2/4/8).  Per-image wall clock feeds the
marginal-hit tuner's EWMAs.

Writes take a latent, an image (encoded on the card) or a recipe
(synthesised, then encoded); a read of an object demoted to its recipe
regenerates it (recipe -> pixels -> encoder -> latent) bit-exactly.
Pixels are served as uint8 or float32.  The uint8 path may serve
decoder weights stored in bf16 or int8 (``StoreConfig.weight_dtype``),
admitted only behind the +-1-LSB gate that the engine runs when it
opens.  Every batch ends with bounded maintenance: with a segment-log
store (``StoreConfig.data_dir``) one flush of the write-behind appends
and at most one compaction step, and with ``StoreConfig.autoscale`` one
step of the elastic autoscaler, which moves a virtual decode-fleet width
(provisioned-cost accounting, the utilization denominator) and the
per-node cache capacity from the batcher's measured decode occupancy.

Serving is not window-only: ``admit``/``dispatch`` expose the open
microbatch, so the event-loop serving runtime (``serve/runtime/``) feeds
the batcher continuously; ``serve_stream`` replays a timestamped
open-loop request stream through it, and ``serve_window`` stays the
fixed-group path that its drain-mode conformance is defined against.
The kernel autotuner waits for a later slice (see ROADMAP.md) and
raises ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
import time
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.compression.latentcodec import (compress_latent,
                                                 decompress_latent)
from repro_torch.core.dual_cache import IMAGE_HIT, LATENT_HIT
from repro_torch.core.latent_store import LatentStore
from repro_torch.core.regen_tier import (Recipe, RegenTierStore,
                                         synthesize_image)
from repro_torch.core.tuner import MarginalHitTuner, TunerConfig
from repro_torch.device import resolve_device
from repro_torch.store.api import StoreConfig
from repro_torch.store.tiers import DurableTier, RecipeTier
from repro_torch.store.walk import TierWalk


def not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported to repro_torch yet: "
                               f"{item}")


@dataclasses.dataclass
class EngineConfig:
    """The legacy engine configuration (the JAX package's), taken by
    :class:`ServingEngine` with explicit image and latent sizes in place
    of a :class:`StoreConfig`."""

    n_nodes: int = 2
    cache_bytes_per_node: float = 64e6
    alpha0: float = 0.5
    tau: float = 0.1
    #: Paper parameter ``h``: latent hits before promotion to the pixel
    #: tier; doubles as the spillover queue-depth bound (the deprecated
    #: ``theta`` alias encoded the same value).
    promote_threshold: int = 4
    decode_buckets: Tuple[int, ...] = (1, 2, 4, 8)
    #: 'uint8' serves displayable bytes off the fused decode epilogue;
    #: 'float32' keeps the [-1, 1] float pixels.
    pixel_format: str = "uint8"
    #: Decoder weight storage precision for the uint8 path, applied
    #: behind the +-1-LSB open-time gate (see :class:`StoreConfig`).
    weight_dtype: str = "float32"
    #: Kernel autotuning (see :class:`StoreConfig`; not ported yet).
    autotune: bool = False
    adaptive: bool = True               # run the marginal-hit tuner
    tuner: TunerConfig = dataclasses.field(
        default_factory=lambda: TunerConfig(window=500, step=0.02))
    #: Injectable wall clock (seconds); ``None`` = ``time.time``.
    clock: Optional[Any] = None
    #: Deprecated alias of ``promote_threshold``: passing it is an error.
    theta: dataclasses.InitVar[Optional[int]] = None

    def __post_init__(self, theta: Optional[int]) -> None:
        if theta is not None:
            raise TypeError(
                "EngineConfig.theta was merged into promote_threshold "
                "(both encode the paper's h); pass promote_threshold "
                "instead")

    def store_config(self, image_bytes: float,
                     latent_bytes: float) -> StoreConfig:
        """The cache/routing half of this config, for the shared walk."""
        return StoreConfig(
            n_nodes=self.n_nodes,
            cache_bytes_per_node=self.cache_bytes_per_node,
            alpha0=self.alpha0, tau=self.tau,
            promote_threshold=self.promote_threshold,
            image_bytes=image_bytes, latent_bytes=latent_bytes,
            adaptive=self.adaptive, tuner=self.tuner,
            decode_buckets=self.decode_buckets,
            pixel_format=self.pixel_format,
            weight_dtype=self.weight_dtype, autotune=self.autotune,
            clock=self.clock)


class _Node:
    """Engine-side view of one walk node: payload dicts + decode queue
    depth around the walk's cache/tuner."""

    def __init__(self, idx: int, tier) -> None:
        self.idx = idx
        self.tier = tier
        self.cache = tier.cache
        self.tuner: Optional[MarginalHitTuner] = tier.tuner
        self.images: Dict[int, np.ndarray] = {}     # decoded-image payloads
        self.latents: Dict[int, bytes] = {}         # compressed payloads
        self.queue_depth = 0

    def drop_payloads(self, oid: int) -> None:
        self.images.pop(oid, None)
        self.latents.pop(oid, None)


class DecodeBatcher:
    """Microbatching decode scheduler over one VAE, serving uint8 pixels
    (``decode_u8``, the fused epilogue) or float32 ones (``decode``).

    Pending misses queue up via :meth:`submit`; duplicate in-flight object
    ids coalesce into one decode (single-flight).  :meth:`flush` drains the
    queue in FIFO order as batches, each padded up to the smallest
    configured bucket that fits, repeating the last real latent (the decode
    is per-image independent, so padding never perturbs real outputs).

    Host DEFLATE decompression is memoised per oid (bounded LRU keyed on
    the exact blob).  The flush is pipelined: chunk k+1's decompression
    and kernel launches happen while chunk k runs on the card; latents go
    host -> device from pinned memory, each chunk's pixels come back by an
    asynchronous copy into pinned memory, and a CUDA event per chunk is
    awaited only after the next chunk has been dispatched.
    """

    #: decompressed latents kept (LRU), as the JAX engine's default
    MEMO_ENTRIES = 256

    def __init__(self, vae, buckets: Sequence[int] = (1, 2, 4, 8),
                 pixel_format: str = "uint8"):
        if not buckets or any(b <= 0 for b in buckets):
            raise ValueError(f"buckets must be positive: {buckets!r}")
        if pixel_format not in ("uint8", "float32"):
            raise ValueError(f"pixel_format must be uint8|float32: "
                             f"{pixel_format!r}")
        self.vae = vae
        self.pixel_format = pixel_format
        self.device = vae.device
        self.buckets = tuple(sorted(set(int(b) for b in buckets)))
        self.max_batch = self.buckets[-1]
        # oid -> (compressed blob, exec node) in arrival order
        self._pending: Dict[int, Tuple[bytes, Any]] = {}
        # oid -> (blob, decompressed z): reused only when the blob matches
        self._zmemo: "OrderedDict[int, Tuple[bytes, np.ndarray]]" = \
            OrderedDict()
        self._warm: set = set()       # buckets whose decode shape has run
        self.stats = {"decodes": 0, "batches": 0, "coalesced": 0,
                      "padded_slots": 0, "decompressions": 0, "memo_hits": 0}
        self.last_per_image_ms: Dict[int, float] = {}
        #: per bucket, (batch wall ms, real images) of every batch
        self.bucket_ms: Dict[int, List[Tuple[float, int]]] = {}
        #: Cumulative decode wall occupancy (ms): summary()'s gpu_seconds.
        self.busy_ms = 0.0

    def __len__(self) -> int:
        return len(self._pending)

    def clear(self) -> None:
        """Drop everything pending (a window aborted mid-admission)."""
        self._pending.clear()

    def forget(self, oid: int) -> None:
        """Invalidate the decompression memo for ``oid``."""
        self._zmemo.pop(oid, None)

    def submit(self, oid: int, blob: bytes, node: Any) -> bool:
        """Queue a decode for ``oid``; returns True if newly enqueued,
        False if it coalesced with an in-flight decode of the same oid."""
        if oid in self._pending:
            self.stats["coalesced"] += 1
            return False
        self._pending[oid] = (blob, node)
        return True

    def bucket_for(self, n: int) -> int:
        """Smallest configured bucket >= n (n itself beyond the largest)."""
        for b in self.buckets:
            if b >= n:
                return b
        return n

    # -- decode plumbing ------------------------------------------------------

    def _decode_fn(self, z: torch.Tensor) -> torch.Tensor:
        if self.pixel_format == "uint8":
            return self.vae.decode_u8(z)
        return self.vae.decode(z)

    def _dispatch(self, zb: np.ndarray):
        """Start the decode of a stacked latent batch; returns a handle for
        :meth:`_wait`.  On CUDA everything here is asynchronous."""
        z = torch.from_numpy(zb)
        if self.device.type == "cuda":
            z = z.pin_memory().to(self.device, non_blocking=True)
            out = self._decode_fn(z)
            host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
            host.copy_(out, non_blocking=True)
            done = torch.cuda.Event()
            done.record()
            return host, done
        return self._decode_fn(z), None

    @staticmethod
    def _wait(handle) -> np.ndarray:
        host, done = handle
        if done is not None:
            done.synchronize()
        return host.numpy().copy()

    def decode_single(self, z: np.ndarray) -> np.ndarray:
        """One-off decode of a single latent in the configured pixel
        format (prewarm / promotion paths outside the batched window)."""
        return self._wait(self._dispatch(
            np.asarray(z, np.float32)[None]))[0]

    def prewarm(self, latent_hwc: Tuple[int, int, int]) -> None:
        """Run every bucket's decode shape once up front (building and
        loading the kernels on the first), so no serving window pays it."""
        for b in self.buckets:
            if b not in self._warm:
                self._wait(self._dispatch(
                    np.zeros((b,) + tuple(latent_hwc), np.float32)))
                self._warm.add(b)

    def _latent_of(self, oid: int, blob: bytes) -> np.ndarray:
        """Memoised host decompression."""
        hit = self._zmemo.get(oid)
        if hit is not None and hit[0] == blob:
            self._zmemo.move_to_end(oid)
            self.stats["memo_hits"] += 1
            return hit[1]
        self.stats["decompressions"] += 1
        z = np.asarray(decompress_latent(blob), np.float32)
        self._zmemo[oid] = (blob, z)
        self._zmemo.move_to_end(oid)
        while len(self._zmemo) > self.MEMO_ENTRIES:
            self._zmemo.popitem(last=False)
        return z

    def _assemble(self, chunk):
        """Host half of one chunk: decompress (memoised), pad to the
        bucket, stack, and make sure the bucket's shape has run once."""
        n_real = len(chunk)
        bucket = self.bucket_for(n_real)
        zs = [self._latent_of(oid, blob) for oid, (blob, _) in chunk]
        zs.extend([zs[-1]] * (bucket - n_real))   # pad with the last real z
        zb = np.stack(zs)
        if bucket not in self._warm:
            # first run of this shape outside the timed region
            self._wait(self._dispatch(np.zeros_like(zb)))
            self._warm.add(bucket)
        return zb, bucket, n_real

    def _account(self, chunk, imgs, per_image_ms, bucket, n_real):
        self.stats["batches"] += 1
        self.stats["decodes"] += n_real
        self.stats["padded_slots"] += bucket - n_real
        self.busy_ms += per_image_ms * n_real
        self.bucket_ms.setdefault(bucket, []).append(
            (per_image_ms * n_real, n_real))
        out = {}
        for i, (oid, (_, node)) in enumerate(chunk):
            if node.tuner is not None:
                node.tuner.observe_decode_ms(per_image_ms)
            self.last_per_image_ms[oid] = per_image_ms
            out[oid] = imgs[i]
        return out

    def flush(self) -> Dict[int, np.ndarray]:
        """Decode everything pending; returns oid -> image and feeds
        each exec node's tuner the per-image wall clock of its batch."""
        results: Dict[int, np.ndarray] = {}
        items = list(self._pending.items())
        self._pending.clear()
        self.last_per_image_ms = {}
        chunks = [items[s:s + self.max_batch]
                  for s in range(0, len(items), self.max_batch)]
        inflight = None           # (chunk, handle, start, bucket, n_real)
        prev_done = 0.0
        for chunk in chunks:
            zb, bucket, n_real = self._assemble(chunk)
            t0 = time.perf_counter()
            handle = self._dispatch(zb)
            if inflight is not None:
                prev_done = self._collect(results, *inflight)
            # the card runs chunks in order: this chunk only starts once
            # the previous one finished, so its timed span begins there
            inflight = (chunk, handle, max(t0, prev_done), bucket, n_real)
        if inflight is not None:
            self._collect(results, *inflight)
        return results

    def _collect(self, results, chunk, handle, start, bucket, n_real) -> float:
        imgs = self._wait(handle)
        done = time.perf_counter()
        per_image_ms = (done - start) * 1e3 / n_real
        results.update(self._account(chunk, imgs, per_image_ms, bucket,
                                     n_real))
        return done


@dataclasses.dataclass
class _Ticket:
    """One request's routing decision, held across the batched decode."""
    oid: int
    outcome: str
    owner: _Node
    exec_node: Optional[_Node] = None
    img: Optional[np.ndarray] = None          # set on image hit
    write_image: bool = False                 # promote/pin decision at lookup
    spilled: bool = False
    fetch_ms: float = 0.0                     # measured durable-fetch wall
    regen_ms: float = 0.0                     # measured regeneration wall
    decode_ms: float = 0.0                    # per-image share of its batch


class ServingEngine:
    """Single-process stand-in for the decode fleet: N logical nodes share
    one device; the cache/routing/tuning logic is the shared ``TierWalk``.

    ``cfg`` is a :class:`StoreConfig` (its ``image_bytes``/``latent_bytes``
    win) or a legacy :class:`EngineConfig` combined with the explicit size
    arguments.  ``device`` (default ``"cuda"``, raising where CUDA is
    absent) is where the engine decodes; ``vae`` must live there."""

    def __init__(self, vae, store: LatentStore, cfg=None,
                 image_bytes: float = 16e3, latent_bytes: float = 13e3,
                 recipes: Optional[RegenTierStore] = None, device=None):
        dev = resolve_device(device)
        if vae.device != dev:
            raise ValueError(f"the VAE lives on {vae.device}, but the "
                             f"engine was asked to run on {dev}")
        if isinstance(cfg, StoreConfig):
            self.cfg = cfg
        else:
            self.cfg = (cfg or EngineConfig()).store_config(
                image_bytes, latent_bytes)
        if self.cfg.autotune:
            raise not_ported("autotune=True",
                             "ROADMAP A 8, kernel autotuner")
        self.vae = vae
        self.store = store
        self.recipes = recipes
        self.walk = TierWalk(
            self.cfg,
            durable=DurableTier(store),
            recipes=RecipeTier(recipes) if recipes is not None else None)
        self.nodes = [_Node(i, t) for i, t in enumerate(self.walk.caches)]
        for node in self.nodes:
            # capacity evictions drop the decoded/compressed payload too
            node.tier.evict_cb(node.drop_payloads)
        self.router = self.walk.router
        self.batcher = DecodeBatcher(vae, self.cfg.decode_buckets,
                                     pixel_format=self.cfg.pixel_format)
        self.stats = self.walk.counts           # shared hit/spill accounting
        self._inflight: List[_Ticket] = []      # open microbatch
        # -- quantized decoder weights, admitted behind the gate -------------
        self.gate_lsb: Optional[Dict[int, int]] = None
        if self.cfg.weight_dtype != "float32":
            if self.cfg.pixel_format != "uint8":
                raise ValueError(
                    "weight_dtype quantization serves the uint8 fast path "
                    "only; the float32 pixel format stays on f32 weights")
            from repro_torch.vae.quantize import check_u8_gate
            vae.set_weight_dtype(self.cfg.weight_dtype)
            # the +-1-LSB open-time gate: quantized against fp32-oracle
            # uint8 pixels on probe latents at every decode bucket; raises
            # QuantizationGateError (configuration refused) on a breach
            self.gate_lsb = check_u8_gate(
                vae, self.cfg.decode_buckets,
                (8, 8, vae.cfg.latent_channels))
        # -- elastic autoscaling (off by default: no controller at all) ------
        # the engine's decode fleet is one shared device, so the GPU knob
        # moves a virtual fleet width (provisioned-cost accounting and the
        # utilization denominator); the cache knob is real, through the
        # walk's capacity handoff
        self.gpus_per_node = int(self.cfg.gpus_per_node)
        opened_s = self.cfg.now_s()
        self._gpu_ms = 0.0
        self._cache_byte_ms = 0.0
        self._acct_mark_s = opened_s
        self._cache_bytes_per_node = float(self.cfg.cache_bytes_per_node)
        self.autoscaler = None
        if self.cfg.autoscale:
            from repro_torch.core.autoscale import (AutoscaleConfig,
                                                    AutoscaleController,
                                                    PlantState)
            from repro_torch.core.cost_model import params_for_store
            acfg = self.cfg.autoscale_cfg or dataclasses.replace(
                AutoscaleConfig(), params=params_for_store(self.cfg))
            self.autoscaler = AutoscaleController(
                PlantState(self.gpus_per_node, len(self.walk.caches),
                           self._cache_bytes_per_node), acfg)
            self._as_mark = {"reqs": 0, "now_s": opened_s,
                             "busy": 0.0, "image_hits": 0}

    def prewarm_decode(self, latent_hwc: Tuple[int, int, int]) -> None:
        """Run every decode bucket once for the given latent shape, so no
        serving batch pays the first build and launch."""
        self.batcher.prewarm(latent_hwc)

    # -- writes ---------------------------------------------------------------

    def put(self, oid: int, image: Optional[np.ndarray] = None,
            latent: Optional[np.ndarray] = None,
            recipe: Optional[Recipe] = None) -> int:
        """Durable write: encode (if given pixels or a recipe) -> compress
        -> latent store; the recipe (if any) becomes the coldest
        durability class.  Overwriting an existing object purges its
        cached copies.  Returns the durable byte count."""
        if oid in self.store:           # overwrite: drop every cached copy
            for tier in self.walk.caches:
                tier.evict(oid)
            for node in self.nodes:
                node.drop_payloads(oid)
        if latent is None:
            if image is None:
                if recipe is None:
                    raise ValueError("put needs an image, latent, or recipe")
                image = synthesize_image(recipe)
            img4 = np.asarray(image)
            if img4.dtype == np.uint8:      # display bytes -> [-1, 1] floats
                img4 = img4.astype(np.float32) / 127.5 - 1.0
            img4 = img4.astype(np.float32)
            if img4.ndim == 3:
                img4 = img4[None]
            latent = self._encode(img4)
        blob = compress_latent(np.asarray(latent))
        self.store.put(oid, blob)
        self.batcher.forget(oid)            # durable blob rewritten
        if recipe is not None and self.recipes is not None:
            self.recipes.put(oid, float(len(blob)), recipe=recipe)
        return len(blob)

    def delete(self, oid: int) -> bool:
        """Remove from every tier, payload dicts included."""
        found = self.walk.delete(oid)
        for node in self.nodes:
            node.drop_payloads(oid)
        self.batcher.forget(oid)
        return found

    def demote(self, oid: int, rung=None) -> bool:
        """Demote down the rate-distortion ladder (see the shared walk)."""
        return self.walk.demote(oid, rung)

    def promote(self, oid: int) -> bool:
        """Regenerate a demoted object's latent back into the durable tier."""
        if self.recipes is None or not self.recipes.is_demoted(oid):
            return False
        self._regenerate(oid)
        return True

    def prewarm(self, oid: int) -> bool:
        """Decode now and pin pixels at the hash owner (no stats impact)."""
        blob = self.store.get(oid)
        if blob is None:
            return False
        z = np.asarray(decompress_latent(blob), np.float32)
        img = self.batcher.decode_single(z)
        owner = self.nodes[self.walk._idx[self.walk.router.ring.owner(oid)]]
        owner.cache.insert_image(oid, nbytes=img.nbytes)
        owner.images[oid] = img
        return True

    def _encode(self, img4: np.ndarray) -> np.ndarray:
        """[1, H, W, 3] float32 pixels -> the fp16 latent [h, w, C] that
        the store keeps.  The copy to the host waits for the card, so a
        caller's clock around it times the encode."""
        mean = self.vae.encode_mean(torch.from_numpy(img4))
        return mean.cpu().numpy()[0].astype(np.float16)

    def _regenerate(self, oid: int) -> bytes:
        """Recipe -> pixels -> latent -> durable re-admission (bit-exact on
        the same stack, which is what makes recipes a durability class)."""
        recipe = self.recipes.recipe_of(oid) if self.recipes else None
        if recipe is None:
            raise KeyError(f"object {oid} has no recipe to regenerate from")
        blob = compress_latent(self._encode(synthesize_image(recipe)))
        self.store.put(oid, blob)
        self.batcher.forget(oid)            # durable blob rewritten
        self.recipes.readmit(oid, float(len(blob)), now_mo=0.0)
        return blob

    # -- request admission ---------------------------------------------------

    def _lookup(self, oid: int) -> _Ticket:
        """Route one request up to (but excluding) the decode: the shared
        tier-walk classifies and admits; this method materialises payloads
        (durable fetch / regeneration) and enqueues the decode."""
        ticket = self.walk.lookup(
            oid, depth_of=lambda i: self.nodes[i].queue_depth)
        owner = self.nodes[ticket.owner]
        exec_node = self.nodes[ticket.exec_node]

        if ticket.hit_class == IMAGE_HIT:
            img = owner.images.get(oid)
            if img is not None:
                return _Ticket(oid, IMAGE_HIT, owner, img=img)
            # admitted to the image tier, but the pixel payload is still
            # in-flight in the open microbatch: join the pending decode
            blob = owner.latents.get(oid) or self.store.get(oid)
            if blob is None:
                raise KeyError(f"object {oid} not in store")
            if self.batcher.submit(oid, blob, owner):
                owner.queue_depth += 1
            return _Ticket(oid, IMAGE_HIT, owner, exec_node=owner,
                           write_image=True)

        fetch_ms = regen_ms = 0.0
        if ticket.hit_class == LATENT_HIT:
            blob = owner.latents.get(oid) or self.store.get(oid)
            if blob is None:
                raise KeyError(f"object {oid} lost its latent payload")
        elif ticket.needs_regen:
            t0 = time.perf_counter()
            blob = self._regenerate(oid)
            regen_ms = (time.perf_counter() - t0) * 1e3
            if owner.tuner is not None:
                owner.tuner.observe_fetch_ms(regen_ms)
            if self.walk.admit_latent(ticket.owner, oid):
                owner.latents[oid] = blob
        else:                                         # durable fetch
            t0 = time.perf_counter()
            blob = self.store.get(oid)
            if blob is None:
                raise KeyError(f"object {oid} has no durable payload "
                               "(size-only registration?)")
            fetch_ms = ((time.perf_counter() - t0) * 1e3
                        + self.store.fetch_ms(oid, self.cfg.now_s()))
            if owner.tuner is not None:
                owner.tuner.observe_fetch_ms(fetch_ms)
            if self.walk.admit_latent(ticket.owner, oid):
                owner.latents[oid] = blob

        if self.batcher.submit(oid, blob, exec_node):
            exec_node.queue_depth += 1          # one slot per unique decode
        return _Ticket(oid, ticket.hit_class, owner, exec_node=exec_node,
                       write_image=ticket.write_image, spilled=ticket.spilled,
                       fetch_ms=fetch_ms, regen_ms=regen_ms)

    # -- public API ----------------------------------------------------------

    def get(self, oid: int) -> Tuple[np.ndarray, str]:
        return self.get_many([oid])[0]

    def get_many(self, oids: Sequence[int]
                 ) -> List[Tuple[np.ndarray, str]]:
        """Serve one group of requests with one batched decode flush;
        returns ``(pixels, hit_class)`` pairs in request order."""
        return [(t.img, t.outcome) for t in self.serve_window(oids)]

    def admit(self, oid: int) -> _Ticket:
        """Admit one request into the open microbatch without flushing it."""
        try:
            ticket = self._lookup(int(oid))
        except Exception:
            self._abort_open_batch()
            raise
        self._inflight.append(ticket)
        return ticket

    def dispatch(self) -> List[_Ticket]:
        """Close the open microbatch: flush the queued decodes, write
        decoded pixels back to their hash owners in admission order, then
        run the bounded end-of-batch maintenance."""
        tickets, self._inflight = self._inflight, []
        decoded = self._flush()
        touched = {}
        for t in tickets:
            if t.img is not None:
                continue
            img = decoded[t.oid]
            t.decode_ms = self.batcher.last_per_image_ms.get(t.oid, 0.0)
            # cache pinning: decoded result written back to the OWNER node
            if t.write_image or t.owner.cache.contains(t.oid) == "image":
                t.owner.images[t.oid] = img
                t.owner.cache.set_image_nbytes(t.oid, img.nbytes)
            touched[id(t.owner)] = t.owner
            t.img = img
        for node in touched.values():
            self._gc(node)
        self._maintenance()
        return tickets

    def _abort_open_batch(self) -> None:
        self.batcher.clear()
        for n in self.nodes:
            n.queue_depth = 0
        self._inflight = []

    def serve_window(self, oids: Sequence[int]) -> List[_Ticket]:
        """Serve one fixed group of requests with a single batched decode
        flush: ``admit`` every id in request order, then ``dispatch``."""
        for oid in oids:
            self.admit(oid)
        return self.dispatch()

    def serve_stream(self, requests, runtime_cfg=None):
        """Replay an open-loop request stream through the event-loop
        serving runtime (simulated clock, per-tenant QoS, SLO-aware
        admission), feeding this engine's batcher continuously through
        :meth:`admit`/:meth:`dispatch`.  ``requests`` is a sequence of
        :class:`repro_torch.serve.runtime.Request` or a ``SyntheticTrace``;
        returns a :class:`repro_torch.serve.runtime.StreamReport`."""
        from repro_torch.serve.runtime import RuntimeConfig, ServingRuntime
        if runtime_cfg is None:
            runtime_cfg = RuntimeConfig.from_store(self.cfg)
        return ServingRuntime.for_engine(self, runtime_cfg).run(requests)

    def _maintenance(self) -> None:
        """End-of-batch bounded work: durable flush and at most one
        compaction step (no-ops in memory), then one autoscaler step."""
        self.store.flush()
        self.store.maybe_compact()
        if self.autoscaler is not None:
            self._autoscale_step()

    def _account_provisioned(self) -> None:
        """Advance the provisioned GPU/cache time integrals to the clock."""
        now_s = self.cfg.now_s()
        dt_ms = (now_s - self._acct_mark_s) * 1e3
        if dt_ms <= 0.0:
            return
        self._gpu_ms += dt_ms * len(self.nodes) * self.gpus_per_node
        self._cache_byte_ms += (dt_ms * len(self.nodes)
                                * self._cache_bytes_per_node)
        self._acct_mark_s = now_s

    def _autoscale_step(self) -> None:
        """One control step from the engine's own signals: walk hit counts
        (arrival volume, decode fraction) and the batcher's measured decode
        occupancy.  The engine has no plant queue, so it scales on
        utilization alone."""
        from repro_torch.core.autoscale import WindowObs
        from repro_torch.store.api import HIT_CLASSES
        mark = self._as_mark
        reqs = sum(self.walk.counts[k] for k in HIT_CLASSES)
        if reqs - mark["reqs"] < self.autoscaler.cfg.window:
            return
        now_s = self.cfg.now_s()
        span_ms = (now_s - mark["now_s"]) * 1e3
        n = reqs - mark["reqs"]
        hits = self.walk.counts[IMAGE_HIT] - mark["image_hits"]
        obs = WindowObs(
            requests=n, span_ms=span_ms,
            busy_ms=max(0.0, self.batcher.busy_ms - mark["busy"]),
            decode_frac=1.0 - hits / n if n else 1.0)
        self._as_mark = {"reqs": reqs, "now_s": now_s,
                         "busy": self.batcher.busy_ms,
                         "image_hits": self.walk.counts[IMAGE_HIT]}
        ev = self.autoscaler.step(obs)
        if ev is not None:
            self._apply_scale(ev.state)

    def _apply_scale(self, state) -> None:
        self._account_provisioned()
        self.gpus_per_node = int(state.gpus_per_node)
        if state.cache_bytes_per_node != self._cache_bytes_per_node:
            self._cache_bytes_per_node = float(state.cache_bytes_per_node)
            self.walk.set_cache_capacity(self._cache_bytes_per_node)

    def _flush(self) -> Dict[int, np.ndarray]:
        try:
            return self.batcher.flush()
        finally:
            for n in self.nodes:
                n.queue_depth = 0               # all in-flight decodes drained

    def _gc(self, node: _Node) -> None:
        if len(node.images) > 2 * len(node.cache.image_tier) + 32:
            live = set(iter(node.cache.image_tier))
            node.images = {k: v for k, v in node.images.items() if k in live}
        if len(node.latents) > 2 * len(node.cache.latent_tier) + 32:
            live = set(iter(node.cache.latent_tier))
            node.latents = {k: v for k, v in node.latents.items()
                            if k in live}

    def summary(self) -> Dict[str, Any]:
        out = self.walk.summary()
        self._account_provisioned()
        out["gpu_seconds"] = self.batcher.busy_ms / 1e3
        out["decode_gpus"] = len(self.nodes) * self.gpus_per_node
        out["decode_util"] = (min(1.0, self.batcher.busy_ms / self._gpu_ms)
                              if self._gpu_ms > 0 else 0.0)
        out["provisioned_gpu_ms"] = self._gpu_ms
        out["provisioned_cache_byte_ms"] = self._cache_byte_ms
        if self.autoscaler is not None:
            out.update(self.autoscaler.summary())
        out["decode_batches"] = self.batcher.stats["batches"]
        out["decodes"] = self.batcher.stats["decodes"]
        out["coalesced_decodes"] = self.batcher.stats["coalesced"]
        out["decompressions"] = self.batcher.stats["decompressions"]
        out["decompress_memo_hits"] = self.batcher.stats["memo_hits"]
        out["pixel_format"] = self.cfg.pixel_format
        out["weight_dtype"] = self.cfg.weight_dtype
        if self.gate_lsb is not None:
            out["quantize_gate_lsb"] = dict(self.gate_lsb)
        out["device"] = str(self.batcher.device)
        return out
