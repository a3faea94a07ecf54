"""Public value types of the LatentBox object-store API.

Kept import-light (numpy + core configs only) so every store module —
tiers, walk, backends, facade — and both serving stacks can depend on it
without cycles.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.autoscale import AutoscaleConfig
from repro_torch.core.dual_cache import FULL_MISS, IMAGE_HIT, LATENT_HIT
from repro_torch.core.latent_store import (DEFAULT_OBJECT_BYTES,
                                     StoreLatencyModel)
from repro_torch.core.tuner import TunerConfig

#: Fourth hit class beyond the paper's three: the object was demoted to
#: recipe-only storage and must be regenerated before decode.
REGEN_MISS = "regen_miss"

HIT_CLASSES = (IMAGE_HIT, LATENT_HIT, FULL_MISS, REGEN_MISS)

#: :data:`DEFAULT_OBJECT_BYTES` (re-exported above) is the canonical
#: accounting size of an object whose real byte count is unknown — a
#: 0.28 MB compressed SD3.5-class latent (paper Table 1b), THE named home
#: of the old scattered ``0.28e6`` literals.  The value itself lives in
#: ``repro.core.latent_store`` only because ``core`` modules cannot
#: import ``repro.store`` without a cycle; store-side code references it
#: from here.


@dataclasses.dataclass
class StoreConfig:
    """One config for both backends.

    The cache/routing half (everything through ``latent_bytes``) drives the
    shared tier walk, so an engine box and a sim box built from the same
    ``StoreConfig`` classify a shared trace identically.  The plant half
    (``gpus_per_node`` onward) is only consumed by the simulator backend.
    """

    n_nodes: int = 2
    #: Explicit node names for the walk's ring (default: ``node0..node{N-1}``).
    #: A sharded cluster hands each shard a *slice of one global namespace*
    #: (e.g. shard 1 of a 2x2 fleet gets ``("node2", "node3")``): consistent
    #: hashing guarantees the owner among a subset of the ring is the global
    #: owner whenever it lies in that subset, so sharding never moves an
    #: object to a different node than the unsharded fleet would pick.
    node_names: Optional[Tuple[str, ...]] = None
    cache_bytes_per_node: float = 64e6
    alpha0: float = 0.5                 # initial image-tier fraction
    tau: float = 0.1                    # tail-segment fraction (tuner signal)
    promote_threshold: int = 4          # paper h: latent hits before promote;
                                        # doubles as the spillover depth bound
    #: Per-object accounting sizes.  The pixel tier stores *decoded*
    #: pixels in ``pixel_format`` — at the uint8 default an entry costs
    #: H*W*3 bytes, 4x less than the float32 images the engine used to
    #: pin (the engine additionally corrects the charge to each stored
    #: array's real ``nbytes``).  16e3 is the uint8 charge at the nominal
    #: ~73x73 demo object the old 64e3 float32 default described.
    image_bytes: float = 16e3
    latent_bytes: float = 13e3
    #: Stored dtype of pixel-cache entries: 'uint8' (the fused-epilogue
    #: fast path — displayable bytes straight off the decode) or
    #: 'float32' (legacy [-1, 1] float pixels).  Selects the ENGINE's
    #: decode output; the simulator has no payloads and always charges
    #: ``image_bytes``, so set ``image_bytes`` to an entry's size in this
    #: format (the engine corrects its charges to each array's real
    #: nbytes, and conformance tests rely on the two agreeing).
    pixel_format: str = "uint8"
    #: Storage precision of the decoder weights the uint8 fast path
    #: serves from: 'float32' (identity), 'bfloat16' (default-safe
    #: half-storage), or 'int8' (opt-in per-channel quantization).  The
    #: ENGINE applies it to its VAE at open time behind a ±1-LSB uint8
    #: output gate per decode bucket (:mod:`repro.vae.quantize`): a
    #: config whose quantized pixels drift further than ±1 LSB from the
    #: f32 oracle is rejected.  The simulator has no weights — ignored.
    weight_dtype: str = "float32"
    #: Enable the persistent Pallas kernel autotuner
    #: (:mod:`repro.kernels.autotune`): the engine loads
    #: ``data_dir/tuning_cache.json`` at open (tuned block shapes are
    #: compiled by ``prewarm_decode``) and tunes missing (kernel, shape,
    #: bucket, weight_dtype) keys with bounded work per dispatched batch
    #: (tune-on-first-miss).  Engine-only; no-op for the simulator.
    autotune: bool = False
    adaptive: bool = True               # run the marginal-hit tuner
    tuner: TunerConfig = dataclasses.field(
        default_factory=lambda: TunerConfig(window=500, step=0.02))
    decode_buckets: Tuple[int, ...] = (1, 2, 4, 8)
    # -- durable persistence (the log-structured on-disk tier) ---------------
    #: Directory of the segment log.  ``None`` (default) keeps the durable
    #: tier in memory (sim-mode conformance; nothing survives the
    #: process).  Set — usually via ``LatentBox.open(path)`` — to persist
    #: latents AND recipes through one append-only checksummed log with
    #: manifest-checkpointed recovery and online compaction.
    data_dir: Optional[str] = None
    segment_bytes: float = 4e6          # active segment seals past this
    fsync: bool = False                 # force platters on every flush/ack
    checkpoint_every: int = 1024        # appends between manifest checkpoints
    #: Sealed segments at or below this live fraction compact (coldest
    #: first), one per maintenance step.  0 disables online compaction.
    compact_live_frac: float = 0.6
    #: ``False`` (default): every put is flushed before it is acknowledged
    #: (``PutResult.durable``).  ``True``: puts buffer and become durable
    #: at the next ``flush()`` — the serving engine flushes once per
    #: request window, trading a bounded unacknowledged tail for
    #: sequential-append write cost.
    write_behind: bool = False
    #: Injectable wall clock (seconds) for the engine's store-latency
    #: draws; ``None`` = ``time.time``.  The simulator always uses its
    #: virtual clock; injecting a fake clock here makes the ENGINE's
    #: warm/cold latency classification deterministic under test.
    clock: Optional[Callable[[], float]] = None
    # -- simulator plant ----------------------------------------------------
    gpus_per_node: int = 1
    decode_ms: float = 31.0
    generation_ms: float = 3905.0       # full diffusion pipeline (regen cost)
    net_ms: float = 10.0
    latent_ship_ms: float = 1.0
    decode_jitter_sigma: float = 0.0    # 0 => deterministic sim latencies
    store_latency: StoreLatencyModel = dataclasses.field(
        default_factory=StoreLatencyModel)
    seed: int = 0
    # -- elastic autoscaling (off by default: provably a no-op) --------------
    #: Run the cost-model-driven :class:`~repro.core.autoscale.
    #: AutoscaleController`: every control window the backend trades
    #: decode-GPU count against cache bytes (and, on a sharded cluster,
    #: shard count) for the cheapest SLO-feasible plant.  ``False`` builds
    #: no controller at all — the default path is untouched.
    autoscale: bool = False
    #: Control-loop knobs; ``None`` = :class:`AutoscaleConfig` defaults.
    autoscale_cfg: Optional[AutoscaleConfig] = None

    def __post_init__(self) -> None:
        if self.pixel_format not in ("uint8", "float32"):
            raise ValueError(f"pixel_format must be 'uint8' or 'float32': "
                             f"{self.pixel_format!r}")
        if self.weight_dtype not in ("float32", "bfloat16", "int8"):
            raise ValueError(f"weight_dtype must be 'float32', 'bfloat16' "
                             f"or 'int8': {self.weight_dtype!r}")
        if self.node_names is not None:
            self.node_names = tuple(self.node_names)
            if len(set(self.node_names)) != len(self.node_names):
                raise ValueError(f"duplicate node names: {self.node_names}")
            self.n_nodes = len(self.node_names)

    def now_s(self) -> float:
        """The injectable wall clock every engine-side ``now_s`` routes
        through (satellite of the durable-store PR: no more bare
        ``time.time()`` on the serve path)."""
        return time.time() if self.clock is None else float(self.clock())


@dataclasses.dataclass
class PutResult:
    oid: int
    stored_bytes: float                 # durable latent bytes written
    recipe_bytes: float = 0.0           # recipe payload bytes (0: none)
    format: str = "latent"              # 'latent' | 'size' (sim, size-only)
    prewarmed: bool = False
    #: True when this put is crash-durable at return: its record (and the
    #: recipe's) is flushed to the on-disk log.  False in memory mode and
    #: under ``write_behind`` (durable at the next ``flush()``).
    durable: bool = False


@dataclasses.dataclass
class GetResult:
    """One request's answer: payload + hit class + latency breakdown."""

    oid: int
    hit_class: str                        # one of HIT_CLASSES
    payload: Optional[np.ndarray] = None  # decoded pixels (engine); None (sim)
    node: int = -1                        # cache owner (hash-pinned home)
    exec_node: int = -1                   # where the decode ran
    spilled: bool = False
    regenerated: bool = False
    #: The owner shard was dead/partitioned and a replica served the read.
    failover: bool = False
    #: A speculative replica fetch was fired AND won the race; latency_ms
    #: reflects the hedged path.  (Fired-but-lost hedges only count in the
    #: cluster's ``hedges_fired``.)
    hedged: bool = False
    latency_ms: Dict[str, float] = dataclasses.field(default_factory=dict)

    @property
    def total_ms(self) -> float:
        return self.latency_ms.get("total", 0.0)


@dataclasses.dataclass
class ObjectStat:
    oid: int
    residency: List[str]                  # e.g. ['image@node0', 'durable']
    durable_bytes: float = 0.0
    recipe_bytes: float = 0.0
    #: Bytes the pixel tier charges for this object (0.0 when not
    #: pixel-resident) — real stored-array bytes on the engine backend.
    pixel_bytes: float = 0.0
    demoted: bool = False                 # recipe-only durability class
    #: Rate-distortion ladder position (``repro.compression.ladder``):
    #: the rung the durable bytes are encoded at (0 = lossless; the
    #: recipe rung when demoted; None when the object has no durable
    #: class at all), its name, and any not-yet-applied demotion target
    #: awaiting the compactor (segment-log backends only).
    rung: Optional[int] = None
    rung_name: Optional[str] = None
    target_rung: Optional[int] = None
    meta: Optional[Dict[str, Any]] = None
