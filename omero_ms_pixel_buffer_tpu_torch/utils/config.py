"""Layered YAML config with the reference's key schema, plus TPU keys
(copy of ``omero_ms_pixel_buffer_tpu/utils/config.py``: the same
dataclasses, field names, defaults and ``ConfigError`` messages; the
port's wiring, ``http/server.py`` ``wire``, decides what each key does
here). Without PyYAML, ``Config.load`` reads a file written in YAML's
JSON subset with ``json``.

The reference uses Vert.x ConfigRetriever: default stores (sys props /
env) overlaid with an optional ``conf/config.yaml``
(PixelBufferMicroserviceVerticle.java:120-130; shipped config at
src/dist/conf/config.yaml). Keys reproduced here:

- ``port`` (8082), ``event-bus-send-timeout`` (15000 ms),
  ``worker_pool_size`` (default 2 x CPUs,
  PixelBufferMicroserviceVerticle.java:117-118)
- ``omero.host`` / ``omero.port`` — OMERO server for session joins
- ``omero.server.*`` — embedded data-layer properties (data dir, pixels
  service selection, DB creds); config.yaml:12-19
- ``session-store.{type,synchronicity,uri}`` — config.yaml:22-34;
  missing block is a hard startup error
  (PixelBufferMicroserviceVerticle.java:258-261)
- ``http-tracing.{enabled,zipkin-url}``, ``jmx-metrics.enabled``

New (TPU) keys live under ``backend``: engine selection, batching shape
buckets, coalesce window, mesh axes.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Optional

import json

try:  # PyYAML ships with the base image's dep chain; gate just in case.
    import yaml
except ImportError:  # pragma: no cover
    yaml = None


class ConfigError(ValueError):
    """Hard startup error for missing required blocks
    (PixelBufferMicroserviceVerticle.java:155-158,258-261,270-273)."""


@dataclasses.dataclass
class SessionStoreConfig:
    type: str = "memory"  # reference: "redis" | "postgres"; we add "memory"
    synchronicity: str = "async"
    uri: Optional[str] = None


@dataclasses.dataclass
class BurstContinuationConfig:
    """The backend.batching.burst-continuation: block — when a
    short coalesce window catches lanes that share a burst identity
    (image + render spec + resolution + session + burst tile grid),
    the window extends by up to ``window_ms`` so the rest of the zoom
    burst joins the SAME batch, and the identity carries across
    dispatches so a straggling 100-tile zoom executes as a handful of
    device programs instead of one per window. The extension is
    deadline-bounded at half the tightest remaining lane budget."""

    enabled: bool = True
    window_ms: float = 25.0


@dataclasses.dataclass
class BatchingConfig:
    """TPU batch-executor tuning (no reference analog; replaces the
    worker-pool sizing knob as the throughput control)."""

    # Shape buckets (square tile edge) requests are padded up to.
    buckets: tuple = (256, 512, 1024)
    # Max lanes coalesced into one TPU batch.
    max_batch: int = 32
    # How long the coalescer waits to fill a batch before flushing.
    coalesce_window_ms: float = 2.0
    # Encode on device (Pallas deflate) vs host zlib.
    device_encode: bool = True
    # Cross-window burst affinity (see BurstContinuationConfig).
    burst_continuation: BurstContinuationConfig = dataclasses.field(
        default_factory=BurstContinuationConfig
    )


@dataclasses.dataclass
class PngConfig:
    """PNG encode tuning. Strategy "fast" (the native RLE + dynamic-
    Huffman encoder) matches zlib level-6 ratios on filtered microscopy
    data at >10x the speed; every strategy emits a compliant stream
    (the correctness contract is decoded-pixel equality, not byte
    equality)."""

    filter: str = "up"  # none | sub | up | average | paeth | adaptive
    level: int = 6
    # fast | default | filtered | huffman | rle | fixed
    strategy: str = "fast"
    # Build the zlib stream on the accelerator (ops/device_deflate)
    # for device PNG lanes instead of host deflate: only compressed
    # bytes cross the link and the host's role shrinks to PNG chunk
    # framing. On by default — it only engages when the device engine
    # serves the lane.
    device_deflate: bool = True
    # Which stream the accelerator builds for raw PNG lanes:
    # "dynamic" (two-pass canonical Huffman — ~host-parity ratio),
    # "rle" (fixed Huffman, one dispatch), or "stored". Render lanes
    # always use "rle" (their host-mirror byte-identity contract).
    device_deflate_mode: str = "dynamic"
    # Bounded in-flight encode groups in the streaming device queue:
    # 2 keeps the classic double buffer; deeper queues absorb longer
    # host stalls at the cost of HBM residency per in-flight group.
    queue_depth: int = 2


@dataclasses.dataclass
class BackendConfig:
    engine: str = "jax"  # "jax"/"auto" | "device" | "host"
    batching: BatchingConfig = dataclasses.field(default_factory=BatchingConfig)
    png: PngConfig = dataclasses.field(default_factory=PngConfig)
    # Per-request allocation guard (MiB); 0 disables. The reference
    # allocates w*h*bpp unchecked (TileRequestHandler.java:98-103).
    max_tile_mb: int = 256


@dataclasses.dataclass
class BreakerConfig:
    """Circuit-breaker thresholds (resilience.breaker). A breaker
    opens on EITHER ``failure_threshold`` consecutive failures or a
    failure rate >= ``failure_rate_threshold`` over the last
    ``window`` calls (once ``min_calls`` outcomes exist); it stays
    open ``open_duration_ms`` and then admits ``half_open_probes``
    trial calls."""

    failure_threshold: int = 5
    failure_rate_threshold: float = 0.5
    window: int = 20
    min_calls: int = 10
    open_duration_ms: float = 30000.0
    half_open_probes: int = 1
    # Slow-call trip rule: a call that *succeeds* slower than
    # ``slow_call_duration_ms`` counts toward a separate rate; past
    # ``slow_call_rate_threshold`` over the window the breaker opens.
    # 0 disables (failures only).
    slow_call_duration_ms: float = 0.0
    slow_call_rate_threshold: float = 1.0


@dataclasses.dataclass
class RetryConfig:
    """Jittered-exponential retry shape for remote-I/O edges
    (resilience.retry). ``budget_ms`` caps cumulative backoff sleep
    per call; the ambient request deadline additionally bounds every
    attempt."""

    max_attempts: int = 3
    base_delay_ms: float = 50.0
    max_delay_ms: float = 2000.0
    jitter: float = 0.5
    budget_ms: float = 5000.0


@dataclasses.dataclass
class AdmissionConfig:
    """HTTP-front load shedding (resilience.admission): beyond
    ``max_inflight`` concurrent tile requests the front answers 503
    with ``Retry-After: retry_after_s``."""

    max_inflight: int = 256
    retry_after_s: float = 1.0


@dataclasses.dataclass
class WatchdogConfig:
    """Event-loop lag watchdog (resilience.watchdog) — the Vert.x
    BlockedThreadChecker analog (utils/loop_watchdog.py). ``warn_ms``
    is the blocked threshold past which the loop thread's stack is
    logged; lag histograms export regardless."""

    enabled: bool = True
    interval_ms: float = 100.0
    warn_ms: float = 1000.0


@dataclasses.dataclass
class ResilienceConfig:
    """The resilience: block — one policy surface for breakers,
    retries, deadlines, and admission control (resilience/ package).
    ``request_budget_ms`` None means "use event-bus-send-timeout" (the
    deadline minted per request at the HTTP front).
    ``io_timeout_ms`` caps every single network exchange on the
    Postgres/Redis/Glacier2 edges (resilience/timeouts.py); 0
    disables, leaving only the request deadline."""

    enabled: bool = True
    breaker: BreakerConfig = dataclasses.field(default_factory=BreakerConfig)
    retry: RetryConfig = dataclasses.field(default_factory=RetryConfig)
    admission: AdmissionConfig = dataclasses.field(
        default_factory=AdmissionConfig
    )
    watchdog: WatchdogConfig = dataclasses.field(
        default_factory=WatchdogConfig
    )
    request_budget_ms: Optional[float] = None
    io_timeout_ms: float = 5000.0


@dataclasses.dataclass
class SloConfig:
    """The slo: block — SLO-aware scheduling + graceful degradation
    (resilience/scheduler.py). ``queue_size`` is the deadline-ordered
    wait room past ``resilience.admission.max-inflight`` (0 restores
    the binary shed-at-the-door gate); ``class_weights`` are the
    weighted-round-robin grants per cycle for
    (interactive, prefetch, bulk); ``degrade`` enables the
    hybrid-resolution fallback when a grant's remaining budget is
    inside ``degrade_factor`` x the full-resolution service-time
    EWMA; ``sweep_window`` consecutive constant-stride steps demote a
    session to the bulk class for ``sweep_ttl_s``."""

    enabled: bool = True
    queue_size: int = 512
    class_weights: tuple = (8, 2, 1)
    degrade: bool = True
    degrade_factor: float = 1.5
    sweep_window: int = 16
    sweep_ttl_s: float = 30.0
    # Override header clients may set to label themselves
    # (interactive|prefetch|bulk); empty string disables the override.
    priority_header: str = "x-ompb-priority"


@dataclasses.dataclass
class ObsConfig:
    """The obs: block — the flight-recorder observability plane
    (obs/ package). ``enabled`` turns the per-request stamp record,
    the tail sampler, the ``/debug/requests`` ring, and the SLI layer
    on (default) or off entirely; ``slow_threshold_ms`` is both the
    tail sampler's keep-if-slower bound and the SLI latency budget;
    ``head_sample_rate`` keeps that fraction of healthy fast requests
    (deterministic per trace id); ``ring_size`` bounds the in-memory
    wide-event ring."""

    enabled: bool = True
    slow_threshold_ms: float = 300.0
    head_sample_rate: float = 0.01
    ring_size: int = 512


@dataclasses.dataclass
class SessionPlaneConfig:
    """The session: block — the interactive session plane (session/
    package): live push channels (WebSocket + SSE fallback) at
    ``GET /session/{imageId}/live`` and annotation CRUD at
    ``/annotations/{imageId}``. ``max_channels``/``max_per_image``
    bound the channel registry (registrations beyond them answer 503
    — explicit backpressure, never eviction of someone else's live
    channel); ``queue_size`` bounds each channel's outbound frame
    queue (a slow viewer drops frames, counted, never blocks the
    purge path); ``ping_interval_s`` is the idle keepalive cadence
    AND the session re-validation period (a revoked browser session
    is disconnected within one interval); the annotation bounds cap
    the in-memory store (per-image never exceeds the render path's
    MAX_SHAPES)."""

    enabled: bool = True
    max_channels: int = 256
    max_per_image: int = 64
    queue_size: int = 64
    ping_interval_s: float = 15.0
    max_annotations_per_image: int = 64
    max_annotation_images: int = 1024


@dataclasses.dataclass
class PrefetchConfig:
    """Viewport prefetch (cache.prefetch): speculative warming of the
    result cache from per-session access streams, shed first under
    load (``headroom`` is the fraction of admission capacity real
    traffic may use before prefetch stops entirely). ``budget_ms`` 0
    (default) gives each prefetch the full request budget: a REAL
    request that pans onto a predicted tile joins the prefetch's
    single-flight, so a shorter prefetch deadline would 504 the real
    request on a slow store where a direct request would have
    succeeded."""

    enabled: bool = True
    queue_size: int = 256
    headroom: float = 0.5
    budget_ms: float = 0.0
    lookahead: int = 2
    # whole-viewport speculation: perpendicular tiles predicted
    # each side of the pan trajectory at every lookahead step, so the
    # speculative band fuses into the super-tile path. 0 restores the
    # the base prediction (continuation + nearest perpendicular pair at the
    # first step only).
    viewport_span: int = 1


@dataclasses.dataclass
class TinyLfuConfig:
    """TinyLFU admission for the memory tier (cache.tinylfu —
    cache/plane/tinylfu.py). ``counters`` sizes the 4-bit count-min
    sketch (and the doorkeeper bloom bits); ``sample_size`` is the
    aging period in recorded accesses, 0 = 10x counters (the Caffeine
    default shape)."""

    enabled: bool = True
    counters: int = 16384
    sample_size: int = 0


@dataclasses.dataclass
class CacheConfig:
    """The cache: block — the tiered rendered-tile result cache
    (cache/ package). ``disk_dir`` None disables the spill tier;
    ``ttl_s`` 0 disables time-based expiry (metadata invalidation
    still purges); ``etag_precheck`` answers If-None-Match 304s from
    the cache before the per-request OMERO session join (safe: a
    matching strong content ETag proves the client already holds
    those exact bytes); ``manifest`` journals the disk tier so
    restarts begin warm (cache/plane/manifest.py)."""

    enabled: bool = True
    memory_mb: int = 256
    protected_fraction: float = 0.8
    disk_dir: Optional[str] = None
    disk_mb: int = 1024
    ttl_s: float = 0.0
    max_entry_kb: int = 4096
    max_age_s: float = 60.0
    etag_precheck: bool = True
    manifest: bool = True
    prefetch: PrefetchConfig = dataclasses.field(
        default_factory=PrefetchConfig
    )
    tinylfu: TinyLfuConfig = dataclasses.field(
        default_factory=TinyLfuConfig
    )


@dataclasses.dataclass
class ClusterL2Config:
    """The shared L2 tier (cluster.l2 — cache/plane/l2.py): a Redis
    consulted between local miss and render. ``uri`` None disables;
    ``ttl_s`` bounds staleness for entries whose writer died before
    an invalidation reached Redis (0 = no expiry)."""

    uri: Optional[str] = None
    ttl_s: float = 3600.0


@dataclasses.dataclass
class ClusterHedgeConfig:
    """Owner-side hedging (cluster/hedge.py): start the local render
    when a peer fetch runs past the observed peer-stage quantile.
    ``fallback_ms`` 0 means half the peer timeout (used before the
    stage histogram has any samples)."""

    enabled: bool = False
    quantile: float = 0.99
    min_ms: float = 20.0
    max_ms: float = 250.0
    fallback_ms: float = 0.0


@dataclasses.dataclass
class ClusterDrainConfig:
    """Graceful drain (cluster/lifecycle.py): the planned-leave
    protocol SIGTERM (and a signed POST /internal/drain) triggers.
    ``deadline_s`` bounds the whole protocol — marker propagation,
    hot-set handoff, in-flight quiescence; ``signal`` installs the
    SIGTERM handler (off leaves SIGTERM as an immediate stop — the
    crash path the fleet already survives)."""

    deadline_s: float = 10.0
    signal: bool = True


@dataclasses.dataclass
class ClusterRepairConfig:
    """Anti-entropy repair (cluster/repair.py): ``interval_s`` > 0
    runs the low-duty digest-exchange loop (one rotating peer per
    round); ``max_keys`` bounds the entries pulled per round (the
    transfer byte cap bounds the payload independently)."""

    interval_s: float = 0.0
    max_keys: int = 64


@dataclasses.dataclass
class ClusterGossipConfig:
    """Decentralized coordination (cluster/gossip.py): SWIM-style
    push-pull gossip over the signed /internal/gossip endpoint.
    Enabled, membership + epochs + fleet brains disseminate peer-to-
    peer — the ring keeps rebuilding, invalidations keep fanning out,
    and suspicion keeps demoting through a total Redis outage (Redis,
    when configured, demotes to L2 cache + join-bootstrap hint).
    ``interval_s`` paces the rounds; ``fanout`` is the targets per
    round; a member whose heartbeat stalls past ``fail_after_s``
    leaves the live view."""

    enabled: bool = False
    interval_s: float = 1.0
    fanout: int = 2
    fail_after_s: float = 5.0


@dataclasses.dataclass
class ClusterIntegrityConfig:
    """End-to-end byte integrity (cluster/integrity.py): every
    transfer path (peer fetch, replication push, handoff, repair
    pull, L2 read) cross-checks the body against the entry's strong
    content hash when ``verify_bodies`` is on; a mismatch discards
    the bytes and, after ``verdict_after`` fresh strikes, feeds the
    suspicion quorum as a corruption verdict."""

    verify_bodies: bool = True
    verdict_after: int = 1


@dataclasses.dataclass
class ClusterSuspectConfig:
    """Quality-based suspicion (cluster/suspect.py): a replica whose
    self-reported error rate crosses ``error_rate``, whose p99
    exceeds ``p99_factor`` x the fleet median, or against whom a
    peer's client failed ``peer_failures``+ times in a heartbeat
    window earns a BAD verdict; a strict majority of verdicts demotes
    it to non-owner until its signals recover. ``min_requests`` is
    the self-report floor below which signals are too thin to
    judge."""

    enabled: bool = False
    error_rate: float = 0.5
    p99_factor: float = 3.0
    min_requests: int = 8
    peer_failures: int = 3


@dataclasses.dataclass
class ClusterConfig:
    """The cluster: block — the distributed cache plane
    (cache/plane/), the coordination plane (cluster/), and the
    lifecycle + repair plane. ``members`` seeds the consistent-
    hash ring; ``self_url`` identifies this replica on it and enables
    peer fetch. With ``lease_ttl_s`` > 0 the seed is only the
    BOOTSTRAP view: replicas hold heartbeat-refreshed leases in the
    shared Redis and the ring rebuilds live as leases appear/expire.
    ``replication_factor`` >= 2 pushes TinyLFU-hot entries to the
    ring successor(s) and enables the join-time warm-up transfer;
    ``secret`` HMAC-authenticates the /internal/* peer surface
    (nonce-stamped, replay-proof). ``drain``/``repair``/``suspect``
    configure the self-healing lifecycle. An empty block (the
    default) keeps the service single-process."""

    members: tuple = ()
    self_url: Optional[str] = None
    virtual_nodes: int = 64
    peer_timeout_ms: float = 500.0
    lease_ttl_s: float = 0.0
    replication_factor: int = 1
    transfer_max_entries: int = 128
    secret: Optional[str] = None
    hedge: ClusterHedgeConfig = dataclasses.field(
        default_factory=ClusterHedgeConfig
    )
    l2: ClusterL2Config = dataclasses.field(
        default_factory=ClusterL2Config
    )
    drain: ClusterDrainConfig = dataclasses.field(
        default_factory=ClusterDrainConfig
    )
    repair: ClusterRepairConfig = dataclasses.field(
        default_factory=ClusterRepairConfig
    )
    suspect: ClusterSuspectConfig = dataclasses.field(
        default_factory=ClusterSuspectConfig
    )
    gossip: ClusterGossipConfig = dataclasses.field(
        default_factory=ClusterGossipConfig
    )
    integrity: ClusterIntegrityConfig = dataclasses.field(
        default_factory=ClusterIntegrityConfig
    )

    @property
    def plane_enabled(self) -> bool:
        return bool(self.l2.uri) or (
            bool(self.members) and self.self_url is not None
        )


@dataclasses.dataclass
class IoConfig:
    """The io: block — the batched read plane (io/fetch.py).
    ``parallel_fetch`` False restores the strictly sequential
    one-GET-per-chunk path; ``fetch_workers`` bounds the shared
    fan-out executor; ``max_conns_per_host`` bounds the keep-alive
    pool (and therefore per-origin concurrency); ``coalesce_gap_kb``
    merges adjacent ranged reads separated by at most this many KiB
    into one request; ``decode_workers`` bounds the parallel chunk
    decode pool (0 = decode serially); ``negative_ttl_s`` bounds how
    long an absent chunk (fill_value) is remembered by the block
    cache (0 = never expires); ``shard_index_ttl_s`` bounds how long
    a zarr v3 shard's parsed index footer is memoized, so a shard
    rewritten in place is observed without a restart (0 = never
    expires)."""

    parallel_fetch: bool = True
    fetch_workers: int = 16
    max_conns_per_host: int = 8
    coalesce_gap_kb: float = 64.0
    decode_workers: int = 4
    negative_ttl_s: float = 300.0
    shard_index_ttl_s: float = 300.0


@dataclasses.dataclass
class RenderConfig:
    """The render: block — the /render serving surface (render/
    package). ``lut_dir`` points at a directory of ImageJ ``.lut``
    files loaded into the LUT registry at startup; ``jpeg_quality``
    is the default when a request carries no ``q``."""

    enabled: bool = True
    lut_dir: Optional[str] = None
    jpeg_quality: int = 90


@dataclasses.dataclass
class AnalysisConfig:
    """The analysis: block — the /histogram serving surface
    (render/analysis.py). ``max_bins`` caps the per-request ``bins``
    param (the reduction materializes a bins-wide table per lane, so
    operators bound it like any other allocation)."""

    enabled: bool = True
    max_bins: int = 65536


@dataclasses.dataclass
class ProtocolAdapterConfig:
    """One viewer-protocol adapter (http/protocols/): an independently
    shippable grammar over the native TileCtx/RenderSpec core.
    ``tile_size`` is the grid the dialect advertises (DZI TileSize /
    IIIF tile width / Iris layer grid)."""

    enabled: bool = True
    tile_size: int = 256


@dataclasses.dataclass
class ProtocolsConfig:
    """The protocols: block — per-adapter enable flags so an operator
    can ship ``/histogram`` + DZI without exposing IIIF (or turn the
    whole plane off). Adapters translate foreign URL grammars into
    the SAME resolved TileCtx/RenderSpec the native endpoints build,
    so they share cache entries, ETags, and admission behavior."""

    dzi: ProtocolAdapterConfig = dataclasses.field(
        default_factory=ProtocolAdapterConfig
    )
    iiif: ProtocolAdapterConfig = dataclasses.field(
        default_factory=ProtocolAdapterConfig
    )
    iris: ProtocolAdapterConfig = dataclasses.field(
        default_factory=ProtocolAdapterConfig
    )


@dataclasses.dataclass
class SupertileConfig:
    """The supertile: block — super-tile fusion (render/supertile).
    The dispatch batcher buckets spatially adjacent render
    lanes of one (image, spec, resolution) into fused super-tiles:
    one plane gather over the bounding rectangle, one composite,
    per-tile regions carved out byte-identically. ``max_pixels``
    bounds the bounding-RECT area one fusion may gather (the
    allocation ceiling); ``min_lanes`` is the smallest neighborhood
    worth fusing; ``coverage`` is the minimum fraction of the
    bounding rect the member tiles must cover (sparse neighborhoods
    would gather mostly pixels nobody asked for). ``mesh`` shard_maps
    the fused gather+composite+carve+deflate across the serving mesh
    (the mesh-fusion plane); False reverts to the pre-fusion
    preference where an active mesh sends lanes down the per-lane
    sharded path instead — the escape hatch, byte-identical either
    way."""

    enabled: bool = True
    max_pixels: int = 4 << 20  # 4 Mpx ~ a 2048x2048 viewport
    min_lanes: int = 2
    coverage: float = 0.5
    mesh: bool = True


@dataclasses.dataclass
class MeshConfig:
    """The mesh: block — serving-mesh health. ``probe_interval_ms``
    > 0 runs MeshManager's chip probe on a background cadence so a
    recovered chip rejoins the mesh BEFORE the next dispatch failure
    (the reactive-only degradation gap); 0 (default) keeps probing
    purely reactive."""

    probe_interval_ms: float = 0.0


@dataclasses.dataclass
class IngestConfig:
    """The ingest: block — the write path (ingest/assembler.py).

    Off by default: the service stays a pure read-only viewer backend
    unless an operator explicitly opens the write surface. The bounds
    cap a single request's staged state: ``max_inflight_shards`` is
    the most distinct store objects (shards, or chunks when unsharded)
    one commit may touch; ``staging_bytes`` bounds the decoded chunks
    held in RAM while tiles assemble."""

    enabled: bool = False
    max_inflight_shards: int = 64
    staging_bytes: int = 256 << 20


@dataclasses.dataclass
class JaxConfig:
    """The jax: block — runtime knobs for the accelerator toolchain.

    ``compilation-cache-dir`` pins jax's persistent XLA compilation
    cache (runtime/jax_cache.py) so the device encode programs' tens-
    of-seconds TPU compiles survive process restarts; an explicit dir
    engages on ANY backend (operator opt-in), unlike the TPU-only
    ``OMPB_JAX_CACHE_DIR`` env fallback."""

    compilation_cache_dir: Optional[str] = None


@dataclasses.dataclass
class LoggingConfig:
    """Reference logging (src/dist/conf/logback.xml): stdout by
    default; with a file, daily rolling with 7-day retention."""

    file: Optional[str] = None
    level: str = "INFO"
    retention_days: int = 7


@dataclasses.dataclass
class Config:
    port: int = 8082
    event_bus_send_timeout_ms: int = 15000  # config.yaml:5
    worker_pool_size: Optional[int] = None  # default 2 x CPUs at deploy
    omero_host: str = "localhost"
    omero_port: int = 4064
    # Join the OMERO session per request over Glacier2 (the reference's
    # OmeroRequest behavior). Off by default: standalone deployments
    # have no OMERO server, and the session store already authenticated
    # the browser session.
    omero_validate_sessions: bool = False
    omero_secure: bool = True  # Glacier2 over TLS (OMERO default)
    # Verify the router's TLS certificate. Opt out only for
    # self-signed deployments — without verification the join can be
    # spoofed by an on-path attacker.
    omero_verify_tls: bool = True
    # How long a successful Glacier2 join keeps authorizing a session
    # key without re-joining. 0 restores the reference's strict
    # per-request join (PixelBufferVerticle.java:106-110); the >0
    # default trades up-to-TTL staleness after an OMERO logout for not
    # paying one TLS handshake + router session per tile of a burst.
    omero_session_validation_ttl_s: float = 30.0
    omero_server: dict = dataclasses.field(default_factory=dict)
    session_store: SessionStoreConfig = dataclasses.field(
        default_factory=SessionStoreConfig
    )
    http_tracing_enabled: bool = False
    zipkin_url: Optional[str] = None
    jmx_metrics_enabled: bool = True  # config.yaml:43-44 analog
    backend: BackendConfig = dataclasses.field(default_factory=BackendConfig)
    resilience: ResilienceConfig = dataclasses.field(
        default_factory=ResilienceConfig
    )
    slo: SloConfig = dataclasses.field(default_factory=SloConfig)
    obs: ObsConfig = dataclasses.field(default_factory=ObsConfig)
    session: SessionPlaneConfig = dataclasses.field(
        default_factory=SessionPlaneConfig
    )
    cache: CacheConfig = dataclasses.field(default_factory=CacheConfig)
    cluster: ClusterConfig = dataclasses.field(
        default_factory=ClusterConfig
    )
    io: IoConfig = dataclasses.field(default_factory=IoConfig)
    render: RenderConfig = dataclasses.field(default_factory=RenderConfig)
    analysis: AnalysisConfig = dataclasses.field(
        default_factory=AnalysisConfig
    )
    protocols: ProtocolsConfig = dataclasses.field(
        default_factory=ProtocolsConfig
    )
    supertile: SupertileConfig = dataclasses.field(
        default_factory=SupertileConfig
    )
    mesh: MeshConfig = dataclasses.field(default_factory=MeshConfig)
    ingest: IngestConfig = dataclasses.field(default_factory=IngestConfig)
    jax: JaxConfig = dataclasses.field(default_factory=JaxConfig)
    logging: LoggingConfig = dataclasses.field(default_factory=LoggingConfig)
    # Filesystem image registry (stands in for the OMERO Postgres
    # metadata plane when running without a server; see io.pixels_service).
    image_registry: Optional[str] = None

    @property
    def effective_worker_pool_size(self) -> int:
        if self.worker_pool_size is not None:
            return self.worker_pool_size
        return 2 * (os.cpu_count() or 1)

    @staticmethod
    def _parse_deflate_mode(value) -> str:
        if value not in ("dynamic", "rle", "stored"):
            # typos must fail at startup, not silently pick a stream
            raise ConfigError(
                "Invalid value for 'backend.png.device-deflate-mode': "
                f"{value!r} (expected dynamic|rle|stored)"
            )
        return value

    @staticmethod
    def _parse_queue_depth(value) -> int:
        try:
            depth = int(value)
        except (TypeError, ValueError):
            raise ConfigError(
                "Invalid value for 'backend.png.queue-depth': "
                f"{value!r} (expected an integer >= 1)"
            ) from None
        if depth < 1:
            raise ConfigError("'backend.png.queue-depth' must be >= 1")
        return depth

    @staticmethod
    def _parse_ttl_value(value) -> float:
        try:
            ttl = float(value)
        except (TypeError, ValueError):
            raise ConfigError(
                "Invalid value for 'omero.session-validation-ttl': "
                f"{value!r} (expected seconds; 0 = per-request join)"
            ) from None
        if ttl < 0:
            raise ConfigError(
                "'omero.session-validation-ttl' must be >= 0"
            )
        return ttl

    @staticmethod
    def _parse_resilience(raw: dict) -> ResilienceConfig:
        """Validate the resilience: block — typos and nonsense values
        must fail at startup, not silently run with defaults (the
        session-store.type precedent)."""
        res_raw = raw.get("resilience") or {}
        br = res_raw.get("breaker") or {}
        rt = res_raw.get("retry") or {}
        ad = res_raw.get("admission") or {}
        wd = res_raw.get("watchdog") or {}

        def _num(block: dict, key: str, default, minimum, cast=float):
            try:
                value = cast(block.get(key, default))
            except (TypeError, ValueError):
                raise ConfigError(
                    f"Invalid value for 'resilience...{key}': "
                    f"{block.get(key)!r}"
                ) from None
            if value < minimum:
                raise ConfigError(
                    f"'resilience...{key}' must be >= {minimum}"
                )
            return value

        rate = _num(br, "failure-rate-threshold", 0.5, 0.0)
        if rate > 1.0:
            raise ConfigError(
                "'resilience.breaker.failure-rate-threshold' must be "
                "in [0, 1]"
            )
        slow_rate = _num(br, "slow-call-rate-threshold", 1.0, 0.0)
        if slow_rate > 1.0:
            raise ConfigError(
                "'resilience.breaker.slow-call-rate-threshold' must "
                "be in [0, 1]"
            )
        jitter = _num(rt, "jitter", 0.5, 0.0)
        if jitter > 1.0:
            # jitter subtracts up to this fraction of each delay;
            # > 1 would produce negative sleeps
            raise ConfigError("'resilience.retry.jitter' must be in [0, 1]")
        window = _num(br, "window", 20, 1, int)
        min_calls = _num(br, "min-calls", 10, 1, int)
        if min_calls > window:
            # outcomes live in a window-sized deque: a min-calls the
            # window can never reach silently disables the rate rule
            raise ConfigError(
                "'resilience.breaker.min-calls' must be <= "
                "'resilience.breaker.window'"
            )
        budget = res_raw.get("request-budget-ms")
        return ResilienceConfig(
            enabled=bool(res_raw.get("enabled", True)),
            breaker=BreakerConfig(
                failure_threshold=_num(
                    br, "failure-threshold", 5, 1, int
                ),
                failure_rate_threshold=rate,
                window=window,
                min_calls=min_calls,
                open_duration_ms=_num(br, "open-duration-ms", 30000.0, 0.0),
                half_open_probes=_num(br, "half-open-probes", 1, 1, int),
                slow_call_duration_ms=_num(
                    br, "slow-call-duration-ms", 0.0, 0.0
                ),
                slow_call_rate_threshold=slow_rate,
            ),
            retry=RetryConfig(
                max_attempts=_num(rt, "max-attempts", 3, 1, int),
                base_delay_ms=_num(rt, "base-delay-ms", 50.0, 0.0),
                max_delay_ms=_num(rt, "max-delay-ms", 2000.0, 0.0),
                jitter=jitter,
                budget_ms=_num(rt, "budget-ms", 5000.0, 0.0),
            ),
            admission=AdmissionConfig(
                max_inflight=_num(ad, "max-inflight", 256, 1, int),
                retry_after_s=_num(ad, "retry-after-s", 1.0, 0.0),
            ),
            watchdog=WatchdogConfig(
                enabled=bool(wd.get("enabled", True)),
                interval_ms=_num(wd, "interval-ms", 100.0, 1.0),
                warn_ms=_num(wd, "warn-ms", 1000.0, 1.0),
            ),
            request_budget_ms=(
                None if budget is None
                else _num(res_raw, "request-budget-ms", None, 1.0)
            ),
            io_timeout_ms=_num(res_raw, "io-timeout-ms", 5000.0, 0.0),
        )

    @staticmethod
    def _parse_slo(raw: dict) -> SloConfig:
        """Validate the slo: block — same posture as resilience/cache:
        typos and nonsense fail at startup, never silently default."""
        sl = raw.get("slo") or {}
        unknown = set(sl) - {
            "enabled", "queue-size", "class-weights", "degrade",
            "degrade-factor", "sweep-window", "sweep-ttl-s",
            "priority-header",
        }
        if unknown:
            raise ConfigError(
                f"Unknown keys in 'slo' block: {sorted(unknown)}"
            )

        def _num(key: str, default, minimum, cast=float):
            try:
                value = cast(sl.get(key, default))
            except (TypeError, ValueError):
                raise ConfigError(
                    f"Invalid value for 'slo.{key}': {sl.get(key)!r}"
                ) from None
            if value < minimum:
                raise ConfigError(f"'slo.{key}' must be >= {minimum}")
            return value

        weights_raw = sl.get("class-weights", (8, 2, 1))
        if (
            not isinstance(weights_raw, (list, tuple))
            or len(weights_raw) != 3
        ):
            raise ConfigError(
                "'slo.class-weights' must be a list of 3 integers "
                "(interactive, prefetch, bulk)"
            )
        weights = []
        for w in weights_raw:
            try:
                w = int(w)
            except (TypeError, ValueError):
                raise ConfigError(
                    f"Invalid 'slo.class-weights' entry: {w!r}"
                ) from None
            if w < 1:
                raise ConfigError(
                    "'slo.class-weights' entries must be >= 1"
                )
            weights.append(w)
        header = sl.get("priority-header", "x-ompb-priority")
        if header is None:
            header = ""
        if not isinstance(header, str):
            raise ConfigError(
                f"Invalid value for 'slo.priority-header': {header!r}"
            )
        factor = _num("degrade-factor", 1.5, 0.0)
        if factor <= 0:
            raise ConfigError("'slo.degrade-factor' must be > 0")
        return SloConfig(
            enabled=bool(sl.get("enabled", True)),
            queue_size=_num("queue-size", 512, 0, int),
            class_weights=tuple(weights),
            degrade=bool(sl.get("degrade", True)),
            degrade_factor=factor,
            sweep_window=_num("sweep-window", 16, 2, int),
            sweep_ttl_s=_num("sweep-ttl-s", 30.0, 0.0),
            priority_header=header.lower(),
        )

    @staticmethod
    def _parse_obs(raw: dict) -> ObsConfig:
        """Validate the obs: block — same posture as the others:
        typos and nonsense fail at startup, never silently default."""
        ob = raw.get("obs") or {}
        unknown = set(ob) - {
            "enabled", "slow-threshold-ms", "head-sample-rate",
            "ring-size",
        }
        if unknown:
            raise ConfigError(
                f"Unknown keys in 'obs' block: {sorted(unknown)}"
            )

        def _num(key: str, default, minimum, cast=float):
            try:
                value = cast(ob.get(key, default))
            except (TypeError, ValueError):
                raise ConfigError(
                    f"Invalid value for 'obs.{key}': {ob.get(key)!r}"
                ) from None
            if value < minimum:
                raise ConfigError(f"'obs.{key}' must be >= {minimum}")
            return value

        rate = _num("head-sample-rate", 0.01, 0.0)
        if rate > 1.0:
            raise ConfigError(
                "'obs.head-sample-rate' must be in [0, 1]"
            )
        return ObsConfig(
            enabled=bool(ob.get("enabled", True)),
            slow_threshold_ms=_num("slow-threshold-ms", 300.0, 0.0),
            head_sample_rate=rate,
            ring_size=_num("ring-size", 512, 1, int),
        )

    @staticmethod
    def _parse_session(raw: dict) -> SessionPlaneConfig:
        """Validate the session: block (session/ package) — the
        same posture as every other block: unknown keys and nonsense
        values fail at startup, never silently default."""
        sp = raw.get("session") or {}
        unknown = set(sp) - {
            "enabled", "max-channels", "max-per-image", "queue-size",
            "ping-interval-s", "max-annotations-per-image",
            "max-annotation-images",
        }
        if unknown:
            raise ConfigError(
                f"Unknown keys in 'session' block: {sorted(unknown)}"
            )

        def _num(key: str, default, minimum, cast=float):
            try:
                value = cast(sp.get(key, default))
            except (TypeError, ValueError):
                raise ConfigError(
                    f"Invalid value for 'session.{key}': {sp.get(key)!r}"
                ) from None
            if value < minimum:
                raise ConfigError(f"'session.{key}' must be >= {minimum}")
            return value

        return SessionPlaneConfig(
            enabled=bool(sp.get("enabled", True)),
            max_channels=_num("max-channels", 256, 1, int),
            max_per_image=_num("max-per-image", 64, 1, int),
            queue_size=_num("queue-size", 64, 1, int),
            ping_interval_s=_num("ping-interval-s", 15.0, 0.05),
            max_annotations_per_image=_num(
                "max-annotations-per-image", 64, 1, int
            ),
            max_annotation_images=_num(
                "max-annotation-images", 1024, 1, int
            ),
        )

    @staticmethod
    def _parse_cache(raw: dict) -> CacheConfig:
        """Validate the cache: block — same posture as resilience:
        typos and nonsense fail at startup, never silently default."""
        cc = raw.get("cache") or {}
        pf = cc.get("prefetch") or {}

        def _num(block: dict, key: str, default, minimum, cast=float):
            try:
                value = cast(block.get(key, default))
            except (TypeError, ValueError):
                raise ConfigError(
                    f"Invalid value for 'cache...{key}': "
                    f"{block.get(key)!r}"
                ) from None
            if value < minimum:
                raise ConfigError(f"'cache...{key}' must be >= {minimum}")
            return value

        protected = _num(cc, "protected-fraction", 0.8, 0.0)
        if protected > 1.0:
            raise ConfigError(
                "'cache.protected-fraction' must be in [0, 1]"
            )
        headroom = _num(pf, "headroom", 0.5, 0.0)
        if headroom > 1.0:
            raise ConfigError(
                "'cache.prefetch.headroom' must be in [0, 1]"
            )
        tl = cc.get("tinylfu") or {}
        unknown = set(tl) - {"enabled", "counters", "sample-size"}
        if unknown:
            raise ConfigError(
                f"Unknown keys in 'cache.tinylfu' block: {sorted(unknown)}"
            )
        tinylfu = TinyLfuConfig(
            enabled=bool(tl.get("enabled", True)),
            counters=_num(tl, "counters", 16384, 2, int),
            sample_size=_num(tl, "sample-size", 0, 0, int),
        )
        return CacheConfig(
            enabled=bool(cc.get("enabled", True)),
            memory_mb=_num(cc, "memory-mb", 256, 1, int),
            protected_fraction=protected,
            disk_dir=cc.get("disk-dir"),
            disk_mb=_num(cc, "disk-mb", 1024, 1, int),
            ttl_s=_num(cc, "ttl-s", 0.0, 0.0),
            max_entry_kb=_num(cc, "max-entry-kb", 4096, 1, int),
            max_age_s=_num(cc, "max-age-s", 60.0, 0.0),
            etag_precheck=bool(cc.get("etag-precheck", True)),
            manifest=bool(cc.get("manifest", True)),
            tinylfu=tinylfu,
            prefetch=PrefetchConfig(
                enabled=bool(pf.get("enabled", True)),
                queue_size=_num(pf, "queue-size", 256, 1, int),
                headroom=headroom,
                budget_ms=_num(pf, "budget-ms", 0.0, 0.0),
                lookahead=_num(pf, "lookahead", 2, 1, int),
                viewport_span=_num(pf, "viewport-span", 1, 0, int),
            ),
        )

    @staticmethod
    def _parse_cluster(raw: dict) -> ClusterConfig:
        """Validate the cluster: block — the same posture as the
        other blocks: typos and nonsense fail at startup. A cluster
        whose ring members disagree about the member list would
        silently double-render (never corrupt — keys carry the full
        encode signature), but a ``self`` not present in ``members``
        is ALWAYS a config error and fails loudly."""
        cl = raw.get("cluster") or {}
        unknown = set(cl) - {
            "members", "self", "virtual-nodes", "peer-timeout-ms", "l2",
            "lease-ttl-s", "replication-factor", "transfer-max-entries",
            "secret", "hedge", "drain", "repair", "suspect",
            "gossip", "integrity",
        }
        if unknown:
            raise ConfigError(
                f"Unknown keys in 'cluster' block: {sorted(unknown)}"
            )
        members_raw = cl.get("members") or []
        if isinstance(members_raw, str):
            members_raw = [members_raw]
        if not isinstance(members_raw, (list, tuple)):
            raise ConfigError(
                "'cluster.members' must be a list of replica URLs"
            )
        members = []
        for m in members_raw:
            if not isinstance(m, str) or not m.strip():
                raise ConfigError(
                    f"Invalid 'cluster.members' entry: {m!r}"
                )
            members.append(m.strip().rstrip("/"))
        if len(set(members)) != len(members):
            raise ConfigError("'cluster.members' has duplicate entries")
        self_url = cl.get("self")
        if self_url is not None:
            if not isinstance(self_url, str) or not self_url.strip():
                raise ConfigError(
                    f"Invalid value for 'cluster.self': {self_url!r}"
                )
            self_url = self_url.strip().rstrip("/")
        if members and self_url is None:
            raise ConfigError(
                "'cluster.members' set without 'cluster.self' — this "
                "replica cannot locate itself on the ownership ring"
            )
        if self_url is not None and members and self_url not in members:
            raise ConfigError(
                f"'cluster.self' ({self_url}) is not one of "
                "'cluster.members'"
            )

        def _num(block: dict, key: str, default, minimum, cast=float):
            try:
                value = cast(block.get(key, default))
            except (TypeError, ValueError):
                raise ConfigError(
                    f"Invalid value for 'cluster...{key}': "
                    f"{block.get(key)!r}"
                ) from None
            if value < minimum:
                raise ConfigError(
                    f"'cluster...{key}' must be >= {minimum}"
                )
            return value

        l2_raw = cl.get("l2") or {}
        unknown = set(l2_raw) - {"uri", "ttl-s"}
        if unknown:
            raise ConfigError(
                f"Unknown keys in 'cluster.l2' block: {sorted(unknown)}"
            )
        l2_uri = l2_raw.get("uri")
        if l2_uri is not None and (
            not isinstance(l2_uri, str) or not l2_uri
        ):
            raise ConfigError(
                f"Invalid value for 'cluster.l2.uri': {l2_uri!r}"
            )
        lease_ttl_s = _num(cl, "lease-ttl-s", 0.0, 0.0)
        if lease_ttl_s > 0 and not l2_uri:
            raise ConfigError(
                "'cluster.lease-ttl-s' needs 'cluster.l2.uri' — "
                "replica leases live in the shared Redis"
            )
        replication_factor = _num(cl, "replication-factor", 1, 1, int)
        if replication_factor > 1 and not members:
            raise ConfigError(
                "'cluster.replication-factor' > 1 needs "
                "'cluster.members' — replication targets come from "
                "the ownership ring"
            )
        secret = cl.get("secret")
        if secret is not None and (
            not isinstance(secret, str) or not secret.strip()
        ):
            raise ConfigError(
                "'cluster.secret' must be a non-empty string"
            )
        hedge_raw = cl.get("hedge") or {}
        unknown = set(hedge_raw) - {
            "enabled", "quantile", "min-ms", "max-ms", "fallback-ms",
        }
        if unknown:
            raise ConfigError(
                f"Unknown keys in 'cluster.hedge' block: "
                f"{sorted(unknown)}"
            )
        hedge_enabled = hedge_raw.get("enabled", False)
        if not isinstance(hedge_enabled, bool):
            raise ConfigError(
                "'cluster.hedge.enabled' must be a boolean"
            )
        hedge_quantile = _num(hedge_raw, "quantile", 0.99, 0.0)
        if not 0.0 < hedge_quantile < 1.0:
            raise ConfigError(
                "'cluster.hedge.quantile' must be inside (0, 1)"
            )
        drain_raw = cl.get("drain") or {}
        unknown = set(drain_raw) - {"deadline-s", "signal"}
        if unknown:
            raise ConfigError(
                f"Unknown keys in 'cluster.drain' block: "
                f"{sorted(unknown)}"
            )
        drain_signal = drain_raw.get("signal", True)
        if not isinstance(drain_signal, bool):
            raise ConfigError(
                "'cluster.drain.signal' must be a boolean"
            )
        repair_raw = cl.get("repair") or {}
        unknown = set(repair_raw) - {"interval-s", "max-keys"}
        if unknown:
            raise ConfigError(
                f"Unknown keys in 'cluster.repair' block: "
                f"{sorted(unknown)}"
            )
        repair_interval_s = _num(repair_raw, "interval-s", 0.0, 0.0)
        if repair_interval_s > 0 and replication_factor < 2:
            raise ConfigError(
                "'cluster.repair.interval-s' needs "
                "'cluster.replication-factor' >= 2 — anti-entropy "
                "repairs the replication contract; without one there "
                "is nothing to repair"
            )
        gossip_raw = cl.get("gossip") or {}
        unknown = set(gossip_raw) - {
            "enabled", "interval-s", "fanout", "fail-after-s",
        }
        if unknown:
            raise ConfigError(
                f"Unknown keys in 'cluster.gossip' block: "
                f"{sorted(unknown)}"
            )
        gossip_enabled = gossip_raw.get("enabled", False)
        if not isinstance(gossip_enabled, bool):
            raise ConfigError(
                "'cluster.gossip.enabled' must be a boolean"
            )
        if gossip_enabled and (not members or self_url is None):
            raise ConfigError(
                "'cluster.gossip.enabled' needs 'cluster.members' "
                "and 'cluster.self' — gossip seeds from the "
                "configured peer list"
            )
        gossip_interval_s = _num(gossip_raw, "interval-s", 1.0, 0.05)
        gossip_fail_after_s = _num(gossip_raw, "fail-after-s", 5.0, 0.1)
        if gossip_fail_after_s <= gossip_interval_s:
            raise ConfigError(
                "'cluster.gossip.fail-after-s' must exceed "
                "'cluster.gossip.interval-s' — a member must survive "
                "at least one missed round"
            )
        integrity_raw = cl.get("integrity") or {}
        unknown = set(integrity_raw) - {"verify-bodies", "verdict-after"}
        if unknown:
            raise ConfigError(
                f"Unknown keys in 'cluster.integrity' block: "
                f"{sorted(unknown)}"
            )
        integrity_verify = integrity_raw.get("verify-bodies", True)
        if not isinstance(integrity_verify, bool):
            raise ConfigError(
                "'cluster.integrity.verify-bodies' must be a boolean"
            )
        suspect_raw = cl.get("suspect") or {}
        unknown = set(suspect_raw) - {
            "enabled", "error-rate", "p99-factor", "min-requests",
            "peer-failures",
        }
        if unknown:
            raise ConfigError(
                f"Unknown keys in 'cluster.suspect' block: "
                f"{sorted(unknown)}"
            )
        suspect_enabled = suspect_raw.get("enabled", False)
        if not isinstance(suspect_enabled, bool):
            raise ConfigError(
                "'cluster.suspect.enabled' must be a boolean"
            )
        if suspect_enabled and lease_ttl_s <= 0 and not gossip_enabled:
            raise ConfigError(
                "'cluster.suspect.enabled' needs "
                "'cluster.lease-ttl-s' or 'cluster.gossip.enabled' — "
                "suspicion rides the fleet-brain exchange, which "
                "rides the lease heartbeat or the gossip rounds"
            )
        suspect_error_rate = _num(suspect_raw, "error-rate", 0.5, 0.0)
        if not 0.0 < suspect_error_rate <= 1.0:
            raise ConfigError(
                "'cluster.suspect.error-rate' must be inside (0, 1]"
            )
        return ClusterConfig(
            members=tuple(members),
            self_url=self_url,
            virtual_nodes=_num(cl, "virtual-nodes", 64, 1, int),
            peer_timeout_ms=_num(cl, "peer-timeout-ms", 500.0, 1.0),
            lease_ttl_s=lease_ttl_s,
            replication_factor=replication_factor,
            transfer_max_entries=_num(
                cl, "transfer-max-entries", 128, 0, int
            ),
            secret=secret,
            hedge=ClusterHedgeConfig(
                enabled=hedge_enabled,
                quantile=hedge_quantile,
                min_ms=_num(hedge_raw, "min-ms", 20.0, 0.0),
                max_ms=_num(hedge_raw, "max-ms", 250.0, 1.0),
                fallback_ms=_num(hedge_raw, "fallback-ms", 0.0, 0.0),
            ),
            l2=ClusterL2Config(
                uri=l2_uri,
                ttl_s=_num(l2_raw, "ttl-s", 3600.0, 0.0),
            ),
            drain=ClusterDrainConfig(
                deadline_s=_num(drain_raw, "deadline-s", 10.0, 0.1),
                signal=drain_signal,
            ),
            repair=ClusterRepairConfig(
                interval_s=repair_interval_s,
                max_keys=_num(repair_raw, "max-keys", 64, 1, int),
            ),
            suspect=ClusterSuspectConfig(
                enabled=suspect_enabled,
                error_rate=suspect_error_rate,
                p99_factor=_num(suspect_raw, "p99-factor", 3.0, 1.0),
                min_requests=_num(
                    suspect_raw, "min-requests", 8, 1, int
                ),
                peer_failures=_num(
                    suspect_raw, "peer-failures", 3, 1, int
                ),
            ),
            gossip=ClusterGossipConfig(
                enabled=gossip_enabled,
                interval_s=gossip_interval_s,
                fanout=_num(gossip_raw, "fanout", 2, 1, int),
                fail_after_s=gossip_fail_after_s,
            ),
            integrity=ClusterIntegrityConfig(
                verify_bodies=integrity_verify,
                verdict_after=_num(
                    integrity_raw, "verdict-after", 1, 1, int
                ),
            ),
        )

    @staticmethod
    def _parse_io(raw: dict) -> IoConfig:
        """Validate the io: block — same posture as the other blocks:
        typos and nonsense fail at startup, never silently default."""
        io = raw.get("io") or {}
        unknown = set(io) - {
            "parallel-fetch", "fetch-workers", "max-conns-per-host",
            "coalesce-gap-kb", "decode-workers", "negative-ttl-s",
            "shard-index-ttl-s",
        }
        if unknown:
            raise ConfigError(
                f"Unknown keys in 'io' block: {sorted(unknown)}"
            )

        def _num(key: str, default, minimum, cast=float):
            try:
                value = cast(io.get(key, default))
            except (TypeError, ValueError):
                raise ConfigError(
                    f"Invalid value for 'io.{key}': {io.get(key)!r}"
                ) from None
            if value < minimum:
                raise ConfigError(f"'io.{key}' must be >= {minimum}")
            return value

        return IoConfig(
            parallel_fetch=bool(io.get("parallel-fetch", True)),
            fetch_workers=_num("fetch-workers", 16, 1, int),
            max_conns_per_host=_num("max-conns-per-host", 8, 1, int),
            coalesce_gap_kb=_num("coalesce-gap-kb", 64.0, 0.0),
            decode_workers=_num("decode-workers", 4, 0, int),
            negative_ttl_s=_num("negative-ttl-s", 300.0, 0.0),
            shard_index_ttl_s=_num("shard-index-ttl-s", 300.0, 0.0),
        )

    @staticmethod
    def _parse_render(raw: dict) -> RenderConfig:
        """Validate the render: block — same posture as the others:
        typos and nonsense fail at startup, never silently default."""
        rd = raw.get("render") or {}
        unknown = set(rd) - {"enabled", "lut-dir", "jpeg-quality"}
        if unknown:
            raise ConfigError(
                f"Unknown keys in 'render' block: {sorted(unknown)}"
            )
        lut_dir = rd.get("lut-dir")
        if lut_dir is not None and (
            not isinstance(lut_dir, str) or not lut_dir
        ):
            raise ConfigError(
                f"Invalid value for 'render.lut-dir': {lut_dir!r} "
                "(expected a non-empty path)"
            )
        try:
            quality = int(rd.get("jpeg-quality", 90))
        except (TypeError, ValueError):
            raise ConfigError(
                "Invalid value for 'render.jpeg-quality': "
                f"{rd.get('jpeg-quality')!r}"
            ) from None
        if not 1 <= quality <= 100:
            raise ConfigError(
                "'render.jpeg-quality' must be in [1, 100]"
            )
        return RenderConfig(
            enabled=bool(rd.get("enabled", True)),
            lut_dir=lut_dir,
            jpeg_quality=quality,
        )

    @staticmethod
    def _parse_analysis(raw: dict) -> AnalysisConfig:
        """Validate the analysis: block — same posture as the other
        blocks: typos and nonsense fail at startup."""
        an = raw.get("analysis") or {}
        unknown = set(an) - {"enabled", "max-bins"}
        if unknown:
            raise ConfigError(
                f"Unknown keys in 'analysis' block: {sorted(unknown)}"
            )
        try:
            max_bins = int(an.get("max-bins", 65536))
        except (TypeError, ValueError):
            raise ConfigError(
                "Invalid value for 'analysis.max-bins': "
                f"{an.get('max-bins')!r}"
            ) from None
        if not 2 <= max_bins <= 65536:
            raise ConfigError(
                "'analysis.max-bins' must be in [2, 65536]"
            )
        return AnalysisConfig(
            enabled=bool(an.get("enabled", True)),
            max_bins=max_bins,
        )

    @staticmethod
    def _parse_protocols(raw: dict) -> ProtocolsConfig:
        """Validate the protocols: block — per-adapter sub-blocks
        (dzi/iiif/iris), unknown keys fail at startup."""
        pr = raw.get("protocols") or {}
        unknown = set(pr) - {"dzi", "iiif", "iris"}
        if unknown:
            raise ConfigError(
                f"Unknown keys in 'protocols' block: {sorted(unknown)}"
            )

        def adapter(name: str) -> ProtocolAdapterConfig:
            block = pr.get(name) or {}
            bad = set(block) - {"enabled", "tile-size"}
            if bad:
                raise ConfigError(
                    f"Unknown keys in 'protocols.{name}' block: "
                    f"{sorted(bad)}"
                )
            try:
                ts = int(block.get("tile-size", 256))
            except (TypeError, ValueError):
                raise ConfigError(
                    f"Invalid value for 'protocols.{name}.tile-size': "
                    f"{block.get('tile-size')!r}"
                ) from None
            if not 16 <= ts <= 4096:
                raise ConfigError(
                    f"'protocols.{name}.tile-size' must be in "
                    "[16, 4096]"
                )
            return ProtocolAdapterConfig(
                enabled=bool(block.get("enabled", True)),
                tile_size=ts,
            )

        return ProtocolsConfig(
            dzi=adapter("dzi"), iiif=adapter("iiif"),
            iris=adapter("iris"),
        )

    @staticmethod
    def _parse_supertile(raw: dict) -> SupertileConfig:
        """Validate the supertile: block — same posture as the other
        blocks: unknown keys and nonsense fail at startup, never
        silently default."""
        st = raw.get("supertile") or {}
        unknown = set(st) - {
            "enabled", "max-pixels", "min-lanes", "coverage", "mesh",
        }
        if unknown:
            raise ConfigError(
                f"Unknown keys in 'supertile' block: {sorted(unknown)}"
            )

        def _num(key: str, default, minimum, cast=float):
            try:
                value = cast(st.get(key, default))
            except (TypeError, ValueError):
                raise ConfigError(
                    f"Invalid value for 'supertile.{key}': "
                    f"{st.get(key)!r}"
                ) from None
            if value < minimum:
                raise ConfigError(
                    f"'supertile.{key}' must be >= {minimum}"
                )
            return value

        coverage = _num("coverage", 0.5, 0.0)
        if coverage > 1.0:
            raise ConfigError("'supertile.coverage' must be in [0, 1]")
        return SupertileConfig(
            enabled=bool(st.get("enabled", True)),
            # floor: one 256x256 tile — a smaller budget could never
            # fuse anything and would silently disable the plane
            max_pixels=_num("max-pixels", 4 << 20, 65536, int),
            min_lanes=_num("min-lanes", 2, 2, int),
            coverage=coverage,
            mesh=bool(st.get("mesh", True)),
        )

    @staticmethod
    def _parse_burst_continuation(raw: dict) -> BurstContinuationConfig:
        """Validate the backend.batching.burst-continuation: block —
        unknown keys and nonsense fail at startup."""
        bc = raw.get("burst-continuation") or {}
        unknown = set(bc) - {"enabled", "window-ms"}
        if unknown:
            raise ConfigError(
                "Unknown keys in 'backend.batching.burst-continuation'"
                f" block: {sorted(unknown)}"
            )
        try:
            window = float(bc.get("window-ms", 25.0))
        except (TypeError, ValueError):
            raise ConfigError(
                "Invalid value for "
                "'backend.batching.burst-continuation.window-ms': "
                f"{bc.get('window-ms')!r}"
            ) from None
        if window < 0:
            raise ConfigError(
                "'backend.batching.burst-continuation.window-ms' "
                "must be >= 0"
            )
        return BurstContinuationConfig(
            enabled=bool(bc.get("enabled", True)),
            window_ms=window,
        )

    @staticmethod
    def _parse_ingest(raw: dict) -> IngestConfig:
        """Validate the ingest: block — same posture as the other
        blocks: unknown keys and nonsense fail at startup, never
        silently default (a typo'd `enabled` must not leave a write
        surface closed — or open — by surprise)."""
        ig = raw.get("ingest") or {}
        unknown = set(ig) - {
            "enabled", "max-inflight-shards", "staging-bytes",
        }
        if unknown:
            raise ConfigError(
                f"Unknown keys in 'ingest' block: {sorted(unknown)}"
            )

        def _num(key: str, default, minimum, cast=int):
            try:
                value = cast(ig.get(key, default))
            except (TypeError, ValueError):
                raise ConfigError(
                    f"Invalid value for 'ingest.{key}': "
                    f"{ig.get(key)!r}"
                ) from None
            if value < minimum:
                raise ConfigError(
                    f"'ingest.{key}' must be >= {minimum}"
                )
            return value

        return IngestConfig(
            enabled=bool(ig.get("enabled", False)),
            max_inflight_shards=_num("max-inflight-shards", 64, 1),
            # floor: one 4 MiB chunk — anything smaller could never
            # stage a single chunk and would reject every write
            staging_bytes=_num("staging-bytes", 256 << 20, 4 << 20),
        )

    @staticmethod
    def _parse_mesh(raw: dict) -> MeshConfig:
        """Validate the mesh: block."""
        ms = raw.get("mesh") or {}
        unknown = set(ms) - {"probe-interval-ms"}
        if unknown:
            raise ConfigError(
                f"Unknown keys in 'mesh' block: {sorted(unknown)}"
            )
        try:
            interval = float(ms.get("probe-interval-ms", 0.0))
        except (TypeError, ValueError):
            raise ConfigError(
                "Invalid value for 'mesh.probe-interval-ms': "
                f"{ms.get('probe-interval-ms')!r}"
            ) from None
        if interval < 0:
            raise ConfigError("'mesh.probe-interval-ms' must be >= 0")
        return MeshConfig(probe_interval_ms=interval)

    @staticmethod
    def _parse_jax(raw: dict) -> JaxConfig:
        """Validate the jax: block — same posture as resilience/cache:
        typos and nonsense fail at startup, never silently default."""
        jx = raw.get("jax") or {}
        cache_dir = jx.get("compilation-cache-dir")
        if cache_dir is not None:
            if not isinstance(cache_dir, str) or not cache_dir:
                raise ConfigError(
                    "Invalid value for 'jax.compilation-cache-dir': "
                    f"{cache_dir!r} (expected a non-empty path)"
                )
        unknown = set(jx) - {"compilation-cache-dir"}
        if unknown:
            raise ConfigError(
                f"Unknown keys in 'jax' block: {sorted(unknown)}"
            )
        return JaxConfig(compilation_cache_dir=cache_dir)

    @classmethod
    def from_dict(cls, raw: dict) -> "Config":
        raw = dict(raw or {})
        omero = raw.get("omero") or {}
        ss_raw = raw.get("session-store")
        if ss_raw is None:
            raise ConfigError("'session-store' block missing from configuration")
        ss = SessionStoreConfig(
            type=ss_raw.get("type") or "",
            synchronicity=ss_raw.get("synchronicity", "async"),
            uri=ss_raw.get("uri"),
        )
        if ss.type not in ("redis", "postgres", "memory"):
            raise ConfigError(
                "Missing/invalid value for 'session-store.type' in config"
            )
        if ss.synchronicity not in ("sync", "async"):
            # accepted-but-ignored config is worse than an error
            raise ConfigError(
                "Invalid value for 'session-store.synchronicity': "
                f"{ss.synchronicity!r} (expected sync|async)"
            )
        tracing = raw.get("http-tracing") or {}
        jmx = raw.get("jmx-metrics") or {}
        be_raw = raw.get("backend") or {}
        batching_raw = be_raw.get("batching") or {}
        png_raw = be_raw.get("png") or {}
        engine = be_raw.get("engine", "jax")
        if engine not in ("jax", "auto", "device", "tpu", "host"):
            # typos must fail at startup, not silently pick a path
            # (the session-store.type precedent, :258-261)
            raise ConfigError(
                f"Invalid value for 'backend.engine': {engine!r} "
                "(expected jax|auto|device|tpu|host)"
            )
        backend = BackendConfig(
            engine=engine,
            batching=BatchingConfig(
                buckets=tuple(batching_raw.get("buckets", (256, 512, 1024))),
                max_batch=int(batching_raw.get("max-batch", 32)),
                coalesce_window_ms=float(
                    batching_raw.get("coalesce-window-ms", 2.0)
                ),
                device_encode=bool(batching_raw.get("device-encode", True)),
                burst_continuation=cls._parse_burst_continuation(
                    batching_raw
                ),
            ),
            png=PngConfig(
                filter=png_raw.get("filter", "up"),
                level=int(png_raw.get("level", 6)),
                strategy=png_raw.get("strategy", "fast"),
                device_deflate=bool(
                    png_raw.get("device-deflate", True)
                ),
                device_deflate_mode=cls._parse_deflate_mode(
                    png_raw.get("device-deflate-mode", "dynamic")
                ),
                queue_depth=cls._parse_queue_depth(
                    png_raw.get("queue-depth", 2)
                ),
            ),
            max_tile_mb=int(be_raw.get("max-tile-mb", 256)),
        )
        log_raw = raw.get("logging") or {}
        return cls(
            port=int(raw.get("port", 8082)),
            event_bus_send_timeout_ms=int(
                raw.get("event-bus-send-timeout", 15000)
            ),
            worker_pool_size=(
                None if raw.get("worker_pool_size") is None
                else int(raw["worker_pool_size"])
            ),
            omero_host=omero.get("host", "localhost"),
            omero_port=int(omero.get("port", 4064)),
            omero_validate_sessions=bool(
                omero.get("validate-sessions", False)
            ),
            omero_secure=bool(omero.get("secure", True)),
            omero_verify_tls=bool(omero.get("verify-tls", True)),
            omero_session_validation_ttl_s=cls._parse_ttl_value(
                omero.get("session-validation-ttl", 30.0)
            ),
            omero_server=dict(raw.get("omero.server") or {}),
            session_store=ss,
            http_tracing_enabled=bool(tracing.get("enabled", False)),
            zipkin_url=tracing.get("zipkin-url"),
            jmx_metrics_enabled=bool(jmx.get("enabled", True)),
            backend=backend,
            resilience=cls._parse_resilience(raw),
            slo=cls._parse_slo(raw),
            obs=cls._parse_obs(raw),
            session=cls._parse_session(raw),
            cache=cls._parse_cache(raw),
            cluster=cls._parse_cluster(raw),
            io=cls._parse_io(raw),
            render=cls._parse_render(raw),
            analysis=cls._parse_analysis(raw),
            protocols=cls._parse_protocols(raw),
            supertile=cls._parse_supertile(raw),
            mesh=cls._parse_mesh(raw),
            ingest=cls._parse_ingest(raw),
            jax=cls._parse_jax(raw),
            logging=LoggingConfig(
                file=log_raw.get("file"),
                level=str(log_raw.get("level", "INFO")),
                retention_days=int(log_raw.get("retention-days", 7)),
            ),
            image_registry=raw.get("image-registry"),
        )

    @classmethod
    def load(
        cls,
        path: Optional[str] = None,
        default_memory_store: bool = False,
    ) -> "Config":
        """Layered load: YAML file (if present) under env overrides,
        mirroring ConfigRetriever's default-stores + optional file.

        A missing ``session-store`` block is a hard startup error like
        the reference (PixelBufferMicroserviceVerticle.java:258-261)
        unless the caller opts into the in-memory store explicitly
        (dev/bench mode) with ``default_memory_store=True``.
        """
        raw: dict = {}
        if path and os.path.exists(path):
            with open(path) as f:
                text = f.read()
            if yaml is not None:
                raw = yaml.safe_load(text) or {}
            else:
                # YAML's JSON subset reads without PyYAML; anything else
                # fails as the JAX package fails without it
                try:
                    raw = json.loads(text) if text.strip() else {}
                except ValueError:
                    raise ConfigError(
                        "PyYAML unavailable; cannot read " + path
                    ) from None
        # An empty `session-store:` block parses to None; treat as {}.
        if "session-store" in raw and raw["session-store"] is None:
            raw["session-store"] = {}
        # Env overrides (the sys-prop/env default stores analog).
        if "OMPB_PORT" in os.environ:
            raw["port"] = int(os.environ["OMPB_PORT"])
        if "OMPB_SESSION_STORE" in os.environ:
            raw.setdefault("session-store", {})["type"] = os.environ[
                "OMPB_SESSION_STORE"
            ]
        if default_memory_store and "session-store" not in raw:
            raw["session-store"] = {"type": "memory"}
        return cls.from_dict(raw)
