"""HTTP/1.1 front on ``asyncio.start_server`` (counterpart of the /tile,
/render, /histogram and viewer-protocol routes of
``omero_ms_pixel_buffer_tpu/http/server.py``, without aiohttp).

Routes: ``GET``/``HEAD /tile/{imageId}/{z}/{c}/{t}`` (query x/y/w/h/
resolution/format), ``GET``/``HEAD /render/{imageId}/{z}/{c}/{t}`` (the
same region query plus the render dialect of ``render/model.py``: c, m,
maps, p, roi, format png|jpeg, q; the path's c is the default channel),
``GET``/``HEAD /histogram/{imageId}/{z}/{c}/{t}`` (the same region query
plus ``bins``, ``usePixelsTypeRange`` and the render channel grammar of
``c``; a JSON body, ``render/analysis.py``),
the DZI, IIIF and Iris adapters (``http/protocols/``: ``/dzi/{id}.dzi``,
``/dzi/{id}_files/{level}/{col}_{row}.{fmt}``, ``/iiif/{id}/info.json``,
``/iiif/{id}/{region}/{size}/{rotation}/{quality}.{fmt}``,
``/iris/{id}/metadata``, ``/iris/{id}/layers/{layer}/tiles/{tile}``),
``GET``/``HEAD /healthz``, ``GET``/``HEAD /metrics`` (Prometheus text, or
OpenMetrics 1.0 when ``Accept`` names ``application/openmetrics-text``:
``utils/metrics.py``), ``GET /debug/requests[?limit=N]`` and ``GET
/debug/requests/{traceId}`` (the flight recorder's ring of kept wide
events, when ``obs`` is on; an unknown trace id is 404), the session
plane's routes (below), and ``OPTIONS``
on any path (the service discovery JSON). Any other method on a route, and any
unrouted path, answers 405 ``405: Method Not Allowed``, as the JAX
package's aiohttp app does with its catch-all OPTIONS route. HEAD answers
the GET's status and headers without the body (and without
``Content-Length`` when that body is empty, as aiohttp answers). Connections are
keep-alive. Requests are read as aiohttp's parser reads them (``http/
target.py``): llhttp's request-line rules and 400s, routes matched on
yarl's ``path_safe`` with each group decoded after, the first of a
repeated header, ``100 Continue`` before the body. Sessions (``auth/stores.py``, the JAX ``session_middleware``):
the ``sessionid`` cookie is looked up in the session store (OMERO.web's
Django sessions in Redis or Postgres; an in-memory map; with ``dev`` the
echo store, where every cookie value is its own key). Every path but
``/healthz``, ``/metrics`` and ``/debug/`` and every method but OPTIONS
needs a session: a missing or
unknown cookie is 403 "Permission denied", and a store that cannot answer
(an open breaker, a refused or timed-out connection) 503 "Session store
unavailable" with ``Retry-After``, never a 403. A bad parameter is 400
with the parse message, an unknown image (or one the caller's OMERO ACL
hides, under the database metadata resolver) 404, as the JAX package
answers. On ``/render`` a grammar error or an
unknown LUT is a 400 with the JAX message, a channel out of range a 404,
a projection stack over the tile budget a 413; ``annotations=1`` appends
the image's stored annotations to the ``roi=`` shapes (at most 64 in
all), so the answer, its cache key and its ETag are those of the explicit
``roi=`` request. On
``/histogram`` a bad ``bins`` or ``c`` is a 400 with the JAX message, a
channel out of range a 404, a region whose channels exceed the tile
budget a 413. A request whose image store's circuit breaker is open
answers 503 with ``Retry-After`` (whole seconds, rounded up, until the
breaker's next probe), as the JAX front does.

Scheduling (``resilience/scheduler.py``, the JAX ``slo:`` block, on by
default): a request to a serving route first meets the door gate, before
the session check: when the scheduler's wait queue is full and the
request's header class would shed anyway, it answers 503 ``Service
overloaded`` with ``Retry-After`` at once, unless it is a ``/tile`` or
``/render`` request whose entry is in the result cache (the w/h = 0
spelling normalised from an open buffer). After the session check each
request is classified (``x-ompb-priority``, prefetch purpose headers,
the sweep detector), and a miss acquires an execution slot under its
``Deadline`` (the budget ``request_budget_ms``, default the JAX
``event-bus-send-timeout`` of 15 s): a shed answers 503 with
``Retry-After``, a deadline spent in the queue or later 504, and a grant
flagged degraded is served from the next pyramid level, upscaled, under
its own cache key, tagged ``X-OMPB-Degraded: 1`` (PNG ``/tile`` and
render requests only). With ``slo.enabled: false`` there is no
scheduler and no sweep detector: the JAX binary door gate takes their
place in front of the serving routes (after OPTIONS, before the session
check), answering 503 ``Service overloaded`` with ``Retry-After`` beyond
``resilience.admission.max-inflight`` requests in flight, and every
request that passes it executes; ``/healthz`` and ``/metrics`` stay
reachable. The event-loop watchdog (``utils/loop_watchdog.py``) is armed
at start.

Tiles, renders and histograms go through the result cache's memory tier
(``cache/``), keyed by ``TileCtx.cache_key`` after the w/h = 0 spelling is rewritten to the
full plane's size. A 200 carries the content ``ETag``, ``Cache-Control:
private, max-age=<cache.max-age-s>`` and ``X-Cache: hit|miss``; an
``If-None-Match`` that matches the ETag answers 304, on a hit (before the
authorization step with ``cache.etag-precheck``) or on a fresh render.
A hit skips the pipeline, never the authorization: the session validator
and the caller's ACL (``get_pixels`` under the session key) are asked
again unless the pair (session, image) took the full path within the
last 10 s, and a hit that does not authorize takes the full path, which
answers 403, 404 or 503. Concurrent misses with one
``TileCtx.dedupe_key`` share one pipeline execution (single-flight),
which fills the cache once. A changed ``pixels`` row seen by the metadata
resolver purges the image's cached tiles, authorization verdicts, open
buffer, device planes and decoded blocks (``_invalidate_image``). With
``cache.enabled: false`` there is no result cache, single-flight,
prefetcher or fleet plane (as in JAX): every request executes, and a 200
carries no ``ETag``, ``Cache-Control`` or ``X-Cache`` (so never a 304).

Observability (``obs/``, the JAX ``obs:`` block, on by default): every
request to a serving route carries a ``FlightRecord`` from the door
(stamped ``door``, ``auth``, ``cache_probe``, ``queue_wait`` and ``frame``
here, the batcher's and pipeline's stages below), completed with its
status by the tail sampler, which feeds ``request_stage_seconds``,
``http_request_seconds`` and the SLI burn rates and keeps the ring of
``/debug/requests``; ``/healthz`` ``obs`` holds its counts. With
``http-tracing.zipkin-url`` set, kept records are exported as Zipkin spans
(``utils/tracing.py``). ``jmx-metrics`` adds the process collector.

The viewport prefetcher (``cache/prefetch.py``, the JAX
``cache.prefetch`` block, on by default in a config and off in
``create_server`` unless asked): a served hit or miss of a tile or render
is observed (never a histogram), predicted pan tiles are queued at
prefetch priority and rendered through the miss path a real request
takes (``_prefetch_fetch``: single-flight, batcher, kernels, result
cache); ``/healthz`` ``prefetch`` holds its counts. The memory tier's
TinyLFU gate is ``cache.tinylfu``.

The session plane (``session/``, the JAX ``session:`` block, on by
default): ``GET /session/{imageId}/live`` is a live channel, a WebSocket
(``http/websocket.py``; ``permessage-deflate`` declined) when the client
asks to upgrade, else server-sent events; it sends a hello, every delta
the image's purges and annotation writes push (an annotation write sends
``invalidate`` then ``annotations``), and pings each quiet
``ping-interval-s``, which also revalidates the session (a revoked one
gets ``{"type":"close","reason":"revoked"}`` and the close). Past either
channel cap it answers 503 ``Session plane at capacity``. ``POST
/session/{imageId}/viewport`` (and a WebSocket ``viewport`` frame)
reports the viewer's rectangle to the prefetcher (viewport-true
speculation). ``/annotations/{imageId}`` (POST, GET) and
``/annotations/{imageId}/{annId}`` (GET, PUT, DELETE) are the annotation
CRUD (``session/annotations.py``). These routes need a session but skip
the door gate, the scheduler and the flight record, as in JAX; a request
body reaches them when it is at most 1 MiB (a larger one reads as no
body, so its handler answers 400, as JAX's handlers answer aiohttp's
413). ``/healthz`` ``session`` holds the registry's and the store's
counts.

The result cache's disk tier (``cache.disk-dir``, off by default): memory
evictions spill to files, a disk hit is re-admitted to memory, the
manifest journal makes a restart warm, and the door gate's hit exemption
asks both tiers (``contains_any_tier``).

The fleet plane (``cache/plane/``, ``cluster/``, the JAX ``cluster:``
block; ``cluster.members`` is the ring, or with ``cluster.lease-ttl-s``
or ``cluster.gossip`` the seed of a membership that changes while it
serves): between the local miss and the
render, the shared L2 tier and then one bounded GET to the key's owner
on the consistent-hash ring (a request carrying ``X-OMPB-Peer`` is a hop,
served here and never forwarded); a fill is published to L2 stamped with
the image epoch seen before the render; an invalidation bumps the epoch,
DELs the image's L2 entries and POSTs ``/internal/purge`` to the other
members. The cluster guard (with ``cluster.secret``, every ``/internal/*``
request and every hop carries a valid ``X-OMPB-Sig``, one verdict a
request) sits inside the flight record and before the door gate; the
quality tracker sits outermost; a verified hop's ``X-OMPB-Peer`` is the
gossip join hint. ``/internal/`` serves purge, replica, transfer,
handoff, digest, pull, drain and gossip (503 without gossip membership)
without a session; ``/healthz`` adds ``cluster`` and ``result_cache.plane``, and
``?probe=1`` pings the session store, L2 and the database. SIGTERM runs
the drain first (``drain_on_signal``).

``wire`` builds the whole service from a ``utils.config.Config`` (the
JAX ``PixelBufferApp.__init__``): ``create_app`` and ``create_server``
both go through it, with every value the JAX ``Config`` accepts: the
``backend.png`` policy, the host engine,
``cache.enabled: false`` and ``slo.enabled: false`` included.
"""

from __future__ import annotations

import asyncio
import contextvars
import dataclasses
import http
import json
import logging
import re
import threading
import time
from http.cookies import CookieError, SimpleCookie
from typing import Dict, List, Optional, Tuple

import torch

from .. import __version__
from ..auth.omero_session import AllowListValidator
from ..auth.stores import EchoSessionStore, MemorySessionStore
from ..cache.plane.coordinator import CachePlane
from ..cache.plane.l2 import decode_entry_epoch
from ..cache.plane.peer import (
    EPOCH_HEADER,
    KEY_HEADER,
    PEER_HEADER,
    TRACE_HEADER,
    TRACE_PARENT_HEADER,
)
from ..cache.plane.tinylfu import TinyLFU
from ..cache.prefetch import ViewportPrefetcher
from ..cache.result_cache import CachedTile, TileResultCache, etag_matches
from ..cache.single_flight import SingleFlight
from ..dispatch.batcher import BatchingTileWorker
from ..errors import ServiceUnavailableError, TileError
from ..ingest import IngestError, IngestPlane
from ..io.fetch import io_snapshot
from ..obs import FlightRecorder, SliLayer
from ..obs.recorder import ambient_stage, current_record, record_scope
from ..ops.kernels import launch_counts
from ..parallel.mesh import MeshProber
from ..render.analysis import HistogramSpec
from ..render.masks import MAX_SHAPES
from ..render.model import RenderSpec
from ..resilience import deadline as rdeadline
from ..resilience import retry
from ..resilience import timeouts
from ..resilience.admission import AdmissionController
from ..resilience.breaker import BOARD
from ..resilience.deadline import Deadline
from ..resilience.scheduler import (
    PRIORITY_INTERACTIVE,
    PRIORITY_NAMES,
    SloScheduler,
    SweepDetector,
    classify,
    header_priority,
)
from ..runtime.native import host_engine, loaded_host_engine
from ..cluster import DrainCoordinator, HedgePolicy, QualityTracker, SuspicionPolicy
from ..cluster.replicate import MAX_TRANSFER_BYTES
from ..cluster.security import SIG_HEADER, NonceCache
from ..cluster.security import verify as verify_cluster_sig
from ..session import AnnotationStore, ChannelRegistry
from ..tile_ctx import TileCtx
from ..utils.config import Config
from ..utils.loop_watchdog import LoopWatchdog
from .target import (
    HTTP09,
    ParseError,
    match_groups,
    parse_request_line,
    path_of,
    path_safe,
    query_pairs,
    split_target,
)
from ..utils.metrics import REGISTRY
from ..utils.tracing import TRACER
from . import protocols, websocket

log = logging.getLogger("omero_ms_pixel_buffer_tpu_torch.http")

CONTENT_TYPES = {
    None: "application/octet-stream",
    "png": "image/png",
    "tif": "image/tiff",
    "jpeg": "image/jpeg",
    "json": "application/json",  # histogram bodies
}

JSON_TYPE = "application/json; charset=utf-8"
_TILE_PATH = re.compile(r"^/tile/([^{}/]+)/([^{}/]+)/([^{}/]+)/([^{}/]+)$")
_RENDER_PATH = re.compile(r"^/render/([^{}/]+)/([^{}/]+)/([^{}/]+)/([^{}/]+)$")
_HISTOGRAM_PATH = re.compile(r"^/histogram/([^{}/]+)/([^{}/]+)/([^{}/]+)/([^{}/]+)$")
_DEBUG_TRACE_PATH = re.compile(r"^/debug/requests/([^{}/]+)$")
# the session plane's routes (the JAX app registers them when
# ``session.enabled``): path pattern -> handler name by method
_SESSION_ROUTES = (
    (re.compile(r"^/session/([^{}/]+)/live$"),
     {"GET": "_session_live", "HEAD": "_session_live"}),
    (re.compile(r"^/session/([^{}/]+)/viewport$"), {"POST": "_session_viewport"}),
    (re.compile(r"^/annotations/([^{}/]+)$"),
     {"POST": "_annotations_create", "GET": "_annotations_list", "HEAD": "_annotations_list"}),
    (re.compile(r"^/annotations/([^{}/]+)/([^{}/]+)$"),
     {"GET": "_annotation_get", "HEAD": "_annotation_get", "PUT": "_annotation_update",
      "DELETE": "_annotation_delete"}),
)
# the ingest plane's write routes (the JAX app registers them when
# ``ingest.enabled``), behind the session check like the session routes
_INGEST_ROUTES = (
    (re.compile(r"^/image/([^{}/]+)/tile/([^{}/]+)/([^{}/]+)/([^{}/]+)$"),
     {"PUT": "_ingest_tile"}),
    (re.compile(r"^/image/([^{}/]+)/planes$"), {"POST": "_ingest_planes"}),
)
_SSE_HEADERS = {"Content-Type": "text/event-stream", "Cache-Control": "no-cache",
                "X-Accel-Buffering": "no"}
# routes that need no session (the JAX session middleware's exemptions)
_SESSION_EXEMPT = ("/healthz", "/metrics")
# the routes the door gate and the scheduler serve: the native endpoints
# and every adapter
SERVING_PREFIXES = ("/tile/", "/render/", "/histogram/", "/dzi/", "/iiif/", "/iris/")
# what a routed path allows (aiohttp's Allow header): GET with its HEAD,
# and the catch-all OPTIONS; an unrouted path allows OPTIONS alone
_ROUTE_METHODS = "GET,HEAD,OPTIONS"
# the discovery document (getMicroserviceDetails)
DISCOVERY = {"provider": "PixelBufferMicroservice", "version": __version__, "features": []}
_MAX_HEADERS = 100
# request bodies, with a Content-Length or chunked: up to aiohttp's
# client_max_size reach the handler (1 MiB, or the JAX app's larger bound
# with the cluster plane: an L2-framed entry or a transfer-framed batch,
# plus 64 KiB; with the ingest plane: ingest.staging-bytes plus 64 KiB); a
# larger one is read and dropped, and the handler sees None, as a JAX
# handler sees aiohttp's 413 inside its body parse. Without the ingest
# plane a body over _MAX_DRAIN is a 400; with it every body is read (an
# ingest handler answers aiohttp's 413 for one over the bound)
_MAX_BODY = 1 << 20
_MAX_DRAIN = 64 << 20
_DRAIN_CHUNK = 1 << 16
# the cluster plane's surface, lower-cased as the front keys its headers
_PEER = PEER_HEADER.lower()
# (path pattern, handler name by method) of the plane's /internal/* routes
_INTERNAL_ROUTES = (
    (re.compile(r"^/internal/purge/([^{}/]+)$"), {"POST": "_internal_purge"}),
    (re.compile(r"^/internal/replica$"), {"POST": "_internal_replica"}),
    (re.compile(r"^/internal/transfer$"), {"GET": "_internal_transfer",
                                           "HEAD": "_internal_transfer"}),
    (re.compile(r"^/internal/handoff$"), {"POST": "_internal_handoff"}),
    (re.compile(r"^/internal/digest$"), {"GET": "_internal_digest", "HEAD": "_internal_digest"}),
    (re.compile(r"^/internal/pull$"), {"POST": "_internal_pull"}),
    (re.compile(r"^/internal/drain$"), {"POST": "_internal_drain"}),
    (re.compile(r"^/internal/gossip$"), {"POST": "_internal_gossip"}),
)
# the request target as aiohttp's ``request.path_qs`` spells it, for the
# serving path's owner hop (set per request by ``_route``)
_PATH_QS: contextvars.ContextVar = contextvars.ContextVar("ompb_path_qs", default="")
# opt-in dependency pings of /healthz?probe=1: at most one round per
# interval (the JAX app's throttle)
_PROBE_MIN_INTERVAL_S = 5.0
# how long a closing WebSocket waits for the client's close frame, and
# how long shutdown waits for the live channels to end
_WS_CLOSE_TIMEOUT_S = 10.0
_LIVE_SHUTDOWN_S = 2.0
# a session and image pair that took the full path stays authorized for
# result-cache hits this long (the JAX resolver's session-context TTL)
AUTHZ_TTL_S = 10.0
_AUTHZ_MAX = 65536
# what a session store raises when it cannot answer: 503, never 403
_STORE_DOWN = (ConnectionError, OSError, asyncio.TimeoutError)


def default_config() -> Config:
    """The JAX defaults with the in-memory session store: what a server
    built without a config runs with."""
    return Config.from_dict({"session-store": {"type": "memory"}})


class TileServer:
    """The asyncio HTTP front over a batching worker. Its knobs come from
    ``config`` (default: the JAX defaults, in-memory sessions);
    ``max_inflight``, ``queue_size`` and ``request_budget_ms`` override
    the config's ``resilience.admission.max-inflight``, ``slo.queue-size``
    and ``resilience.request-budget-ms``. ``session_store`` defaults to
    the echo store with ``dev``, else to ``sessions`` in memory;
    ``session_validator`` authorizes cache hits (default: the allow-list
    of every key the store resolved). ``absent`` names the default-on
    planes the port started without (``/healthz`` ``config.absent``).
    The flight recorder (``recorder``), the TinyLFU gate and the
    prefetcher (``prefetcher``) follow the config's ``obs:`` and
    ``cache:`` blocks."""

    def __init__(
        self,
        worker: BatchingTileWorker,
        dev: bool = False,
        sessions: Optional[Dict[str, str]] = None,
        gpu: Optional[dict] = None,
        max_inflight: Optional[int] = None,
        queue_size: Optional[int] = None,
        request_budget_ms: Optional[float] = None,
        config: Optional[Config] = None,
        session_store=None,
        session_validator=None,
        absent: Tuple[str, ...] = (),
    ):
        config = config or default_config()
        self.config = config
        self.worker = worker
        self.pipeline = worker.pipeline
        if session_store is None:
            session_store = EchoSessionStore() if dev else MemorySessionStore(sessions)
        self.session_store = session_store
        self.session_validator = session_validator or AllowListValidator()
        self.absent = tuple(absent)
        self.gpu = gpu
        oc = config.obs
        self.recorder: Optional[FlightRecorder] = None
        if oc.enabled:
            self.recorder = FlightRecorder(
                enabled=True, slow_threshold_s=oc.slow_threshold_ms / 1000.0,
                head_sample_rate=oc.head_sample_rate, ring_size=oc.ring_size,
                sli=SliLayer(budget_s=oc.slow_threshold_ms / 1000.0))
        cc = config.cache
        # ``cache.enabled: false`` turns the whole subsystem off, as in
        # JAX: no result cache, single-flight, prefetcher or fleet plane
        self.cache: Optional[TileResultCache] = None
        if cc.enabled:
            admission = (TinyLFU(counters=cc.tinylfu.counters,
                                 sample_size=cc.tinylfu.sample_size)
                         if cc.tinylfu.enabled else None)
            self.cache = TileResultCache(memory_bytes=cc.memory_mb << 20,
                                         max_entry_bytes=cc.max_entry_kb << 10,
                                         protected_fraction=cc.protected_fraction,
                                         ttl_s=cc.ttl_s, admission=admission,
                                         disk_dir=cc.disk_dir, disk_bytes=cc.disk_mb << 20,
                                         manifest=cc.manifest)
        self.max_age_s = int(cc.max_age_s)
        self.etag_precheck = cc.etag_precheck
        self._flight: Optional[SingleFlight] = SingleFlight() if cc.enabled else None
        res, slo = config.resilience, config.slo
        self.admission = AdmissionController(
            max_inflight=(res.admission.max_inflight if max_inflight is None
                          else max_inflight),
            retry_after_s=res.admission.retry_after_s)
        # ``slo.enabled: false``: no scheduler and no sweep detector; the
        # binary door gate of ``_route`` takes their place
        self.sweep_detector: Optional[SweepDetector] = None
        self.scheduler: Optional[SloScheduler] = None
        if slo.enabled:
            self.sweep_detector = SweepDetector(threshold=slo.sweep_window,
                                                ttl_s=slo.sweep_ttl_s)
            self.scheduler = SloScheduler(
                self.admission, queue_size=slo.queue_size if queue_size is None else queue_size,
                class_weights=slo.class_weights, degrade=slo.degrade,
                degrade_factor=slo.degrade_factor)
        self.priority_header = slo.priority_header
        if request_budget_ms is None:
            request_budget_ms = (res.request_budget_ms if res.request_budget_ms is not None
                                 else config.event_bus_send_timeout_ms)
        self.request_budget_s = request_budget_ms / 1000.0
        self.prefetcher: Optional[ViewportPrefetcher] = None
        if self.cache is not None and cc.prefetch.enabled:
            pf = cc.prefetch
            self.prefetcher = ViewportPrefetcher(
                self._prefetch_fetch, self.cache, self.admission,
                quality=self.pipeline.encode_signature(), queue_size=pf.queue_size,
                headroom_fraction=pf.headroom,
                # 0: the full request budget (real requests join prefetch
                # flights, so a shorter one would 504 them)
                budget_s=pf.budget_ms / 1000.0 or self.request_budget_s,
                lookahead=pf.lookahead, viewport_span=pf.viewport_span,
                extent_fn=self.pipeline.pixels_service.peek_extent,
                sweep_detector=self.sweep_detector)
        # the session plane: live channels and annotations
        self.session_channels: Optional[ChannelRegistry] = None
        self.annotations: Optional[AnnotationStore] = None
        sp = config.session
        if sp.enabled:
            self.session_channels = ChannelRegistry(
                max_channels=sp.max_channels, max_per_image=sp.max_per_image,
                queue_size=sp.queue_size, recorder=self.recorder)
            self.annotations = AnnotationStore(max_images=sp.max_annotation_images,
                                               max_per_image=sp.max_annotations_per_image)
        self.ping_interval_s = sp.ping_interval_s
        # the fleet plane (cache/plane/, cluster/): the shared L2 tier
        # and/or the consistent-hash ring, its quality tracker and drain
        self.cache_plane: Optional[CachePlane] = None
        self.quality: Optional[QualityTracker] = None
        self.drainer: Optional[DrainCoordinator] = None
        self.cluster_nonces = NonceCache()
        self.max_body = _MAX_BODY
        cl = config.cluster
        if cl.plane_enabled and self.cache is not None:
            # the fleet layers fill and are filled by the local cache
            self._build_plane(cl)
            self.max_body = max((cc.max_entry_kb << 10) + 65536, MAX_TRANSFER_BYTES + 65536)
        # the ingest plane: the write routes over the same pixels service
        # the readers use (so one ACL resolver, buffer memo and
        # invalidation path); without a cluster epoch registry a commit's
        # epoch is this local sequence
        self.ingest: Optional[IngestPlane] = None
        self._ingest_epoch_seq = 0
        self.max_drain: Optional[int] = _MAX_DRAIN
        ig = config.ingest
        if ig.enabled:
            self.ingest = IngestPlane(self.pipeline.pixels_service,
                                      max_inflight_shards=ig.max_inflight_shards,
                                      staging_bytes=ig.staging_bytes)
            # the JAX app's client_max_size with the plane on
            self.max_body = max(self.max_body, (cc.max_entry_kb << 10) + 65536,
                                ig.staging_bytes + 65536)
            self.max_drain = None
        # the background mesh probe (``mesh.probe-interval-ms``): readmits
        # a recovered device before a dispatch has to fail
        self.mesh_prober: Optional[MeshProber] = None
        if config.mesh.probe_interval_ms > 0:
            self.mesh_prober = MeshProber(self.pipeline.mesh_manager,
                                          interval_s=config.mesh.probe_interval_ms / 1000.0)
        self._drain_task: Optional[asyncio.Task] = None
        self._probe_task: Optional[asyncio.Task] = None
        self._probe_cache: Optional[Tuple[float, dict]] = None
        wd = res.watchdog
        self.watchdog = (LoopWatchdog(interval_s=wd.interval_ms / 1000.0,
                                      warn_after_s=wd.warn_ms / 1000.0)
                         if wd.enabled else None)
        self.render_enabled = config.render.enabled
        self.jpeg_quality = config.render.jpeg_quality
        self.analysis_enabled = config.analysis.enabled
        self.max_bins = config.analysis.max_bins
        pc = config.protocols
        self.protocols_enabled = {"dzi": pc.dzi.enabled, "iiif": pc.iiif.enabled,
                                  "iris": pc.iris.enabled}
        self.tile_sizes = {"dzi": pc.dzi.tile_size, "iiif": pc.iiif.tile_size,
                           "iris": pc.iris.tile_size}
        self._routes = protocols.routes(self.protocols_enabled)
        # (session, image) -> expiry of the full path's verdict; purged
        # from the resolver's thread on invalidation
        self._authz: Dict[tuple, float] = {}
        self._authz_lock = threading.Lock()
        resolver = getattr(self.pipeline.pixels_service, "metadata_resolver", None)
        if resolver is not None and hasattr(resolver, "add_invalidation_listener"):
            resolver.add_invalidation_listener(self._invalidate_image)
        self.kernel_libraries: Dict[str, dict] = {}  # set by ``wire`` on CUDA
        self._server: Optional[asyncio.AbstractServer] = None
        self._writers: set = set()  # open connections, closed at shutdown
        self._live: set = set()  # connections a live channel owns
        self.port: Optional[int] = None

    def _build_plane(self, cl) -> None:
        """The cluster plane of the ``cluster:`` block, as the JAX app
        builds it: the hedge policy, the quality tracker and suspicion
        policy, the ``CachePlane`` (with lease or gossip membership and the
        fleet brains when the block asks for them) and the drain
        coordinator."""
        hedge = None
        if cl.hedge.enabled:
            peer_timeout_s = cl.peer_timeout_ms / 1000.0
            hedge = HedgePolicy(
                enabled=True, quantile=cl.hedge.quantile, min_s=cl.hedge.min_ms / 1000.0,
                max_s=cl.hedge.max_ms / 1000.0,
                fallback_s=cl.hedge.fallback_ms / 1000.0 or peer_timeout_s / 2.0)
        self.quality = QualityTracker()
        suspicion = SuspicionPolicy(
            enabled=cl.suspect.enabled, error_rate=cl.suspect.error_rate,
            p99_factor=cl.suspect.p99_factor, min_requests=cl.suspect.min_requests,
            peer_failures=cl.suspect.peer_failures,
            corruption_after=cl.integrity.verdict_after)
        self.cache_plane = CachePlane(
            members=cl.members, self_url=cl.self_url, virtual_nodes=cl.virtual_nodes,
            peer_timeout_s=cl.peer_timeout_ms / 1000.0, l2_uri=cl.l2.uri, l2_ttl_s=cl.l2.ttl_s,
            lease_ttl_s=cl.lease_ttl_s, replication_factor=cl.replication_factor,
            transfer_max_entries=cl.transfer_max_entries, hedge=hedge, secret=cl.secret,
            result_cache=self.cache, scheduler=self.scheduler, admission=self.admission,
            repair_interval_s=cl.repair.interval_s, repair_max_keys=cl.repair.max_keys,
            quality=self.quality, suspicion=suspicion,
            gossip_interval_s=cl.gossip.interval_s if cl.gossip.enabled else 0.0,
            gossip_fanout=cl.gossip.fanout, gossip_fail_after_s=cl.gossip.fail_after_s,
            integrity_verify=cl.integrity.verify_bodies)
        # SIGTERM (``drain_on_signal``) or POST /internal/drain runs it;
        # live channels ride the drain (reconnect frames, the summary)
        self.drainer = DrainCoordinator(
            self.cache_plane, deadline_s=cl.drain.deadline_s, admission=self.admission,
            scheduler=self.scheduler, session_registry=self.session_channels)

    async def start(self, host: str = "127.0.0.1", port: int = 0) -> int:
        """Start the worker and listen; returns the bound port."""
        await self.worker.start()
        if self.watchdog is not None:
            self.watchdog.start()  # on the serving loop's thread
        if self.prefetcher is not None:
            self.prefetcher.start()
        if self.mesh_prober is not None:
            self.mesh_prober.start()
        if self.session_channels is not None:
            # delta pushes come from resolver threads: they land on this loop
            self.session_channels.start(asyncio.get_running_loop())
        if self.cache_plane is not None:
            # invalidation listeners fire on resolver threads: the fan-out
            # is scheduled on this loop
            self.cache_plane.start(asyncio.get_running_loop())
        self._server = await asyncio.start_server(self._client, host, port)
        self.port = self._server.sockets[0].getsockname()[1]
        return self.port

    async def close(self) -> None:
        if self.session_channels is not None:
            # the close sentinel to every live channel; their connections
            # end (an SSE EOF, a WebSocket close) before the rest is cut
            await self.session_channels.close()
            if self._live:
                await asyncio.wait(list(self._live), timeout=_LIVE_SHUTDOWN_S)
        if self._server is not None:
            self._server.close()
            for writer in list(self._writers):
                writer.close()  # idle keep-alive connections end here
            await self._server.wait_closed()
            self._server = None
        if self.watchdog is not None:
            self.watchdog.stop()
        if self.mesh_prober is not None:
            self.mesh_prober.stop()
        if self.prefetcher is not None:
            await self.prefetcher.close()
        if self.cache_plane is not None:
            await self.cache_plane.close()
        await self.worker.close()
        if self.cache is not None:
            self.cache.close()
        if TRACER.reporter is not None:  # flush the spans, as the JAX app's cleanup
            TRACER.reporter.close()
            TRACER.reporter = None
        close = getattr(self.session_store, "close", None)
        if close is not None:
            await close()

    # -- connection loop ---------------------------------------------------

    async def _client(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        self._writers.add(writer)
        try:
            while True:
                request = await self._read_request(reader, writer)
                if request is None:
                    break
                method, target, version, headers, body = request
                keep_alive = _keep_alive(version, headers)
                if body is _EXPECTATION_FAILED:
                    # aiohttp's expect handler answers before any route
                    _write_response(writer, 417, {}, b"Unknown Expect: "
                                    + headers["expect"].encode("latin-1"), False, version=version)
                    await writer.drain()
                    break
                answer = await self._dispatch(method, target, headers, body)
                if isinstance(answer, _Takeover):
                    # a live channel owns the connection until its pump ends
                    task = asyncio.current_task()
                    self._live.add(task)
                    try:
                        await answer.run(reader, writer)
                    finally:
                        self._live.discard(task)
                    break
                status, out_headers, body = answer
                _write_response(writer, status, out_headers, body, keep_alive,
                                head=method == "HEAD", version=version)
                await writer.drain()
                if not keep_alive:
                    break
        except (ConnectionError, asyncio.IncompleteReadError):
            pass
        except _BadRequest as e:
            _write_response(writer, 400, {}, str(e).encode(), False)
        except ParseError as e:
            # aiohttp's answer to a request its parser refuses
            _write_response(writer, 400, {}, e.body(), False, version="HTTP/1.0")
        finally:
            self._writers.discard(writer)
            writer.close()
            try:
                await writer.wait_closed()
            except ConnectionError:
                pass

    async def _read_request(self, reader, writer):
        """(method, target, version, headers, body) of the next request, or
        None at the end of the stream. A repeated header keeps its first
        value, as aiohttp's ``headers.get`` reads it; ``Expect:
        100-continue`` on HTTP/1.1 answers ``100 Continue`` before the body
        is read, and another expectation reads no body
        (``_EXPECTATION_FAILED``)."""
        line = await reader.readline()
        while line in (b"\r\n", b"\n"):  # llhttp skips empty lines before a request
            line = await reader.readline()
        if not line:
            return None
        method, target, version = parse_request_line(line.rstrip(b"\r\n"))
        headers: Dict[str, str] = {}
        for _ in range(_MAX_HEADERS + 1):
            raw = await reader.readline()
            if raw in (b"\r\n", b"\n", b""):
                break
            name, sep, value = raw.decode("latin-1").partition(":")
            if not sep:
                raise _BadRequest("Malformed header")
            name = name.strip().lower()
            if name == "content-length" and name in headers:
                text = raw.rstrip(b"\r\n")
                raise ParseError("Duplicate Content-Length", text,
                                 len(text) - len(text.split(b":", 1)[1].lstrip()))
            headers.setdefault(name, value.strip())
        else:
            raise _BadRequest("Too many headers")
        expect = headers.get("expect")
        if expect and version == "HTTP/1.1":
            if expect.lower() != "100-continue":
                return method, target, version, headers, _EXPECTATION_FAILED
            writer.write(b"HTTP/1.1 100 Continue\r\n\r\n")
            await writer.drain()
        if "transfer-encoding" in headers:
            if ("content-length" in headers
                    or headers["transfer-encoding"].strip().lower() != "chunked"):
                raise _BadRequest("Bad Transfer-Encoding")
            return method, target, version, headers, await self._read_chunked(reader)
        try:
            length = int(headers.get("content-length", "0") or 0)
        except ValueError:
            raise _BadRequest("Bad Content-Length") from None
        if length < 0 or (self.max_drain is not None and length > self.max_drain):
            raise _BadRequest("Bad Content-Length")
        body: Optional[bytes] = b""
        if length > self.max_body:
            while length:  # over the limit: read and dropped
                length -= len(await reader.readexactly(min(length, _DRAIN_CHUNK)))
            body = None
        elif length:
            body = await reader.readexactly(length)
        return method, target, version, headers, body

    async def _read_chunked(self, reader) -> Optional[bytes]:
        """A chunked body, decoded as aiohttp's parser decodes it (chunk
        extensions and trailers skipped); over ``max_body`` the rest is
        read and dropped (None), and over ``max_drain`` it is a 400."""
        parts: List[bytes] = []
        size = 0
        while True:
            line = await reader.readline()
            if not line.endswith(b"\n"):
                raise asyncio.IncompleteReadError(line, None)
            try:
                n = int(line.split(b";", 1)[0].strip(), 16)
            except ValueError:
                raise _BadRequest("Bad chunk size") from None
            if n < 0:
                raise _BadRequest("Bad chunk size")
            if n == 0:
                while (await reader.readline()) not in (b"\r\n", b"\n", b""):
                    pass  # trailers
                break
            size += n
            if self.max_drain is not None and size > self.max_drain:
                raise _BadRequest("Bad chunked body")
            while n:
                piece = await reader.readexactly(min(n, _DRAIN_CHUNK))
                n -= len(piece)
                if size <= self.max_body:
                    parts.append(piece)
            if await reader.readline() not in (b"\r\n", b"\n"):
                raise _BadRequest("Bad chunk terminator")
        return b"".join(parts) if size <= self.max_body else None

    async def _dispatch(self, method: str, target: str, headers: Dict[str, str],
                        body: Optional[bytes] = b""):
        """One request's answer, a (status, headers, body) triple or a
        ``_Takeover`` of the connection. With the cluster plane, a request
        to a serving route notes its status and wall time in the quality
        tracker first (the JAX ``quality_middleware``, outermost); a
        client that hangs up notes nothing."""
        path = path_of(split_target(target)[0])
        serving = method != "OPTIONS" and path.startswith(SERVING_PREFIXES)
        sig = _SigVerdict(self, method, target, headers)
        if self.quality is None or not serving:
            return await self._observed(method, target, headers, path, body, serving, sig)
        t0 = time.perf_counter()
        status = 500
        try:
            answer = await self._observed(method, target, headers, path, body, serving, sig)
            if not isinstance(answer, _Takeover):
                status = answer[0]
            return answer
        except asyncio.CancelledError:
            status = None
            raise
        finally:
            if status is not None:
                self.quality.note(status, time.perf_counter() - t0)

    async def _observed(self, method, target, headers, path, body, serving, sig):
        """The request under the cluster guard; one to a serving route
        rides a flight record from here (the JAX ``obs_middleware``). A
        peer hop whose cluster identity checks out joins the requester's
        trace (``X-OMPB-Trace-Id``, ``X-OMPB-Trace-Span``)."""
        rec = None
        if self.recorder is not None and serving:
            trace_id = parent = None
            if _PEER in headers and self._peer_claim_verified(sig):
                trace_id = _valid_trace_id(headers.get(TRACE_HEADER.lower()))
                parent = _valid_trace_id(headers.get(TRACE_PARENT_HEADER.lower()), 16)
            rec = self.recorder.start(path, method, trace_id=trace_id, parent_span_id=parent)
            if rec is not None and trace_id is not None:
                rec.peer_origin = headers.get(_PEER)
        if rec is None:
            return await self._guarded(method, target, headers, path, None, body, sig)
        status = 500
        try:
            with record_scope(rec):
                response = await self._guarded(method, target, headers, path, rec, body, sig)
            status, out_headers, _ = response
            degraded = out_headers.get("X-OMPB-Degraded")
            if degraded:
                rec.tag("degraded", int(degraded))
            x_cache = out_headers.get("X-Cache")
            if x_cache:
                rec.tag("cache", x_cache)
            return response
        finally:
            self.recorder.complete(rec, status)

    async def _guarded(self, method, target, headers, path, rec, body, sig):
        """The cluster guard (the JAX ``cluster_guard_middleware``), inside
        the flight record and before the door gate: with the plane, an
        ``/internal/*`` request or one that carries ``X-OMPB-Peer`` must
        hold a valid ``X-OMPB-Sig`` when ``cluster.secret`` is set, and
        without a secret an ``/internal/*`` request must carry the peer
        marker; else 403."""
        if self.cache_plane is not None:
            is_internal = path.startswith("/internal/")
            claims_peer = _PEER in headers
            if is_internal or claims_peer:
                if self.config.cluster.secret:
                    if not sig.ok(body or b""):
                        return 403, {}, b"invalid cluster signature"
                    if claims_peer:
                        # the join hint: the peer marker carries the
                        # sender's serving URL inside the HMAC, so a
                        # verified contact teaches this replica a member
                        self.cache_plane.note_peer_contact(headers.get(_PEER, ""))
                elif is_internal and not claims_peer:
                    return 403, {}, b"peer requests only"
        return await self._traced(method, target, headers, path, rec, body)

    def _peer_claim_verified(self, sig: "_SigVerdict") -> bool:
        """Whether a peer-marked request's cluster identity holds for the
        trace adoption outside the guard: its signature over an empty
        body (serving hops are bodiless GETs), or, without a secret,
        the network's word."""
        if not self.config.cluster.secret:
            return True
        return sig.ok(b"")

    async def _traced(self, method, target, headers, path, rec, body=b""):
        """The request inside a live ``http:<path>`` span when
        ``http-tracing.enabled`` (the JAX ``tracing_middleware``): it joins
        the flight record's trace and carries the record's span id."""
        if not TRACER.enabled:
            return await self._route(method, target, headers, body)
        if rec is not None:
            span = TRACER.start_span_with_context(
                f"http:{path}", {"traceId": rec.trace_id, "spanId": rec.parent_span_id})
            span.span_id = rec.span_id
        else:
            span = TRACER.start_span(f"http:{path}")
        with span:
            return await self._route(method, target, headers, body)

    async def _route(self, method: str, target: str, headers: Dict[str, str],
                     body: Optional[bytes] = b""):
        # aiohttp's two spellings of the path: ``request.path`` (every escape
        # decoded) for the prefix checks, and the router's ``path_safe``
        # (``%2F`` and ``%25`` kept) for the routes, whose groups then decode
        raw_path, raw_query = split_target(target)
        path, safe = path_of(raw_path), path_safe(raw_path)
        _PATH_QS.set(aiohttp_path_qs(target))
        if method == "OPTIONS":
            return 200, {"Content-Type": JSON_TYPE}, json.dumps(DISCOVERY).encode()
        query: Dict[str, str] = {}
        for k, v in query_pairs(raw_query):
            query.setdefault(k, v)  # first value per key, as aiohttp's
        if path.startswith(SERVING_PREFIXES):
            if self.scheduler is None:
                # the binary door gate (the JAX ``admission_middleware``):
                # a slot for the whole request, or 503 at once
                if not self.admission.try_acquire():
                    return 503, {"Retry-After": _retry_after(self.admission.retry_after_s)}, \
                        b"Service overloaded"
                try:
                    return await self._past_door(method, path, safe, query, headers, body)
                finally:
                    self.admission.release()
            shed = self._door_gate(path, safe, query, headers)
            if shed is not None:
                return shed
        return await self._past_door(method, path, safe, query, headers, body)

    async def _past_door(self, method: str, path: str, safe: str, query: Dict[str, str],
                         headers: Dict[str, str], body: Optional[bytes]):
        """A request past the door: the session check, then its route."""
        healthz = safe == "/healthz"
        metrics = safe == "/metrics"
        debug = None
        if self.recorder is not None:
            debug = (() if safe == "/debug/requests"
                     else match_groups(_DEBUG_TRACE_PATH, safe))
        exempt = path in _SESSION_EXEMPT or path.startswith(("/internal/", "/debug/"))
        m = render = histogram = adapter = None
        if not exempt:
            m = match_groups(_TILE_PATH, safe)
            if m is None and self.render_enabled:
                m = render = match_groups(_RENDER_PATH, safe)
            if m is None and self.analysis_enabled:
                m = histogram = match_groups(_HISTOGRAM_PATH, safe)
            if m is None:
                adapter = self._adapter_route(safe)
        session_route = None
        if m is None and adapter is None and not exempt and self.session_channels is not None:
            session_route = _session_route(safe)
        ingest_route = None
        if m is None and adapter is None and not exempt and self.ingest is not None:
            ingest_route = _match_route(_INGEST_ROUTES, safe)
        key = None
        if not exempt:
            key, refusal = await self._session(headers.get("cookie"))
            if refusal is not None:
                return refusal
        if session_route is not None:
            # behind the session check, outside the door gate, admission
            # and the flight record, as in JAX
            methods, groups = session_route
            name = methods.get(method)
            if name is None:
                return 405, {"Allow": ",".join(sorted({*methods, "OPTIONS"}))}, \
                    b"405: Method Not Allowed"
            return await getattr(self, name)(groups, headers, key or "", body, method)
        if ingest_route is not None:
            # behind the session check; the scheduler pin lives in the
            # handler (outside the door gate and the flight record)
            methods, groups = ingest_route
            name = methods.get(method)
            if name is None:
                return 405, {"Allow": ",".join(sorted({*methods, "OPTIONS"}))}, \
                    b"405: Method Not Allowed"
            return await getattr(self, name)(groups, query, key or "", body)
        if self.cache_plane is not None and path.startswith("/internal/"):
            internal = _match_route(_INTERNAL_ROUTES, safe)
            if internal is not None:
                methods, groups = internal
                name = methods.get(method)
                if name is None:
                    return 405, {"Allow": ",".join(sorted({*methods, "OPTIONS"}))}, \
                        b"405: Method Not Allowed"
                return await getattr(self, name)(groups, query, headers, body)
        routed = (healthz or metrics or debug is not None or m is not None
                  or adapter is not None)
        if method not in ("GET", "HEAD") or not routed:
            return 405, {"Allow": _ROUTE_METHODS if routed else "OPTIONS"}, \
                b"405: Method Not Allowed"
        if healthz:
            view = self.health()
            if query.get("probe", "").strip().lower() in ("1", "true", "yes"):
                # opt-in dependency pings; probes mint breakers
                view["probes"] = await self._probe_dependencies_throttled()
                view["breakers"] = BOARD.snapshot()
            return 200, {"Content-Type": JSON_TYPE}, json.dumps(view).encode()
        if metrics:
            return _metrics_response(headers)
        if debug is not None:
            return await self._debug_requests(debug, query, headers)
        if adapter is not None:
            handler, groups = adapter
            return await handler(self, groups, query, headers, key)
        path_params = dict(zip(("imageId", "z", "c", "t"), m))
        if render is not None:
            ctx, error = self._render_ctx(path_params, query, key)
            if error is None:
                self._join_annotations(ctx, query)
        elif histogram is not None:
            ctx, error = self._histogram_ctx(path_params, query, key)
        else:
            ctx, error = self._tile_ctx(path_params, query, key)
        if error is not None:
            return 400, {}, error.encode()
        return await self.serve(ctx, headers)

    def _adapter_route(self, safe: str):
        """(handler, decoded groups) of the adapter route that matches the
        ``path_safe`` path, or None."""
        for pattern, handler in self._routes:
            groups = match_groups(pattern, safe)
            if groups is not None:
                return handler, groups
        return None

    def _door_gate(self, path: str, safe: str, query: dict, headers: Dict[str, str]):
        """The door gate: None to go on, or the 503 of a request that would
        shed at ``acquire`` anyway while the wait queue is full (classified
        by its headers alone: no session exists yet). A ``/tile`` or
        ``/render`` request whose entry is cached passes."""
        rec = current_record()
        t_door = time.perf_counter()
        try:
            priority = classify(headers, None, None, self.priority_header)
            if not self.scheduler.would_overflow_shed(priority):
                return None
            if self.cache is not None and path.startswith(("/tile/", "/render/")):
                probe = self._door_probe_key(safe, query)
                if probe is not None and self.cache.contains_any_tier(probe):
                    return None
            self.scheduler.shed_at_door(priority)
            if rec is not None:
                rec.tag("priority", PRIORITY_NAMES[priority])
                rec.tag("shed_at", "door")
            return 503, {"Retry-After": _retry_after(self.admission.retry_after_s)}, \
                b"Service overloaded"
        finally:
            if rec is not None:
                rec.stamp("door", time.perf_counter() - t_door)

    def _door_probe_key(self, safe: str, query: dict) -> Optional[str]:
        """The cache key the door gate probes for a ``path_safe`` path, or
        None when the request does not parse (it then sheds like any
        other): the w/h = 0 spelling normalised from an open buffer only
        (no I/O), a ``/render`` request keyed with its spec."""
        render = match_groups(_RENDER_PATH, safe)
        m = render or match_groups(_TILE_PATH, safe)
        if m is None:
            return None
        path_params = dict(zip(("imageId", "z", "c", "t"), m))
        if render is not None:
            ctx, error = self._render_ctx(path_params, query, None)
        else:
            ctx, error = self._tile_ctx(path_params, query, None)
        if error is not None:
            return None
        region = ctx.region
        if region.width == 0 or region.height == 0:
            extent = self.pipeline.pixels_service.peek_extent(ctx.image_id, ctx.resolution)
            if extent is not None:
                if region.width == 0:
                    region.width = extent[0]
                if region.height == 0:
                    region.height = extent[1]
        return ctx.cache_key(self.pipeline.encode_signature())

    @staticmethod
    def _tile_ctx(path_params, query, key):
        """(ctx, None) for a /tile request, or (None, the 400 message)."""
        try:
            return TileCtx.from_params({**path_params, **query}, key), None
        except TileError as e:
            return None, e.message

    def _render_ctx(self, path_params, query, key):
        """(ctx, None) for a /render request, or (None, the 400 message):
        the path's ids, the RenderSpec of the query (the path's c is the
        default channel; named LUTs must be known), then the query's
        x/y/w/h/resolution, parsed in that order as the JAX front does."""
        try:
            ctx = TileCtx.from_params(path_params, key)
        except TileError as e:
            return None, e.message
        spec, error = self.build_render_spec(query, ctx.c)
        if error is not None:
            return None, error
        ctx.render = spec
        ctx.format = spec.format  # Content-Type and filename
        return _apply_region_params(ctx, query)

    def build_render_spec(self, query, default_channel: int):
        """The one parse of a ``RenderSpec``, shared by ``/render`` and the
        adapters: (spec, None), or (None, the 400 message) for a grammar
        error or an unknown LUT."""
        try:
            spec = RenderSpec.from_params(query, default_channel=default_channel,
                                          default_quality=self.jpeg_quality)
        except TileError as e:
            return None, e.message
        for ch in spec.channels:
            if ch.lut is not None and ch.lut not in self.pipeline.lut_registry:
                return None, f"Unknown LUT: {ch.lut}"
        return spec, None

    def _histogram_ctx(self, path_params, query, key):
        """(ctx, None) for a /histogram request, or (None, the 400
        message): the path's ids, the HistogramSpec of the query (the
        path's c is the default channel; ``bins`` at most
        ``analysis.max-bins``), then x/y/w/h/resolution, in the JAX front's
        order."""
        try:
            ctx = TileCtx.from_params(path_params, key)
            spec = HistogramSpec.from_params(query, default_channel=ctx.c,
                                             max_bins=self.max_bins)
        except TileError as e:
            return None, e.message
        ctx.analysis = spec
        ctx.format = "json"  # Content-Type and filename
        return _apply_region_params(ctx, query)

    async def serve(self, ctx: TileCtx, headers: Dict[str, str]) -> Tuple[int, dict, bytes]:
        """A parsed ``/tile``, ``/render``, ``/histogram`` or adapter
        request: classified, then through the result cache; a miss takes a
        scheduler slot under the request's deadline and one flight. A
        served tile or render is observed by the prefetcher. Without the
        scheduler there is no class and no slot here (the door gate held
        one); without the result cache every request executes once, on
        its own."""
        rec = ctx.obs = current_record()
        sched, cache = self.scheduler, self.cache
        if sched is not None:
            ctx.priority = classify(headers, ctx.omero_session_key, self.sweep_detector,
                                    self.priority_header)
            if header_priority(headers, self.priority_header) is None:
                # only unlabelled traffic trains the sweep detector; a
                # sweep demotes the session's next request, not this one
                r = ctx.region
                self.sweep_detector.observe(ctx.omero_session_key, ctx.image_id, ctx.z, ctx.c,
                                            ctx.t, ctx.resolution, r.x, r.y, r.width, r.height)
        if rec is not None:
            rec.tag("priority", PRIORITY_NAMES.get(ctx.priority, "interactive"))
            rec.tag("engine", self.pipeline.engine)
        inm = headers.get("if-none-match", "")
        quality = self.pipeline.encode_signature()
        key = None
        plane_epoch = plane_pending = plane_generation = None
        if cache is not None:
            with ambient_stage("cache_probe"):
                await self._normalize_region(ctx)
            key = ctx.cache_key(quality)
            with ambient_stage("cache_probe"):
                entry = await cache.get(key)
            plane = self.cache_plane
            if plane is not None and entry is not None:
                # replication qualifies on frequency, and most keys cross
                # the bar on a hit (O(1) when it declines)
                plane.note_hit(key, entry)
            if plane is not None and entry is None:
                # the cluster consult, between the local miss and the
                # render: the shared L2, then one bounded GET to the key's
                # owner. The generation is taken before the hop, so an
                # invalidation racing it blocks the re-admission
                peer_originated = _PEER in headers
                plane_generation = cache.generation()
                plane_entry, source, plane_epoch, plane_pending = await plane.fetch(
                    key, _PATH_QS.get(), _cookie_session_id(headers.get("cookie")),
                    peer_originated=peer_originated)
                if peer_originated and plane_epoch is None:
                    # the owner's side of a hop: the fill stamps the epoch
                    # the requester observed before it
                    plane_epoch = _parse_epoch(headers.get(EPOCH_HEADER.lower()))
                if plane_entry is not None:
                    if await self._authorize_cached(ctx):
                        cache.put(key, plane_entry, generation=plane_generation)
                        self._observe_prefetch(ctx)
                        return self._tile_response(ctx, plane_entry, inm, source)
                    # not confirmed: the full path answers 403, 404 or 503
                    # (and never admits the fetched bytes under an
                    # unverified session)
            if entry is not None:
                if inm and self.etag_precheck and etag_matches(inm, entry.etag):
                    # the client already holds these exact bytes:
                    # revalidation discloses nothing, so it answers before
                    # the session join
                    return 304, self._cache_headers(entry.etag), b""
                if await self._authorize_cached(ctx):
                    self._observe_prefetch(ctx)
                    return self._tile_response(ctx, entry, inm, "hit")
                # not confirmed: the full path answers 403, 404 or 503
        ctx.deadline = Deadline.after(self.request_budget_s)
        permit = None
        served = False
        try:
            full_res_key = None
            if sched is not None:
                try:
                    permit = await sched.acquire(ctx.priority, ctx.deadline,
                                                 degradable=_degradable(ctx))
                except TileError as e:
                    if rec is not None and isinstance(e, ServiceUnavailableError):
                        rec.tag("shed_at", "queue")  # acquire's only 503 is a shed
                    return _failure(e)
                if rec is not None and permit.queued_s > 0.0:
                    rec.stamp("queue_wait", permit.queued_s)
                if permit.degraded:
                    # the next-lower level, upscaled, under its own key;
                    # the full-resolution key is kept for a flight that
                    # comes back undegraded (no coarser level)
                    ctx.degraded = 1
                    if cache is not None:
                        full_res_key, key = key, ctx.cache_key(quality)
                        entry = await cache.get(key)
                        if entry is not None and await self._authorize_cached(ctx):
                            return self._tile_response(ctx, entry, inm, "hit", degraded=1)
            try:
                if key is None:
                    # no result cache: this request's own execution
                    body, meta = await self.worker.handle(ctx)
                    entry = CachedTile(body, etag="", filename=meta["filename"])
                    degraded = int(meta.get("degraded", 0))
                elif plane_pending is not None:
                    # the hedge fired: the local render races the peer fetch
                    reply, early = await self._hedged_fetch(
                        ctx, key, full_res_key, plane_epoch, plane_pending, plane_generation,
                        inm)
                    if early is not None:
                        return early
                    entry, degraded = reply
                else:
                    entry, degraded = await self._flight.do(
                        ctx.dedupe_key(quality),
                        lambda: self._render(ctx, key, full_res_key, plane_epoch))
            except TileError as e:
                return _failure(e)
            served = True
        finally:
            if plane_pending is not None and not plane_pending.done():
                plane_pending.cancel()  # every exit cancels an unconsumed hedge
            if permit is not None:
                # failures do not train the service-time estimate
                sched.release(permit, train=served)
        if cache is not None:
            # the full path validated the session and resolved the image
            # under its ACL: the verdict serves this pair's hits a while
            self._authz_record(ctx)
        self._observe_prefetch(ctx)
        return self._tile_response(ctx, entry, inm, "miss" if cache is not None else None,
                                   degraded=degraded)

    def _observe_prefetch(self, ctx: TileCtx) -> None:
        """Feed a served tile or render to the prefetcher; histogram
        streams never train it (its predictions would warm tiles)."""
        if self.prefetcher is not None and ctx.analysis is None:
            self.prefetcher.observe(ctx)

    async def _prefetch_fetch(self, ctx: TileCtx, key: str) -> None:
        """The prefetcher's fetch: the miss path of a real request (one
        flight per dedupe key, the batcher, the kernels, the cache fill),
        so a warmed tile lands with its ETag and a real request arriving
        meanwhile joins the flight. A failure raises to the prefetcher,
        which counts it."""
        quality = self.pipeline.encode_signature()
        await self._flight.do(ctx.dedupe_key(quality), lambda: self._render(ctx, key, None))

    def _cache_headers(self, etag: str) -> dict:
        """Validator and freshness headers of a tile the cache saw.
        ``private``: tiles are authorized per session, so shared proxies
        must not keep them."""
        return {"ETag": etag, "Cache-Control": f"private, max-age={self.max_age_s}"}

    def _tile_response(self, ctx: TileCtx, entry: CachedTile, inm: str,
                       x_cache: Optional[str], degraded: int = 0) -> Tuple[int, dict, bytes]:
        """200 with the body, or 304 when ``inm`` matches its ETag; a
        degraded body is tagged ``X-OMPB-Degraded`` (the levels down).
        An entry without an ETag (no result cache) carries none of the
        cache's headers and never answers 304."""
        tag = {"X-OMPB-Degraded": str(degraded)} if degraded else {}
        if inm and entry.etag and etag_matches(inm, entry.etag):
            return 304, {**self._cache_headers(entry.etag), **tag}, b""
        t_frame = time.perf_counter()
        headers = {
            "Content-Type": CONTENT_TYPES.get(ctx.format, "application/octet-stream"),
            "Content-Disposition": f'attachment; filename="{entry.filename}"',
            **(self._cache_headers(entry.etag) if entry.etag else {}),
            **({"X-Cache": x_cache} if x_cache else {}),
            **tag,
        }
        if ctx.obs is not None:
            ctx.obs.stamp("frame", time.perf_counter() - t_frame)
        return 200, headers, entry.body

    async def _render(self, ctx: TileCtx, key: str, full_res_key: Optional[str],
                      epoch: Optional[int] = None) -> Tuple[CachedTile, int]:
        """One pipeline execution of a miss, memoized once per flight:
        (entry, levels degraded). A degraded flight that came back at full
        resolution (no coarser level) fills the full-resolution key. With
        the cluster plane the fill is published to the shared tier, stamped
        with ``epoch``, the image epoch observed before the render."""
        generation = self.cache.generation()
        body, meta = await self.worker.handle(ctx)
        entry = CachedTile(body, filename=meta["filename"])
        degraded = int(meta.get("degraded", 0))
        target = full_res_key if full_res_key is not None and not degraded else key
        self.cache.put(target, entry, generation=generation)
        if self.cache_plane is not None:
            self.cache_plane.publish(target, entry, epoch=epoch)
        return entry, degraded

    async def _hedged_fetch(self, ctx: TileCtx, key: str, full_res_key: Optional[str],
                            epoch: Optional[int], pending: asyncio.Task,
                            generation: Optional[int], inm: str):
        """The hedge race (``cluster/hedge.py``): the peer fetch ran past
        the observed p99, so the local render starts now and the first to
        finish serves. ``((entry, degraded), None)`` when the local render
        wins, ``(None, answer)`` when the peer's bytes come first: those
        are full-resolution bytes, admitted under the full-resolution key
        with the generation taken before the hop, and only our wait on the
        flight is cancelled (the flight and its fill go on)."""
        plane = self.cache_plane
        hedge = plane.hedge
        rec = ctx.obs
        quality = self.pipeline.encode_signature()
        fetch_task = asyncio.ensure_future(self._flight.do(
            ctx.dedupe_key(quality), lambda: self._render(ctx, key, full_res_key, epoch)))
        try:
            done, _ = await asyncio.wait({fetch_task, pending},
                                         return_when=asyncio.FIRST_COMPLETED)
            if pending in done and fetch_task not in done:
                result = pending.result()  # ompb-lint: disable=loop-block -- asyncio.Task already in asyncio.wait's done set: result() returns immediately, never blocks
                if result is not None and result[1].get("x-ompb-degraded"):
                    # the owner served its own hybrid-resolution fallback:
                    # those bytes belong under a degraded key
                    result = None
                entry = plane.entry_from_peer(result, getattr(pending, "ompb_owner", None))
                if entry is not None and await self._authorize_cached(ctx):
                    hedge.note("peer_win")
                    if rec is not None:
                        rec.tag("hedge", "peer_win")
                    fetch_task.cancel()
                    self.cache.put(full_res_key if full_res_key is not None else key, entry,
                                   generation=generation)
                    return None, self._tile_response(ctx, entry, inm, "peer-hit")
                hedge.note("peer_failed")
            reply = await fetch_task
            hedge.note("local_win")
            if rec is not None:
                rec.tag("hedge", "local_win")
            return reply, None
        finally:
            if not pending.done():
                pending.cancel()

    # -- authorization of cache hits, invalidation ---------------------------

    def _authz_fresh(self, ctx: TileCtx) -> bool:
        with self._authz_lock:
            expiry = self._authz.get((ctx.omero_session_key, ctx.image_id))
        return expiry is not None and expiry > time.monotonic()

    def _authz_record(self, ctx: TileCtx) -> None:
        with self._authz_lock:
            if len(self._authz) >= _AUTHZ_MAX:
                self._authz.clear()  # coarse but bounded
            self._authz[(ctx.omero_session_key, ctx.image_id)] = time.monotonic() + AUTHZ_TTL_S

    def _authz_purge(self, image_id: int) -> None:
        with self._authz_lock:
            for k in [k for k in self._authz if k[1] == image_id]:
                del self._authz[k]

    async def _authorize_cached(self, ctx: TileCtx) -> bool:
        """Whether a cache hit may be served to this caller: the session
        validates and the image resolves under its ACL. Any failure is
        False, and the request takes the full path, which maps it to its
        status."""
        if self._authz_fresh(ctx):
            return True
        with ambient_stage("cache_probe"):
            return await self._authorize_cached_slow(ctx)

    async def _authorize_cached_slow(self, ctx: TileCtx) -> bool:
        try:
            if not await self.session_validator.validate(ctx.omero_session_key):
                return False
            svc = self.pipeline.pixels_service
            meta = await asyncio.get_running_loop().run_in_executor(
                None, lambda: svc.get_pixels(ctx.image_id, session_key=ctx.omero_session_key))
        except Exception:
            log.debug("cache-hit authorization failed; full path", exc_info=True)
            return False
        if meta is None:
            return False
        self._authz_record(ctx)
        return True

    def _invalidate_image(self, image_id: int) -> None:
        """The metadata resolver's listener (its own thread), and every
        annotation write: the local purge first, synchronous, then the
        cluster plane's fan-out (epoch bump, L2 DELs, peer purges),
        scheduled on the serving loop, which can never block or fail it."""
        self._invalidate_local(image_id)
        if self.cache_plane is not None:
            self.cache_plane.invalidate_image(int(image_id))

    def _invalidate_local(self, image_id: int) -> None:
        """Purge every process-local artifact of one image: its cached
        tiles (both tiers), authorization verdicts, open buffer, device
        planes and decoded blocks, then push an ``invalidate`` delta with
        the plane's epoch to its live channels. Any thread; also the
        target of a peer's purge, which must not fan out again."""
        image_id = int(image_id)
        epoch = self._session_epoch(image_id)
        if epoch is not None:
            # stamped on the open buffer before the pipeline drops it
            self.pipeline.pixels_service.note_epoch(image_id, epoch)
        if self.cache is not None:
            self.cache.invalidate_image(image_id)
        if self.prefetcher is not None:
            self.prefetcher.invalidate_image(image_id)
        self._authz_purge(image_id)
        self.pipeline.invalidate_image(image_id)
        if self.session_channels is not None:
            self.session_channels.push_delta(image_id, epoch=epoch)

    def _session_epoch(self, image_id: int) -> Optional[int]:
        """The image's epoch as this replica knows it (None without the
        plane's epoch registry)."""
        plane = self.cache_plane
        if plane is not None and plane.epochs is not None:
            return plane.epochs.known(image_id)
        return None

    # -- the cluster plane's peer surface (/internal/*) ------------------------

    def verify_cluster_request(self, method: str, target: str, headers: Dict[str, str],
                               body: bytes) -> bool:
        """``X-OMPB-Sig`` over the request as aiohttp's ``path_qs`` spells
        it, with this replica's nonce cache (see ``_SigVerdict``)."""
        return verify_cluster_sig(
            self.config.cluster.secret, headers.get(SIG_HEADER.lower()), method,
            aiohttp_path_qs(target), body, nonce_cache=self.cluster_nonces,
            peer=headers.get(_PEER, "-"))

    async def _internal_purge(self, groups, query, headers, body):
        """Inbound half of the purge fan-out: the forwarded epoch advances
        this replica's high-water mark (so an in-flight replica push for
        the image loses), then the local purge, which fans out no further."""
        if _PEER not in headers:
            return 403, {}, b"peer requests only"
        try:
            image_id = int(groups[0])
        except (TypeError, ValueError):
            return 400, {}, b"bad image id"
        epoch = _parse_epoch(headers.get(EPOCH_HEADER.lower()))
        if epoch is not None:
            self.cache_plane.note_epoch(image_id, epoch)
        self._invalidate_local(image_id)
        return _json(200, {"purged": image_id})

    async def _internal_replica(self, groups, query, headers, body):
        """Inbound next-owner replication: one hot entry framed as an L2
        value (epoch stamp included), admitted to the local cache unless
        its bytes fail their hash (400) or it predates a purge seen here."""
        if _PEER not in headers:
            return 403, {}, b"peer requests only"
        key = headers.get(KEY_HEADER.lower())
        if not key:
            return 400, {}, b"missing key header"
        entry, epoch = decode_entry_epoch(body or b"")
        if entry is None:
            return 400, {}, b"malformed frame"
        plane = self.cache_plane
        if not plane.verify_entry_bytes(entry, "replica", member=headers.get(_PEER)):
            return 400, {}, b"integrity check failed"
        if plane.replica_push_stale(key, epoch):
            if plane.replicator is not None:
                plane.replicator.rejected_stale += 1
            return _json(200, {"stored": False, "stale": True})
        self.cache.put(key, entry, generation=self.cache.generation())
        if plane.replicator is not None:
            plane.replicator.received += 1
        return _json(200, {"stored": True})

    @staticmethod
    def _internal_limit(query, limit: int):
        """(limit, None) under the ``?limit=`` bound, or (None, the 400)."""
        raw = query.get("limit")
        if raw is not None:
            try:
                limit = min(limit, max(0, int(raw)))
            except (TypeError, ValueError):
                return None, (400, {}, b"bad limit")
        return limit, None

    async def _internal_transfer(self, groups, query, headers, body):
        """This replica's hottest memory entries as one bounded transfer
        payload (a joiner's warm-up)."""
        if _PEER not in headers:
            return 403, {}, b"peer requests only"
        limit, error = self._internal_limit(query, self.config.cluster.transfer_max_entries)
        if error is not None:
            return error
        return 200, {"Content-Type": "application/octet-stream"}, \
            self.cache_plane.hot_transfer_payload(limit)

    async def _internal_handoff(self, groups, query, headers, body):
        """Inbound half of a drain handoff: transfer-framed entries,
        absorbed through the epoch- and hash-checked path, or (JSON) a
        draining peer's live-channel summary for the session plane."""
        if _PEER not in headers:
            return 403, {}, b"peer requests only"
        ctype = headers.get("content-type", "").split(";", 1)[0].strip().lower()
        if ctype == "application/json":
            if self.session_channels is None:
                return 503, {}, b"session plane disabled"
            payload = _json_body(body)
            if payload is None:
                return 400, {}, b"bad handoff body"
            if not isinstance(payload, dict) or payload.get("kind") != "session_handoff":
                return 400, {}, b"bad handoff kind"
            return _json(200, {"absorbed": self.session_channels.absorb_handoff(payload)})
        stored = await self.cache_plane.absorb_handoff(body or b"", member=headers.get(_PEER))
        return _json(200, {"stored": stored})

    async def _internal_digest(self, groups, query, headers, body):
        """The anti-entropy digest: (key, epoch) pairs of the warm set,
        checksummed."""
        if _PEER not in headers:
            return 403, {}, b"peer requests only"
        limit, error = self._internal_limit(query, self.cache_plane.digest_limit())
        if error is not None:
            return error
        return 200, {"Content-Type": "application/json"}, \
            self.cache_plane.digest_payload(limit)

    async def _internal_pull(self, groups, query, headers, body):
        """The anti-entropy pull: the named entries held here, transfer-
        framed, bounded in count and bytes."""
        if _PEER not in headers:
            return 403, {}, b"peer requests only"
        parsed = _json_body(body)
        keys = parsed.get("keys") if isinstance(parsed, dict) else None
        if not isinstance(keys, list):
            return 400, {}, b"bad key list"
        return 200, {"Content-Type": "application/octet-stream"}, \
            await self.cache_plane.pull_payload(keys)

    async def _internal_drain(self, groups, query, headers, body):
        """Run (or join) the drain: ``?wait=1`` answers when it is done,
        else the current state at once while it runs."""
        if _PEER not in headers:
            return 403, {}, b"peer requests only"
        if query.get("wait", "").strip().lower() in ("1", "true", "yes"):
            stats = await self.drainer.drain()
            return _json(200, {"state": self.drainer.state, "stats": stats})
        task = asyncio.ensure_future(self.drainer.drain())
        task.add_done_callback(lambda t: t.cancelled() or t.exception())
        return _json(200, self.drainer.snapshot())

    async def _internal_gossip(self, groups, query, headers, body):
        """One push-pull gossip exchange (cluster/gossip.py): merge the
        sender's digest and answer with ours; 503 without gossip
        membership, as the JAX app answers."""
        if _PEER not in headers:
            return 403, {}, b"peer requests only"
        remote = _json_body(body)
        if not isinstance(remote, dict):
            return 400, {}, b"bad digest"
        reply = self.cache_plane.gossip_receive(remote)
        if reply is None:
            return 503, {}, b"gossip disabled"
        return _json(200, reply)

    def drain_on_signal(self, done) -> bool:
        """SIGTERM with ``cluster.drain.signal``: run the drain, then call
        ``done`` (the caller's stop); False (nothing started) without the
        plane or the key. A repeat signal while it runs joins it."""
        if self.drainer is None or not self.config.cluster.drain.signal:
            return False
        if self._drain_task is None or self._drain_task.done():
            async def drain_then_stop() -> None:
                try:
                    await self.drainer.drain()
                except Exception:
                    log.exception("drain on SIGTERM failed; stopping anyway")
                finally:
                    done()

            self._drain_task = asyncio.ensure_future(drain_then_stop())
            self._drain_task.add_done_callback(lambda t: t.cancelled() or t.exception())
        return True

    async def _probe_dependencies_throttled(self) -> dict:
        """``/healthz?probe=1``: at most one round a ``_PROBE_MIN_INTERVAL_S``
        (concurrent callers share the round in flight, later ones get its
        result), so the unauthenticated endpoint cannot pump traffic or
        failures into the stores' breakers."""
        now = time.monotonic()
        if self._probe_cache is not None and now - self._probe_cache[0] < _PROBE_MIN_INTERVAL_S:
            return self._probe_cache[1]
        if self._probe_task is None or self._probe_task.done():
            async def round_() -> dict:
                probes = await self._probe_dependencies()
                self._probe_cache = (time.monotonic(), probes)
                return probes

            self._probe_task = asyncio.get_running_loop().create_task(round_())
        return await asyncio.shield(self._probe_task)

    async def _probe_dependencies(self) -> dict:
        """One bounded exchange with each configured remote dependency,
        concurrently, through its client (so through its breaker): the
        session store, the L2 tier and the OMERO database. "ok", or the
        error's name and text."""
        bound = timeouts.io_timeout_s()
        bound = min(bound, 2.0) if bound > 0 else 2.0
        probes: dict = {}

        async def run(name: str, factory) -> None:
            try:
                await asyncio.wait_for(factory(), bound)
                probes[name] = "ok"
            except Exception as e:
                probes[name] = f"{type(e).__name__}: {e}"

        tasks = [run("session-store", lambda: self.session_store.get_omero_session_key(
            "__ompb_healthz_probe__"))]
        plane = self.cache_plane
        if plane is not None and plane.l2 is not None:
            tasks.append(run("cache-l2", lambda: plane.l2.get("__ompb_healthz_probe__")))
        resolver = getattr(self.pipeline.pixels_service, "metadata_resolver", None)
        if resolver is not None and hasattr(resolver, "query"):
            loop = asyncio.get_running_loop()
            tasks.append(run("postgres", lambda: loop.run_in_executor(
                None, lambda: resolver.query("SELECT 1", []))))
        await asyncio.gather(*tasks)
        return probes

    # -- the session plane ---------------------------------------------------

    def _session_snapshot(self) -> dict:
        if self.session_channels is None:
            return {"enabled": False}
        out = self.session_channels.snapshot()
        out["annotations"] = self.annotations.snapshot()
        return out

    def _join_annotations(self, ctx: TileCtx, query) -> None:
        """``/render?annotations=1``: the image's stored shapes appended to
        the spec's masks, the joined set cut at ``MAX_SHAPES`` (explicit
        ``roi=`` shapes first), so the key and ETag are those of the
        explicit ``roi=`` request with the same shapes."""
        if self.annotations is None or query.get("annotations", "").strip().lower() not in (
                "1", "true", "yes"):
            return
        stored = self.annotations.shapes(ctx.image_id)
        if stored:
            ctx.render = dataclasses.replace(
                ctx.render, masks=(ctx.render.masks + stored)[:MAX_SHAPES])

    def _note_viewport(self, session_key: str, image_id: int, rect) -> bool:
        if self.prefetcher is None or not isinstance(rect, dict):
            return False
        return self.prefetcher.note_viewport(session_key, image_id, rect)

    async def _session_still_valid(self, session_id: str) -> bool:
        """The ping interval's revalidation: a session revoked in the store
        loses its channel within one interval; a store that cannot answer
        reads as still valid (never as denied)."""
        try:
            key = await self.session_store.get_omero_session_key(session_id)
        except Exception:
            return True
        return bool(key)

    def _session_hello(self, channel) -> dict:
        return {"type": "hello", "image": channel.image_id, "transport": channel.transport,
                "epoch": self._session_epoch(channel.image_id),
                "annotations": self.annotations.sub_epoch(channel.image_id)}

    def _session_inbound(self, channel, frame) -> None:
        """One client frame off a WebSocket: a viewport report feeds the
        prefetcher; anything else is ignored."""
        if isinstance(frame, dict) and frame.get("type") == "viewport":
            self._note_viewport(channel.omero_session_key, channel.image_id, frame)

    async def _session_pump(self, channel, send) -> None:
        """Drain the channel's queue into ``send`` until the close sentinel.
        A quiet ``session.ping-interval-s`` revalidates the session (a
        revoked one gets the close frames next) and else sends a ping."""
        while True:
            try:
                frame = await asyncio.wait_for(channel.queue.get(), self.ping_interval_s)
            except asyncio.TimeoutError:
                if not await self._session_still_valid(channel.session_id):
                    self.session_channels.revoke(channel)
                    continue
                await send({"type": "ping", "epoch": self._session_epoch(channel.image_id)})
                continue
            if frame is None:
                return
            await send(frame)

    async def _session_live(self, groups, headers, key, body, method):
        """``GET /session/{imageId}/live``: a WebSocket when the client asks
        to upgrade, else server-sent events. 503 with ``Retry-After`` past
        either channel cap."""
        try:
            image_id = int(groups[0])
        except ValueError:
            return 400, {}, b"bad image id"
        if method == "HEAD":
            return 200, dict(_SSE_HEADERS), b""
        want_ws = headers.get("upgrade", "").strip().lower() == "websocket"
        channel = self.session_channels.register(
            image_id, _cookie_session_id(headers.get("cookie")) or "", key,
            "ws" if want_ws else "sse")
        if channel is None:
            return 503, {"Retry-After": "1"}, b"Session plane at capacity"
        if not want_ws:
            return _Takeover(self._session_sse, channel)
        answer, error = websocket.handshake(headers)
        if error is not None:
            self.session_channels.unregister(channel)
            return 400, {}, error.encode()
        return _Takeover(self._session_ws, channel, answer)

    async def _session_sse(self, reader, writer, channel) -> None:
        """The SSE transport: one ``data:`` event a frame (compact JSON),
        chunked, ended by the last chunk. The pump runs beside a reader
        that sees the client leave, so a dropped socket ends it."""
        head = ["HTTP/1.1 200 OK", *(f"{k}: {v}" for k, v in _SSE_HEADERS.items()),
                "Transfer-Encoding: chunked", "Connection: close"]
        writer.write(("\r\n".join(head) + "\r\n\r\n").encode("latin-1"))

        async def send(frame: dict) -> None:
            data = b"data: " + json.dumps(frame, separators=(",", ":")).encode() + b"\n\n"
            writer.write(b"%x\r\n%s\r\n" % (len(data), data))
            await writer.drain()

        async def pump() -> None:
            await send(self._session_hello(channel))
            await self._session_pump(channel, send)
            writer.write(b"0\r\n\r\n")
            await writer.drain()

        async def gone() -> None:
            while await reader.read(1 << 16):
                pass  # SSE is one-way: whatever the client sends is dropped

        try:
            await _first_of(pump(), gone())
        finally:
            self.session_channels.unregister(channel)

    async def _session_ws(self, reader, writer, channel, answer) -> None:
        """The WebSocket transport: the 101 answer, the hello, then the pump
        as a tracked task while this reads the client's frames (viewport
        reports). The pump's end (revocation, shutdown) sends the close
        frame; the client's close, an EOF or a protocol error ends the
        reader, which cancels and awaits the pump."""
        head = ["HTTP/1.1 101 Switching Protocols", *(f"{k}: {v}" for k, v in answer.items())]
        writer.write(("\r\n".join(head) + "\r\n\r\n").encode("latin-1"))
        ws = websocket.WebSocket(reader, writer)

        async def pump_then_close() -> None:
            try:
                await ws.send_json(self._session_hello(channel))
                await self._session_pump(channel, ws.send_json)
            finally:
                if not ws.closed:
                    await ws.close()
            # the client answers our close; a silent one is cut
            await asyncio.sleep(_WS_CLOSE_TIMEOUT_S)
            writer.close()

        pump = asyncio.get_running_loop().create_task(pump_then_close())
        try:
            while True:
                text = await ws.receive()
                if text is None:
                    break
                try:
                    frame = json.loads(text)
                except ValueError:
                    continue  # a garbled frame is a no-op
                self._session_inbound(channel, frame)
        finally:
            pump.cancel()
            try:
                await pump
            except asyncio.CancelledError:
                if not pump.cancelled():
                    raise  # this handler was cancelled: propagate
            except (ConnectionError, OSError):
                pass  # a send racing a gone socket is the close
            self.session_channels.unregister(channel)

    async def _session_viewport(self, groups, headers, key, body, method):
        """``POST /session/{imageId}/viewport``: an SSE client's viewport
        report (WebSocket clients send it inline)."""
        try:
            image_id = int(groups[0])
        except ValueError:
            return 400, {}, b"bad image id"
        rect = _json_body(body)
        if not isinstance(rect, dict):
            return 400, {}, b"bad viewport body"
        noted = self._note_viewport(key, image_id, rect)
        if not noted and self.prefetcher is not None:
            return 400, {}, b"bad viewport rect"
        return _json(200, {"noted": noted})

    def _annotation_changed(self, image_id: int, sub_epoch: int) -> None:
        """Every annotation write: the image's purge (an ``invalidate``
        delta), then the ``annotations`` delta with the sub-epoch."""
        self._invalidate_image(image_id)
        self.session_channels.push_delta(image_id, epoch=self._session_epoch(image_id),
                                         kind="annotations",
                                         annotation_epoch=sub_epoch)

    async def _annotations_create(self, groups, headers, key, body, method):
        try:
            image_id = int(groups[0])
        except ValueError:
            return 400, {}, b"bad image id"
        doc = _json_body(body)
        if not isinstance(doc, dict):
            return 400, {}, b"bad annotation body"
        try:
            record, sub_epoch = self.annotations.create(image_id, doc)
        except TileError as e:
            return e.code, {}, e.message.encode()
        self._annotation_changed(image_id, sub_epoch)
        return _json(201, {"annotation": record, "epoch": sub_epoch})

    async def _annotations_list(self, groups, headers, key, body, method):
        try:
            image_id = int(groups[0])
        except ValueError:
            return 400, {}, b"bad image id"
        return _json(200, self.annotations.list(image_id))

    async def _annotation_get(self, groups, headers, key, body, method):
        try:
            image_id = int(groups[0])
        except ValueError:
            return 400, {}, b"bad image id"
        record = self.annotations.get(image_id, groups[1])
        if record is None:
            return 404, {}, b"no such annotation"
        return _json(200, {"annotation": record})

    async def _annotation_update(self, groups, headers, key, body, method):
        try:
            image_id = int(groups[0])
        except ValueError:
            return 400, {}, b"bad image id"
        doc = _json_body(body)
        if not isinstance(doc, dict):
            return 400, {}, b"bad annotation body"
        try:
            result = self.annotations.update(image_id, groups[1], doc)
        except TileError as e:
            return e.code, {}, e.message.encode()
        if result is None:
            return 404, {}, b"no such annotation"
        record, sub_epoch = result
        self._annotation_changed(image_id, sub_epoch)
        return _json(200, {"annotation": record, "epoch": sub_epoch})

    async def _annotation_delete(self, groups, headers, key, body, method):
        try:
            image_id = int(groups[0])
        except ValueError:
            return 400, {}, b"bad image id"
        sub_epoch = self.annotations.delete(image_id, groups[1])
        if sub_epoch is None:
            return 404, {}, b"no such annotation"
        self._annotation_changed(image_id, sub_epoch)
        return _json(200, {"deleted": True, "epoch": sub_epoch})

    # -- the ingest plane ------------------------------------------------------

    def _ingest_snapshot(self) -> dict:
        if self.ingest is None:
            return {"enabled": False}
        return {**self.ingest.snapshot(), "enabled": True}

    async def _ingest_allowed(self, image_id: int, session_key: str) -> bool:
        """Write permission from the metadata resolver's
        ``can_write_image`` (OMERO's permissions, ``db/metadata.py``); a
        resolver without one (the file registry: no ACLs) allows the
        write, as it allows the read."""
        resolver = getattr(self.pipeline.pixels_service, "metadata_resolver", None)
        can_write = getattr(resolver, "can_write_image", None)
        if can_write is None:
            return True
        loop = asyncio.get_running_loop()
        return bool(await loop.run_in_executor(None, can_write, image_id, session_key))

    def _too_large(self, body: Optional[bytes]) -> Optional[Tuple[int, dict, bytes]]:
        """aiohttp's 413 of ``request.read()`` for a body at or over the
        bound (its text names the size read when the bound was crossed;
        the port names the body's whole size)."""
        if body is not None and len(body) < self.max_body:
            return None
        actual = self.max_body if body is None else len(body)
        return 413, {}, (f"Maximum request body size {self.max_body} exceeded, "
                         f"actual body size {actual}").encode()

    async def _ingest_commit(self, image_id: int, key: str, tiles: list):
        """The write path shared by both routes: write permission, a
        scheduler permit that cannot be degraded, stage and commit on a
        worker thread (stage ``ingest`` of the ambient record), then the
        epoch bump first, the purges, and the written tiles' delta to the
        live channels. A failed commit is a 503: each object publishes
        atomically and the fault points fire before the publish."""
        if not await self._ingest_allowed(image_id, key):
            return 403, {}, f"Cannot write Image:{image_id}".encode()
        permit = None
        if self.scheduler is not None:
            try:
                # a write is never degradable, and it must not train the
                # viewer models: a linear acquisition scan is the canonical
                # sweep, and the writer's own viewers would be demoted
                permit = await self.scheduler.acquire(
                    PRIORITY_INTERACTIVE, Deadline.after(self.request_budget_s),
                    degradable=False)
            except TileError as e:
                return _failure(e)
        try:
            plane = self.ingest

            def commit() -> dict:
                with ambient_stage("ingest"):
                    return plane.write_tiles(image_id, tiles, session_key=key)

            cvctx = contextvars.copy_context()
            loop = asyncio.get_running_loop()
            try:
                stats = await loop.run_in_executor(None, lambda: cvctx.run(commit))
            except IngestError as e:
                return e.code, {}, e.message.encode()
            except TileError as e:
                return _failure(e)
            except Exception as e:
                log.warning("ingest commit failed: %s", e)
                return 503, {}, f"ingest commit failed: {e}".encode()
        finally:
            # a multi-second shard rebuild must not inflate the read
            # service-time estimate
            if permit is not None:
                self.scheduler.release(permit, train=False)
        epoch = None
        plane = self.cache_plane
        if plane is not None and plane.epochs is not None:
            await plane.epochs.bump(image_id)
            epoch = plane.epochs.known(image_id)
        else:
            # no epoch registry: a local token, so open buffers' shard
            # index memos still invalidate
            self._ingest_epoch_seq += 1
            self.pipeline.pixels_service.note_epoch(image_id, self._ingest_epoch_seq)
        self._invalidate_image(image_id)
        if self.session_channels is not None:
            # the written tiles on top of the whole-image frame: viewers
            # re-fetch just these
            self.session_channels.push_delta(image_id, epoch=self._session_epoch(image_id),
                                             tiles=[t[:7] for t in tiles])
        return _json(200, {"image": image_id, "epoch": epoch, **stats})

    async def _ingest_tile(self, groups, query, key, body):
        """PUT /image/{id}/tile/{z}/{c}/{t}?x&y&w&h: one tile, w*h
        big-endian pixels of the image's type (the raw /tile read's byte
        order, so the bytes put are the bytes read back)."""
        try:
            image_id, z, c, t = (int(g) for g in groups)
            x, y, w, h = (int(query[k]) for k in ("x", "y", "w", "h"))
        except (KeyError, TypeError, ValueError):
            return 400, {}, (b"expected /image/{id}/tile/{z}/{c}/{t}?x&y&w&h "
                             b"with integer values")
        refusal = self._too_large(body)
        if refusal is not None:
            return refusal
        return await self._ingest_commit(image_id, key, [(z, c, t, x, y, w, h, body)])

    async def _ingest_planes(self, groups, query, key, body):
        """POST /image/{id}/planes?planes=z:c:t,...: whole planes appended
        in one commit; the body is the listed planes' big-endian pixels,
        concatenated in order."""
        try:
            image_id = int(groups[0])
        except (TypeError, ValueError):
            return 400, {}, b"bad image id"
        coords = []
        try:
            for part in query.get("planes", "").split(","):
                z, c, t = (int(v) for v in part.split(":"))
                coords.append((z, c, t))
        except (TypeError, ValueError):
            return 400, {}, b"expected ?planes=z:c:t[,z:c:t...] with integer coordinates"
        loop = asyncio.get_running_loop()
        meta = await loop.run_in_executor(None, self.pipeline.pixels_service.get_pixels,
                                          image_id, key)
        if meta is None:
            return 404, {}, f"Cannot find Image:{image_id}".encode()
        refusal = self._too_large(body)
        if refusal is not None:
            return refusal
        if not body or len(body) % len(coords):
            return 400, {}, (f"body ({len(body)} bytes) is not {len(coords)} "
                             "equal whole planes").encode()
        step = len(body) // len(coords)
        tiles = [(z, c, t, 0, 0, meta.size_x, meta.size_y, body[i * step:(i + 1) * step])
                 for i, (z, c, t) in enumerate(coords)]
        return await self._ingest_commit(image_id, key, tiles)

    async def _normalize_region(self, ctx: TileCtx) -> None:
        """Rewrite w/h = 0 (the full plane) to the plane's size before any
        key derives from the region, so both spellings share one cache
        entry and one flight; an unknown image or level leaves it alone."""
        if ctx.region.width > 0 and ctx.region.height > 0:
            return
        extent = await asyncio.get_running_loop().run_in_executor(
            None, self._full_plane_extent, ctx)
        if extent is None:
            return
        if ctx.region.width == 0:
            ctx.region.width = extent[0]
        if ctx.region.height == 0:
            ctx.region.height = extent[1]

    def _full_plane_extent(self, ctx: TileCtx) -> Optional[Tuple[int, int]]:
        try:
            buf = self.pipeline.pixels_service.get_pixel_buffer(ctx.image_id)
            level = ctx.resolution or 0
            if buf is None or not 0 <= level < buf.resolution_levels:
                return None
            return buf.level_size(level)
        except Exception:
            return None

    async def _session(self, cookie_header: Optional[str]):
        """(OMERO session key, None), or (None, the refusal): 403 for no
        cookie or an unknown session, 503 with ``Retry-After`` for a store
        that cannot answer (auth unavailable must never read as auth
        denied, or a store blip logs every user out)."""
        denied = (403, {}, b"Permission denied")
        session_id = _cookie_session_id(cookie_header)
        if not session_id:
            return None, denied
        try:
            with ambient_stage("auth"):
                key = await self.session_store.get_omero_session_key(session_id)
        except ServiceUnavailableError as e:
            return None, (503, {"Retry-After": _retry_after(e.retry_after_s)},
                          b"Session store unavailable")
        except _STORE_DOWN as e:
            log.warning("session store lookup failed: %s", e)
            return None, (503, {"Retry-After": "1"}, b"Session store unavailable")
        if not key:
            return None, denied
        return key, None

    def health(self) -> dict:
        """/healthz body: the scheduler's (``slo``: per-class classified,
        granted, shed, degraded and expired-in-queue counts, the service-time
        estimate, the sweep detector), admission's, the adapters'
        (``protocols``), the event-loop watchdog's (``watchdog``), expired
        requests by stage (``deadline``), the request budget, kernel launch counters, the host engine and its
        lanes (oversize lanes; device-filtered lanes deflated on the host),
        the encode queue's (with its deflate mode and packer), the plane
        cache's, the batcher's (with its lone lanes and super-tile
        stamps), the result cache's, the render engine's, the histogram
        plane's and super-tile fusion's snapshots, the batched host reads
        (``reads``, with the RGB lanes sent to the device) and the JPEG
        device IDCT's (``jpeg``: its mode, calls and device ms), the read
        plane's (``io``: store requests, coalescing, bytes, chunk decodes,
        the connection pool) and the stores' circuit breakers
        (``breakers``, with the retry counts under ``retries``), whether the
        process holds a CUDA context (``cuda_initialized``), the flight
        recorder's (``obs``: started, kept, dropped, the ring, the SLI burn
        rates) and the prefetcher's (``prefetch``). The status
        is "degraded" (still 200) while a breaker is open, every execution
        slot is taken or the event loop is blocked."""
        breakers = BOARD.snapshot()
        admission = self.admission.snapshot()
        watchdog = (self.watchdog.snapshot() if self.watchdog is not None
                    else {"enabled": False, "blocked": False})
        degraded = (any(b["state"] == "open" for b in breakers.values())
                    or admission["inflight"] >= admission["max_inflight"]
                    or watchdog["blocked"])
        return {
            "status": "degraded" if degraded else "ok",
            "config": self.config_view(),
            "obs": (self.recorder.snapshot() if self.recorder is not None
                    else {"enabled": False}),
            "prefetch": (self.prefetcher.snapshot() if self.prefetcher is not None
                         else {"enabled": False}),
            "session": self._session_snapshot(),
            "ingest": self._ingest_snapshot(),
            "slo": ({**self.scheduler.snapshot(), "sweep": self.sweep_detector.snapshot()}
                    if self.scheduler is not None else {"enabled": False}),
            "admission": admission,
            "protocols": {**self.protocols_enabled,
                          "requests": protocols.request_counts()},
            "watchdog": watchdog,
            "deadline": rdeadline.snapshot(),
            "request_budget_ms": self.request_budget_s * 1000.0,
            "device": (str(self.pipeline.device) if self.pipeline.device is not None
                       else "host"),
            "gpu": self.gpu,
            # whether this process holds a CUDA context (never on the host
            # engine); a query, it creates none
            "cuda_initialized": torch.cuda.is_initialized(),
            "kernels": launch_counts(),
            "host_engine": loaded_host_engine(),
            "host_png_lanes": self.pipeline.host_png_lanes,
            "device_deflate": self.pipeline.device_deflate,
            "host_deflate_lanes": self.pipeline.host_deflate_lanes,
            "render": self._render_health(),
            "analysis": {"enabled": self.analysis_enabled, **self.pipeline.analysis_snapshot()},
            "supertile": {"enabled": self.worker.supertile,
                          "stamped_lanes": self.worker.stamped,
                          **self.pipeline.supertile_snapshot()},
            "queue": self.pipeline.device_queue_snapshot(),
            "plane_cache": self.pipeline.plane_cache_snapshot(),
            "batcher": self.worker.snapshot(),
            "result_cache": self._result_cache_snapshot(),
            "cluster": self._cluster_snapshot(),
            "reads": self.pipeline.read_snapshot(),
            "jpeg": self.pipeline.pixels_service.idct.snapshot(),
            "io": io_snapshot(),
            "breakers": breakers,
            "retries": retry.snapshot(),
        }


    def _render_health(self) -> dict:
        """``/healthz`` ``render``, with the serving mesh's manager under
        ``mesh`` once the pipeline has one (JAX: the same key)."""
        out = {"enabled": self.render_enabled, **self.pipeline.render_snapshot()}
        mgr = self.pipeline.mesh_manager()
        if mgr is not None:
            out["mesh"] = mgr.snapshot()
        return out

    def _result_cache_snapshot(self) -> dict:
        if self.cache is None:
            return {"enabled": False}  # the JAX ``cache`` view
        out = self.cache.snapshot()
        if self.cache_plane is not None:
            out["plane"] = self.cache_plane.snapshot()
        return out

    def _cluster_snapshot(self) -> dict:
        """``/healthz`` ``cluster``: the plane's coordination view, its
        drain and (with a secret) the nonce cache; ``{"enabled": false}``
        without the plane."""
        if self.cache_plane is None:
            return {"enabled": False}
        out = self.cache_plane.cluster_snapshot()
        out["drain"] = self.drainer.snapshot()
        if self.config.cluster.secret:
            out["nonces"] = self.cluster_nonces.snapshot()
        return out

    async def _debug_requests(self, match, query, headers) -> Tuple[int, dict, bytes]:
        """``/debug/requests``: the ring's kept wide events, most recent
        first (``?limit=N``; ``?fleet=1`` with the cluster plane gathers
        every member's); ``/debug/requests/{traceId}``: one trace's
        events, 404 when none is kept."""
        if match:
            trace_id = match[0]
            events = self.recorder.events(trace_id=trace_id)
            if not events:
                return 404, {}, b"unknown trace id"
            return 200, {"Content-Type": JSON_TYPE}, json.dumps(
                {"trace_id": trace_id, "events": events}).encode()
        limit = None
        raw = query.get("limit")
        if raw is not None:
            try:
                limit = max(0, int(raw))
            except (TypeError, ValueError):
                return 400, {}, b"bad limit"
        events = self.recorder.events(limit=limit)
        local = {"kept": self.recorder.kept_count(), "ring_size": self.recorder.ring_size,
                 "count": len(events), "events": events}
        plane = self.cache_plane
        if (query.get("fleet", "").strip().lower() in ("1", "true", "yes")
                and plane is not None and plane.self_url and _PEER not in headers):
            # the fleet view: every member's ring (null when unreachable);
            # a peer-originated scatter is terminal, never re-fanned out
            others = [m for m in plane.members_view() if m != plane.self_url]
            path = "/debug/requests" + (f"?limit={limit}" if limit is not None else "")
            replies = await asyncio.gather(*(plane.peers.get_json(m, path) for m in others))
            members = {plane.self_url: local, **dict(zip(others, replies))}
            return _json(200, {"fleet": True, "members": members})
        return _json(200, local)

    def config_view(self) -> dict:
        """``/healthz`` ``config``: the default-on planes the port started
        without (``absent``), the session store and validator, and the
        knobs the config set on this front, its batcher and the
        process-wide layers."""
        w, cfg = self.worker, self.config
        return {
            "absent": list(self.absent),
            "session_store": type(self.session_store).__name__,
            "session_validator": type(self.session_validator).__name__,
            "engine": cfg.backend.engine,
            "pipeline_engine": self.pipeline.engine,
            "batching": {"buckets": list(self.pipeline.buckets), "max_batch": w.max_batch,
                         "coalesce_window_ms": w.coalesce_window_s * 1000.0,
                         "burst_window_ms": w.burst_window_s * 1000.0, "workers": w.workers},
            "cache": ({"memory_bytes": self.cache.memory.max_bytes,
                       "protected_fraction": cfg.cache.protected_fraction,
                       "ttl_s": self.cache.ttl_s, "max_entry_bytes": self.cache.max_entry_bytes,
                       "max_age_s": self.max_age_s, "etag_precheck": self.etag_precheck}
                      if self.cache is not None else {"enabled": False}),
            "png": {"filter": self.pipeline.png_filter, "level": self.pipeline.png_level,
                    "strategy": self.pipeline.png_strategy},
            "breaker": {"enabled": BOARD.enabled, **BOARD.defaults},
            "io_timeout_ms": timeouts.io_timeout_s() * 1000.0,
            "supertile": {"enabled": w.supertile, "limits": list(w.supertile_limits)},
            "max_tile_bytes": self.pipeline.max_tile_bytes,
            "jpeg_quality": self.jpeg_quality,
            "analysis_max_bins": self.max_bins,
            "tile_sizes": dict(self.tile_sizes),
        }


# default-on planes of the JAX package that the port starts without, by
# the config key that enables them (none is left)
ABSENT_PLANES: Tuple[Tuple[str, object], ...] = ()


def check_planes(config: Config) -> List[str]:
    """Decide once what the port does with the planes it does not have:
    return the default-on planes that are enabled, which start absent
    with one warning each (none is left). Every value the JAX package's
    ``Config`` accepts is served; the ``jax:`` block is parsed and has no
    effect."""
    if config.jax.compilation_cache_dir:
        log.warning("the jax: block has no effect on the PyTorch port")
    absent = [name for name, on in ABSENT_PLANES if on(config)]
    for name in absent:
        log.warning("'%s' is enabled, but the PyTorch port has no such plane yet: "
                    "starting without it", name)
    return absent


def _pixels_service(config: Config, device):
    """The pixels service of ``config``: the OMERO database's metadata
    plane (ACL-scoped unless ``omero.db.enforce-permissions`` is false)
    with ``omero.db.uri``; image paths from the database and
    ``omero.data.dir`` when both are set and no ``image-registry`` is,
    else the JSON registry."""
    from ..io.pixels_service import ImageRegistry, PixelsService

    server = config.omero_server
    db_uri, data_dir = server.get("omero.db.uri"), server.get("omero.data.dir")
    resolver = None
    if db_uri:
        from ..db.metadata import OmeroPostgresMetadataResolver

        # Java-style properties may arrive as strings: "false" must disable
        flag = server.get("omero.db.enforce-permissions", True)
        resolver = OmeroPostgresMetadataResolver(
            db_uri, enforce_permissions=str(flag).strip().lower() not in ("false", "0", "no",
                                                                           "off"))
    if db_uri and data_dir and not config.image_registry:
        from ..db.resolver import OmeroImageSource

        registry = OmeroImageSource(db_uri, data_dir, metadata=resolver)
    else:
        registry = ImageRegistry(config.image_registry)
    return PixelsService(registry, device=device, metadata_resolver=resolver,
                         memo_dir=server.get("omero.pixeldata.memoizer.dir"))


def wire(config: Config, pixels_service=None, session_store=None, session_validator=None,
         device: str = "cuda", dev: bool = False, packer: Optional[str] = None) -> TileServer:
    """The service of ``config`` (the JAX ``PixelBufferApp.__init__``):
    the planes decided (``check_planes``), the resilience, ``io:`` and
    tracing layers configured process-wide (and, with ``jmx-metrics``, the
    process collector registered), then session store -> pixels service
    -> pipeline -> batcher -> HTTP front, every key reaching the object it
    reaches in JAX. ``dev`` takes the echo session store; ``packer`` is
    the bit packer (default ``OMPB_BITPACK``, else ``pallas`` on CUDA).
    The pipeline takes the ``backend.png`` policy and the engine as the
    JAX app maps it: ``backend.engine: host`` or
    ``backend.batching.device-encode: false`` is the host engine; ``jax``,
    ``auto``, ``device`` and ``tpu`` are the CUDA device engine (no link
    probe: the card is required). On the device engine on CUDA the kernels are
    built (or found built) here, so a build failure stops start-up; the
    host engine builds no kernel and makes no CUDA call (``device`` is
    not read). The native host engine and the LUT registry are built (or
    found) here too."""
    from ..auth.ice import IceSessionValidator
    from ..auth.stores import make_session_store
    from ..io.fetch import configure as configure_fetch
    from ..models.tile_pipeline import TilePipeline
    from ..resilience import configure as configure_resilience
    from ..runtime.device import gpu_info
    from ..utils.process_metrics import install as install_process_metrics
    from ..utils.tracing import configure as configure_tracing

    absent = check_planes(config)
    configure_resilience(config.resilience)
    configure_fetch(config.io)
    # the JAX reporter selection: zipkin-url -> the batched sender; with
    # the recorder on, kept records become retro spans through it even
    # with live tracing off
    configure_tracing(
        enabled=config.http_tracing_enabled, log_spans=config.http_tracing_enabled,
        zipkin_url=(config.zipkin_url if (config.http_tracing_enabled or config.obs.enabled)
                    else None),
        tail=config.obs.enabled)
    if config.jmx_metrics_enabled:
        install_process_metrics()
    if session_store is None:
        session_store = (EchoSessionStore() if dev else
                         make_session_store(config.session_store.type, config.session_store.uri))
    if config.session_store.synchronicity == "sync":
        log.warning("session-store.synchronicity: sync no longer serializes lookups; "
                    "the key is accepted for compatibility only")
    be = config.backend
    engine = "host" if be.engine == "host" or not be.batching.device_encode else "device"
    if pixels_service is None:
        # the host engine's opt-in JPEG device IDCT runs its CPU version:
        # the process never touches the card
        pixels_service = _pixels_service(config, device if engine == "device" else "cpu")
    if session_validator is None:
        if config.omero_validate_sessions:
            session_validator = IceSessionValidator(
                config.omero_host, config.omero_port, secure=config.omero_secure,
                verify_tls=config.omero_verify_tls,
                cache_ttl_s=config.omero_session_validation_ttl_s)
        else:
            session_validator = AllowListValidator()
    pipeline = TilePipeline(
        pixels_service, buckets=tuple(be.batching.buckets), queue_depth=be.png.queue_depth,
        device=device, device_deflate_mode=be.png.device_deflate_mode, packer=packer,
        device_deflate=be.png.device_deflate, lut_dir=config.render.lut_dir,
        max_tile_bytes=be.max_tile_mb << 20, supertile_mesh=config.supertile.mesh,
        png_filter=be.png.filter, png_level=be.png.level, png_strategy=be.png.strategy,
        engine=engine,
    )
    host_engine()
    if config.render.enabled:
        pipeline.lut_registry  # noqa: B018 - read the LUT directory before serving
    gpu, kernels = None, {}
    if pipeline.device is not None and pipeline.device.type == "cuda":
        from ..ops.kernels import _build

        built = _build.build()
        kernels = {name: {"path": str(_build.target(name)), "built": name in built}
                   for name in _build.SOURCES}
        gpu = gpu_info(pipeline.device.index or 0)
    st, bc = config.supertile, be.batching.burst_continuation
    worker = BatchingTileWorker(
        pipeline, supertile=st.enabled, session_validator=session_validator,
        max_batch=be.batching.max_batch, coalesce_window_ms=be.batching.coalesce_window_ms,
        workers=config.effective_worker_pool_size, burst_continuation=bc.enabled,
        burst_window_ms=bc.window_ms, supertile_limits=(st.max_pixels, st.min_lanes, st.coverage),
    )
    server = TileServer(worker, dev=dev, gpu=gpu, config=config, session_store=session_store,
                        session_validator=session_validator, absent=tuple(absent))
    server.kernel_libraries = kernels  # name -> library path, compiled here or found
    return server


def create_app(config: Config, pixels_service=None, session_store=None,
               session_validator=None, device: str = "cuda") -> TileServer:
    """The service of a loaded config, as ``python -m
    omero_ms_pixel_buffer_tpu_torch --config`` runs it (the JAX
    ``create_app``)."""
    return wire(config, pixels_service, session_store, session_validator, device=device)


def create_server(
    registry_path: str, dev: bool = False, device: str = "cuda",
    buckets=(256, 512, 1024), queue_depth: int = 2,
    deflate_mode: str = "dynamic", packer: Optional[str] = None,
    device_deflate: bool = True, lut_dir: Optional[str] = None,
    supertile_enabled: bool = True, max_inflight: Optional[int] = None,
    queue_size: Optional[int] = None, request_budget_ms: Optional[float] = None,
    obs: bool = True, head_sample_rate: Optional[float] = None, prefetch: bool = False,
    session: Optional[dict] = None, ingest: Optional[dict] = None, mesh: Optional[dict] = None,
    png: Optional[dict] = None, cache: bool = True, slo: bool = True,
) -> TileServer:
    """The service over a JSON registry with in-memory sessions (the echo
    store with ``dev``), the other keys at the JAX defaults: ``wire`` of
    the config these arguments spell. ``deflate_mode`` is
    ``backend.png.device-deflate-mode``, ``device_deflate``
    ``backend.png.device-deflate``, ``lut_dir`` ``render.lut-dir``,
    ``supertile_enabled`` ``supertile.enabled``, ``max_inflight``,
    ``queue_size`` and ``request_budget_ms`` the JAX
    ``resilience.admission.max-inflight``, ``slo.queue-size`` and
    ``resilience.request-budget-ms`` (None: their defaults), ``obs``
    ``obs.enabled`` (on, the JAX default), ``head_sample_rate``
    ``obs.head-sample-rate`` and ``prefetch`` ``cache.prefetch.enabled``
    (off unless asked, as the JAX app of the HTTP contract tests runs);
    ``session``, ``ingest`` and ``mesh`` are the ``session:``, ``ingest:``
    and ``mesh:`` blocks (default: the JAX defaults); ``png`` adds
    ``backend.png`` keys (``filter``, ``level``, ``strategy``), ``cache``
    is ``cache.enabled`` and ``slo`` ``slo.enabled``."""
    raw = {
        "session-store": {"type": "memory"},
        "image-registry": registry_path,
        "backend": {"batching": {"buckets": list(buckets)},
                    "png": {"device-deflate": device_deflate,
                            "device-deflate-mode": deflate_mode,
                            "queue-depth": queue_depth, **(png or {})}},
        "render": {"lut-dir": lut_dir},
        "supertile": {"enabled": supertile_enabled},
        "resilience": {"admission": {} if max_inflight is None
                       else {"max-inflight": max_inflight}},
        "slo": {"enabled": slo, **({} if queue_size is None else {"queue-size": queue_size})},
        "obs": {"enabled": obs} if head_sample_rate is None
        else {"enabled": obs, "head-sample-rate": head_sample_rate},
        "cache": {"enabled": cache, "prefetch": {"enabled": prefetch}},
        "session": session or {},
        "ingest": ingest or {},
        "mesh": mesh or {},
    }
    if request_budget_ms is not None:
        raw["resilience"]["request-budget-ms"] = request_budget_ms
    return wire(Config.from_dict(raw), device=device, dev=dev, packer=packer)


class _BadRequest(Exception):
    pass


# the body ``_read_request`` gives a request whose ``Expect`` is not
# ``100-continue`` (aiohttp answers 417 before routing, no body read)
_EXPECTATION_FAILED = object()


class _Takeover:
    """A route's answer that owns the connection: ``run(reader, writer)``
    calls ``fn(reader, writer, *args)``; the connection closes after it."""

    def __init__(self, fn, *args):
        self.fn = fn
        self.args = args

    async def run(self, reader, writer) -> None:
        await self.fn(reader, writer, *self.args)


def _session_route(safe: str):
    """(handler names by method, decoded groups) of the session route that
    matches the ``path_safe`` path, or None."""
    return _match_route(_SESSION_ROUTES, safe)


def _match_route(routes, safe: str):
    """(handler names by method, decoded groups) of the first of ``routes``
    whose pattern matches the ``path_safe`` path, or None."""
    for pattern, methods in routes:
        groups = match_groups(pattern, safe)
        if groups is not None:
            return methods, groups
    return None


def aiohttp_path_qs(target: str) -> str:
    """The request target as aiohttp's ``request.path_qs`` spells it, the
    string the cluster's HMAC covers and the owner hop forwards: the raw
    target (percent-escapes, dot segments and fragments kept as sent),
    less the ``?`` of an empty query."""
    path, sep, query = target.partition("?")
    return path if sep and not query else target


class _SigVerdict:
    """One cluster-signature verdict per request, memoized: the trace
    adoption and the guard both ask, and the nonce cache takes a nonce on
    its first acceptance, so a second verification would read as a replay
    and 403 every signed hop."""

    __slots__ = ("server", "method", "target", "headers", "verdict")

    def __init__(self, server, method: str, target: str, headers: Dict[str, str]):
        self.server, self.method, self.target, self.headers = server, method, target, headers
        self.verdict: Optional[bool] = None

    def ok(self, body: bytes) -> bool:
        if self.verdict is None:
            self.verdict = self.server.verify_cluster_request(
                self.method, self.target, self.headers, body)
        return self.verdict


def _parse_epoch(value) -> Optional[int]:
    """A forwarded image epoch, or None when absent or malformed."""
    try:
        return int(value) if value is not None else None
    except (TypeError, ValueError):
        return None


def _valid_trace_id(value, length: int = 32) -> Optional[str]:
    """A forwarded trace or span id, or None when absent or malformed (the
    ids the recorder mints are fixed-width lowercase hex)."""
    if isinstance(value, str) and len(value) == length and all(
            c in "0123456789abcdef" for c in value):
        return value
    return None


def _cookie_session_id(cookie_header: Optional[str]) -> Optional[str]:
    """The ``sessionid`` cookie's value, or None."""
    if not cookie_header:
        return None
    try:
        morsel = SimpleCookie(cookie_header).get("sessionid")
    except CookieError:
        return None
    return morsel.value if morsel is not None else None


def _json_body(body: Optional[bytes]):
    """The request body as JSON, or None (no body, one past the limit, or
    not JSON)."""
    if body is None:
        return None
    try:
        return json.loads(body)
    except Exception:  # as the JAX handlers: any parse failure is a 400
        return None


def _json(status: int, obj) -> Tuple[int, dict, bytes]:
    """aiohttp's ``json_response``: ``json.dumps`` with its default
    separators."""
    return status, {"Content-Type": JSON_TYPE}, json.dumps(obj).encode()


async def _first_of(*coros) -> None:
    """Run the coroutines as tasks until the first ends, then cancel and
    await the rest; connection errors end a task quietly."""
    tasks = [asyncio.ensure_future(c) for c in coros]
    try:
        await asyncio.wait(tasks, return_when=asyncio.FIRST_COMPLETED)
    finally:
        for task in tasks:
            task.cancel()
        # waiting on the tasks raises none of their errors, so a
        # cancellation of this coroutine itself still propagates
        await asyncio.wait(tasks)
    for task in tasks:
        if not task.cancelled():
            error = task.exception()
            if error is not None and not isinstance(error, (ConnectionError, OSError)):
                raise error


def _apply_region_params(ctx: TileCtx, query):
    """The query's x/y/w/h/resolution onto ``ctx``, the one parse of every
    query-region route (/render, /histogram): (ctx, None), or (None, the
    400 message)."""
    try:
        ctx.region.x = int(query.get("x", 0))
        ctx.region.y = int(query.get("y", 0))
        ctx.region.width = int(query.get("w", 0))
        ctx.region.height = int(query.get("h", 0))
        res = query.get("resolution")
        ctx.resolution = None if res is None else int(res)
    except (TypeError, ValueError) as e:
        return None, str(e)
    return ctx, None


def _metrics_response(headers: Dict[str, str]) -> Tuple[int, dict, bytes]:
    """``GET /metrics``: OpenMetrics when ``Accept`` asks for it, else the
    classic Prometheus text (the JAX ``handle_metrics``)."""
    if "application/openmetrics-text" in headers.get("accept", ""):
        return 200, {"Content-Type": "application/openmetrics-text; charset=utf-8"}, \
            REGISTRY.exposition(openmetrics=True).encode()
    return 200, {"Content-Type": "text/plain; charset=utf-8"}, REGISTRY.exposition().encode()


def _degradable(ctx: TileCtx) -> bool:
    """Whether the hybrid-resolution fallback may serve ``ctx``: PNG tiles
    and renders only (raw and TIFF consumers measure pixels)."""
    return ctx.degraded == 0 and (ctx.format == "png" or ctx.render is not None)


def _failure(e: TileError) -> Tuple[int, dict, bytes]:
    """A failed request's answer: its code (below 1: 500), empty, and a
    503 with ``Retry-After``."""
    status = e.code if e.code >= 1 else 500
    headers = {}
    if status == 503:
        headers["Retry-After"] = _retry_after(getattr(e, "retry_after_s", None) or 1.0)
    return status, headers, b""


def _keep_alive(version: str, headers: Dict[str, str]) -> bool:
    """llhttp's rule: HTTP/1.1 keeps the connection unless asked to close;
    every other version closes it unless asked to keep it."""
    conn = headers.get("connection", "").lower()
    if version == "HTTP/1.1":
        return conn != "close"
    return conn == "keep-alive" and version != HTTP09


def _retry_after(seconds: float) -> str:
    """``Retry-After`` in whole seconds, rounded up so a client never
    retries early."""
    return str(max(1, int(seconds + 0.999)))


def _write_response(writer, status: int, headers: dict, body: bytes,
                    keep_alive: bool, head: bool = False, version: str = "HTTP/1.1") -> None:
    """One response in the request's version. A 304 has no body and no
    Content-Length; a HEAD answer keeps the GET's Content-Length, unless
    that body is empty, and sends no body. ``Connection`` is aiohttp's:
    ``close`` on an HTTP/1.1 connection that ends, ``keep-alive`` on an
    HTTP/1.0 one that stays, else none."""
    reason = http.HTTPStatus(status).phrase
    lines = [f"{version} {status} {reason}"]
    if body and "Content-Type" not in headers:
        headers = {**headers, "Content-Type": "text/plain; charset=utf-8"}
    for k, v in headers.items():
        lines.append(f"{k}: {v}")
    if status != 304 and not (head and not body):
        lines.append(f"Content-Length: {len(body)}")
    if version == "HTTP/1.1" and not keep_alive:
        lines.append("Connection: close")
    elif version == "HTTP/1.0" and keep_alive:
        lines.append("Connection: keep-alive")
    writer.write(("\r\n".join(lines) + "\r\n\r\n").encode("latin-1")
                 + (b"" if head else body))
