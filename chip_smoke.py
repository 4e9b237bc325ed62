#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it.

    python3 chip_smoke.py [--seed 42] [--size 8192] [--requests 256] \
        [--rle-requests 128] [--stored-requests 32] [--render-size 4096] \
        [--render-requests 128] [--histogram-requests 128] [--viewports 8] \
        [--wsi-size 8192] [--wsi-requests 256] [--zarr-size 8192] \
        [--zarr-requests 128] [--zarr-s3-requests 64] [--config-requests 256] \
        [--filter-sweep] [--slice-paths] \
        [--bitpack-sweep] [--bitpack-time | --dense-time | --paths-only [--port-root DIR]]

Phases, one JSON line each on stdout:

1. ``build``   — the three CUDA kernels built from
   ``omero_ms_pixel_buffer_tpu_torch/csrc`` with nvcc (one process per
   source, in parallel).
2. ``fixture`` — an ``--size``² uint16 OME-TIFF with 512x512 zlib tiles:
   a smooth field plus Gaussian noise, made from ``--seed`` (image 1); and
   a ``--render-size``² uint16 OME-TIFF of C = 3, Z = 4, T = 1 with
   512x512 zlib tiles, three distinct smooth fields plus noise (image 2,
   a small fluorescence stack). ``fixture_wsi``: a ``--wsi-size``² RGB8
   whole-slide pyramid from ``--seed`` (image 3: 256x256 JPEG tiles at
   quality 85 and 4:2:0, SubIFD levels down to <= 1024, no OME-XML, so
   ``/tile`` gives RGB lanes), and the layout fixtures: LZW (512²),
   PackBits, zstd (written with raw zstd blocks where the ``zstandard``
   package is missing), zlib with predictor 2, one strip per plane, a
   little-endian BigTIFF, a float32 C = 3 image (1024² each) and a ROMIO
   plane file of C = 2. ``fixture_zarr``: image 4, NGFF 0.4 (Zarr v2), a
   ``--zarr-size``² uint16 plane (smooth field plus noise, from
   ``--seed``) in 1024² chunks, blosc lz4 clevel 5 with byte shuffle,
   levels down to 1024 (bioformats2raw's defaults), one level-0 chunk
   object deleted afterwards; image 5, NGFF 0.5 (Zarr v3), (1, 3, 1, 4096,
   4096) uint16 in 2048² shards of 512² inner chunks, inner blosc lz4 with
   shuffle and crc32c indexes, 3 levels. Both are written by the port's
   ``write_ngff`` with their blosc frames compressed in a process pool
   (one frame checked against the codec); the write times are printed.
3. ``kernels`` — each kernel against its plain PyTorch version on the card
   at the main path's shapes (32 lanes of 512x512 uint16): the filter in
   all five modes plus uint8, RGB uint8 and RGB16 (bpp 6, 256x256
   lanes), and in every mode at the
   geometries of ``FILTER_EDGES`` and on a misaligned input; its
   ``cold_ms`` is its device time with the L2 flushed before each launch.
   The scalar-prefetch packer on the real ``dynamic`` pass-2 tokens of
   those lanes, the dense packer on their real ``rle`` tokens (also
   against the scalar-prefetch packer), and both at the edge geometries of
   ``ops/kernels/bitpack_edges.py`` (``SP_EDGES``, made from ``--seed``,
   as the tests make them) and on one lane of 103 M 21-bit tokens (past
   2^31 bits). Byte equality is required, and every lane's stream must
   inflate back. A kernel's ``ms`` is its device time from torch.profiler
   (CUDA events around the wrapper when the profiler records none): the
   filter's of its kernel, each packer's per call over every kernel and
   memset the call issues; wrapper (``call_ms``) and plain times are CUDA
   events. Then the render shape (``kernels_render``): 32 composites of
   512x512 from image 2 (the ``path_render`` spec), the filter on the
   (32, 512, 512, 3) uint8 RGB and the scalar-prefetch packer on the real
   ``rle`` tokens of those scanlines, each byte-equal to its plain version
   (every lane's stream inflates back), with the composite's device time
   beside its byte bound.
4. ``http_contract`` — the service on the card: a lone 512x512 request
   answered with the host bytes of the single-request path, two 1100x300
   lanes (larger than every bucket) coalesced into one batch and answered
   with the host engine's bytes (``host_engine``: the native engine or
   Python zlib, named on ``/healthz``), ``ETag``/``Cache-Control``/
   ``X-Cache`` on a miss and a hit, 304 on a matching ``If-None-Match``
   (strong, ``W/``, in a list) and 200 on ``*``, HEAD, OPTIONS and an
   unrouted GET's 405.
5. ``path``    — the service (``http.server.create_server``, what
   ``python -m omero_ms_pixel_buffer_tpu_torch`` runs) on 127.0.0.1 in
   this process, deflate mode ``dynamic``, packer ``pallas``; kernel
   launch counters reset to 0 just before; two warm-up rounds of 32
   tiles (the plane is admitted on its second touch), then ``--requests``
   512x512 PNG tiles at concurrency 32 over keep-alive connections, then
   odd sizes and edge cases. Every PNG is inflated with zlib, unfiltered
   with numpy and compared with the source pixels; the filter and the
   scalar-prefetch packer must have launched and the dense packer not,
   the plane cache must have hits and no encode group may have failed.
5a. ``path_obs`` — two fresh servers, the flight recorder on (keeping a
   tenth of healthy requests, ``head_sample_rate``) and off, over
   ``path``'s timed tiles, each position once: a cold round at 32 clients
   (on, then off: tiles/s, p50, p99 each) and a warm round of hits one at
   a time, three passes per arm interleaved (off, on, on, off, off, on),
   each arm's p50 the lowest of its passes. The warm-hit p50 penalty must
   meet the JAX ``obs_ok_overhead`` rule (at most 3 %, or 0.3 ms). Between
   ``/metrics`` and ``/healthz`` views just before and after the on arm's
   cold window: ``tiles_served_total`` rises by the 200s and
   ``device_stage_seconds_count{stage="hist"}`` by the encode groups; the
   OpenMetrics body ends with ``# EOF``; an exemplar's trace id resolves
   through ``/debug/requests/{traceId}`` to a kept record with a
   ``device`` stage whose stages sum to no more than its total. Reports
   ``device_idle_share``: the ``device_queue_idle_seconds`` sum over the
   window's seconds.
5b. ``path_prefetch`` — a fresh server with the prefetcher on
   (``create_server(prefetch=True)``): one session pans 512² tiles along a
   row, 12 steps of ``/tile`` PNG, then 12 of ``/render`` (image 1, one
   channel), waiting after each step until the prefetcher has drained.
   From the third step of each pan the tile asked for is a predicted one:
   it must answer ``X-Cache: hit`` with the source's pixels (numpy tile or
   composite). The filter and the SP packer must launch over the render
   pan's hit steps, where every device lane is a prefetched one (a
   prefetched ``/tile`` lane is a batch of one, encoded on the host, as in
   the JAX package); ``/healthz`` ``prefetch`` warmed > 0, failed 0.
   Reports issued, warmed, dropped, shed and the launches.
5c. ``path_session`` — a fresh server with the session plane (``ping-
   interval-s`` 1, two channels an image) and the prefetcher on; one
   WebSocket and one SSE client (stdlib sockets) subscribe to image 1.
   The WebSocket client reports a 1024x512 viewport at each of 10 steps of
   a pan of one-channel 512² ``/render`` tiles along a row and asks for
   the tile at its left, waiting after each step until the prefetcher has
   drained. From the third step the tile, and both tiles of the
   rectangle's next position (asked by sessions without a stream), answer
   ``X-Cache: hit`` with the numpy composite's pixels; the filter and
   SP-packer launches over those steps (all prefetched lanes) must be > 0
   and equal ``/healthz`` ``kernels``, and ``prefetch.viewport_true`` must
   rise. An annotation is then created, updated and deleted: after each
   write both channels receive ``invalidate`` then ``annotations`` with
   the sub-epoch, and ``/render?annotations=1`` equals the explicit
   ``roi=`` request (body and ETag) and the numpy masked composite. A third
   channel answers 503; removing the channels' session from the store
   closes both with ``revoked`` within two ping intervals. Reports hits,
   ``viewport_true``, launches, each write's frames and the frame latency
   from the write's answer (p50, max; negative when the frame arrives
   first).
6. ``path_rle`` — a second server in the same way, deflate mode ``rle``,
   packer ``pallas_dense``: warm-up, ``--rle-requests`` timed tiles,
   edge cases; the filter and the dense packer must have launched and
   the scalar-prefetch packer not. It reports the mean zlib stream bytes
   per 512x512 tile beside the ``dynamic`` phase's.
7. ``path_rle_sp`` — the same with packer ``pallas`` (the scalar-prefetch
   packer must have launched and the dense one not), so that against
   ``path`` only the mode differs.
8. ``path_stored`` — a fourth server, deflate mode ``stored``:
   ``--stored-requests`` tiles, pixel-checked; the filter must have
   launched and neither packer.
9. ``path_render`` — a server with the defaults; counters reset, two
   warm-up rounds of 32, then ``--render-requests`` 512x512 ``/render``
   requests of image 2 at concurrency 32 (three channels, windows and
   colours), then two rounds of 32 each of ``p=intmax|0:3`` (the second
   must stay on the device: ``projection_host_pulls`` unchanged),
   ``p=intmean``, ``m=g``, a ``roi=`` rect and ``maps=`` reverse and
   logarithmic, then the edge cases (a grammar 400, an unknown LUT's 400,
   an out-of-range channel's 404, a projection over the tile budget's
   413, JPEG: 200 with Pillow, 404 without). Every PNG is checked pixel by
   pixel against a numpy composite of the source (the port's
   ``build_tables``, numpy gathers); the filter and the scalar-prefetch
   packer must have launched and no encode group failed. Reports the
   composite's device ms per render group.
10. ``path_host_deflate`` — a server with ``device_deflate=False``: 32
   ``/tile`` PNG requests, pixel-checked; the filter must have launched
   and neither packer (the host deflates: ``host_engine``).
11. ``path_histogram`` — a server with the defaults: ``--histogram-requests``
   ``/histogram`` requests of image 2 (512x512 regions of channels 1-3,
   bins 256 and 65536 in turn, ``usePixelsTypeRange=1``) plus 8 full-plane
   ones (w = h = 0), all timed at concurrency 32. Every body's counts are
   checked against ``np.bincount`` of the source region; every channel
   plane must have been reduced by the torch histogram on the card
   (``/healthz`` ``analysis``), and its device ms per group is reported
   beside its byte bound.
12. ``path_supertile`` — a server with the defaults (super-tile fusion on),
   and ``path_supertile_off``, one with ``supertile_enabled=False``, each
   run twice on a fresh server in the order off, on, on, off (so neither
   always runs first):
   ``--viewports`` pans, each a 4x4 grid of adjacent 512x512
   three-channel ``/render`` PNG tiles (a 2048x2048 viewport, the
   default 4 Mpx budget) at a seeded random origin on the 512 grid, the
   last one at the image's edge (its last column and row 256 wide), each
   viewport with its own windows (no result-cache hit between them); the
   16 requests of a viewport go at once. Every tile is checked against
   the numpy composite; fused device lanes must be > 0 and the filter
   and the scalar-prefetch packer must have launched. Reports the
   super-tile groups, their encode groups, fused lanes (device, host),
   fallback lanes, mean lanes per group and the composite + carve's
   device ms per group beside its byte bound; the off runs must stamp
   nothing. ``supertile_pair`` then gives both settings' tiles/s side by
   side.
13. ``idct`` — ``idct_blocks_torch`` on the card against its CPU version
   and a float64 numpy IDCT (at most 1 count from each) on every block of
   ten JPEG tiles of image 3, equal with TF32 allowed and not; its
   device time at N = 1024 blocks beside the byte bound. The WSI kernel
   rows (``filter_wsi_rgb8``, ``bitpack_wsi``: 32 host-decoded RGB8 lanes
   of 256x256 and their ``dynamic`` pass-2 tokens) are checked and timed
   first.
14. ``path_wsi`` — a server with the defaults: 32 warm-up tiles, then
   ``--wsi-requests`` 256x256 PNG tiles of a DeepZoom-style raster sweep
   over levels 0 and 1 at concurrency 32. Every body is decoded (colour
   type 2) and must equal the port's host decode of the region; the
   filter and the SP packer must have launched, RGB device lanes be > 0
   and no encode group fail. Reports tiles/s, p50/p99, ``timed_window``
   and ``reads`` (the batched host reads' milliseconds and their share
   of ``handle_batch`` time).
15. ``path_wsi_device_idct`` — the same with ``OMPB_JPEG_DEVICE_IDCT=1``
   and a quarter of the tiles: device IDCT calls > 0 on ``/healthz``
   ``jpeg``, every pixel within 3 of the host decode (the count that
   differ is reported), the IDCT's span per call on its stream.
16. ``path_layouts`` — ``/tile`` PNG, raw and TIF of every layout fixture
   and of ROMIO, each against its source; ``/render`` and ``/histogram``
   of the float image against the port's quantization and tables in
   numpy; a float render without windows and a float PNG tile answer 404;
   the zstd image answers 404 without ``zstandard``.
17. ``path_zarr`` — image 4 from the filesystem on a server with the
   defaults (``dynamic``, packer ``pallas``): 32 warm-up tiles one at a
   time, each in its own chunk (a lone request that decodes it),
   ``--zarr-requests`` timed 512x512 PNG tiles at concurrency 32 at
   distinct seeded random positions of the level-0 512 grid (the plane is
   staged in this window), the four tiles of the deleted chunk (0, the fill value), then
   64 tiles of level 1; every PNG against
   the source, the filter and SP-packer launch counts must rise and no
   encode group fail. Reports tiles/s, p50/p99, ``timed_window``,
   ``reads`` (plane-cache staging reads included) and the ``/healthz``
   ``io`` view over the window (store requests per tile, coalescing,
   bytes, chunk decodes, the pool).
18. ``path_zarr_s3`` — image 5 served from an S3 stub in this process on
   127.0.0.1 (path-style, SigV4 checked with the port's signer, ranged
   GETs answered 206): 32 warm-up tiles of channels 0 and 1 one at a
   time, each in its own inner chunk, ``--zarr-s3-requests`` timed
   ``/tile`` PNG tiles of channels 0 and 1 at distinct positions at
   concurrency 32, 32 three-channel ``/render`` PNG
   tiles and 8 ``/histogram`` requests, each against the source (numpy
   composite, ``np.bincount``). Then the stub stops: 8 sequential level-1
   tiles answer 404 while the store's retries fail and 503 with
   ``Retry-After`` once its breaker opens (the fifth failure), as the JAX
   package answers; the stub restarts, the breaker's 30 s open period is
   waited out, and the same tiles are served and checked. The same
   figures as ``path_zarr``.

19. ``path_dzi`` — image 4 through the DZI adapter on a server with the
   defaults, 32 keep-alive clients: ``/dzi/4.dzi`` must equal
   ``descriptor_xml(8192, 8192, 256)``; a warm-up of two 2x2 blocks of each
   level (bottom rows) fuses into super-tiles whose second touch stages
   the level's plane; then a timed row-major sweep of 256x256 PNG tiles,
   four rows of DZI level 13 (pyramid level 0) and eight of level 12
   (level 1), 256 tiles; four tiles of level 9, coarser than the stored
   pyramid, must answer 404. Every tile is held against the numpy
   composite of its source region, and its native ``/render`` request,
   sent after, must answer the same bytes and ETag with ``X-Cache: hit``;
   eight IIIF and eight Iris tiles must equal their DZI twins. Reports
   tiles/s, p50/p99, ``burst_continuations`` (must be > 0), fused lanes
   (> 0), super-tile groups, stage means and launches.
20. ``path_overload`` — a second front over the same pipeline with the
   JAX names ``max_inflight`` 4, ``queue_size`` 8 and
   ``request_budget_ms`` 1000: 256 concurrent 512x512 level-0 ``/tile``
   PNG requests (every cell of the plane) at once, then the same set
   again. Every status must be 200, 503 or 504, at least one 503, each
   503 with ``Retry-After``; a 200 equals the source region, or with
   ``X-OMPB-Degraded`` the level-1 region with rows and columns
   replicated. The ``/healthz`` ``slo`` sheds must equal the 503s, its
   expiries plus the 504s counted by stage (``deadline``) the 504s, and
   its degraded grants the degraded 200s (up to grants that ran out of
   budget after). A session stepping 18 times at a constant stride is
   classified bulk; 32 requests one at a time then answer 200 undegraded.
   Last, 32 level-0 ``/tile`` lanes and 16 ``/render`` lanes with
   ``degraded=1`` go straight through ``handle_batch``: each equals the
   replicated level-1 region (or its numpy composite), with their own
   kernel launches. Reports every count, p50 and p99.
21. ``path_config`` — the port as an OMERO deployment starts it: the
   port's RESP2 stub (``cache/plane/resp_stub.py``) on its own thread and
   loop in this process holds 32 OMERO.web sessions (16 pickled, 16
   signed JSON, each with its own OMERO key) and one without a connector;
   a config file in YAML's JSON subset names them (``session-store:
   redis``), image 1's registry, ``device-deflate-mode: dynamic``,
   ``slo.queue-size: 128`` and the breaker's ``failure-threshold: 3``,
   ``open-duration-ms: 2000``. ``python -m omero_ms_pixel_buffer_tpu_torch
   debug-context --config FILE`` must exit 0 naming ``RedisSessionStore``,
   ``cuda`` and the built kernels; ``python -m
   omero_ms_pixel_buffer_tpu_torch --config FILE --port P`` runs as a
   subprocess, timed from spawn to ``listening on``; two warm-up rounds of
   32 (as ``path``), then ``--config-requests`` of ``path``'s timed 512²
   PNG tiles at 32 clients, each client with its own cookie: every PNG
   against the source, every body byte-equal to ``path``'s for the region
   or (a lone lane's host route, either side) to the host encode, and at
   least 8 equal. No cookie, an unknown cookie and the connector-less
   session answer 403; the stub closing connections answers 503 with
   ``Retry-After`` and opens the store's breaker; healed and 2.2 s later,
   200. The subprocess's ``/healthz``: filter and SP-packer launches > 0
   over the timed window and the dense packer's 0, ``slo.queue_size``
   128, the breaker's open and close in its transitions, no failed encode
   group. SIGTERM must exit 0. Then the same file with ``--dev`` (the echo
   store), the same warm-up and timed tiles (``echo_store``), so the pair
   differs in the session store alone. The config leaves the default-on
   planes on: ``/healthz`` ``config.absent`` must be empty and
   ``/metrics`` must carry the process collector's families. Reports
   tiles/s, p50/p99, the stub's commands, the 403s and 503s, the start-up
   seconds, the launches, the ``process_*`` families and the
   prefetcher's counts over the timed window.
22. ``path_disk`` — the port as a subprocess (``--config``, ``--dev``)
   with ``cache.disk-dir`` in a temporary directory and ``cache.memory-mb``
   16, so at most a quarter of the 256 level-0 512² PNG tiles of image 1
   fit in memory: a cold pass of the 256 tiles at 32 clients (filter and
   SP-packer launches > 0); once every evicted tile has spilled, a second
   pass whose memory and disk hits (``/metrics``
   ``tile_cache_requests_total`` by tier) sum to 256, every body equal to
   the first pass's; SIGTERM (exit 0), then a new process on the same
   directory, whose ``/healthz`` ``result_cache.disk.manifest`` must show
   every spilled entry replayed (and the replay's seconds), and a third
   pass over the spilled tiles (the compacted journal's keys): each
   ``X-Cache: hit`` from disk with the first pass's bytes and no kernel
   launch. Reports cold, warm and after-restart tiles/s, the hits by tier,
   the journal's bytes and the files on disk.
23. ``path_fleet`` — two replicas A and B of the port as subprocesses
   (``--config``, ``--dev``) on the one card, started together after the
   build: a static ring of both (``cluster.members``, ``cluster.self``),
   the RESP stub in this process as the shared L2 (``cluster.l2.uri``), a
   ``cluster.secret``, ``replication-factor`` 2, ``peer-timeout-ms`` 5000
   and the prefetcher off (speculative renders would blur the counts).
   ``path``'s 256 timed tiles (image 1, ``dynamic``, 32 clients): cold,
   alternating A and B, every PNG against the source, and the lanes the
   two batchers ran equal to the distinct keys (render-once); warm, each
   request to the other replica: no launch on either, step 1's ETag and
   body; invalidate: an annotation write on A (its purge of image 1 bumps
   the L2 epoch, DELs the image's L2 entries and fans a signed purge out
   to B), a signed ``POST /internal/purge/1`` to A (200), the same purge
   unsigned, forged and replayed (403 each), then every key once,
   alternating: the lanes equal the keys, launches > 0, step 1's bytes;
   drain: a signed ``POST /internal/drain?wait=1`` to B (``pushed`` > 0,
   ``drained``), then A serves every key with no launch. SIGTERM exits 0
   on both. Reports each step's tiles/s, p50/p99, ``X-Cache`` counts (peer
   fetches, L2 hits), launches and lanes per replica, the drain's stats
   and the phase's seconds.
24. ``path_gossip`` — dynamic membership: three replicas A, B and C of the
   port as subprocesses (``--config``, ``--dev``) on the one card with
   ``cluster.gossip`` (``interval-s`` 0.5, ``fanout`` 2, ``fail-after-s``
   5), a ``cluster.secret``, the RESP stub in this process as the L2 and
   the join hint, ``replication-factor`` 2 and the prefetcher off; A and
   B seeded with each other, C with A alone. Converge: every ``/healthz``
   ``cluster.membership`` lists all three (seconds reported). Cold:
   ``path``'s 256 timed tiles over A, B and C, every PNG against the
   source, the lanes of the three batchers equal to the distinct keys
   (render-once), filter and SP launches > 0. Join: D seeded with C
   alone; all four views agree and D's warm-up pulls entries
   (``/internal/transfer``); then every key on D: no other replica
   renders, D renders only keys it answers itself, every body step 2's.
   Crash: SIGKILL B; A, C and D drop it within ``fail-after-s`` + 2
   intervals (seconds reported), then every key once over them: the
   re-rendered keys at most B's, every body against the source and step
   2's bytes (or, for a lone lane, the host encoder's). Lease: the fleet
   restarted on the same stub with ``lease-ttl-s`` 3 in place of gossip;
   a signed ``POST /internal/drain?wait=1`` to one replica is seen as
   draining by the others within one heartbeat (the drain's 1.5-interval
   window) and it leaves their views within one more once its lease is
   deleted. SIGTERM exits 0 on every replica but B. Reports each step's
   tiles/s, p50/p99, ``X-Cache`` counts, lanes and launches per replica,
   the convergence and detection seconds and each replica's
   ``cluster_gossip_rounds_total`` and ``cluster_membership_events_total``.
25. ``path_ingest`` — the write plane: a server with ``ingest.enabled``
   over two copies of image 5 (image 6 on the filesystem, image 7 behind
   the S3 stub, whose store's multipart threshold is lowered to 4 MiB
   with 5 MiB parts). Three new 4096² planes (smooth fields plus noise)
   in one ``POST /image/6/planes`` (96 MiB); every 512² tile of every
   level read back through ``/tile`` PNG at 32 clients against the
   written pixels; 8 ``PUT``s of 512² tiles at distinct cells, each read
   back at every level; 3 commits over one tile while a reader thread
   reads it (every read the old tile or a new one); 4 ``PUT``s on image 7
   (multipart uploads), each read back. ``/healthz`` ``ingest`` must
   count every commit and no failure; filter and SP launches > 0.
   Reports commit ms per plane and per tile (p50, p99), MB/s written,
   read-after-write tiles/s and the launches.
26. ``path_mesh`` — the multi-device plane: images 1 and 2 through a mesh
   of two slots injected on the one card (``reduced``: one card stands
   for two) and through the same pipeline without one (``"auto"``, which
   must build no mesh on a one-card host), in ``dynamic`` and in ``rle``:
   256 timed ``/tile`` tiles, then (``dynamic``) 32 ``/render`` tiles, 16
   ``/histogram`` requests, two fused 4x4 pans and a 4096² full-plane
   lane batched with 15 tiles (rows over the mesh: the distributed
   route), every body equal between the two servers (a lone request's
   host route allowed on either side, pixel-checked). Then slot 1 fails
   (``device.chip:1``, one failed dispatch): the retry runs at width 1
   with the same bytes, breaker ``device:1`` opens, the width listener
   warms the known shapes at 1; with the fault cleared the prober
   (``mesh.probe-interval-ms`` 200) readmits the slot and the shapes are
   warmed at 2. Reports tiles/s with and without the mesh, launches per
   slot and the sharded programs alone (device ms over two slots and
   one, beside their byte bounds).

27. ``path_png_policy`` (after ``path_host_deflate``) — image 1 through
   one server per PNG policy (``backend.png``), the device engine,
   ``dynamic``: ``up`` (the reference arm), ``none``, ``sub``, ``average``,
   ``paeth`` and ``adaptive`` at level 9, strategy ``default``; a warm-up
   round of 32 and the same 64 timed 512² tiles at 32 clients each. Every
   body's inflated scanlines equal the source filtered in numpy in the
   server's mode (so every row's filter-type byte is the mode's, or the
   row's ``adaptive`` choice); the device modes launch the filter kernel
   and the SP packer, ``adaptive`` launches nothing and its lanes take the
   host route (``host_png_lanes``); every tile's ETag differs from the
   ``up`` server's. The ``paeth`` server also renders 32 ``/render`` lanes
   of image 2, held against the numpy composite filtered with paeth.
   Reports each arm's tiles/s, p50/p99, launches, stream bytes and lanes.
28. ``path_host_engine`` (after ``path_config``) — the port as a
   ``--config`` subprocess with ``backend.engine: host``, then with
   ``backend.batching.device-encode: false`` (``--device cuda`` both
   times): 256 image-1 ``/tile`` PNG tiles and 64 image-2 ``/render``
   tiles at 32 clients, 8 region and 8 full-plane ``/histogram``
   requests and a 4x4 super-tile viewport, every body against the source.
   The subprocess's ``/healthz``: no plane cache, encode queue or GPU, no
   CUDA context (``cuda_initialized``), no launch; its pid absent from
   ``nvidia-smi --query-compute-apps=pid``; this process's counters
   unchanged. Reports tiles/s and p50/p99 per route.
29. ``path_planes_off`` — a server with ``cache.enabled: false``,
   ``slo.enabled: false`` and ``max_inflight`` 4: one tile 32 times in
   turn (32 executions, no ``ETag``/``X-Cache``), then 64 distinct tiles
   at once: 200s (pixel-checked) and 503s with ``Retry-After``, the 503s
   equal to the gate's sheds; ``/healthz`` and ``/metrics`` answer 200
   during the burst.
30. ``microbench`` (after ``path_mesh``) — ``runtime/microbench.py``
   ``run_microbench()`` at its defaults (32 lanes of 512², a 4096² plane)
   on the card: its dict on one line with the launches it made.

Each path phase also reports ``timed_window``: the encode queue's groups,
stage means and thread busy shares over its timed requests alone (two
``/healthz`` views, just before and just after them), and how many of
those requests bypassed the device: result-cache hits, lone lanes (a
batch of one, encoded on the host), host-encoded oversize lanes and
(``path_render``) render lanes on the host mirror; and the super-tile
counts (``supertile``: lanes stamped, groups, fused device and host
lanes, fallback lanes, crops pulled to the host).

Then the kernels' JSON line (nine rows; the filter's and SP packer's
launches from ``path``, ``path_obs``, ``path_prefetch``, ``path_session``,
``path_planes_off``, ``path_disk``'s cold pass, ``path_fleet``,
``path_gossip``, ``path_ingest``, ``path_mesh``, ``microbench`` and the
``up``, ``none`` and ``sub`` arms of ``path_png_policy``, the SP
packer's also from its ``average`` and ``paeth`` arms; the filter's
``filter_u16_average`` and ``filter_u16_paeth`` rows, timed at the main
shape, from those two arms; the WSI rows' from ``path_wsi``), the
``nvidia-smi --query-gpu=name,power.limit`` line, and last ``{"ok":
true, "device": {...}}``. ``--slice-paths`` runs only the build, the
fixtures of images 1 and 2, ``path_png_policy``, ``path_host_engine``,
``path_planes_off`` and ``microbench`` (no result line). ``--filter-sweep`` stops
after the fixture and prints instead the filter kernel's device times over
rows per warp and by mode (``filter_sweep``), and the nvidia-smi line;
``--bitpack-time`` likewise prints the scalar-prefetch packer's device time
per call, call time and kernels by name on the real pass-2 tokens
(``bitpack_time``), ``--dense-time`` the dense packer's on the real ``rle``
tokens (``dense_time``), with ``--port-root`` taking the port package from
another checkout (an earlier version timed by the same code), and
``--bitpack-sweep`` its default and stamped builds (``bitpack_sweep``), and
``--paths-only`` only the ``path`` (``dynamic``), ``path_obs``,
``path_prefetch``, ``path_session``, ``path_render``, ``path_config``,
``path_disk``, ``path_fleet`` and ``path_gossip`` phases
(with ``--port-root``, to pair two versions in one call); the
Zarr and viewer phases add no kernel row, their launches are on their phase
lines. Any failure exits
non-zero before the last line; without CUDA, or without the port package
beside this file, it exits non-zero at once.
"""

from __future__ import annotations

import argparse
import asyncio
import concurrent.futures
import contextlib
import http.client
import io
import json
import os
import signal
import struct
import sys
import threading
import time
import traceback
import zlib

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, "build", "chip_smoke")
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (data sheet)
# H100 SXM int32 peak outside the tensor cores: 132 SMs x 64 INT32 lanes
# x 1.98 GHz boost (Hopper architecture white paper); used only to state
# what the dense formulation's op count would take at that peak
INT32_OPS_PER_S = 132 * 64 * 1.98e9
TILE = 512
LANES = 32
# filter geometries at the CUDA kernel's edges (shape, dtype)
FILTER_EDGES = {
    "pixel_1x1": ((1, 1, 1), np.uint16),
    "h17_u16": ((3, 17, 512), np.uint16),     # row groups straddle lanes, end short
    "rows_u8": ((7, 11, 600), np.uint8),
    "rgb16_w21": ((2, 5, 21, 3), np.uint16),  # bpp 6, rows of 126 bytes
    "u16_1024": ((4, 8, 1024), np.uint16),
    "rgba16": ((2, 6, 9, 4), np.uint16),      # bpp 8
    "rgb16_w16": ((2, 7, 16, 3), np.uint16),  # bpp 6, rows of 96 bytes
    "rgba8_w36": ((3, 5, 36, 4), np.uint8),   # bpp 4, rows of 144 bytes
    "rgba16_w400": ((1, 4, 400, 4), np.uint16),  # 3,200-byte rows
    "row_80kb": ((1, 3, 40000), np.uint16),   # 157 column steps, the last ragged
}
COOKIE = {"Cookie": "sessionid=chip-smoke"}


_T0 = time.perf_counter()


def emit(obj) -> None:
    """One JSON line; a phase line also carries ``at_s``, the seconds
    since the script started (the run's time budget, phase by phase)."""
    if "phase" in obj:
        obj = {**obj, "at_s": round(time.perf_counter() - _T0, 1)}
    print(json.dumps(obj), flush=True)


class SmokeFailure(RuntimeError):
    pass


def require(cond, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


# ---------------------------------------------------------------------------
# fixture
# ---------------------------------------------------------------------------


def make_field(size: int, seed: int) -> np.ndarray:
    """Smooth field + noise (compresses like microscopy, unlike white
    noise): (size, size) uint16."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
    base = 2000 + 1500 * np.sin(xx / 97.0) + 1500 * np.cos(yy / 131.0)
    return (base + rng.normal(0, 120, (size, size))).clip(0, 65535).astype(np.uint16)


def make_stack(size: int, seed: int) -> np.ndarray:
    """Three channels of four z planes, each channel its own smooth field
    drifting over z, plus noise: (3, 4, size, size) uint16."""
    rng = np.random.default_rng(seed + 7)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
    out = np.empty((3, 4, size, size), np.uint16)
    for c, (level, amp, px, py) in enumerate(((9000, 7000, 61.0, 83.0),
                                              (20000, 15000, 149.0, 37.0),
                                              (30000, 25000, 211.0, 173.0))):
        for z in range(4):
            field = level + amp * np.sin(xx / px + 0.7 * z) * np.cos(yy / py - 0.4 * z)
            out[c, z] = (field + rng.normal(0, 400, (size, size))).clip(0, 65535)
    return out


def write_fixture(data: np.ndarray, stack: np.ndarray) -> str:
    """Image 1 (the plane) and image 2 (the stack) and their registry."""
    from omero_ms_pixel_buffer_tpu_torch.io.ometiff import write_ome_tiff

    os.makedirs(WORK, exist_ok=True)
    path = os.path.join(WORK, "smoke.ome.tiff")
    write_ome_tiff(path, data[None, None, None], tile_size=(TILE, TILE),
                   compression="zlib")
    stack_path = os.path.join(WORK, "render.ome.tiff")
    write_ome_tiff(stack_path, stack[None], tile_size=(TILE, TILE), compression="zlib")
    registry = os.path.join(WORK, "registry.json")
    with open(registry, "w") as f:
        json.dump({"images": [{"id": 1, "path": path, "name": "smoke"},
                              {"id": 2, "path": stack_path, "name": "render"}]}, f)
    return registry


# ---------------------------------------------------------------------------
# kernels against their plain versions
# ---------------------------------------------------------------------------


def time_ms(torch, fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean time of one call on the card (CUDA events around a run)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def kernel_ms(torch, fn, name: str, iters: int = 10, before=None):
    """Mean device time of the kernels whose name contains ``name``
    over ``iters`` calls, from torch.profiler's CUDA trace; None when the
    profiler records no device time for them. ``before`` runs ahead of
    each call (its kernels must not match ``name``)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            if before is not None:
                before()
            fn()
        torch.cuda.synchronize()
    total = count = 0
    for ev in prof.key_averages():
        if name in ev.key:
            total += getattr(ev, "device_time_total", 0) or getattr(ev, "cuda_time_total", 0)
            count += ev.count
    return total / count / 1e3 if count and total else None


def call_device_ms(torch, fn, iters: int = 10):
    """Device time of one call of ``fn``: every kernel and memset it issues,
    summed from torch.profiler's CUDA trace over ``iters`` calls and
    divided by ``iters``; None when the profiler records no device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total = sum(getattr(ev, "device_time_total", 0) or getattr(ev, "cuda_time_total", 0)
                for ev in prof.key_averages())
    return total / iters / 1e3 if total else None


def device_breakdown(torch, fn, top: int = 10, iters: int = 1) -> dict:
    """Device milliseconds of one call of ``fn`` in total and for its
    ``top`` most expensive kernels (torch.profiler's CUDA trace over
    ``iters`` calls, divided by ``iters``; ``n`` counts over all of them)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    rows = []
    for ev in prof.key_averages():
        t = getattr(ev, "device_time_total", 0) or getattr(ev, "cuda_time_total", 0)
        if t:
            rows.append((t / 1e3 / iters, ev.count, ev.key[:60]))
    rows.sort(reverse=True)
    return {"total": sum(r[0] for r in rows),
            "top": [{"ms": ms, "n": n, "kernel": k} for ms, n, k in rows[:top]]}


def lane_tiles(data: np.ndarray, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed + 1)
    size = data.shape[0]
    ys = rng.integers(0, (size - TILE) // 64 + 1, LANES) * 64
    xs = rng.integers(0, (size - TILE) // 64 + 1, LANES) * 64
    return np.stack([data[y:y + TILE, x:x + TILE] for y, x in zip(ys, xs)])


def check_edges(torch, device, seed: int) -> dict:
    """Both tile packers (scalar-prefetch and dense) against their plain
    versions on every edge case, and on one lane whose total passes 2^31
    bits (64-bit offsets and look-back values): {packer: {case:
    max_abs_err}}; raises on any difference."""
    from omero_ms_pixel_buffer_tpu_torch.ops.kernels.bitpack import (
        pack_tokens_sp,
        pack_tokens_sp_plain,
    )
    from omero_ms_pixel_buffer_tpu_torch.ops.kernels.bitpack_dense import (
        pack_tokens_dense,
        pack_tokens_dense_plain,
    )
    from omero_ms_pixel_buffer_tpu_torch.ops.kernels.bitpack_edges import SP_EDGES, sp_edge_case

    packers = {"bitpack": (pack_tokens_sp, pack_tokens_sp_plain),
               "bitpack_dense": (pack_tokens_dense, pack_tokens_dense_plain)}
    errs = {k: {} for k in packers}

    def hold(name, bt, nt, maxbits):
        for k, (pack, plain) in packers.items():
            got, want = pack(bt, nt, maxbits), plain(bt, nt, maxbits)
            torch.cuda.synchronize()
            errs[k][name] = int((got[0].to(torch.int64) - want[0].to(torch.int64)).abs().max().item())
            require(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
                    f"{k} kernel != plain for {name}")
            del got, want

    for name in SP_EDGES:
        b, n, maxbits = sp_edge_case(name, seed)
        hold(name, torch.from_numpy(b).to(device), torch.from_numpy(n).to(device), maxbits)
    # one lane of 103 M 21-bit tokens: 2,163,000,000 bits, past 2^31
    ntok = 103_000_000
    gen = torch.Generator(device=device).manual_seed(seed)
    bt = torch.randint(0, 1 << 21, (1, ntok), generator=gen, device=device, dtype=torch.int32)
    nt = torch.full((1, ntok), 21, dtype=torch.int32, device=device)
    require(int(nt.sum(dtype=torch.int64)) > 1 << 31, "big lane total not past 2^31")
    hold("lane_past_2e31_bits", bt, nt, -(-ntok * 21 // 1024) * 1024 + 1024)
    del bt, nt
    torch.cuda.empty_cache()
    return errs


def pass2_tokens(torch, device, tiles: np.ndarray):
    """The real ``dynamic`` pass-2 tokens of 32 lanes: (bits, nbits,
    maxbits) on the card, and what framing and inflating them needs."""
    from omero_ms_pixel_buffer_tpu_torch.ops import device_deflate as dd
    from omero_ms_pixel_buffer_tpu_torch.ops.convert import bits_tensor

    u16 = bits_tensor(tiles).to(device)
    row_bytes = 1 + TILE * 2
    flat, counts, extras, real = dd.fused_filter_histogram_batch(u16, TILE, row_bytes, 2)
    tables = dd.build_dynamic_tables(counts.cpu().numpy(), extras.cpu().numpy(), real=real)
    bits, nbits = dd.emit_tokens(flat, dd.tables_from_numpy(tables, device))
    return bits, nbits, dd._packing_maxbits(flat.shape[1]), (flat, real, tables)


def rle_tokens(torch, device, tiles: np.ndarray):
    """The real ``rle`` (fixed-Huffman) tokens of 32 lanes: (bits, nbits,
    maxbits) on the card."""
    from omero_ms_pixel_buffer_tpu_torch.ops import device_deflate as dd
    from omero_ms_pixel_buffer_tpu_torch.ops.convert import bits_tensor

    u16 = bits_tensor(tiles).to(device)
    flat = dd.fused_filter_histogram_batch(u16, TILE, 1 + TILE * 2, 2)[0]
    bits, nbits = dd._lane_tokens(flat)
    return bits, nbits, dd._packing_maxbits(flat.shape[1])


def packer_time(torch, device, tiles: np.ndarray, dense: bool) -> dict:
    """One packer alone: the scalar-prefetch packer on the real ``dynamic``
    pass-2 tokens, or the dense packer on the real ``rle`` tokens. Device
    time per call over everything a call issues, the wrapper's call time,
    the device kernels by name, byte equality with the plain version."""
    if dense:
        from omero_ms_pixel_buffer_tpu_torch.ops.kernels.bitpack_dense import (
            pack_tokens_dense as pack,
            pack_tokens_dense_plain as plain,
        )

        bits, nbits, maxbits = rle_tokens(torch, device, tiles)
    else:
        from omero_ms_pixel_buffer_tpu_torch.ops.kernels.bitpack import (
            pack_tokens_sp as pack,
            pack_tokens_sp_plain as plain,
        )

        bits, nbits, maxbits, _ = pass2_tokens(torch, device, tiles)
    got, want = pack(bits, nbits, maxbits), plain(bits, nbits, maxbits)
    torch.cuda.synchronize()
    require(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
            f"{'dense' if dense else 'bitpack'} kernel != plain on its tokens")
    call = lambda: pack(bits, nbits, maxbits)  # noqa: E731
    return {"phase": "dense_time" if dense else "bitpack_time",
            "package": os.path.dirname(os.path.dirname(
                sys.modules["omero_ms_pixel_buffer_tpu_torch"].__file__)),
            "shape": list(bits.shape), "maxbits": maxbits,
            "device_ms_per_call": [call_device_ms(torch, call, iters=20) for _ in range(3)],
            "call_ms": [time_ms(torch, call) for _ in range(3)],
            "by_kernel": device_breakdown(torch, call)}


def bitpack_sweep(torch, device, tiles: np.ndarray, seed: int) -> None:
    """Emit the scalar-prefetch kernel's two builds, the default (through
    the wrapper) and the one with ``%globaltimer`` stamps (the C entry
    ``ompb_sp_pack_stamped``, see ``csrc/bitpack.cu``), with their device
    time per call (kernel and memset), the CTAs' phase times from one
    stamped call, and every case, three runs each, where one differs from
    the plain version (the real pass-2 tokens and every edge case); then
    fail if any did."""
    import ctypes

    from omero_ms_pixel_buffer_tpu_torch.ops.kernels import _build
    from omero_ms_pixel_buffer_tpu_torch.ops.kernels.bitpack import (
        pack_tokens_sp,
        pack_tokens_sp_plain,
        sp_tiles,
        sp_workspace_bytes,
    )
    from omero_ms_pixel_buffer_tpu_torch.ops.kernels.bitpack_edges import SP_EDGES, sp_edge_case

    fn = _build.entry("bitpack", "ompb_sp_pack_stamped",
                      [ctypes.c_void_p] * 5 + [ctypes.c_longlong, ctypes.c_int,
                                               ctypes.c_longlong, ctypes.c_longlong,
                                               ctypes.c_void_p, ctypes.c_void_p])

    def stamped(bits, nbits, maxbits, stamps):
        B, ntok = bits.shape
        ws_bytes = sp_workspace_bytes(B, ntok)
        out = torch.empty((B, maxbits // 32), dtype=torch.int32, device=device)
        totals = torch.empty((B,), dtype=torch.int64, device=device)
        ws = torch.empty((ws_bytes,), dtype=torch.uint8, device=device)
        _build.check(fn(bits.data_ptr(), nbits.data_ptr(), out.data_ptr(), totals.data_ptr(),
                        ws.data_ptr(), ws_bytes, B, ntok, maxbits // 32,
                        _build.stream_handle(device), stamps.data_ptr()),
                     "bitpack stamped build")
        return out.view(torch.uint8), totals

    def phases():
        """Per-CTA phase times (us) of one stamped call: median and p90."""
        n = bits.shape[0] * sp_tiles(bits.shape[1])
        stamps = torch.zeros((n, 8), dtype=torch.int64, device=device)
        stamped(bits, nbits, maxbits, stamps)
        st = stamps.cpu().numpy()
        t = st[:, :7].astype(np.float64) / 1e3
        names = ["ticket", "tokens_scanned", "prefix_known", "strip_built",
                 "handover_thread0", "stores_to_end"]
        deltas = {k: t[:, i + 1] - t[:, i] for i, k in enumerate(names[:4])}
        deltas["handover_thread0"] = t[:, 5] - t[:, 4]
        deltas["stores_to_end"] = t[:, 6] - t[:, 4]
        life = t[:, 6] - t[:, 0]
        span = t[:, 6].max() - t[:, 0].min()
        return {"ctas": int(n), "span_us": float(span),
                "mean_resident_ctas": float(life.sum() / span),
                "sms": int(len(np.unique(st[:, 7]))),
                "last_entry_to_end_us": float(t[:, 6].max() - t[:, 0].max()),
                "lifetime_us": [float(np.median(life)), float(np.percentile(life, 90))],
                "phase_us_median_p90": {k: [float(np.median(v)), float(np.percentile(v, 90))]
                                        for k, v in deltas.items()}}

    bits, nbits, maxbits, _ = pass2_tokens(torch, device, tiles)
    want = pack_tokens_sp_plain(bits, nbits, maxbits)
    edges = {}
    for k in SP_EDGES:
        b, n, m = sp_edge_case(k, seed)
        edges[k] = (torch.from_numpy(b).to(device), torch.from_numpy(n).to(device), m)
    edge_want = {k: pack_tokens_sp_plain(*v) for k, v in edges.items()}
    cases = {"pass2": (bits, nbits, maxbits), **edges}
    wants = {"pass2": want, **edge_want}

    def diff(got, want) -> dict:
        bad = (got[0] != want[0]).nonzero()
        return {"lane_byte": bad[0].tolist() if len(bad) else None, "bytes": len(bad),
                "totals_equal": bool(torch.equal(got[1], want[1]))}

    table, failures = [], {}
    most = max(v[0].shape[0] * sp_tiles(v[0].shape[1]) for v in cases.values())
    stamps = torch.zeros((most, 8), dtype=torch.int64, device=device)
    builds = {"default": pack_tokens_sp,
              "stamped": lambda b, n, m: stamped(b, n, m, stamps)}
    for build, pack in builds.items():
        for k, v in cases.items():
            for rep in range(3):
                got = pack(*v)
                torch.cuda.synchronize()
                if not (torch.equal(got[0], wants[k][0]) and torch.equal(got[1], wants[k][1])):
                    failures.setdefault(f"{build}/{k}", []).append(diff(got, wants[k]))
        call = lambda: pack(bits, nbits, maxbits)  # noqa: E731
        table.append({"build": build,
                      "device_ms_per_call": [call_device_ms(torch, call, iters=20)
                                             for _ in range(3)]})
    table[1]["phases"] = phases()
    emit({"phase": "bitpack_sweep", "shape": list(bits.shape), "maxbits": maxbits,
          "table": table, "failures": failures})
    require(not failures, f"bitpack builds differ from plain: {sorted(failures)}")


def check_kernels(torch, device, tiles: np.ndarray, seed: int) -> list:
    from omero_ms_pixel_buffer_tpu_torch.ops import device_deflate as dd
    from omero_ms_pixel_buffer_tpu_torch.ops.convert import bits_tensor
    from omero_ms_pixel_buffer_tpu_torch.ops.kernels.bitpack import (
        pack_tokens_sp,
        pack_tokens_sp_plain,
    )
    from omero_ms_pixel_buffer_tpu_torch.ops.kernels.bitpack_dense import (
        OPS_PER_TOKEN,
        pack_tokens_dense,
        pack_tokens_dense_plain,
    )
    from omero_ms_pixel_buffer_tpu_torch.ops.kernels.filter import (
        filter_tiles,
        filter_tiles_plain,
    )

    def max_err(a, b) -> int:
        return int((a.to(torch.int64) - b.to(torch.int64)).abs().max().item())

    u16 = bits_tensor(tiles).to(device)
    rng = np.random.default_rng(7)
    cases = {f"u16_{m}": (u16, m) for m in ("none", "sub", "up", "average", "paeth")}
    cases["u8_up"] = (bits_tensor((tiles >> 4).astype(np.uint8)).to(device), "up")
    rgb = rng.integers(0, 256, (LANES, TILE, TILE, 3), dtype=np.uint8)
    cases["rgb8_paeth"] = (bits_tensor(rgb).to(device), "paeth")
    # RGB16 lanes (bpp 6) at the whole-slide tile shape
    rgb16 = rng.integers(0, 65536, (LANES, 256, 256, 3), dtype=np.uint16)
    for m in ("up", "paeth"):
        cases[f"rgb16_256_{m}"] = (bits_tensor(rgb16).to(device), m)
    # the kernel's edges: groups of scanlines that straddle lanes or end
    # short, rows that are not a multiple of 16 bytes and a misaligned
    # input (its byte-load branch), wide rows with a ragged last step
    for name, (shape, dtype) in FILTER_EDGES.items():
        info = np.iinfo(dtype)
        x = bits_tensor(rng.integers(info.min, info.max, shape, dtype=dtype,
                                     endpoint=True)).to(device)
        for m in ("none", "sub", "up", "average", "paeth"):
            cases[f"{name}_{m}"] = (x, m)
    flat = torch.from_numpy(rng.integers(0, 256, 1 + 5 * 19 * 37 * 3, dtype=np.uint8))
    misaligned = flat.to(device)[1:].view(5, 19, 37, 3)
    require(misaligned.data_ptr() % 16 == 1, "misaligned case is aligned")
    for m in ("none", "sub", "up", "average", "paeth"):
        cases[f"misaligned_rgb8_{m}"] = (misaligned, m)
    filter_errs = {}
    for name, (x, mode) in cases.items():
        got, want = filter_tiles(x, mode), filter_tiles_plain(x, mode)
        torch.cuda.synchronize()
        filter_errs[name] = max_err(got, want)
        require(torch.equal(got, want), f"filter kernel != plain for {name}")
    f_call = time_ms(torch, lambda: filter_tiles(u16, "up"))
    f_ms = kernel_ms(torch, lambda: filter_tiles(u16, "up"), "filter_row_groups")
    # cold: a 256 MB buffer zeroed before each launch flushes the 50 MB L2
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=device)
    f_cold = kernel_ms(torch, lambda: filter_tiles(u16, "up"), "filter_row_groups",
                       before=flush.zero_)
    del flush
    f_plain = time_ms(torch, lambda: filter_tiles_plain(u16, "up"))
    f_bytes = u16.numel() * 2 + LANES * TILE * (1 + TILE * 2)
    # the modes path_png_policy serves beside up, at the main shape
    mode_rows = []
    for m in ("average", "paeth"):
        m_ms = kernel_ms(torch, lambda m=m: filter_tiles(u16, m), "filter_row_groups")
        m_call = time_ms(torch, lambda m=m: filter_tiles(u16, m))
        mode_rows.append(
            {"name": f"filter_u16_{m}", "route": "cuda",
             "source": "omero_ms_pixel_buffer_tpu_torch/csrc/filter.cu",
             "replaces": "omero_ms_pixel_buffer_tpu/ops/pallas/filter.py:137",
             "max_abs_err": filter_errs[f"u16_{m}"], "ms": m_ms if m_ms else m_call,
             "ms_from": "profiler" if m_ms else "events", "call_ms": m_call,
             "plain_ms": time_ms(torch, lambda m=m: filter_tiles_plain(u16, m)),
             "bound_ms": f_bytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
             "library_ms": None})

    # the packer on the real pass-2 tokens of these lanes
    row_bytes = 1 + TILE * 2
    bits, nbits, maxbits, (flat, real, tables) = pass2_tokens(torch, device, tiles)
    got_p, got_t = pack_tokens_sp(bits, nbits, maxbits)
    want_p, want_t = pack_tokens_sp_plain(bits, nbits, maxbits)
    torch.cuda.synchronize()
    require(torch.equal(got_p, want_p) and torch.equal(got_t, want_t),
            "bitpack kernel != plain on pass-2 tokens")
    flat_np = flat.cpu().numpy()

    def inflate_all(packed, body_bits, eob_bits, what):
        streams, lengths = dd._frame_lanes(flat, packed, body_bits, eob_bits=eob_bits)
        streams_np, lengths_np = streams.cpu().numpy(), lengths.cpu().numpy()
        for i in range(real):
            require(zlib.decompress(streams_np[i, : lengths_np[i]].tobytes())
                    == flat_np[i].tobytes(), f"lane {i} {what} stream does not inflate back")
        return lengths_np[:real]

    lengths_np = inflate_all(got_p, got_t, 0, "dynamic")

    # the dense packer on the real rle (fixed-Huffman) tokens of these lanes
    rbits, rnbits = dd._lane_tokens(flat)
    got_d, got_dt = pack_tokens_dense(rbits, rnbits, maxbits)
    want_d, want_dt = pack_tokens_dense_plain(rbits, rnbits, maxbits)
    sp_d, sp_dt = pack_tokens_sp(rbits, rnbits, maxbits)
    torch.cuda.synchronize()
    require(torch.equal(got_d, want_d) and torch.equal(got_dt, want_dt),
            "dense bitpack kernel != plain on rle tokens")
    require(torch.equal(got_d, sp_d) and torch.equal(got_dt, sp_dt),
            "dense bitpack kernel != scalar-prefetch kernel on rle tokens")
    require(torch.equal(pack_tokens_dense(rbits, rnbits, 1 << 20)[0],
                        pack_tokens_dense_plain(rbits, rnbits, 1 << 20)[0]),
            "dense bitpack kernel != plain when truncated at 2^20 bits")
    rle_lengths_np = inflate_all(got_d, got_dt, 7, "rle")
    # device time of one whole 32-lane group (both passes), by kernel
    def group():
        f, c, e, r = dd.fused_filter_histogram_batch(u16, TILE, row_bytes, 2)
        dd.dynamic_emit(f, dd.tables_from_numpy(tables, device))

    group_top = device_breakdown(torch, group)
    edge_errs = check_edges(torch, device, seed)
    sp_errs, dense_errs = edge_errs["bitpack"], edge_errs["bitpack_dense"]
    b_call = time_ms(torch, lambda: pack_tokens_sp(bits, nbits, maxbits))
    # device time per call: the kernel and the memset of its tile records
    b_ms = call_device_ms(torch, lambda: pack_tokens_sp(bits, nbits, maxbits))
    b_kernel = kernel_ms(torch, lambda: pack_tokens_sp(bits, nbits, maxbits), "sp_pack_tiles")
    b_plain = time_ms(torch, lambda: pack_tokens_sp_plain(bits, nbits, maxbits), iters=5)
    b_bytes = 8 * bits.numel() + bits.shape[0] * maxbits // 8
    d_call = time_ms(torch, lambda: pack_tokens_dense(rbits, rnbits, maxbits))
    # device time per call: the kernel and the memset of its tile records
    d_ms = call_device_ms(torch, lambda: pack_tokens_dense(rbits, rnbits, maxbits))
    d_kernel = kernel_ms(torch, lambda: pack_tokens_dense(rbits, rnbits, maxbits),
                         "dense_pack_tiles")
    d_plain = time_ms(torch, lambda: pack_tokens_dense_plain(rbits, rnbits, maxbits),
                      iters=2, warmup=1)
    d_bytes = 8 * rbits.numel() + rbits.shape[0] * maxbits // 8
    d_ops = OPS_PER_TOKEN * rbits.numel()
    emit({"phase": "kernels", "filter_cases_max_abs_err": filter_errs,
          "group_device_ms": group_top,
          "bitpack": {"lanes": int(bits.shape[0]), "ntok": int(bits.shape[1]),
                      "edge_cases_max_abs_err": sp_errs, "kernel_only_ms": b_kernel,
                      "maxbits": maxbits, "body_bits_mean": float(got_t.float().mean()),
                      "stream_bytes_mean": float(lengths_np.mean())},
          "bitpack_dense": {"lanes": int(rbits.shape[0]), "ntok": int(rbits.shape[1]),
                            "edge_cases_max_abs_err": dense_errs,
                            "kernel_only_ms": d_kernel, "maxbits": maxbits,
                            "body_bits_mean": float(got_dt.float().mean()),
                            "rle_stream_bytes_mean": float(rle_lengths_np.mean()),
                            # derived, not measured: the dense formulation's
                            # int op count and that count at the int32 peak
                            "formulation_ops": d_ops,
                            "formulation_ops_at_int32_peak_ms":
                                d_ops / INT32_OPS_PER_S * 1e3}})
    return [
        {"name": "filter", "route": "cuda",
         "source": "omero_ms_pixel_buffer_tpu_torch/csrc/filter.cu",
         "replaces": "omero_ms_pixel_buffer_tpu/ops/pallas/filter.py:137",
         "max_abs_err": max(filter_errs.values()), "ms": f_ms if f_ms else f_call,
         "ms_from": "profiler" if f_ms else "events", "cold_ms": f_cold,
         "call_ms": f_call, "plain_ms": f_plain,
         "bound_ms": f_bytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
         "library_ms": None},
        *mode_rows,
        {"name": "bitpack", "route": "cuda",
         "source": "omero_ms_pixel_buffer_tpu_torch/csrc/bitpack.cu",
         "replaces": "omero_ms_pixel_buffer_tpu/ops/pallas/bitpack.py:201",
         "max_abs_err": max(max_err(got_p, want_p), *sp_errs.values()),
         "ms": b_ms if b_ms else b_call,
         "ms_from": "profiler" if b_ms else "events", "call_ms": b_call, "plain_ms": b_plain,
         "bound_ms": b_bytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
         "library_ms": None},
        {"name": "bitpack_dense", "route": "cuda",
         "source": "omero_ms_pixel_buffer_tpu_torch/csrc/bitpack_dense.cu",
         "replaces": "omero_ms_pixel_buffer_tpu/ops/pallas/bitpack.py:275",
         "max_abs_err": max(max_err(got_d, want_d), *dense_errs.values()),
         "ms": d_ms if d_ms else d_call,
         "ms_from": "profiler" if d_ms else "events", "call_ms": d_call, "plain_ms": d_plain,
         "bound_ms": d_bytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
         "library_ms": None},
    ]


def filter_sweep(torch, device, tiles: np.ndarray) -> dict:
    """Device ms of the filter kernel on the main path's 32 lanes over
    the rows a warp owns (``group_bytes`` of output, rounded up to whole
    rows), mode Up, warm and with the L2 flushed, each checked byte-equal
    to the plain version (through the C entry ``ompb_filter_tuned``);
    then every mode at the default, through the wrapper."""
    import ctypes

    from omero_ms_pixel_buffer_tpu_torch.ops.convert import bits_tensor
    from omero_ms_pixel_buffer_tpu_torch.ops.kernels import _build
    from omero_ms_pixel_buffer_tpu_torch.ops.kernels.filter import (
        filter_tiles,
        filter_tiles_plain,
    )
    from omero_ms_pixel_buffer_tpu_torch.ops.png import FILTER_CODES

    fn = _build.entry("filter", "ompb_filter_tuned",
                      [ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 7
                      + [ctypes.c_void_p])
    u16 = bits_tensor(tiles).to(device)
    want = filter_tiles_plain(u16, "up")
    out = torch.empty_like(want)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=device)
    rows, width = u16.shape[0] * u16.shape[1], u16.shape[2]

    def run(group_bytes):
        _build.check(fn(u16.data_ptr(), out.data_ptr(), rows, u16.shape[1], width, 1, 2,
                        FILTER_CODES["up"], group_bytes, _build.stream_handle(device)),
                     "filter sweep")

    table = []
    for group_bytes in (1024, 2048, 4096, 8192, 16384, 32768):
        out.zero_()
        run(group_bytes)
        torch.cuda.synchronize()
        require(torch.equal(out, want), f"filter sweep {group_bytes} != plain")
        table.append({
            "group_bytes": group_bytes,
            "ms": kernel_ms(torch, lambda: run(group_bytes), "filter_row_groups"),
            "cold_ms": kernel_ms(torch, lambda: run(group_bytes), "filter_row_groups",
                                 before=flush.zero_),
        })
    modes = {m: {"ms": kernel_ms(torch, lambda: filter_tiles(u16, m), "filter_row_groups"),
                 "cold_ms": kernel_ms(torch, lambda: filter_tiles(u16, m), "filter_row_groups",
                                      before=flush.zero_)}
             for m in FILTER_CODES}
    return {"phase": "filter_sweep", "shape": list(u16.shape), "mode": "up", "table": table,
            "modes": modes}


# ---------------------------------------------------------------------------
# the served path
# ---------------------------------------------------------------------------


def decode_png(body: bytes) -> np.ndarray:
    """Grayscale 8/16-bit or RGB8 PNG -> array, with zlib and a numpy
    unfilter (filter types none and up: what the service emits)."""
    require(body[:8] == b"\x89PNG\r\n\x1a\n", "not a PNG")
    pos, idat = 8, b""
    while pos < len(body):
        (n,) = struct.unpack(">I", body[pos:pos + 4])
        tag, data = body[pos + 4:pos + 8], body[pos + 8:pos + 8 + n]
        require(zlib.crc32(tag + data) & 0xFFFFFFFF
                == struct.unpack(">I", body[pos + 8 + n:pos + 12 + n])[0], "bad CRC")
        if tag == b"IHDR":
            w, h, depth, color = struct.unpack(">IIBB", data[:10])
        elif tag == b"IDAT":
            idat += data
        pos += 12 + n
    require((color, depth) in ((0, 8), (0, 16), (2, 8)), "unexpected PNG format")
    samples = 3 if color == 2 else 1
    rb = w * samples * depth // 8
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + rb)
    require(np.isin(rows[:, 0], (0, 2)).all(), "unexpected PNG filter type")
    res = rows[:, 1:].copy()
    up = rows[:, 0] == 2
    out = np.zeros_like(res)
    prev = np.zeros(rb, np.uint8)
    for y in range(h):  # row-serial: each up row adds the row above
        out[y] = res[y] + prev if up[y] else res[y]
        prev = out[y]
    if samples == 3:
        return out.reshape(h, w, 3)
    return out.view(">u2" if depth == 16 else np.uint8).reshape(h, w)


class Client:
    """Keep-alive HTTP connections, one per worker thread."""

    def __init__(self, port: int):
        self.port = port
        self._local = threading.local()
        self._conns = []
        self._lock = threading.Lock()

    def close(self) -> None:
        with self._lock:
            for conn in self._conns:
                conn.close()
            self._conns.clear()

    def request(self, method: str, path: str, headers=None, body=None):
        """(status, headers, body, seconds) of one request on this
        thread's connection, with the session cookie."""
        conn = getattr(self._local, "conn", None)
        if conn is None:
            conn = self._local.conn = http.client.HTTPConnection(
                "127.0.0.1", self.port, timeout=120)
            with self._lock:
                self._conns.append(conn)
        t0 = time.perf_counter()
        conn.request(method, path, body=body, headers={**COOKIE, **(headers or {})})
        resp = conn.getresponse()
        body = resp.read()
        return resp.status, dict(resp.getheaders()), body, time.perf_counter() - t0

    def get(self, path: str):
        status, _, body, seconds = self.request("GET", path)
        return status, body, seconds


def run_requests(client: Client, reqs, concurrency: int):
    with concurrent.futures.ThreadPoolExecutor(concurrency) as pool:
        t0 = time.perf_counter()
        out = list(pool.map(lambda r: client.get(r[0]), reqs))
        return out, time.perf_counter() - t0


def tile_requests(rng, size: int, n: int):
    reqs = []
    for _ in range(n):
        x = int(rng.integers(0, (size - TILE) // 64 + 1)) * 64
        y = int(rng.integers(0, (size - TILE) // 64 + 1)) * 64
        reqs.append((f"/tile/1/0/0/0?x={x}&y={y}&w={TILE}&h={TILE}&format=png",
                     (x, y, TILE, TILE), 200))
    return reqs


def edge_requests(size: int):
    def req(x, y, w, h, status=200):
        return (f"/tile/1/0/0/0?x={x}&y={y}&w={w}&h={h}&format=png", (x, y, w, h), status)

    return [
        req(64, 128, 300, 200), req(size // 8, size * 3 // 8, 300, 200),
        req(5, 7, 17, 511),
        req(size - 300, 640, 300, 200),        # ends at the right edge
        req(512, size - 200, 300, 200),        # ends at the bottom edge
        req(size - TILE // 2, 0, TILE, TILE, 404),  # crosses the right edge
        req(0, 0, 100, 100, 200),
    ]


def get_json(client: Client, path: str) -> dict:
    status, body, _ = client.get(path)
    require(status == 200, f"{path} answered {status}")
    return json.loads(body)


def verify(results, reqs, data: np.ndarray) -> int:
    checked = 0
    for (status, body, _), (path, (x, y, w, h), want) in zip(results, reqs):
        require(status == want, f"{path} answered {status}, expected {want}")
        if status == 200:
            require(np.array_equal(decode_png(body), data[y:y + h, x:x + w]),
                    f"{path}: pixels differ from the source")
            checked += 1
    return checked


def png_stream_len(body: bytes) -> int:
    """Bytes of a PNG's zlib stream (its IDAT chunks)."""
    pos, n_idat = 8, 0
    while pos < len(body):
        (n,) = struct.unpack(">I", body[pos:pos + 4])
        if body[pos + 4:pos + 8] == b"IDAT":
            n_idat += n
        pos += 12 + n
    return n_idat


def timed_window(health_before: dict, health_after: dict, seconds: float) -> dict:
    """The encode queue over the timed requests alone: the difference of
    two ``/healthz`` views taken just before and just after them.
    ``*_busy_share`` is the share of the window's wall time that the
    submit thread (stage) and the readback thread (every other stage)
    spent on its groups; ``result_cache_hits`` and ``lone_lanes`` count
    the requests that bypassed the device (a cache hit, or a batch of one
    encoded on the host)."""
    before, after = health_before["queue"], health_after["queue"]
    groups = after["completed"] - before["completed"]
    total = {k: v - before["stage_ms_total"].get(k, 0.0)
             for k, v in after["stage_ms_total"].items()}
    n = {k: v - before["stage_groups"].get(k, 0) for k, v in after["stage_groups"].items()}
    readback_ms = sum(v for k, v in total.items() if k != "stage")
    return {
        "groups": groups,
        "lanes": after["lanes"] - before["lanes"],
        "seconds": seconds,
        "stage_ms_mean": {k: total[k] / n[k] for k in total if n[k]},
        "submit_busy_share": total.get("stage", 0.0) / 1e3 / seconds,
        "readback_busy_share": readback_ms / 1e3 / seconds,
        "result_cache_hits": (health_after["result_cache"]["memory"]["hits"]
                              - health_before["result_cache"]["memory"]["hits"]),
        "lone_lanes": health_after["batcher"]["lone"] - health_before["batcher"]["lone"],
        "host_png_lanes": health_after["host_png_lanes"] - health_before["host_png_lanes"],
        "render_host_lanes": (health_after["render"]["host_lanes"]
                              - health_before["render"]["host_lanes"]),
        "render_groups": after["render_groups"] - before["render_groups"],
        "supertile": supertile_delta(health_before, health_after),
    }


def supertile_delta(health_before: dict, health_after: dict) -> dict:
    """The super-tile counts of ``/healthz`` between two views."""
    before, after = health_before["supertile"], health_after["supertile"]
    return {k: after[k] - before[k]
            for k in ("stamped_lanes", "groups", "encode_groups", "device_lanes",
                      "host_lanes", "fallback_lanes", "host_pulls")}


def drive_path(registry: str, data: np.ndarray, seed: int, n_requests: int,
               deflate_mode: str, packer: str, launched, idle, warm_rounds: int = 2,
               edges: bool = True, device: str = "cuda", phase: str = "") -> dict:
    """Serve ``n_requests`` timed 512x512 PNG tiles (after ``warm_rounds``
    rounds of 32, then the edge cases) from a fresh server in
    ``deflate_mode`` with ``packer``, every body pixel-checked. The
    kernels in ``launched`` must have launched in the run, those in
    ``idle`` not."""
    from omero_ms_pixel_buffer_tpu_torch.ops.kernels import (
        launch_counts,
        reset_launch_counts,
    )

    with ServerThread(registry, device=device, deflate_mode=deflate_mode,
                      packer=packer) as client:
        size = data.shape[0]
        rng = np.random.default_rng(seed + 2)
        reset_launch_counts()
        # warm-up rounds: the plane is admitted on its second touch
        warm = tile_requests(rng, size, warm_rounds * LANES)
        t_warm = time.perf_counter()
        warm_out = []
        for k in range(warm_rounds):
            warm_out += run_requests(client, warm[k * LANES:(k + 1) * LANES], LANES)[0]
        warm_s = time.perf_counter() - t_warm
        main = tile_requests(rng, size, n_requests)
        before = get_json(client, "/healthz")
        main_out, main_s = run_requests(client, main, LANES)
        window = timed_window(before, get_json(client, "/healthz"), main_s)
        edge_reqs = edge_requests(size) if edges else []
        edge_out = run_requests(client, edge_reqs, len(edge_reqs))[0] if edges else []
        launches = launch_counts()
        health = get_json(client, "/healthz")
    checked = (verify(warm_out, warm, data) + verify(main_out, main, data)
               + verify(edge_out, edge_reqs, data))
    lat_ms = np.array([r[2] for r in main_out]) * 1e3
    require(all(launches[k] > 0 for k in launched),
            f"{deflate_mode}: a kernel of the path never launched: {launches}")
    require(all(launches[k] == 0 for k in idle),
            f"{deflate_mode}: a kernel off the path launched: {launches}")
    require(health["kernels"] == launches, "healthz counters disagree")
    require(health["queue"]["deflate_mode"] == deflate_mode
            and health["queue"]["packer"] == packer, f"served with {health['queue']}")
    require(health["queue"]["failed"] == 0, f"encode groups failed: {health['queue']}")
    return {
        "phase": phase or ("path" if deflate_mode == "dynamic" else f"path_{deflate_mode}"),
        # the timed requests and their bodies, for path_config; popped
        # before the line is printed
        "_timed": (main, [r[1] for r in main_out]),
        "deflate_mode": deflate_mode, "packer": packer,
        "tiles_verified": checked, "launches": launches,
        "requests": n_requests, "concurrency": LANES,
        "tiles_per_s": n_requests / main_s, "p50_ms": float(np.percentile(lat_ms, 50)),
        "p99_ms": float(np.percentile(lat_ms, 99)), "warmup_s": warm_s,
        "stream_bytes_mean": float(np.mean([png_stream_len(r[1]) for r in main_out])),
        "timed_window": window,
        "plane_cache": health["plane_cache"], "queue": health["queue"],
        "batcher": health["batcher"], "result_cache": health["result_cache"],
        "host_engine": health["host_engine"], "gpu": health["gpu"],
    }


class ServerThread:
    """The service (``create_server``) on 127.0.0.1 in this process, its
    event loop on a thread of its own; a context manager that closes it."""

    def __init__(self, registry: str, **kwargs):
        from omero_ms_pixel_buffer_tpu_torch.http.server import create_server

        self.server = create_server(registry, dev=True, **kwargs)
        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self.loop.run_forever, name="smoke-server",
                                       daemon=True)

    def __enter__(self) -> Client:
        self.thread.start()
        port = asyncio.run_coroutine_threadsafe(
            self.server.start("127.0.0.1", 0), self.loop).result(120)
        self.client = Client(port)
        return self.client

    def __exit__(self, *exc) -> None:
        self.client.close()
        asyncio.run_coroutine_threadsafe(self.server.close(), self.loop).result(120)
        self.server.pipeline.close()
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(30)


OBS_SAMPLE_RATE = 0.1  # the obs-on arm keeps a tenth of its healthy requests
_SAMPLE = None
_EXEMPLAR = None


def metrics_text(client: Client, openmetrics: bool = False) -> str:
    headers = {"Accept": "application/openmetrics-text"} if openmetrics else {}
    status, hdrs, body, _ = client.request("GET", "/metrics", headers)
    require(status == 200, f"/metrics answered {status}")
    return body.decode()


def metric_samples(text: str) -> dict:
    """{(name, labels): value} of a classic exposition."""
    import re

    global _SAMPLE
    _SAMPLE = _SAMPLE or re.compile(r"^(\w+)(\{[^}]*\})? (\S+)$", re.M)
    return {(n, lab): float(v) for n, lab, v in _SAMPLE.findall(text)}


def metric_delta(after: dict, before: dict, name: str, **labels) -> float:
    """The summed delta of ``name``'s samples whose labels include ``labels``."""
    want = [f'{k}="{v}"' for k, v in labels.items()]
    return sum(v - before.get(key, 0.0) for key, v in after.items()
               if key[0] == name and all(w in key[1] for w in want))


def exemplar_ids(text: str, series: str = "") -> list:
    """Trace ids of the exemplars on OpenMetrics bucket lines (those of
    ``series`` first), newest family order kept."""
    import re

    global _EXEMPLAR
    _EXEMPLAR = _EXEMPLAR or re.compile(r'^(\S+) \S+ # \{trace_id="([0-9a-f]+)"\}', re.M)
    found = _EXEMPLAR.findall(text)
    first = [t for line, t in found if series and series in line]
    return list(dict.fromkeys(first + [t for _, t in found]))


def drive_obs(registry: str, data: np.ndarray, timed, seed: int, device: str = "cuda") -> dict:
    """``path_obs``: two fresh servers, the flight recorder on (keeping a
    tenth of healthy requests) and off, over ``path``'s timed tiles (each
    position once): a cold round at 32 clients (on, then off), then a warm
    round of hits one at a time, three passes per arm interleaved, each
    arm's p50 the lowest of its passes. The warm-hit p50 penalty
    must meet the JAX ``obs_ok_overhead`` rule (at most 3 %, or at most
    0.3 ms). Over the on arm's cold window, from ``/metrics`` and
    ``/healthz`` views before and after it: ``tiles_served_total`` rises by
    the 200s, ``device_stage_seconds_count`` of ``hist`` (dynamic mode) by
    the encode groups, the OpenMetrics body ends with ``# EOF``, and an
    exemplar's trace id resolves through ``/debug/requests/{traceId}`` to a
    kept record with a ``device`` stage whose stages sum to no more than its
    total (up to their rounding to 0.001 ms each). ``device_idle_share`` is
    the ``device_queue_idle_seconds`` sum over the window's seconds."""
    from omero_ms_pixel_buffer_tpu_torch.ops.kernels import (
        launch_counts,
        reset_launch_counts,
    )

    reqs = list({r[0]: r for r in timed}.values())  # each position once: all misses
    arms, clients = {}, {}
    try:
        for name, kwargs in (("on", {"head_sample_rate": OBS_SAMPLE_RATE}),
                             ("off", {"obs": False})):
            arms[name] = ServerThread(registry, device=device, **kwargs)
            clients[name] = arms[name].__enter__()
        reset_launch_counts()
        cold, warm, window = {}, {}, {}
        for name in ("on", "off"):
            client = clients[name]
            if name == "on":
                m0, h0 = metric_samples(metrics_text(client)), get_json(client, "/healthz")
            out, secs = run_requests(client, reqs, LANES)
            if name == "on":
                h1, text1 = get_json(client, "/healthz"), metrics_text(client)
                om = metrics_text(client, openmetrics=True)
                window = {"seconds": secs, "before": m0, "after": metric_samples(text1),
                          "h0": h0, "h1": h1, "om": om}
            verify(out, reqs, data)
            lat = np.array([r[2] for r in out]) * 1e3
            cold[name] = {"tiles_per_s": len(reqs) / secs,
                          "p50_ms": float(np.percentile(lat, 50)),
                          "p99_ms": float(np.percentile(lat, 99))}
        # the warm round: every request a hit, one at a time, in three
        # passes per arm (off, on, on, off, off, on); an arm's p50 is its
        # lowest (the JAX bench's min of rounds: host noise only adds)
        for name in ("off", "on", "on", "off", "off", "on"):
            out = [clients[name].get(r[0]) for r in reqs]
            require(all(r[0] == 200 for r in out), f"warm round ({name}) failed")
            lat = np.array([r[2] for r in out]) * 1e3
            p50, p99 = float(np.percentile(lat, 50)), float(np.percentile(lat, 99))
            if name not in warm or p50 < warm[name]["p50_ms"]:
                warm[name] = {"p50_ms": p50, "p99_ms": p99}
        launches = launch_counts()
        m0, m1, h0, h1 = window["before"], window["after"], window["h0"], window["h1"]
        served = metric_delta(m1, m0, "tiles_served_total")
        groups = h1["queue"]["groups"] - h0["queue"]["groups"]
        hist_n = metric_delta(m1, m0, "device_stage_seconds_count", stage="hist")
        require(served == len(reqs), f"tiles_served_total rose {served}, 200s {len(reqs)}")
        require(hist_n == groups, f"device_stage_seconds_count{{hist}} rose {hist_n}, "
                                  f"/healthz queue groups {groups}")
        require(window["om"].endswith("# EOF\n"), "the OpenMetrics body does not end with # EOF")
        resolved = None
        for trace_id in exemplar_ids(window["om"], 'request_stage_seconds_bucket{stage="device"'):
            status, _, body, _ = clients["on"].request("GET", f"/debug/requests/{trace_id}")
            if status != 200:
                continue  # an exemplar of an earlier phase's server
            for event in json.loads(body)["events"]:
                stages = event["stages_ms"]
                if "device" in stages and sum(stages.values()) <= (
                        event["total_ms"] + 0.0005 * len(stages)):
                    resolved = event
                    break
            if resolved is not None:
                break
        require(resolved is not None, "no exemplar resolved to a kept record with a device stage")
        penalty_ms = warm["on"]["p50_ms"] - warm["off"]["p50_ms"]
        penalty = penalty_ms / max(warm["off"]["p50_ms"], 1e-9)
        require(penalty <= 0.03 or penalty_ms <= 0.3,
                f"warm-hit p50 penalty {penalty:.4f} ({penalty_ms:.3f} ms)")
        if device == "cuda":
            require(launches["filter"] > 0 and launches["bitpack"] > 0, f"launches: {launches}")
        idle_s = metric_delta(m1, m0, "device_queue_idle_seconds_sum")
        health = h1
    finally:
        for arm in arms.values():
            if hasattr(arm, "client"):
                arm.__exit__(None, None, None)
    return {
        "phase": "path_obs", "requests": len(reqs), "concurrency": LANES,
        "head_sample_rate_on": OBS_SAMPLE_RATE,
        "cold": cold, "warm_hits_sequential": warm,
        "warm_p50_penalty": penalty, "warm_p50_penalty_ms": penalty_ms,
        "tiles_served_delta": served, "hist_observations": hist_n, "queue_groups": groups,
        "device_idle_s": idle_s, "window_s": window["seconds"],
        "device_idle_share": idle_s / window["seconds"],
        "idle_gaps": metric_delta(m1, m0, "device_queue_idle_seconds_count"),
        "exemplar_record": {"trace_id": resolved["trace_id"], "kept_reason":
                            resolved["kept_reason"], "total_ms": resolved["total_ms"],
                            "stages_ms": resolved["stages_ms"]},
        "obs": {k: health["obs"][k] for k in ("started", "kept", "dropped", "ring_occupancy")},
        "burn_rates": health["obs"]["sli"]["burn_rates"],
        "launches": launches,
    }


PREFETCH_STEPS = 12  # under the sweep detector's 16 constant steps
PREFETCH_RENDER = "c=1|1000:60000$00FF00"


class _Drained:
    """Polls a ``ServerThread``'s prefetcher until its queue is empty and no
    flight is left, three times in a row."""

    def __init__(self, st: "ServerThread"):
        self.st = st

    async def _state(self):
        srv = self.st.server
        return srv.prefetcher._queue.qsize(), len(srv._flight._flights)

    def wait(self, timeout_s: float = 60.0) -> None:
        idle, t0 = 0, time.perf_counter()
        while time.perf_counter() - t0 < timeout_s:
            state = asyncio.run_coroutine_threadsafe(self._state(), self.st.loop).result(10)
            idle = idle + 1 if state == (0, 0) else 0
            if idle >= 3:
                return
            time.sleep(0.01)
        raise SmokeFailure("the prefetcher did not drain")


def drive_prefetch(registry: str, data: np.ndarray, seed: int, device: str = "cuda") -> dict:
    """``path_prefetch``: a fresh server with the prefetcher on; one session
    pans 512x512 tiles along a row, ``PREFETCH_STEPS`` steps (fewer on a
    small image) of ``/tile``
    PNG and then as many of ``/render`` (one channel of image 1, green),
    waiting after each step until the prefetcher has drained. From the third
    step on, each requested tile is one the prefetcher predicted: it must
    answer ``X-Cache: hit`` with the source's pixels (the numpy tile, or
    the numpy composite). Kernel launches are counted over the render pan's
    hit steps alone, where every device lane is a prefetched one: the
    filter and the SP packer must have launched. A prefetched ``/tile``
    lane is a batch of one, encoded on the host, as in the JAX package.
    ``/healthz`` ``prefetch``: warmed > 0 and failed 0 (off-image
    predictions are pruned, not failed)."""
    from omero_ms_pixel_buffer_tpu_torch.ops.kernels import (
        launch_counts,
        reset_launch_counts,
    )

    size = data.shape[0]
    n_steps = min(PREFETCH_STEPS, size // TILE - 2)
    require(n_steps >= 4, f"a {size}^2 image is too small for the pan")
    ref = RenderReference(data[None, None])
    st = ServerThread(registry, device=device, prefetch=True)
    drained = _Drained(st)
    steps, launches, t0 = [], {}, time.perf_counter()
    with st as client:
        reset_launch_counts()
        for kind, y in (("tile", size // 2), ("render", size // 4)):
            for i in range(n_steps):
                x = i * TILE
                if kind == "tile":
                    req = (f"/tile/1/0/0/0?x={x}&y={y}&w={TILE}&h={TILE}&format=png",
                           (x, y, TILE, TILE), 200)
                else:
                    req = (f"/render/1/0/0/0?x={x}&y={y}&w={TILE}&h={TILE}&{PREFETCH_RENDER}"
                           "&format=png", (x, y, TILE, TILE), 200,
                           {"c": PREFETCH_RENDER[2:]})
                    if i == 2:
                        before = launch_counts()
                status, hdrs, body, secs = client.request("GET", req[0])
                if kind == "tile":
                    verify([(status, body, secs)], [req], data)
                else:
                    verify_render([(status, body, secs)], [req], ref)
                x_cache = hdrs.get("X-Cache")
                require(i < 2 or x_cache == "hit",
                        f"{req[0]}: a predicted tile answered X-Cache {x_cache}")
                steps.append({"kind": kind, "x": x, "y": y, "x_cache": x_cache,
                              "ms": secs * 1e3})
                drained.wait()
            if kind == "render":
                after = launch_counts()
                launches = {k: after[k] - before[k] for k in after}
        health = get_json(client, "/healthz")
        phase_launches = launch_counts()
    pf = health["prefetch"]
    require(pf["warmed"] > 0 and pf["failed"] == 0, f"prefetch: {pf}")
    if device == "cuda":
        require(launches["filter"] > 0 and launches["bitpack"] > 0,
                f"the prefetched render lanes launched {launches}")
    hits = sum(1 for s in steps if s["x_cache"] == "hit")
    return {
        "phase": "path_prefetch", "steps": len(steps), "hits": hits,
        "tile_pan_hit_ms_mean": float(np.mean([s["ms"] for s in steps
                                               if s["kind"] == "tile" and s["x_cache"] == "hit"])),
        "issued": pf["enqueued"], "warmed": pf["warmed"], "dropped": pf["dropped_queue_full"],
        "shed": pf["shed"], "failed": pf["failed"], "already_cached": pf["already_cached"],
        "pruned_off_image": pf["pruned_off_image"], "observed": pf["observed"],
        "launches_prefetched_render_lanes": launches, "launches": phase_launches,
        "seconds": time.perf_counter() - t0,
    }


def http_contract(registry: str, data: np.ndarray, device: str = "cuda") -> dict:
    """The front's contract with the JAX package on the card's server: a
    lone request answered with host bytes, lanes larger than every bucket
    answered with the host engine's bytes, ETag / Cache-Control / X-Cache,
    304 on a matching If-None-Match (not on ``*``), HEAD, OPTIONS and an
    unrouted GET's 405."""
    from omero_ms_pixel_buffer_tpu_torch.cache.result_cache import make_etag
    from omero_ms_pixel_buffer_tpu_torch.http.server import DISCOVERY
    from omero_ms_pixel_buffer_tpu_torch.ops.png import encode_png
    from omero_ms_pixel_buffer_tpu_torch.runtime.native import get_engine

    def url(x, y, w, h):
        return f"/tile/1/0/0/0?x={x}&y={y}&w={w}&h={h}&format=png"

    with ServerThread(registry, device=device) as client:
        health0 = get_json(client, "/healthz")
        engine = health0["host_engine"]
        require(engine == ("native" if get_engine() is not None else "python"),
                f"/healthz names host engine {engine}")
        # a lone request: the single-request path's host bytes
        x, y = data.shape[1] // 8, data.shape[0] // 4
        status, hdr, body, _ = client.request("GET", url(x, y, TILE, TILE))
        require(status == 200 and body == encode_png(data[y:y + TILE, x:x + TILE]),
                "a lone request was not answered with host bytes")
        etag = hdr.get("ETag")
        require(etag == make_etag(body) and hdr.get("X-Cache") == "miss"
                and hdr.get("Cache-Control") == "private, max-age=60",
                f"miss headers: {hdr}")
        require(get_json(client, "/healthz")["batcher"]["lone"] == health0["batcher"]["lone"] + 1,
                "the lone request was not counted as a batch of one")
        status, hdr2, body2, _ = client.request("GET", url(x, y, TILE, TILE))
        require(status == 200 and body2 == body and hdr2.get("ETag") == etag
                and hdr2.get("X-Cache") == "hit", f"hit headers: {hdr2}")
        for inm in (etag, "W/" + etag, '"other", ' + etag):
            status, hdr3, body3, _ = client.request("GET", url(x, y, TILE, TILE),
                                                    {"If-None-Match": inm})
            require(status == 304 and body3 == b"" and hdr3.get("ETag") == etag,
                    f"If-None-Match {inm} answered {status}")
        status, _, body3, _ = client.request("GET", url(x, y, TILE, TILE), {"If-None-Match": "*"})
        require(status == 200 and body3 == body, f"If-None-Match * answered {status}")
        status, hdr4, body4, _ = client.request("HEAD", url(x, y, TILE, TILE))
        require(status == 200 and body4 == b"" and hdr4.get("ETag") == etag
                and int(hdr4.get("Content-Length", -1)) == len(body), f"HEAD: {status} {hdr4}")
        status, _, body5, _ = client.request("OPTIONS", "/anything")
        require(status == 200 and json.loads(body5) == DISCOVERY, f"OPTIONS: {status} {body5}")
        status, _, body6, _ = client.request("GET", "/tile/1/0/0")
        require((status, body6) == (405, b"405: Method Not Allowed"), f"unrouted GET: {status}")
        # two lanes larger than every bucket in one batch: the host lane
        # route (the native engine's bytes, or Python zlib without it);
        # fresh offsets until both coalesce into one batch
        for attempt in range(8):
            lanes = [(64 * attempt, 100, 1100, 300), (64 * attempt, 600, 1100, 300)]
            host0 = get_json(client, "/healthz")["host_png_lanes"]
            out = run_requests(client, [(url(*r), r, 200) for r in lanes], 2)[0]
            verify(out, [(url(*r), r, 200) for r in lanes], data)
            if get_json(client, "/healthz")["host_png_lanes"] == host0 + 2:
                break
        else:
            raise SmokeFailure("the oversize lanes never coalesced into one batch")
        for (_, got, _), (lx, ly, lw, lh) in zip(out, lanes):
            tile = data[ly:ly + lh, lx:lx + lw]
            want = (get_engine().png_encode_batch([tile], "up", 6, "fast")[0]
                    if engine == "native" else encode_png(tile))
            require(got == want, "an oversize lane was not answered with host-engine bytes")
        health = get_json(client, "/healthz")
    return {"phase": "http_contract", "host_engine": engine, "oversize_attempts": attempt + 1,
            "host_png_lanes": health["host_png_lanes"], "batcher": health["batcher"],
            "result_cache": health["result_cache"]}


# ---------------------------------------------------------------------------
# the render plane
# ---------------------------------------------------------------------------

RENDER_C = "1|500:30000$FF0000,2|1000:40000$00FF00,3|0:65535$0000FF"
# the rounds after the timed requests: (name, extra query), two rounds each
RENDER_ROUNDS = [
    ("intmax", "&p=intmax|0:3"),
    ("intmean", "&p=intmean"),
    ("greyscale", "&m=g"),
    ("roi", '&roi=[{"type":"rect","x":1000,"y":900,"w":1500,"h":1400}]'),
    ("maps", '&maps=[{"reverse":{"enabled":true}},{"quantization":'
             '{"family":"logarithmic","coefficient":4}}]'),
]


def render_lanes(stack: np.ndarray, seed: int) -> np.ndarray:
    """32 lanes of (3, 512, 512) z=0 channel planes at random offsets."""
    rng = np.random.default_rng(seed + 3)
    size = stack.shape[-1]
    ys = rng.integers(0, (size - TILE) // 64 + 1, LANES) * 64
    xs = rng.integers(0, (size - TILE) // 64 + 1, LANES) * 64
    return np.stack([stack[:, 0, y:y + TILE, x:x + TILE] for y, x in zip(ys, xs)])


def check_render_kernels(torch, device, stack: np.ndarray, seed: int):
    """The filter and the scalar-prefetch packer at the render shape, and
    the composite's device time: returns (kernel rows, phase line)."""
    from omero_ms_pixel_buffer_tpu_torch.ops import device_deflate as dd
    from omero_ms_pixel_buffer_tpu_torch.ops.convert import bits_tensor
    from omero_ms_pixel_buffer_tpu_torch.ops.kernels.bitpack import (
        pack_tokens_sp,
        pack_tokens_sp_plain,
    )
    from omero_ms_pixel_buffer_tpu_torch.ops.kernels.filter import (
        filter_tiles,
        filter_tiles_plain,
    )
    from omero_ms_pixel_buffer_tpu_torch.render import engine as rengine
    from omero_ms_pixel_buffer_tpu_torch.render.luts import LutRegistry
    from omero_ms_pixel_buffer_tpu_torch.render.model import RenderSpec

    lanes = render_lanes(stack, seed)
    spec = RenderSpec.from_params({"c": RENDER_C})
    tables, luts = rengine.build_tables(spec, np.dtype(np.uint16), LutRegistry())
    planes = bits_tensor(lanes).to(device)
    packed = torch.from_numpy(rengine.packed_rgb_tables(tables, luts)).to(device)
    rgb = rengine.render_torch(planes, tables, luts, packed=packed)
    want_rgb = np.stack([rengine.render_host(lane, tables, luts) for lane in lanes[:4]])
    require(np.array_equal(rgb[:4].cpu().numpy(), want_rgb), "composite != numpy host mirror")
    composite = lambda: rengine.render_torch(planes, tables, luts, packed=packed)  # noqa: E731
    c_ms = call_device_ms(torch, composite)
    c_call = time_ms(torch, composite)
    c_bytes = lanes.nbytes + rgb.numel()
    c_breakdown = device_breakdown(torch, composite)

    got, want = filter_tiles(rgb, "up"), filter_tiles_plain(rgb, "up")
    torch.cuda.synchronize()
    f_err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max().item())
    require(torch.equal(got, want), "filter kernel != plain on render composites")
    f_call = time_ms(torch, lambda: filter_tiles(rgb, "up"))
    f_ms = kernel_ms(torch, lambda: filter_tiles(rgb, "up"), "filter_row_groups")
    f_plain = time_ms(torch, lambda: filter_tiles_plain(rgb, "up"))
    f_bytes = rgb.numel() + got.numel()

    row_bytes = 1 + TILE * 3
    flat = got[:, :TILE, :row_bytes].contiguous().reshape(LANES, -1)
    bits, nbits = dd._lane_tokens(flat)
    maxbits = dd._packing_maxbits(flat.shape[1])
    got_p, got_t = pack_tokens_sp(bits, nbits, maxbits)
    want_p, want_t = pack_tokens_sp_plain(bits, nbits, maxbits)
    torch.cuda.synchronize()
    b_err = int((got_p.to(torch.int64) - want_p.to(torch.int64)).abs().max().item())
    require(torch.equal(got_p, want_p) and torch.equal(got_t, want_t),
            "bitpack kernel != plain on render rle tokens")
    streams, lengths = dd._frame_lanes(flat, got_p, got_t, eob_bits=7)
    streams_np, lengths_np, flat_np = streams.cpu().numpy(), lengths.cpu().numpy(), flat.cpu().numpy()
    for i in range(LANES):
        require(zlib.decompress(streams_np[i, : lengths_np[i]].tobytes()) == flat_np[i].tobytes(),
                f"render lane {i} rle stream does not inflate back")
    call = lambda: pack_tokens_sp(bits, nbits, maxbits)  # noqa: E731
    b_call = time_ms(torch, call)
    b_ms = call_device_ms(torch, call)
    b_kernel = kernel_ms(torch, call, "sp_pack_tiles")
    b_plain = time_ms(torch, lambda: pack_tokens_sp_plain(bits, nbits, maxbits), iters=5)
    b_bytes = 8 * bits.numel() + bits.shape[0] * maxbits // 8
    line = {"phase": "kernels_render", "shape": list(rgb.shape),
            "composite": {"ms": c_ms, "call_ms": c_call, "bytes": c_bytes,
                          "bound_ms": c_bytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
                          "by_kernel": c_breakdown},
            "bitpack": {"ntok": int(bits.shape[1]), "maxbits": maxbits,
                        "kernel_only_ms": b_kernel,
                        "body_bits_mean": float(got_t.float().mean()),
                        "stream_bytes_mean": float(lengths_np.mean())}}
    rows = [
        {"name": "filter_render_rgb8", "route": "cuda",
         "source": "omero_ms_pixel_buffer_tpu_torch/csrc/filter.cu",
         "replaces": "omero_ms_pixel_buffer_tpu/ops/pallas/filter.py:137",
         "shape": list(rgb.shape), "max_abs_err": f_err, "ms": f_ms if f_ms else f_call,
         "ms_from": "profiler" if f_ms else "events", "call_ms": f_call, "plain_ms": f_plain,
         "bound_ms": f_bytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes", "library_ms": None},
        {"name": "bitpack_render_rle", "route": "cuda",
         "source": "omero_ms_pixel_buffer_tpu_torch/csrc/bitpack.cu",
         "replaces": "omero_ms_pixel_buffer_tpu/ops/pallas/bitpack.py:201",
         "shape": list(bits.shape), "max_abs_err": b_err, "ms": b_ms if b_ms else b_call,
         "ms_from": "profiler" if b_ms else "events", "call_ms": b_call, "plain_ms": b_plain,
         "bound_ms": b_bytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes", "library_ms": None},
    ]
    return rows, line


class RenderReference:
    """The expected RGB of a /render request of image 2, from the source
    stack: the port's ``build_tables``, numpy projection and gathers."""

    def __init__(self, stack: np.ndarray):
        from omero_ms_pixel_buffer_tpu_torch.render import engine as rengine
        from omero_ms_pixel_buffer_tpu_torch.render.luts import LutRegistry

        self.stack, self.rengine, self.luts = stack, rengine, LutRegistry()
        self.tables = {}

    def rgb(self, query: dict, x: int, y: int, w: int, h: int) -> np.ndarray:
        from omero_ms_pixel_buffer_tpu_torch.render.masks import rasterize
        from omero_ms_pixel_buffer_tpu_torch.render.model import RenderSpec

        spec = RenderSpec.from_params(query, default_channel=0)
        key = spec.signature()
        if key not in self.tables:
            self.tables[key] = self.rengine.build_tables(spec, np.dtype(np.uint16), self.luts)
        tables, luts = self.tables[key]
        chans = [ch.index for ch in spec.resolve_channels(self.stack.shape[0])]
        zs = [z for z, _ in spec.plane_range(0, 0, self.stack.shape[1], 1)]
        # crop before the fancy index: indexing channels first copies the
        # whole stack (400 MB at 4096^2 x 12 planes) on every tile
        region = self.stack[:, :, y:y + h, x:x + w][chans][:, zs]
        if spec.projection == "intmax":
            planes = region.max(axis=1)
        elif spec.projection == "intmean":
            planes = (region.astype(np.int64).sum(axis=1) // len(zs)).astype(np.uint16)
        else:
            planes = region[:, 0]
        acc = np.zeros((h, w, 3), np.int64)
        for c in range(tables.shape[0]):
            acc += luts[c][tables[c][planes[c]]]
        rgb = np.minimum(acc, 255)
        if spec.masks:
            rgb = rgb * rasterize(spec.masks, x, y, w, h)[:, :, None]
        return rgb.astype(np.uint8)


def render_requests(rng, size: int, n: int, extra: str = "", image: int = 2):
    from urllib.parse import parse_qsl

    reqs = []
    for _ in range(n):
        x = int(rng.integers(0, (size - TILE) // 64 + 1)) * 64
        y = int(rng.integers(0, (size - TILE) // 64 + 1)) * 64
        query = f"c={RENDER_C}{extra}"
        reqs.append((f"/render/{image}/0/0/0?x={x}&y={y}&w={TILE}&h={TILE}&{query}&format=png",
                     (x, y, TILE, TILE), 200, dict(parse_qsl(query))))
    return reqs


def verify_render(results, reqs, ref: RenderReference) -> int:
    checked = 0
    for (status, body, _), (path, (x, y, w, h), want, query) in zip(results, reqs):
        require(status == want, f"{path} answered {status}, expected {want}")
        if status == 200:
            require(np.array_equal(decode_png(body), ref.rgb(query, x, y, w, h)),
                    f"{path}: pixels differ from the numpy composite")
            checked += 1
    return checked


def drive_render(registry: str, stack: np.ndarray, seed: int, n_requests: int,
                 device: str = "cuda") -> dict:
    """``path_render``: the /render plane on a server with the defaults."""
    from omero_ms_pixel_buffer_tpu_torch.ops.kernels import (
        launch_counts,
        reset_launch_counts,
    )

    ref = RenderReference(stack)
    size = stack.shape[-1]
    rng = np.random.default_rng(seed + 5)
    checked = 0
    with ServerThread(registry, device=device) as client:
        reset_launch_counts()
        warm = render_requests(rng, size, 2 * LANES)
        t_warm = time.perf_counter()
        warm_out = []
        for k in range(2):
            warm_out += run_requests(client, warm[k * LANES:(k + 1) * LANES], LANES)[0]
        warm_s = time.perf_counter() - t_warm
        main = render_requests(rng, size, n_requests)
        before = get_json(client, "/healthz")
        main_out, main_s = run_requests(client, main, LANES)
        after = get_json(client, "/healthz")
        window = timed_window(before, after, main_s)
        groups = after["queue"]["composite_groups"] - before["queue"]["composite_groups"]
        window["composite_device_ms_per_group"] = (
            (after["queue"]["composite_device_ms_total"]
             - before["queue"]["composite_device_ms_total"]) / groups if groups else None)
        rounds = {}
        for name, extra in RENDER_ROUNDS:
            per_round = []
            for _ in range(2):
                reqs = render_requests(rng, size, LANES, extra)
                h0 = get_json(client, "/healthz")
                out, secs = run_requests(client, reqs, LANES)
                h1 = get_json(client, "/healthz")
                checked += verify_render(out, reqs, ref)
                per_round.append({
                    "seconds": secs,
                    "projection_host_pulls": (h1["render"]["projection_host_pulls"]
                                              - h0["render"]["projection_host_pulls"]),
                    "render_groups": (h1["queue"]["render_groups"]
                                      - h0["queue"]["render_groups"]),
                    "render_host_lanes": h1["render"]["host_lanes"] - h0["render"]["host_lanes"],
                    "supertile": supertile_delta(h0, h1)})
            rounds[name] = per_round
        # the second intmax round stays on the card: its independent lanes
        # crop resident planes on the device (no pull); super-tile groups
        # gather their bounding rectangle through the host, as the JAX
        # package does (their pulls are counted apart)
        second = rounds["intmax"][1]
        require(second["projection_host_pulls"] == second["supertile"]["host_pulls"]
                and second["render_groups"] + second["supertile"]["device_lanes"] > 0
                and second["render_host_lanes"] == 0,
                f"the second intmax round left the device: {rounds['intmax']}")
        pillow = True
        try:
            import PIL  # noqa: F401
        except ImportError:
            pillow = False
        from omero_ms_pixel_buffer_tpu_torch.models.tile_pipeline import MAX_TILE_BYTES

        base = f"/render/2/0/0/0?x=0&y=0&w={TILE}&h={TILE}"
        # the whole stack of a full-plane projection: over the tile budget
        # at the default --render-size (4096: 402,653,184 bytes)
        over = stack.nbytes > MAX_TILE_BYTES
        edges = {
            "grammar_400": (f"{base}&c=1|9:1$FF0000", 400),
            "unknown_lut_400": (f"{base}&c=1$nope", 400),
            "channel_404": (f"{base}&c=9", 404),
            "stack_413": ("/render/2/0/0/0?w=0&h=0&c=1,2,3&p=intmax", 413 if over else 200),
            "jpeg": (f"{base}&c={RENDER_C}&format=jpeg", 200 if pillow else 404),
        }
        edge_status = {}
        for name, (path, want) in edges.items():
            status, body, _ = client.get(path)
            edge_status[name] = status
            require(status == want, f"{name}: {path} answered {status}, expected {want}")
            if name == "jpeg" and pillow:
                require(body[:2] == b"\xff\xd8", "the JPEG body is not a JPEG")
        launches = launch_counts()
        health = get_json(client, "/healthz")
    checked += verify_render(warm_out, warm, ref) + verify_render(main_out, main, ref)
    lat_ms = np.array([r[2] for r in main_out]) * 1e3
    require(launches["filter"] > 0 and launches["bitpack"] > 0,
            f"render: a kernel of the path never launched: {launches}")
    require(health["queue"]["failed"] == 0, f"encode groups failed: {health['queue']}")
    require(health["kernels"] == launches, "healthz counters disagree")
    return {
        "phase": "path_render", "tiles_verified": checked, "launches": launches,
        "requests": n_requests, "concurrency": LANES,
        "tiles_per_s": n_requests / main_s, "p50_ms": float(np.percentile(lat_ms, 50)),
        "p99_ms": float(np.percentile(lat_ms, 99)), "warmup_s": warm_s,
        "stream_bytes_mean": float(np.mean([png_stream_len(r[1]) for r in main_out])),
        "timed_window": window, "rounds": rounds, "edges": edge_status, "pillow": pillow,
        "render": health["render"], "queue": health["queue"],
        "plane_cache": health["plane_cache"], "batcher": health["batcher"],
        "result_cache": health["result_cache"], "gpu": health["gpu"],
    }


def drive_host_deflate(registry: str, data: np.ndarray, seed: int, n_requests: int = 32,
                       device: str = "cuda") -> dict:
    """``path_host_deflate``: /tile PNG lanes filtered on the card and
    deflated on the host (``device_deflate=False``)."""
    from omero_ms_pixel_buffer_tpu_torch.ops.kernels import (
        launch_counts,
        reset_launch_counts,
    )

    with ServerThread(registry, device=device, device_deflate=False) as client:
        rng = np.random.default_rng(seed + 9)
        reset_launch_counts()
        reqs = tile_requests(rng, data.shape[0], n_requests)
        before = get_json(client, "/healthz")
        out, secs = run_requests(client, reqs, LANES)
        launches = launch_counts()
        health = get_json(client, "/healthz")
    checked = verify(out, reqs, data)
    require(launches["filter"] > 0, f"host deflate: the filter never launched: {launches}")
    require(launches["bitpack"] == 0 and launches["bitpack_dense"] == 0,
            f"host deflate: a packer launched: {launches}")
    require(health["queue"]["groups"] == 0, "host deflate: an encode group was queued")
    return {"phase": "path_host_deflate", "tiles_verified": checked, "launches": launches,
            "requests": n_requests, "seconds": secs,
            "host_deflate_lanes": health["host_deflate_lanes"] - before["host_deflate_lanes"],
            "lone_lanes": health["batcher"]["lone"] - before["batcher"]["lone"],
            "host_engine": health["host_engine"], "device_deflate": health["device_deflate"]}


# ---------------------------------------------------------------------------
# the histogram plane and super-tile fusion
# ---------------------------------------------------------------------------

HIST_BINS = (256, 65536)


def histogram_requests(rng, stack: np.ndarray, n: int):
    """``n`` 512x512 region histograms of channels 1-3 at random z, bins
    256 and 65536 in turn, plus 8 full-plane ones (w = h = 0), shuffled:
    [(path, (z, x, y, w, h, bins))]."""
    depth, size = stack.shape[1], stack.shape[-1]
    reqs = []
    for k in range(n):
        x = int(rng.integers(0, (size - TILE) // 64 + 1)) * 64
        y = int(rng.integers(0, (size - TILE) // 64 + 1)) * 64
        z, bins = int(rng.integers(0, depth)), HIST_BINS[k % 2]
        reqs.append((f"/histogram/2/{z}/0/0?x={x}&y={y}&w={TILE}&h={TILE}&c=1,2,3"
                     f"&bins={bins}&usePixelsTypeRange=1", (z, x, y, TILE, TILE, bins)))
    for k in range(8):
        z, bins = k % depth, HIST_BINS[k * len(HIST_BINS) // 8]
        reqs.append((f"/histogram/2/{z}/0/0?w=0&h=0&c=1,2,3&bins={bins}&usePixelsTypeRange=1",
                     (z, 0, 0, size, size, bins)))
    return [reqs[i] for i in rng.permutation(len(reqs))]


def verify_histogram(body: bytes, stack: np.ndarray, spec) -> None:
    """The body's counts against ``np.bincount`` of the source region over
    the uint16 range (``usePixelsTypeRange``), channel by channel."""
    z, x, y, w, h, bins = spec
    doc = json.loads(body)
    require(doc["region"] == [x, y, w, h] and doc["bins"] == bins
            and [ch["index"] for ch in doc["channels"]] == [0, 1, 2],
            f"histogram body header: {doc['region']} {doc['bins']}")
    for c, ch in enumerate(doc["channels"]):
        v = stack[c, z, y:y + h, x:x + w].astype(np.float64)
        idx = np.minimum(np.floor(v / 65535.0 * bins), bins - 1).astype(np.int64)
        want = np.bincount(idx.ravel(), minlength=bins)
        require(ch["counts"] == want.tolist() and ch["stats"]["count"] == w * h,
                f"histogram z={z} c={c} ({x},{y},{w},{h}) bins={bins}: counts differ")
    require(doc["data"] == doc["channels"][0]["counts"], "histogram data != first channel")


def histogram_program(stack: np.ndarray, lanes: int = 8) -> dict:
    """The torch histogram alone on the card at a serving group's shape
    (``lanes`` 512x512 channel regions of image 2), per bins value: device
    ms of one call (every kernel and memset it issues), its top kernels,
    its byte bound (planes and tables read once, counts written once), and
    beside it the same counts through one ``torch.bincount`` (checked
    equal), the formulation the port does not use."""
    import torch

    from omero_ms_pixel_buffer_tpu_torch.ops.convert import bits_tensor
    from omero_ms_pixel_buffer_tpu_torch.render.analysis import build_bin_table, histogram_torch

    planes = np.stack([stack[k % 3, k % stack.shape[1], :TILE, k * 64:k * 64 + TILE]
                       for k in range(lanes)])
    dev = bits_tensor(planes).to("cuda")
    out = {}
    for bins in HIST_BINS:
        tabs = np.stack([build_bin_table(np.dtype(np.uint16), (0.0, 65535.0), bins)] * lanes)
        tabs_dev = torch.from_numpy(tabs).to("cuda")
        call = lambda: histogram_torch(dev, tabs_dev, bins)  # noqa: E731
        offsets = torch.arange(lanes, device="cuda", dtype=torch.int64)[:, None] * bins

        def bincount():
            idx = dev.reshape(lanes, -1).to(torch.int64) & 0xFFFF
            binned = torch.gather(tabs_dev.to(torch.int64), 1, idx) + offsets
            return torch.bincount(binned.reshape(-1), minlength=lanes * bins)

        require(torch.equal(bincount().reshape(lanes, bins).to(torch.int32), call()),
                f"histogram_torch != bincount at bins={bins}")
        nbytes = planes.nbytes + tabs.nbytes + lanes * bins * 4
        out[str(bins)] = {"lanes": lanes, "device_ms": call_device_ms(torch, call),
                          "bincount_device_ms": call_device_ms(torch, bincount),
                          "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
                          "by_kernel": device_breakdown(torch, call, top=6, iters=10)}
    return out


def drive_histogram(registry: str, stack: np.ndarray, seed: int, n_requests: int,
                    device: str = "cuda") -> dict:
    """``path_histogram``: /histogram on a server with the defaults."""
    from omero_ms_pixel_buffer_tpu_torch.ops.kernels import (
        launch_counts,
        reset_launch_counts,
    )

    reqs = histogram_requests(np.random.default_rng(seed + 11), stack, n_requests)
    with ServerThread(registry, device=device) as client:
        reset_launch_counts()
        before = get_json(client, "/healthz")
        with concurrent.futures.ThreadPoolExecutor(LANES) as pool:
            t0 = time.perf_counter()
            out = list(pool.map(lambda r: client.request("GET", r[0]), reqs))
            secs = time.perf_counter() - t0
        after = get_json(client, "/healthz")
        launches = launch_counts()
    misses = 0
    for (status, hdrs, body, _), (path, spec) in zip(out, reqs):
        require(status == 200, f"{path} answered {status}")
        verify_histogram(body, stack, spec)
        misses += hdrs.get("X-Cache") == "miss"
    a0, a1 = before["analysis"], after["analysis"]
    groups = a1["device_groups"] - a0["device_groups"]
    timed = a1["timed_groups"] - a0["timed_groups"]
    lanes = a1["device_lanes"] - a0["device_lanes"]
    require(a1["device"].startswith("cuda") and lanes == 3 * misses and a1["failed_groups"] == 0,
            f"histogram lanes reduced off the card: {a1}, {misses} misses")
    device_ms = (a1["device_ms_total"] - a0["device_ms_total"]) / timed if timed else None
    nbytes = (a1["device_bytes_total"] - a0["device_bytes_total"]) / timed if timed else None
    lat_ms = np.array([r[3] for r in out]) * 1e3
    return {
        "phase": "path_histogram", "requests": len(reqs), "concurrency": LANES,
        "bodies_verified": len(out), "misses": misses,
        "tiles_per_s": len(reqs) / secs, "p50_ms": float(np.percentile(lat_ms, 50)),
        "p99_ms": float(np.percentile(lat_ms, 99)), "seconds": secs,
        "device_groups": groups, "device_lanes": lanes,
        "lanes_reduced_elsewhere": 3 * misses - lanes,
        "device_ms_per_group": device_ms, "bytes_per_group": nbytes,
        "bound_ms_per_group": nbytes / HBM_BYTES_PER_S * 1e3 if nbytes else None,
        "bound_by": "bytes", "launches": launches, "analysis": a1,
        "program": histogram_program(stack) if device == "cuda" else None,
        "batcher": after["batcher"], "gpu": after["gpu"],
    }


def viewport_requests(rng, size: int, n: int):
    """``n`` 4x4 viewports of 512x512 tiles at random origins on the 512
    grid, the last at the image's edge (origin size - 1792: its last
    column and row are 256 wide). Each viewport has its own channel
    windows, so no tile repeats one of another viewport."""
    span = 4 * TILE
    origins = [(int(rng.integers(0, (size - span) // TILE + 1)) * TILE,
                int(rng.integers(0, (size - span) // TILE + 1)) * TILE) for _ in range(n - 1)]
    origins.append((size - span + TILE // 2, size - span + TILE // 2))
    from urllib.parse import parse_qsl

    views = []
    for k, (x0, y0) in enumerate(origins):
        query = (f"c=1|{500 + k}:30000$FF0000,2|1000:{40000 + k}$00FF00,"
                 f"3|0:65535$0000FF")
        reqs = []
        for r in range(4):
            for c in range(4):
                x, y = x0 + c * TILE, y0 + r * TILE
                w, h = min(TILE, size - x), min(TILE, size - y)
                reqs.append((f"/render/2/0/0/0?x={x}&y={y}&w={w}&h={h}&{query}&format=png",
                             (x, y, w, h), 200, dict(parse_qsl(query))))
        views.append(reqs)
    return views


def composite_carve_program(stack: np.ndarray) -> dict:
    """The torch composite + carve alone on the card at a viewport's shape
    (a (3, 2048, 2048) stack of image 2 carved into sixteen 512x512
    buckets): device ms of one call, its top kernels and its byte bound
    (stack and packed tables read once, carved batch written once)."""
    import torch

    from omero_ms_pixel_buffer_tpu_torch.ops.convert import bits_tensor
    from omero_ms_pixel_buffer_tpu_torch.render import engine as rengine
    from omero_ms_pixel_buffer_tpu_torch.render.luts import LutRegistry
    from omero_ms_pixel_buffer_tpu_torch.render.model import RenderSpec
    from omero_ms_pixel_buffer_tpu_torch.render.supertile import composite_carve_torch

    span = 4 * TILE
    planes = np.ascontiguousarray(stack[:, 0, :span, :span])
    tables, luts = rengine.build_tables(RenderSpec.from_params({"c": RENDER_C}),
                                        np.dtype(np.uint16), LutRegistry())
    packed = rengine.packed_rgb_tables(tables, luts)
    packed_dev = torch.from_numpy(packed).to("cuda")
    dev = bits_tensor(planes).to("cuda")
    coords = [(y, x) for y in range(0, span, TILE) for x in range(0, span, TILE)]
    call = lambda: composite_carve_torch(dev, tables, luts, coords, TILE, TILE,  # noqa: E731
                                         packed=packed_dev)
    nbytes = planes.nbytes + packed.nbytes + len(coords) * TILE * TILE * 3
    return {"stack": list(planes.shape), "lanes": len(coords),
            "device_ms": call_device_ms(torch, call),
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
            "by_kernel": device_breakdown(torch, call, top=8)}


def drive_supertile(registry: str, stack: np.ndarray, seed: int, n_views: int,
                    enabled: bool = True, device: str = "cuda", run: int = 1) -> dict:
    """``path_supertile`` (``enabled``) or ``path_supertile_off``: the
    viewports of ``viewport_requests`` one after another on a fresh
    server, the 16 requests of each at once, every tile checked against
    the numpy composite. The composite + carve alone is timed in the
    first fused run."""
    from omero_ms_pixel_buffer_tpu_torch.ops.kernels import (
        launch_counts,
        reset_launch_counts,
    )

    ref = RenderReference(stack)
    views = viewport_requests(np.random.default_rng(seed + 13), stack.shape[-1], n_views)
    out, secs = [], 0.0
    with ServerThread(registry, device=device, supertile_enabled=enabled) as client:
        reset_launch_counts()
        before = get_json(client, "/healthz")
        for reqs in views:
            got, s = run_requests(client, reqs, len(reqs))
            out.append(got)
            secs += s
        after = get_json(client, "/healthz")
        launches = launch_counts()
    checked = sum(verify_render(got, reqs, ref) for got, reqs in zip(out, views))
    st0, st1 = before["supertile"], after["supertile"]
    st = supertile_delta(before, after)
    timed = st1["composite_carve_groups"] - st0["composite_carve_groups"]
    device_ms = ((st1["composite_carve_device_ms_total"] - st0["composite_carve_device_ms_total"])
                 / timed if timed else None)
    nbytes = ((st1["composite_carve_bytes_total"] - st0["composite_carve_bytes_total"]) / timed
              if timed else None)
    lat_ms = np.array([r[2] for got in out for r in got]) * 1e3
    require(after["queue"]["failed"] == 0, f"encode groups failed: {after['queue']}")
    if enabled:
        require(st["device_lanes"] > 0, f"no lane was fused on the card: {st}")
        require(launches["filter"] > 0 and launches["bitpack"] > 0,
                f"supertile: a kernel of the path never launched: {launches}")
    else:
        require(st["stamped_lanes"] == 0 and st["groups"] == 0, f"fusion off but fused: {st}")
    q0, q1 = before["queue"], after["queue"]
    return {
        "phase": "path_supertile" if enabled else "path_supertile_off", "run": run,
        "viewports": len(views), "tiles_verified": checked, "requests": checked,
        "tiles_per_s": checked / secs, "p50_ms": float(np.percentile(lat_ms, 50)),
        "p99_ms": float(np.percentile(lat_ms, 99)), "seconds": secs,
        "supertile": st,
        "mean_lanes_per_group": st["device_lanes"] / st["groups"] if st["groups"] else None,
        "composite_carve_device_ms_per_group": device_ms, "bytes_per_group": nbytes,
        "bound_ms_per_group": nbytes / HBM_BYTES_PER_S * 1e3 if nbytes else None,
        "bound_by": "bytes", "launches": launches,
        "encode_groups": q1["groups"] - q0["groups"],
        "render_groups": q1["render_groups"] - q0["render_groups"],
        "render_host_lanes": after["render"]["host_lanes"] - before["render"]["host_lanes"],
        "projection_host_pulls": (after["render"]["projection_host_pulls"]
                                  - before["render"]["projection_host_pulls"]),
        "plane_cache": after["plane_cache"], "batcher": after["batcher"], "gpu": after["gpu"],
        "program": (composite_carve_program(stack)
                    if enabled and run == 1 and device == "cuda" else None),
    }


def supertile_pair(registry: str, stack: np.ndarray, seed: int, n_views: int) -> dict:
    """``path_supertile`` and ``path_supertile_off`` twice each, in the
    order off, on, on, off, each emitted; returns both settings' tiles/s,
    p50 and p99 side by side."""
    runs = []
    for run, enabled in ((1, False), (1, True), (2, True), (2, False)):
        out = drive_supertile(registry, stack, seed, n_views, enabled=enabled, run=run)
        emit(out)
        runs.append(out)

    def side(enabled):
        return {k: [r[k] for r in runs if (r["phase"] == "path_supertile") is enabled]
                for k in ("tiles_per_s", "p50_ms", "p99_ms", "encode_groups")}

    fused, unfused = side(True), side(False)
    return {"phase": "supertile_pair", "order": "off, on, on, off",
            "fused": fused, "unfused": unfused,
            # adjacent runs: (off 1, on 1) and (on 2, off 2)
            "tiles_per_s_ratio": [f / u for f, u in
                                  zip(fused["tiles_per_s"], unfused["tiles_per_s"])]}


# ---------------------------------------------------------------------------
# the whole-slide JPEG RGB pyramid, the device IDCT, the TIFF layouts
# ---------------------------------------------------------------------------

WSI_TILE = 256
# the small layout fixtures of ``path_layouts``: registry id -> (name,
# writer keywords); each a 1024x1024 plane (C = 3 for the float image),
# but LZW's 512x512 (the writer's Python LZW encoder takes ~40 s a MB)
LAYOUT_SIZE = 1024
LAYOUTS = {
    10: ("lzw_u16", dict(compression="lzw")),
    11: ("packbits_u8", dict(compression="packbits")),
    12: ("zstd_u16", dict(compression="zstd")),
    13: ("zlib_pred2_u16", dict(compression="zlib", predictor=2)),
    14: ("zlib_strips_u16", dict(compression="zlib", tile_size=None)),
    15: ("bigtiff_le_u16", dict(compression="zlib", bigtiff=True, big_endian=False)),
    16: ("zlib_f32_c3", dict(compression="zlib")),
}
ROMIO_ID = 17
F32_ID = 16
F32_C = "1|-1500:2500$FF0000,2|0:3000$00FF00,3|-800:800$0000FF"


def make_wsi(size: int, seed: int) -> np.ndarray:
    """A stained-tissue-like (size, size, 3) uint8 slide: smooth colour
    fields with structure at several scales plus noise, from ``seed``,
    made a band of rows at a time."""
    rng = np.random.default_rng(seed + 11)
    out = np.empty((size, size, 3), np.uint8)
    xx = np.arange(size, dtype=np.float32)[None, :]
    for y0 in range(0, size, 1024):
        yy = np.arange(y0, min(size, y0 + 1024), dtype=np.float32)[:, None]
        tissue = (np.sin(xx / 211.0) * np.cos(yy / 157.0)
                  + 0.5 * np.sin((xx + yy) / 53.0) + 0.25 * np.cos(xx / 9.0 - yy / 13.0))
        for c, (base, amp) in enumerate(((200.0, 60.0), (150.0, 80.0), (190.0, 50.0))):
            noise = rng.standard_normal((yy.shape[0], size), dtype=np.float32) * 6.0
            out[y0:y0 + yy.shape[0], :, c] = (base - amp * tissue + noise).clip(0, 255)
    return out


def wsi_levels(size: int) -> int:
    """Pyramid levels from ``size`` down to the first at or under 1024."""
    levels = 1
    while size > 1024:
        size = (size + 1) // 2
        levels += 1
    return levels


def _raw_zstd_frame(data: bytes) -> bytes:
    """A valid zstd frame (RFC 8878) of raw blocks: magic, a single-
    segment header with a 4-byte content size, then blocks of at most
    128 KiB stored as they are. Lets the smoke write a zstd TIFF where
    the ``zstandard`` package is missing."""
    out = bytearray(struct.pack("<IB", 0xFD2FB528, (2 << 6) | (1 << 5)))
    out += struct.pack("<I", len(data))
    blocks = [data[i:i + 131072] for i in range(0, len(data), 131072)] or [b""]
    for k, block in enumerate(blocks):
        out += struct.pack("<I", (k == len(blocks) - 1) | (len(block) << 3))[:3] + block
    return bytes(out)


class _RawZstd:
    """Stands in for ``zstandard`` while the writer runs without it."""

    class ZstdCompressor:
        def __init__(self, level=3):
            pass

        @staticmethod
        def compress(raw: bytes) -> bytes:
            return _raw_zstd_frame(raw)


def layout_data(seed: int) -> dict:
    """The source arrays of ``path_layouts``: registry id -> TCZYX data."""
    rng = np.random.default_rng(seed + 13)
    yy, xx = np.mgrid[0:LAYOUT_SIZE, 0:LAYOUT_SIZE].astype(np.float32)
    field = 2000 + 1500 * np.sin(xx / 71.0) * np.cos(yy / 89.0)
    out = {}
    for rid in (10, 12, 13, 14, 15, ROMIO_ID):
        u16 = (field + rng.normal(0, 80, field.shape)).clip(0, 65535).astype(np.uint16)
        out[rid] = u16[None, None, None]
    out[11] = ((field / 16) + rng.normal(0, 3, field.shape)).clip(0, 255).astype(np.uint8)[
        None, None, None]
    out[10] = out[10][..., :512, :512].copy()
    out[ROMIO_ID] = np.stack([out[ROMIO_ID][0, 0], out[13][0, 0]])[None]  # C = 2
    out[F32_ID] = np.stack([(field - 2000) * (c + 1) / 2 + rng.normal(0, 50, field.shape)
                            for c in range(3)]).astype(np.float32)[None, :, None]
    return out


def write_wsi_fixtures(wsi: np.ndarray, layouts: dict) -> tuple:
    """Image 3 (the JPEG RGB pyramid), the layout fixtures and a ROMIO
    plane file, with their registry: (registry path, image 3 path, zstd
    written with the real codec or not)."""
    from omero_ms_pixel_buffer_tpu_torch.io.ometiff import write_ome_tiff
    from omero_ms_pixel_buffer_tpu_torch.io.romio import write_romio

    os.makedirs(WORK, exist_ok=True)
    wsi_path = os.path.join(WORK, "wsi.tif")
    write_ome_tiff(wsi_path, wsi[None, None, None], tile_size=(WSI_TILE, WSI_TILE),
                   pyramid_levels=wsi_levels(wsi.shape[0]), compression="jpeg",
                   jpeg_quality=85, jpeg_subsampling=2, ome_xml=False)
    images = [{"id": 3, "path": wsi_path, "name": "wsi"}]
    try:
        import zstandard  # noqa: F401
        real_zstd = True
    except ImportError:
        real_zstd = False
    for rid, (name, kw) in LAYOUTS.items():
        path = os.path.join(WORK, f"{name}.ome.tif")
        kw = {"tile_size": (WSI_TILE, WSI_TILE), **kw}
        if kw["compression"] == "zstd" and not real_zstd:
            missing = "zstandard" not in sys.modules
            held = sys.modules.get("zstandard")
            sys.modules["zstandard"] = _RawZstd
            try:
                write_ome_tiff(path, layouts[rid], **kw)
            finally:
                if missing:
                    del sys.modules["zstandard"]
                else:
                    sys.modules["zstandard"] = held
        else:
            write_ome_tiff(path, layouts[rid], **kw)
        images.append({"id": rid, "path": path, "name": name})
    romio = os.path.join(WORK, "Pixels", str(ROMIO_ID))
    os.makedirs(os.path.dirname(romio), exist_ok=True)
    write_romio(romio, layouts[ROMIO_ID])
    images.append({"id": ROMIO_ID, "path": romio, "type": "romio", "sizeX": LAYOUT_SIZE,
                   "sizeY": LAYOUT_SIZE, "sizeZ": 1, "sizeC": 2, "sizeT": 1,
                   "pixelsType": "uint16"})
    registry = os.path.join(WORK, "registry_wsi.json")
    with open(registry, "w") as f:
        json.dump({"images": images}, f)
    return registry, wsi_path, real_zstd


class HostDecode:
    """The port's host decode (islow IDCT) of image 3's regions: the
    reference every ``/tile`` body of the WSI phases is held against."""

    def __init__(self, path: str):
        from omero_ms_pixel_buffer_tpu_torch.io.ometiff import OmeTiffPixelBuffer

        self.buf = OmeTiffPixelBuffer(path)

    def region(self, level, x, y, w, h) -> np.ndarray:
        saved = os.environ.pop("OMPB_JPEG_DEVICE_IDCT", None)
        try:
            return self.buf.get_tile_at(level, 0, 0, 0, x, y, w, h)
        finally:
            if saved is not None:
                os.environ["OMPB_JPEG_DEVICE_IDCT"] = saved

    def pillow_tile(self, x, y) -> np.ndarray:
        """Pillow's decode of the level-0 JPEG tile at (x, y): its stream
        with the tag-347 tables spliced in, an independent oracle of
        ``region`` on the grid."""
        from PIL import Image

        ifd = self.buf.ifds[0]
        i = (y // WSI_TILE) * (self.buf.level_size(0)[0] // WSI_TILE) + x // WSI_TILE
        off, cnt = ifd.values("TILE_OFFSETS")[i], ifd.values("TILE_COUNTS")[i]
        stream = ifd.values("JPEG_TABLES")[0][:-2] + bytes(self.buf.mm[off + 2: off + cnt])
        return np.asarray(Image.open(io.BytesIO(stream)).convert("RGB"))

    def close(self) -> None:
        self.buf.close()


def wsi_requests(ref: HostDecode, seed: int, n: int, levels=(0, 1)):
    """A DeepZoom-style raster sweep: per level, rows of 16 adjacent 256x256
    tiles from a seeded origin on the tile grid, ``n`` in all."""
    rng = np.random.default_rng(seed + 17)
    reqs = []
    per_level = [n // len(levels) + (k < n % len(levels)) for k in range(len(levels))]
    for level, count in zip(levels, per_level):
        w, h = ref.buf.level_size(level)
        cols, rows = w // WSI_TILE, h // WSI_TILE
        span = min(16, cols)
        need_rows = -(-count // span)
        c0 = int(rng.integers(0, cols - span + 1))
        r0 = int(rng.integers(0, max(1, rows - need_rows + 1)))
        for k in range(count):
            x = (c0 + k % span) * WSI_TILE
            y = ((r0 + k // span) % rows) * WSI_TILE
            reqs.append((f"/tile/3/0/0/0?x={x}&y={y}&w={WSI_TILE}&h={WSI_TILE}"
                         f"&format=png&resolution={level}", (level, x, y, WSI_TILE, WSI_TILE),
                         200))
    return reqs


def wsi_tiles(ref: HostDecode, seed: int, n: int = LANES) -> np.ndarray:
    """``n`` host-decoded 256x256 RGB tiles of level 0 at seeded grid spots."""
    rng = np.random.default_rng(seed + 19)
    w, h = ref.buf.level_size(0)
    spots = rng.integers(0, [w // WSI_TILE, h // WSI_TILE], (n, 2)) * WSI_TILE
    return np.stack([ref.region(0, int(x), int(y), WSI_TILE, WSI_TILE) for x, y in spots])


def check_wsi_kernels(torch, device, tiles: np.ndarray):
    """The filter (bpp 3) and the scalar-prefetch packer at the WSI shape:
    32 RGB8 lanes of 256x256 from image 3, and the packer on their real
    ``dynamic`` pass-2 tokens, each byte-equal to its plain version (every
    lane's stream inflates back). Returns the kernel rows."""
    from omero_ms_pixel_buffer_tpu_torch.ops import device_deflate as dd
    from omero_ms_pixel_buffer_tpu_torch.ops.kernels.bitpack import (
        pack_tokens_sp,
        pack_tokens_sp_plain,
    )
    from omero_ms_pixel_buffer_tpu_torch.ops.kernels.filter import (
        filter_tiles,
        filter_tiles_plain,
    )

    rgb = torch.from_numpy(tiles).to(device)
    got, want = filter_tiles(rgb, "up"), filter_tiles_plain(rgb, "up")
    torch.cuda.synchronize()
    f_err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max().item())
    require(torch.equal(got, want), "filter kernel != plain on WSI RGB lanes")
    f_call = time_ms(torch, lambda: filter_tiles(rgb, "up"))
    f_ms = kernel_ms(torch, lambda: filter_tiles(rgb, "up"), "filter_row_groups")
    f_plain = time_ms(torch, lambda: filter_tiles_plain(rgb, "up"))
    f_bytes = rgb.numel() + got.numel()
    row_bytes = 1 + WSI_TILE * 3
    flat, counts, extras, real = dd.fused_filter_histogram_batch(rgb, WSI_TILE, row_bytes, 3)
    tables = dd.build_dynamic_tables(counts.cpu().numpy(), extras.cpu().numpy(), real=real)
    bits, nbits = dd.emit_tokens(flat, dd.tables_from_numpy(tables, device))
    maxbits = dd._packing_maxbits(flat.shape[1])
    got_p, got_t = pack_tokens_sp(bits, nbits, maxbits)
    want_p, want_t = pack_tokens_sp_plain(bits, nbits, maxbits)
    torch.cuda.synchronize()
    b_err = int((got_p.to(torch.int64) - want_p.to(torch.int64)).abs().max().item())
    require(torch.equal(got_p, want_p) and torch.equal(got_t, want_t),
            "bitpack kernel != plain on WSI pass-2 tokens")
    streams, lengths = dd._frame_lanes(flat, got_p, got_t, eob_bits=0)
    streams_np, lengths_np, flat_np = (streams.cpu().numpy(), lengths.cpu().numpy(),
                                       flat.cpu().numpy())
    for i in range(real):
        require(zlib.decompress(streams_np[i, : lengths_np[i]].tobytes())
                == flat_np[i].tobytes(), f"WSI lane {i} dynamic stream does not inflate back")
    call = lambda: pack_tokens_sp(bits, nbits, maxbits)  # noqa: E731
    b_call = time_ms(torch, call)
    b_ms = call_device_ms(torch, call)
    b_plain = time_ms(torch, lambda: pack_tokens_sp_plain(bits, nbits, maxbits), iters=5)
    b_bytes = 8 * bits.numel() + bits.shape[0] * maxbits // 8
    return [
        {"name": "filter_wsi_rgb8", "route": "cuda",
         "source": "omero_ms_pixel_buffer_tpu_torch/csrc/filter.cu",
         "replaces": "omero_ms_pixel_buffer_tpu/ops/pallas/filter.py:137",
         "shape": list(rgb.shape), "max_abs_err": f_err, "ms": f_ms if f_ms else f_call,
         "ms_from": "profiler" if f_ms else "events", "call_ms": f_call, "plain_ms": f_plain,
         "bound_ms": f_bytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes", "library_ms": None},
        {"name": "bitpack_wsi", "route": "cuda",
         "source": "omero_ms_pixel_buffer_tpu_torch/csrc/bitpack.cu",
         "replaces": "omero_ms_pixel_buffer_tpu/ops/pallas/bitpack.py:201",
         "shape": list(bits.shape), "max_abs_err": b_err, "ms": b_ms if b_ms else b_call,
         "ms_from": "profiler" if b_ms else "events", "call_ms": b_call, "plain_ms": b_plain,
         "bound_ms": b_bytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes", "library_ms": None,
         "stream_bytes_mean": float(lengths_np[:real].mean())},
    ]


def idct_f64(coefs: np.ndarray, q: np.ndarray) -> np.ndarray:
    """The float IDCT in float64 numpy: the reference of the card's."""
    from omero_ms_pixel_buffer_tpu_torch.io.jpeg import _A

    deq = (coefs.astype(np.int64) * q[None, :]).astype(np.float64).reshape(-1, 8, 8)
    basis = _A.astype(np.float64)
    s = np.einsum("uy,nuv,vx->nyx", basis, deq, basis)
    return np.clip(np.round(s) + 128.0, 0, 255).astype(np.uint8)


def check_idct(torch, device, wsi_path: str, seed: int, n_tiles: int = 10) -> dict:
    """``idct``: ``idct_blocks_torch`` on the card against its CPU version
    and the float64 numpy IDCT on every coefficient block of ``n_tiles``
    JPEG tiles of image 3 (caught from the host decode), equal with TF32
    allowed and not; its device time at N = 1024 blocks beside the byte
    bound ((N, 64) int32 in, (N, 64) uint8 out)."""
    from omero_ms_pixel_buffer_tpu_torch.io import jpeg as pj
    from omero_ms_pixel_buffer_tpu_torch.io.ometiff import OmeTiffPixelBuffer

    buf = OmeTiffPixelBuffer(wsi_path)
    try:
        ifd = buf.ifds[0]
        tables = pj.parse_tables(ifd.values("JPEG_TABLES")[0])
        offs, cnts = ifd.values("TILE_OFFSETS"), ifd.values("TILE_COUNTS")
        picks = np.random.default_rng(seed + 23).choice(len(offs), n_tiles, replace=False)
        caught = []
        host_idct = pj.idct_blocks_host

        def grab(c, q):
            caught.append((c.copy(), q.copy()))
            return host_idct(c, q)

        pj.idct_blocks_host = grab
        try:
            for i in picks:
                pj.decode_jpeg(bytes(buf.mm[offs[i]: offs[i] + cnts[i]]), tables=tables,
                               idct_mode="host")
        finally:
            pj.idct_blocks_host = host_idct
    finally:
        buf.close()
    err_f64 = err_cpu = 0
    blocks = 0
    flag = torch.backends.cuda.matmul.allow_tf32
    try:
        for coefs, q in caught:
            torch.backends.cuda.matmul.allow_tf32 = False
            off = pj.idct_blocks_torch(coefs, q, device).cpu().numpy()
            torch.backends.cuda.matmul.allow_tf32 = True
            on = pj.idct_blocks_torch(coefs, q, device).cpu().numpy()
            require(np.array_equal(on, off), "device IDCT moved with allow_tf32")
            cpu = pj.idct_blocks_torch(coefs, q, "cpu").numpy()
            err_f64 = max(err_f64, int(np.abs(off.astype(int) - idct_f64(coefs, q)).max()))
            err_cpu = max(err_cpu, int(np.abs(off.astype(int) - cpu.astype(int)).max()))
            blocks += coefs.shape[0]
    finally:
        torch.backends.cuda.matmul.allow_tf32 = flag
    require(err_f64 <= 1, f"device IDCT {err_f64} counts from float64")
    require(err_cpu <= 1, f"device IDCT {err_cpu} counts from its CPU version")
    luma = np.concatenate([c for c, _ in caught[::3]])[:1024]
    c_dev = torch.from_numpy(luma).to(device)
    q_dev = torch.from_numpy(caught[0][1]).to(device)
    call = lambda: pj.idct_blocks_torch(c_dev, q_dev, device)  # noqa: E731
    nbytes = luma.shape[0] * 64 * 4 + luma.shape[0] * 64
    return {"phase": "idct", "tiles": n_tiles, "blocks": blocks,
            "max_abs_err_vs_float64": err_f64, "max_abs_err_vs_cpu": err_cpu,
            "tf32_independent": True, "allow_tf32_flag": flag,
            "n_blocks_timed": int(luma.shape[0]),
            "ms": call_device_ms(torch, call), "call_ms": time_ms(torch, call),
            "cpu_ms": _host_ms(lambda: pj.idct_blocks_torch(luma, caught[0][1], "cpu")),
            "bytes": nbytes, "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
            "by_kernel": device_breakdown(torch, call, iters=10)}


def _host_ms(fn, iters: int = 5) -> float:
    fn()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) / iters * 1e3


def reads_delta(before: dict, after: dict, seconds: float) -> dict:
    """The host reads between two ``/healthz`` views: the read stage's
    milliseconds (plane-cache staging reads included, and counted apart),
    their share of the ``handle_batch`` time they sit in, and
    thread-seconds of reading per wall second."""
    b, a = before["reads"], after["reads"]
    read_ms = a["ms_total"] - b["ms_total"]
    batch_ms = a["batch_ms_total"] - b["batch_ms_total"]
    lanes = a["lanes"] - b["lanes"]
    return {"calls": a["calls"] - b["calls"], "lanes": lanes, "read_ms": read_ms,
            "read_ms_per_lane": read_ms / lanes if lanes else None,
            "batch_ms": batch_ms, "read_share_of_batch": read_ms / batch_ms if batch_ms else None,
            "read_busy_share": read_ms / 1e3 / seconds,
            "stage_reads": a["stage_reads"] - b["stage_reads"],
            "stage_read_ms": a["stage_ms_total"] - b["stage_ms_total"],
            "rgb_device_lanes": a["rgb_device_lanes"] - b["rgb_device_lanes"]}


def drive_wsi(registry: str, ref: HostDecode, seed: int, n_requests: int,
              device_idct: bool = False, device: str = "cuda") -> dict:
    """``path_wsi`` (or ``path_wsi_device_idct``): a server with the
    defaults (``OMPB_JPEG_DEVICE_IDCT=1`` for the second); 32 warm-up
    tiles of level 2, then ``n_requests`` 256x256 PNG tiles of a raster
    sweep over levels 0 and 1 at concurrency 32, timed. Every body is
    decoded (colour type 2) and held against the port's host decode:
    equal, or within 3 with the device IDCT (its pixels that differ are
    counted; the JAX device mode is 3 from its host mode on RGB streams).
    The host decode of every level-0 tile is held against Pillow's."""
    from omero_ms_pixel_buffer_tpu_torch.ops.kernels import (
        launch_counts,
        reset_launch_counts,
    )

    phase = "path_wsi_device_idct" if device_idct else "path_wsi"
    saved = os.environ.get("OMPB_JPEG_DEVICE_IDCT")
    os.environ["OMPB_JPEG_DEVICE_IDCT"] = "1" if device_idct else "0"
    try:
        with ServerThread(registry, device=device) as client:
            reset_launch_counts()
            warm = wsi_requests(ref, seed + 1, LANES,
                                levels=(min(2, ref.buf.resolution_levels - 1),))
            warm_out = run_requests(client, warm, LANES)[0]
            reqs = wsi_requests(ref, seed + (7 if device_idct else 0), n_requests)
            before = get_json(client, "/healthz")
            out, seconds = run_requests(client, reqs, LANES)
            after = get_json(client, "/healthz")
            launches = launch_counts()
    finally:
        if saved is None:
            os.environ.pop("OMPB_JPEG_DEVICE_IDCT", None)
        else:
            os.environ["OMPB_JPEG_DEVICE_IDCT"] = saved
    max_diff, diff_px, checked, pillow_checked = 0, 0, 0, 0
    for (status, body, _), (path, (level, x, y, w, h), want) in zip(warm_out + out, warm + reqs):
        require(status == want, f"{path} answered {status}, expected {want}")
        got = decode_png(body)
        expect = ref.region(level, x, y, w, h)
        require(got.shape == expect.shape == (h, w, 3), f"{path}: not an RGB tile")
        if level == 0:
            require(np.array_equal(expect, ref.pillow_tile(x, y)),
                    f"{path}: the host decode differs from Pillow's")
            pillow_checked += 1
        d = np.abs(got.astype(int) - expect.astype(int))
        max_diff, diff_px = max(max_diff, int(d.max())), diff_px + int((d > 0).sum())
        checked += 1
    if device_idct:
        require(max_diff <= 3, f"{phase}: {max_diff} counts from the host decode")
    else:
        require(max_diff == 0, f"{phase}: pixels differ from the host decode")
    lat_ms = np.array([r[2] for r in out]) * 1e3
    require(pillow_checked > 0, f"{phase}: no level-0 tile held against Pillow")
    require(launches["filter"] > 0 and launches["bitpack"] > 0,
            f"{phase}: the filter or the SP packer never launched: {launches}")
    reads = reads_delta(before, after, seconds)
    require(reads["rgb_device_lanes"] > 0, f"{phase}: no RGB lane went to the device")
    require(after["queue"]["failed"] == 0, f"{phase}: encode groups failed: {after['queue']}")
    jb, ja = before["jpeg"], after["jpeg"]
    calls = ja["device_idct_calls"] - jb["device_idct_calls"]
    if device_idct:
        require(calls > 0 and ja["device_idct_failed"] == 0,
                f"{phase}: device IDCT calls {calls}, failed {ja['device_idct_failed']}")
    else:
        require(ja["device_idct_calls"] == 0, f"{phase}: device IDCT ran in host mode")
    timed = ja["device_idct_timed_calls"] - jb["device_idct_timed_calls"]
    return {
        "phase": phase, "requests": n_requests, "concurrency": LANES,
        "tiles_verified": checked, "host_tiles_equal_to_pillow": pillow_checked,
        "max_abs_diff_vs_host": max_diff,
        "pixels_differing": diff_px, "launches": launches,
        "tiles_per_s": n_requests / seconds, "p50_ms": float(np.percentile(lat_ms, 50)),
        "p99_ms": float(np.percentile(lat_ms, 99)),
        "stream_bytes_mean": float(np.mean([png_stream_len(r[1]) for r in out])),
        "timed_window": timed_window(before, after, seconds), "reads": reads,
        "jpeg": {"device_idct_calls": calls,
                 "device_idct_blocks": ja["device_idct_blocks"] - jb["device_idct_blocks"],
                 # CUDA-event span on the IDCT stream: concurrent readers
                 # and GIL waits inflate it over the device time alone
                 "span_ms_per_call": ((ja["device_idct_span_ms_total"]
                                       - jb["device_idct_span_ms_total"]) / timed
                                      if timed else None)},
        "queue": after["queue"], "gpu": after["gpu"],
    }


def _layout_requests(rid: int, data: np.ndarray, c: int = 0):
    """/tile PNG (an aligned tile, a 300x200 region across blocks, the
    corner), raw and TIF requests of one layout fixture's channel c."""
    n = data.shape[-1]
    regions = [(n // 4, n // 2, 256, 256, "png"), (100, 70, 300, 200, "png"),
               (n - 100, n - 60, 100, 60, "png"), (33, 44, 120, 90, None),
               (n // 2 - 100, n // 4, 200, 150, "tif")]
    out = []
    for x, y, w, h, fmt in regions:
        q = f"x={x}&y={y}&w={w}&h={h}" + (f"&format={fmt}" if fmt else "")
        out.append((f"/tile/{rid}/0/{c}/0?{q}", fmt, data[0, c, 0, y:y + h, x:x + w]))
    return out


def _check_tile(body: bytes, fmt, want: np.ndarray, path: str) -> None:
    from omero_ms_pixel_buffer_tpu_torch.ops.tiff import decode_tiff

    if fmt == "png":
        got = decode_png(body)
    elif fmt == "tif":
        got = decode_tiff(body)
    else:
        got = np.frombuffer(body, want.dtype.newbyteorder(">")).reshape(want.shape)
    require(np.array_equal(got, want), f"{path}: pixels differ from the source")


def drive_layouts(registry: str, layouts: dict, real_zstd: bool, device: str = "cuda") -> dict:
    """``path_layouts``: a server with the defaults; ``/tile`` PNG, raw and
    TIF of every layout fixture and of the ROMIO image, each checked
    against its source array; ``/render`` (windowed composite, intmax
    projection off a single z) and ``/histogram`` of the float image
    against the port's own quantization and tables in numpy; a float
    render without windows answers 404; the zstd image answers 404
    without the ``zstandard`` package, and its pixels with it."""
    from urllib.parse import parse_qsl

    from omero_ms_pixel_buffer_tpu_torch.render import analysis as ranalysis
    from omero_ms_pixel_buffer_tpu_torch.render import engine as rengine
    from omero_ms_pixel_buffer_tpu_torch.render.luts import LutRegistry
    from omero_ms_pixel_buffer_tpu_torch.render.model import RenderSpec

    reqs = []
    for rid in LAYOUTS:
        if rid != F32_ID:
            reqs += [(rid,) + r for r in _layout_requests(rid, layouts[rid])]
    for c in range(2):
        reqs += [(ROMIO_ID,) + r for r in _layout_requests(ROMIO_ID, layouts[ROMIO_ID], c)]
    f32 = layouts[F32_ID][0, :, 0]
    render = []
    for x, y, w, h, extra in ((0, 0, 256, 256, ""), (300, 200, 256, 256, ""),
                              (256, 256, 200, 100, "&m=g"), (512, 0, 256, 256, "&p=intmax")):
        query = f"c={F32_C}{extra}" if "m=g" not in extra else "c=2|0:3000&m=g"
        render.append((f"/render/{F32_ID}/0/0/0?x={x}&y={y}&w={w}&h={h}&{query}&format=png",
                       (x, y, w, h), dict(parse_qsl(query))))
    hist = [(f"/histogram/{F32_ID}/0/0/0?x={x}&y={y}&w={w}&h={h}&c=1,2,3&bins={b}",
             (x, y, w, h), b) for x, y, w, h, b in ((0, 0, 256, 256, 256),
                                                     (100, 200, 300, 200, 1000))]
    edge = [(f"/render/{F32_ID}/0/0/0?x=0&y=0&w=64&h=64&c=1,2&format=png", 404),
            (f"/tile/{F32_ID}/0/0/0?x=0&y=0&w=64&h=64&format=png", 404)]
    with ServerThread(registry, device=device) as client:
        tile_out = run_requests(client, [(r[1],) for r in reqs], 16)[0]
        render_out = run_requests(client, [(r[0],) for r in render], 8)[0]
        hist_out = run_requests(client, [(r[0],) for r in hist], 2)[0]
        edge_out = [client.get(path) for path, _ in edge]
        health = get_json(client, "/healthz")
    checked, zstd_404 = 0, 0
    for (status, body, _), (rid, path, fmt, want) in zip(tile_out, reqs):
        if rid == 12 and not real_zstd:
            require(status == 404, f"{path}: zstd without zstandard answered {status}")
            zstd_404 += 1
            continue
        require(status == 200, f"{path} answered {status}")
        _check_tile(body, fmt, want, path)
        checked += 1
    luts = LutRegistry()
    for (status, body, _), (path, (x, y, w, h), query) in zip(render_out, render):
        require(status == 200, f"{path} answered {status}")
        spec = RenderSpec.from_params(query, default_channel=0)
        chans = spec.resolve_channels(3)
        planes = np.stack([rengine.quantize_to_u16(f32[ch.index, y:y + h, x:x + w], ch.window)
                           for ch in chans])
        tables, clut = rengine.build_tables(spec.without_windows(), np.dtype(np.uint16), luts)
        acc = np.zeros((h, w, 3), np.int64)
        for k in range(tables.shape[0]):
            acc += clut[k][tables[k][planes[k]]]
        require(np.array_equal(decode_png(body), np.minimum(acc, 255).astype(np.uint8)),
                f"{path}: pixels differ from the numpy composite")
        checked += 1
    for (status, body, _), (path, (x, y, w, h), bins) in zip(hist_out, hist):
        require(status == 200, f"{path} answered {status}")
        doc = json.loads(body)
        for c, ch in enumerate(doc["channels"]):
            plane = f32[c, y:y + h, x:x + w]
            window = ranalysis.resolve_window(
                ranalysis.HistogramSpec.from_params({"c": str(c + 1)}).channels[0],
                np.dtype(np.float32), False, plane=plane)
            idx = ranalysis.quant_bin_table(bins)[rengine.quantize_to_u16(plane, window)]
            require(ch["counts"] == np.bincount(idx.ravel(), minlength=bins).tolist(),
                    f"{path}: channel {c} counts differ")
        checked += 1
    for (status, _, _), (path, want) in zip(edge_out, edge):
        require(status == want, f"{path} answered {status}, expected {want}")
    require(health["queue"]["failed"] == 0, f"path_layouts: encode groups failed")
    return {"phase": "path_layouts", "fixtures": {rid: name for rid, (name, _) in LAYOUTS.items()},
            "romio": ROMIO_ID, "zstandard": real_zstd, "zstd_404": zstd_404,
            "responses_verified": checked, "edge_statuses": [s for s, _, _ in edge_out],
            "analysis": health["analysis"], "reads": health["reads"]}


# ---------------------------------------------------------------------------
# OME-NGFF / Zarr sources: images 4 (filesystem) and 5 (an S3 stub)
# ---------------------------------------------------------------------------

ZARR_CHUNK = 1024  # image 4: bioformats2raw's default tile size
ZARR5_SIZE, ZARR5_SHARD, ZARR5_INNER, ZARR5_LEVELS = 4096, 2048, 512, 3
ZARR_ABSENT = (3, 5)  # image 4's level-0 chunk (row, column) deleted after writing
ZARR_OUTAGE = 8  # sequential requests while the S3 stub is stopped
S3_BUCKET, S3_ACCESS, S3_SECRET = "smoke-bucket", "AKIASMOKE", "smoke/secret"


def zarr_levels(size: int) -> int:
    """Image 4's levels: 2x downsamples while a level keeps a whole chunk."""
    n = 1
    while size // 2 >= ZARR_CHUNK:
        size //= 2
        n += 1
    return n


def _blosc_job(job):
    """One blosc frame, compressed in a pool process by the port's codec."""
    from omero_ms_pixel_buffer_tpu_torch.ops.blosc import blosc_compress

    raw, kwargs = job
    return blosc_compress(raw, **kwargs)


def write_ngff_pooled(root: str, data: np.ndarray, pool, **kw) -> int:
    """The port's ``write_ngff`` with its blosc frames compressed in the
    process ``pool`` (the pure-Python LZ4 takes about a second a 1024²
    chunk on one core): a first pass records every frame the writer asks
    for, the pool compresses them, a second pass writes the tree from the
    results. One frame is held against the codec called here. Returns the
    number of frames."""
    import hashlib
    import shutil

    from omero_ms_pixel_buffer_tpu_torch.io import zarr as pzarr

    codec = pzarr.blosc_compress
    jobs = {}

    def key(raw, kwargs):
        return hashlib.sha256(raw).digest(), tuple(sorted(kwargs.items()))

    def record(raw, **kwargs):
        jobs.setdefault(key(raw, kwargs), (raw, kwargs))
        return b""

    pzarr.blosc_compress = record
    try:
        pzarr.write_ngff(root, data, **kw)
        keys = list(jobs)
        frames = dict(zip(keys, pool.map(_blosc_job, [jobs[k] for k in keys], chunksize=1)))
        pzarr.blosc_compress = lambda raw, **kwargs: frames[key(raw, kwargs)]
        shutil.rmtree(root)
        pzarr.write_ngff(root, data, **kw)
    finally:
        pzarr.blosc_compress = codec
    raw, kwargs = jobs[keys[0]]
    require(codec(raw, **kwargs) == frames[keys[0]], "a pooled blosc frame differs from the codec's")
    return len(keys)


def make_zarr_images(size: int, seed: int):
    """Image 4: one ``size``² uint16 plane (TCZYX (1, 1, 1, size, size)),
    a smooth field plus noise; image 5: (1, 3, 1, 4096, 4096) uint16, three
    smooth fields plus noise."""
    return (make_field(size, seed + 4)[None, None, None],
            make_stack(ZARR5_SIZE, seed + 5)[None, :, :1])


def write_zarr_fixtures(img4: np.ndarray, img5: np.ndarray) -> dict:
    """Image 4 as NGFF 0.4 (Zarr v2): 1024² chunks, blosc lz4 clevel 5 with
    byte shuffle, levels down to 1024 (bioformats2raw's defaults), one
    level-0 chunk object deleted afterwards (it reads as the fill value);
    image 5 as NGFF 0.5 (Zarr v3): 2048² shards of 512² inner chunks, inner
    blosc lz4 with shuffle, crc32c on chunks and shard indexes, 3 levels.
    Both written by the port's ``write_ngff``, blosc frames compressed in a
    process pool. Returns the registry path, roots, frame counts and times."""
    import multiprocessing

    os.makedirs(WORK, exist_ok=True)
    root4, root5 = os.path.join(WORK, "zarr4.zarr"), os.path.join(WORK, "zarr5.zarr")
    workers = len(os.sched_getaffinity(0))
    spawn = multiprocessing.get_context("spawn")  # no fork of a process holding CUDA
    with concurrent.futures.ProcessPoolExecutor(workers, mp_context=spawn) as pool:
        t0 = time.perf_counter()
        frames4 = 0 if img4 is None else write_ngff_pooled(
            root4, img4, pool, chunks=(ZARR_CHUNK, ZARR_CHUNK),
            levels=zarr_levels(img4.shape[-1]), compressor="blosc-lz4", level_arg=5)
        t4 = time.perf_counter() - t0
        frames5 = write_ngff_pooled(root5, img5, pool, chunks=(ZARR5_INNER, ZARR5_INNER),
                                    levels=ZARR5_LEVELS, compressor="blosc-lz4", level_arg=5,
                                    zarr_format=3, shards=(ZARR5_SHARD, ZARR5_SHARD))
        t5 = time.perf_counter() - t0 - t4
    if img4 is not None:
        os.remove(os.path.join(root4, "0", "0.0.0.%d.%d" % ZARR_ABSENT))
    registry = os.path.join(WORK, "registry_zarr.json")
    with open(registry, "w") as f:
        json.dump({"images": [
            {"id": 4, "path": root4, "name": "ngff-0.4"},
            {"id": 5, "path": f"s3://{S3_BUCKET}/zarr5.zarr", "type": "zarr",
             "name": "ngff-0.5"}]}, f)

    def tree_bytes(root):
        return sum(os.path.getsize(os.path.join(d, n)) for d, _, fs in os.walk(root) for n in fs)

    return {"registry": registry, "root4": root4, "root5": root5, "workers": workers,
            "frames": [frames4, frames5], "write_s": [t4, t5],
            "bytes": [0 if img4 is None else tree_bytes(root4), tree_bytes(root5)]}


class S3Stub:
    """A path-style S3 endpoint on 127.0.0.1 over ``WORK``: it checks every
    request's SigV4 signature (the port's signer with the stub's secret;
    a Range header must be signed; a write's payload sha256 must be its
    body's), answers ranged GETs with 206, takes PUTs and multipart
    uploads (create, part, complete against the parts' MD5 ETags, abort;
    the key appears whole at complete), and counts requests (``writes``
    by kind). ``stop`` closes it and its keep-alive connections; ``start``
    opens it again on the same port."""

    def __init__(self, root: str):
        self.root, self.port, self.server = root, 0, None
        self.conns: set = set()
        self.requests = 0
        self.writes: dict = {}
        self.uploads: dict = {}
        self.lock = threading.Lock()

    def _handler(self):
        import datetime
        import re
        from http.server import BaseHTTPRequestHandler
        from urllib.parse import unquote

        from omero_ms_pixel_buffer_tpu_torch.io.stores import sigv4_headers

        stub = self
        auth_re = re.compile(r"AWS4-HMAC-SHA256 Credential=([^/]+)/\d+/([^/]+)/s3/aws4_request, "
                             r"SignedHeaders=([^,]+), Signature=([0-9a-f]+)")

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *args):
                pass

            def setup(self):
                super().setup()
                with stub.lock:
                    stub.conns.add(self.connection)

            def finish(self):
                with stub.lock:
                    stub.conns.discard(self.connection)
                super().finish()

            def _reply(self, code, body=b""):
                self.send_response(code)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _verified(self, body: bytes):
                """(path, query) of a correctly signed request, else None
                after a 403."""
                import hashlib
                from urllib.parse import parse_qsl

                m = auth_re.match(self.headers.get("Authorization", ""))
                if m is None or m.group(1) != S3_ACCESS:
                    self._reply(403, b"AccessDenied")
                    return None
                _, region, signed, signature = m.groups()
                payload = self.headers.get("x-amz-content-sha256", "")
                if self.command != "GET" and payload != hashlib.sha256(body).hexdigest():
                    self._reply(403, b"XAmzContentSHA256Mismatch")
                    return None
                rng = self.headers.get("Range")
                if rng is not None and "range" not in signed.split(";"):
                    self._reply(403, b"unsigned Range")
                    return None
                path, _, raw_query = self.path.partition("?")
                query = dict(parse_qsl(raw_query, keep_blank_values=True))
                now = datetime.datetime.strptime(
                    self.headers.get("x-amz-date", ""), "%Y%m%dT%H%M%SZ"
                ).replace(tzinfo=datetime.timezone.utc)
                want = sigv4_headers(self.command, self.headers["Host"], path, region,
                                     S3_ACCESS, S3_SECRET, payload_sha256=payload, now=now,
                                     extra_headers={"range": rng} if rng else None,
                                     query=query or None)
                if want["authorization"].rsplit("Signature=", 1)[1] != signature:
                    self._reply(403, b"SignatureDoesNotMatch")
                    return None
                return path, query

            def _file(self, path: str):
                prefix = f"/{S3_BUCKET}/"
                rel = unquote(path[len(prefix):]) if path.startswith(prefix) else ""
                if not rel or ".." in rel.split("/"):
                    return None
                return os.path.join(stub.root, rel)

            def _count(self, kind: str) -> None:
                with stub.lock:
                    stub.requests += 1
                    stub.writes[kind] = stub.writes.get(kind, 0) + 1

            def _body(self) -> bytes:
                return self.rfile.read(int(self.headers.get("Content-Length", "0") or 0))

            def _write(self, target: str, data: bytes) -> None:
                os.makedirs(os.path.dirname(target), exist_ok=True)
                tmp = f"{target}.stub-{threading.get_ident()}"
                with open(tmp, "wb") as f:
                    f.write(data)
                os.replace(tmp, target)  # a key shows whole, as S3's do

            def do_PUT(self):
                body = self._body()
                got = self._verified(body)
                if got is None:
                    return
                path, query = got
                if "uploadId" in query:
                    self._count("UploadPart")
                    with stub.lock:
                        parts = stub.uploads.get(query["uploadId"])
                        if parts is not None:
                            parts[int(query["partNumber"])] = body
                    return self._reply(200 if parts is not None else 404)
                target = self._file(path)
                if target is None:
                    return self._reply(400, b"InvalidKey")
                self._count("PUT")
                self._write(target, body)
                self._reply(200)

            def do_POST(self):
                import hashlib

                body = self._body()
                got = self._verified(body)
                if got is None:
                    return
                path, query = got
                if "uploads" in query:
                    self._count("CreateMultipartUpload")
                    with stub.lock:
                        upload = f"up{len(stub.uploads) + sum(stub.writes.values())}"
                        stub.uploads[upload] = {}
                    return self._reply(200, (f"<InitiateMultipartUploadResult><UploadId>"
                                             f"{upload}</UploadId>"
                                             "</InitiateMultipartUploadResult>").encode())
                self._count("CompleteMultipartUpload")
                with stub.lock:
                    parts = stub.uploads.pop(query.get("uploadId", ""), None)
                target = self._file(path)
                if parts is None or target is None:
                    return self._reply(404, b"NoSuchUpload")
                listed = [int(n) for n in re.findall(rb"<PartNumber>(\d+)</PartNumber>", body)]
                etags = re.findall(rb"<ETag>&quot;([0-9a-f]+)&quot;</ETag>", body)
                if any(hashlib.md5(parts.get(n, b"")).hexdigest().encode() != e
                       for n, e in zip(listed, etags)):
                    return self._reply(200, b"<Error><Code>InvalidPart</Code></Error>")
                self._write(target, b"".join(parts[n] for n in listed))
                self._reply(200, b"<CompleteMultipartUploadResult/>")

            def do_DELETE(self):
                got = self._verified(b"")
                if got is None:
                    return
                self._count("AbortMultipartUpload")
                with stub.lock:
                    stub.uploads.pop(got[1].get("uploadId", ""), None)
                self._reply(204)

            def do_GET(self):
                with stub.lock:
                    stub.requests += 1
                got = self._verified(b"")
                if got is None:
                    return
                rng = self.headers.get("Range")
                prefix = f"/{S3_BUCKET}/"
                rel = unquote(self.path[len(prefix):]) if self.path.startswith(prefix) else ""
                path = os.path.join(stub.root, rel)
                if not rel or ".." in rel.split("/") or not os.path.isfile(path):
                    return self._reply(404, b"NoSuchKey")
                with open(path, "rb") as f:
                    data = f.read()
                if rng is None:
                    return self._reply(200, data)
                spec = rng.split("=", 1)[1]
                if spec.startswith("-"):
                    body = data[-int(spec[1:]):]
                else:
                    lo, _, hi = spec.partition("-")
                    if int(lo) >= len(data):
                        return self._reply(416)
                    body = data[int(lo):int(hi) + 1 if hi else len(data)]
                return self._reply(206, body)

        return Handler

    def start(self) -> str:
        from http.server import ThreadingHTTPServer

        self.server = ThreadingHTTPServer(("127.0.0.1", self.port), self._handler())
        self.port = self.server.server_address[1]
        threading.Thread(target=self.server.serve_forever, name="s3-stub", daemon=True).start()
        return f"http://127.0.0.1:{self.port}"

    def stop(self) -> None:
        import socket

        if self.server is None:
            return
        self.server.shutdown()
        self.server.server_close()
        self.server = None
        with self.lock:
            conns = list(self.conns)
        for conn in conns:  # keep-alive connections would go on answering
            try:
                conn.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass


def zarr_tile_requests(rng, image: int, size: int, n: int, level: int = 0,
                       channels: int = 1):
    """``n`` 512x512 PNG tiles of ``level`` (``size`` is that level's
    width) at distinct seeded random cells (channel, row, column) of its
    512 grid over ``channels``, cycling only when ``n`` exceeds the cells:
    [(path, (level, c, x, y), status)]."""
    grid = size // TILE
    cells = rng.permutation(channels * grid * grid)
    res = "" if level == 0 else f"&resolution={level}"
    reqs = []
    for k in range(n):
        c, cell = divmod(int(cells[k % len(cells)]), grid * grid)
        y, x = (v * TILE for v in divmod(cell, grid))
        reqs.append((f"/tile/{image}/0/{c}/0?x={x}&y={y}&w={TILE}&h={TILE}&format=png{res}",
                     (level, c, x, y), 200))
    return reqs


def chunk_warm_requests(rng, image: int, size: int, chunk: int, n: int, skip=None,
                        channels: int = 1):
    """Level-0 512x512 PNG tiles, one in each of ``n`` chunks (``chunk``
    wide; over ``channels``) drawn at random, ``skip`` (row, column) of
    channel 0 left out. Sent one at a time, each is a lone request that
    decodes its chunk well within the request budget; the timed window
    then stages the planes' other chunks (a cold plane staged while its
    batch also decodes lanes beside it, under one GIL, can outlast the
    15 s budget: 504)."""
    grid, per = size // chunk, chunk // TILE
    cells = [(i // (grid * grid),) + divmod(i % (grid * grid), grid)
             for i in (int(v) for v in rng.permutation(channels * grid * grid))]
    reqs = []
    for c, cy, cx in [cell for cell in cells if skip is None or cell != (0,) + skip][:n]:
        dy, dx = (int(v) for v in rng.integers(0, per, 2))
        x, y = cx * chunk + dx * TILE, cy * chunk + dy * TILE
        reqs.append((f"/tile/{image}/0/{c}/0?x={x}&y={y}&w={TILE}&h={TILE}&format=png",
                     (0, c, x, y), 200))
    return reqs


def verify_zarr(results, reqs, source) -> int:
    """Every PNG against ``source(level, c)``'s 512x512 region."""
    checked = 0
    for (status, body, _), (path, (level, c, x, y), want) in zip(results, reqs):
        require(status == want, f"{path} answered {status}, expected {want}")
        if status == 200:
            require(np.array_equal(decode_png(body),
                                   source(level, c)[y:y + TILE, x:x + TILE]),
                    f"{path}: pixels differ from the source")
            checked += 1
    return checked


def io_delta(before: dict, after: dict, n_requests: int) -> dict:
    """The read plane (``/healthz`` ``io``) between two views: store
    requests issued by the fetch planner (per tile the batched reads
    planned, and per timed request), coalescing, bytes, chunk decodes,
    and the connection pool after."""
    b, a = before["io"], after["io"]
    d = {k: a[k] - b[k] for k in ("planned", "issued", "ranged", "coalesced_saved",
                                  "bytes_fetched", "bytes_discarded", "fallbacks", "batches",
                                  "tiles", "decodes")}
    d["requests_per_tile"] = d["issued"] / d["tiles"] if d["tiles"] else None
    d["requests_per_request"] = d["issued"] / n_requests
    d["coalesced_ratio"] = d["coalesced_saved"] / d["planned"] if d["planned"] else 0.0
    d["pool"] = a["pool"]
    return d


def zarr_report(phase, n, out, secs, before, after, launches) -> dict:
    """The figures both Zarr phases report over their timed requests."""
    lat_ms = np.array([r[2] for r in out]) * 1e3
    return {"phase": phase, "requests": n, "concurrency": LANES, "launches": launches,
            "tiles_per_s": n / secs, "p50_ms": float(np.percentile(lat_ms, 50)),
            "p99_ms": float(np.percentile(lat_ms, 99)),
            "timed_window": timed_window(before, after, secs),
            "reads": reads_delta(before, after, secs), "io": io_delta(before, after, n),
            "plane_cache": after["plane_cache"], "queue": after["queue"], "gpu": after["gpu"]}


def drive_zarr(registry: str, img4: np.ndarray, seed: int, n_requests: int,
               device: str = "cuda") -> dict:
    """``path_zarr``: image 4 from the filesystem on a server with the
    defaults (``dynamic``, packer ``pallas``): 32 warm-up tiles one at a
    time, each in its own chunk (``chunk_warm_requests``), ``n_requests``
    timed 512x512 PNG tiles at concurrency 32 at distinct seeded random
    positions of the level-0 512 grid, the four tiles of the deleted chunk, then 64
    tiles of level 1. Every PNG is held against the source array (the
    deleted chunk's pixels against 0, the fill value)."""
    from omero_ms_pixel_buffer_tpu_torch.ops.kernels import launch_counts, reset_launch_counts

    plane = img4[0, 0, 0]
    level0 = plane.copy()
    ay, ax = ZARR_ABSENT
    level0[ay * ZARR_CHUNK:(ay + 1) * ZARR_CHUNK, ax * ZARR_CHUNK:(ax + 1) * ZARR_CHUNK] = 0

    def source(level, c):
        return level0 if level == 0 else plane[::2 ** level, ::2 ** level]

    size = plane.shape[0]
    rng = np.random.default_rng(seed + 40)
    warm = chunk_warm_requests(rng, 4, size, ZARR_CHUNK, LANES, skip=ZARR_ABSENT)
    per = ZARR_CHUNK // TILE
    absent = [(f"/tile/4/0/0/0?x={x}&y={y}&w={TILE}&h={TILE}&format=png", (0, 0, x, y), 200)
              for x, y in ((ax * ZARR_CHUNK + dx * TILE, ay * ZARR_CHUNK + dy * TILE)
                           for dy in range(per) for dx in range(per))]
    with ServerThread(registry, device=device) as client:
        reset_launch_counts()
        t0 = time.perf_counter()
        warm_out = run_requests(client, warm, 1)[0]
        warm_s = time.perf_counter() - t0
        main = zarr_tile_requests(rng, 4, size, n_requests)
        before = get_json(client, "/healthz")
        main_out, secs = run_requests(client, main, LANES)
        after = get_json(client, "/healthz")
        absent_out = run_requests(client, absent, len(absent))[0]
        lv1 = zarr_tile_requests(rng, 4, size // 2, 2 * LANES, level=1)
        lv1_out = run_requests(client, lv1, LANES)[0]
        launches = launch_counts()
        health = get_json(client, "/healthz")
    checked = (verify_zarr(warm_out, warm, source) + verify_zarr(main_out, main, source)
               + verify_zarr(absent_out, absent, source) + verify_zarr(lv1_out, lv1, source))
    require(launches["filter"] > 0 and launches["bitpack"] > 0,
            f"path_zarr: the filter or the SP packer never launched: {launches}")
    require(health["queue"]["failed"] == 0, f"path_zarr: encode groups failed: {health['queue']}")
    out = zarr_report("path_zarr", n_requests, main_out, secs, before, after, launches)
    out.update({"tiles_verified": checked, "absent_chunk_tiles": len(absent), "warmup_s": warm_s,
                "level1_tiles": len(lv1), "io_total": health["io"]})
    return out


def drive_zarr_s3(registry: str, img5: np.ndarray, seed: int, n_requests: int,
                  device: str = "cuda") -> dict:
    """``path_zarr_s3``: image 5 from the S3 stub on a server with the
    defaults: 32 warm-up tiles of channels 0 and 1 one at a time, each in
    its own inner chunk (``chunk_warm_requests``), ``n_requests`` timed
    512x512 PNG ``/tile`` tiles of channels 0 and 1 at concurrency 32 at
    distinct positions, 32 three-channel
    ``/render`` PNG tiles and 8 ``/histogram`` requests, each held against
    the source (numpy composite, ``np.bincount``). Then the stub stops:
    ``ZARR_OUTAGE`` sequential level-1 tiles must answer 404 while the
    store's retries fail and 503 with ``Retry-After`` once its breaker
    opens (its fifth failure), as the JAX package answers; the stub
    restarts, the breaker's open period is waited out, and the same tiles
    are served again."""
    from omero_ms_pixel_buffer_tpu_torch.ops.kernels import launch_counts, reset_launch_counts

    stack = img5[0]  # (3, 1, H, W)

    def source(level, c):
        return stack[c, 0, ::2 ** level, ::2 ** level]

    stub = S3Stub(WORK)
    env = {"OMPB_S3_ENDPOINT": stub.start(), "AWS_ACCESS_KEY_ID": S3_ACCESS,
           "AWS_SECRET_ACCESS_KEY": S3_SECRET, "AWS_REGION": "us-east-1",
           "AWS_SHARED_CREDENTIALS_FILE": os.path.join(WORK, "no-aws-credentials"),
           "AWS_CONFIG_FILE": os.path.join(WORK, "no-aws-config")}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    breaker = f"store:s3:{S3_BUCKET}"
    size = stack.shape[-1]
    rng = np.random.default_rng(seed + 50)
    try:
        with ServerThread(registry, device=device) as client:
            reset_launch_counts()
            warm = chunk_warm_requests(rng, 5, size, ZARR5_INNER, LANES, channels=2)
            warm_out = run_requests(client, warm, 1)[0]
            main = zarr_tile_requests(rng, 5, size, n_requests, channels=2)
            before = get_json(client, "/healthz")
            main_out, secs = run_requests(client, main, LANES)
            after = get_json(client, "/healthz")
            render = render_requests(rng, size, LANES, image=5)
            render_out = run_requests(client, render, LANES)[0]
            hist = []
            for k in range(8):
                x, y = (int(v) * TILE for v in rng.integers(0, size // TILE, 2))
                bins = HIST_BINS[k % 2]
                hist.append((f"/histogram/5/0/0/0?x={x}&y={y}&w={TILE}&h={TILE}&c=1,2,3"
                             f"&bins={bins}&usePixelsTypeRange=1", (0, x, y, TILE, TILE, bins)))
            hist_out = run_requests(client, hist, len(hist))[0]
            launches = launch_counts()
            served = get_json(client, "/healthz")
            stub_requests = stub.requests
            # the outage: uncached level-1 tiles, one at a time (each a
            # batch of one, one inner chunk, one store failure)
            stub.stop()
            grid = size // 2 // TILE
            cells = [((k // 3) % grid * TILE, (k // 3) // grid * TILE, k % 3)
                     for k in range(ZARR_OUTAGE)]
            outage = [(f"/tile/5/0/{c}/0?x={x}&y={y}&w={TILE}&h={TILE}&format=png&resolution=1",
                       (1, c, x, y), 200) for x, y, c in cells]
            statuses = []
            for path, _, _ in outage:
                status, headers, _, _ = client.request("GET", path)
                statuses.append((status, headers.get("Retry-After")))
            down = get_json(client, "/healthz")
            stub.start()
            t0 = time.perf_counter()
            while (get_json(client, "/healthz")["breakers"][breaker]["state"] == "open"
                   and time.perf_counter() - t0 < 45):
                time.sleep(0.5)
            waited = time.perf_counter() - t0
            recovered = [client.get(path) for path, _, _ in outage]
            healed = get_json(client, "/healthz")
    finally:
        stub.stop()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    checked = verify_zarr(warm_out, warm, source) + verify_zarr(main_out, main, source)
    checked += verify_render(render_out, render, RenderReference(stack))
    for (status, body, _), (path, spec) in zip(hist_out, hist):
        require(status == 200, f"{path} answered {status}")
        verify_histogram(body, stack, spec)
        checked += 1
    # the JAX sequence: a store error is a 404 until the breaker's fifth
    # failure opens it; then 503 with Retry-After (whole seconds, <= 30)
    require([s for s, _ in statuses] == [404] * 5 + [503] * (ZARR_OUTAGE - 5)
            and all((r is None) == (s == 404) for s, r in statuses)
            and all(1 <= int(r) <= 30 for s, r in statuses if s == 503),
            f"path_zarr_s3: outage statuses {statuses}")
    require(down["breakers"][breaker]["state"] == "open" and down["status"] == "degraded",
            f"path_zarr_s3: breaker not open in the outage: {down['breakers']}")
    checked += verify_zarr(recovered, outage, source)
    require(healed["breakers"][breaker]["state"] == "closed",
            f"path_zarr_s3: breaker did not heal: {healed['breakers'][breaker]}")
    require(launches["filter"] > 0 and launches["bitpack"] > 0,
            f"path_zarr_s3: the filter or the SP packer never launched: {launches}")
    require(served["queue"]["failed"] == 0, f"path_zarr_s3: encode groups failed")
    out = zarr_report("path_zarr_s3", n_requests, main_out, secs, before, after, launches)
    out.update({"tiles_verified": checked, "render_tiles": len(render),
                "histograms": len(hist), "stub_requests": stub_requests,
                "outage_statuses": statuses, "breaker_wait_s": waited,
                "breaker_after": healed["breakers"][breaker], "retries": healed["retries"],
                "io_total": healed["io"]})
    return out


# ---------------------------------------------------------------------------
# the viewer plane: the DZI, IIIF and Iris adapters and the SLO scheduler
# ---------------------------------------------------------------------------

DZI_TILE = 256
# the overload front's limits, under the JAX config names
OVERLOAD = {"max_inflight": 4, "queue_size": 8, "request_budget_ms": 1000}
SWEEP_STEPS = 18  # one past the sweep detector's 16 constant steps and the first


def request_all(client: Client, reqs, concurrency: int):
    """Like ``run_requests``, keeping each answer's headers: [(status,
    headers, body, seconds)] in request order, and the wall seconds."""
    with concurrent.futures.ThreadPoolExecutor(concurrency) as pool:
        t0 = time.perf_counter()
        out = list(pool.map(lambda r: client.request("GET", r[0]), reqs))
        return out, time.perf_counter() - t0


def dzi_sweep(size: int, level: int, rows, top: int):
    """A row-major sweep of 256x256 tiles of DZI ``level`` (pyramid level
    ``top - level``) over ``rows`` of its grid: [(path, (res, x, y, w, h),
    200)]."""
    res = top - level
    cols = -(-(size >> res) // DZI_TILE)
    return [(f"/dzi/4_files/{level}/{c}_{r}.png",
             (res, c * DZI_TILE, r * DZI_TILE, DZI_TILE, DZI_TILE), 200)
            for r in rows for c in range(cols)]


def degraded_reference(level: np.ndarray, coarse: np.ndarray, x, y, w, h) -> np.ndarray:
    """A degraded read spelled apart from the port: pixel (Y, X) of
    ``level`` is ``coarse`` pixel (Y * ch // H, X * cw // W)."""
    (sh, sw), (ch, cw) = level.shape, coarse.shape
    ys = np.minimum((y + np.arange(h)) * ch // sh, ch - 1)
    xs = np.minimum((x + np.arange(w)) * cw // sw, cw - 1)
    return coarse[np.ix_(ys, xs)]


def slo_totals(view: dict) -> dict:
    """The scheduler's counts, summed over classes, and the 504s counted by
    the stage that noticed them, from one ``/healthz`` view."""
    slo = view["slo"]
    return {"shed": sum(slo["shed"].values()), "degraded": sum(slo["degraded"].values()),
            "expired_in_queue": sum(slo["expired_in_queue"].values()),
            "granted": sum(slo["granted"].values()), "bulk": slo["classified"]["bulk"],
            "sweeps": slo["sweep"]["detected_total"], "exceeded": sum(view["deadline"].values())}


def drive_viewer(registry: str, img4: np.ndarray, seed: int, device: str = "cuda"):
    """``path_dzi``, then ``path_overload`` on a second front over the same
    pipeline, on one server over image 4 (levels 0-3: DZI levels 13-10);
    returns both phase lines."""
    from omero_ms_pixel_buffer_tpu_torch.dispatch.batcher import BatchingTileWorker
    from omero_ms_pixel_buffer_tpu_torch.http.server import TileServer

    plane = img4[0, 0, 0]
    ay, ax = ZARR_ABSENT
    level0 = plane.copy()
    level0[ay * ZARR_CHUNK:(ay + 1) * ZARR_CHUNK, ax * ZARR_CHUNK:(ax + 1) * ZARR_CHUNK] = 0
    levels = [level0] + [plane[::2 ** k, ::2 ** k] for k in range(1, zarr_levels(plane.shape[0]))]
    st = ServerThread(registry, device=device)
    with st as client:
        dzi = drive_dzi(client, levels)
        front = TileServer(BatchingTileWorker(st.server.pipeline), dev=True,
                           gpu=st.server.gpu, **OVERLOAD)
        port = asyncio.run_coroutine_threadsafe(front.start("127.0.0.1", 0), st.loop).result(60)
        overload_client = Client(port)
        try:
            overload = drive_overload(overload_client, st.server.pipeline, levels, seed)
        finally:
            overload_client.close()
            asyncio.run_coroutine_threadsafe(front.close(), st.loop).result(60)
    return dzi, overload


def drive_dzi(client: Client, levels) -> dict:
    """``path_dzi`` (phase 19 of the module docstring)."""
    from omero_ms_pixel_buffer_tpu_torch.http.protocols.dzi import descriptor_xml, max_level
    from omero_ms_pixel_buffer_tpu_torch.ops.kernels import launch_counts, reset_launch_counts

    size = levels[0].shape[0]
    top = max_level(size, size)
    refs = [RenderReference(lv[None, None]) for lv in levels[:2]]
    reset_launch_counts()
    status, hdr, body, _ = client.request("GET", "/dzi/4.dzi")
    require(status == 200 and body == descriptor_xml(size, size, DZI_TILE)
            and hdr.get("Content-Type") == "application/xml", f"/dzi/4.dzi: {status} {body[:80]}")
    # warm-up: two 2x2 blocks of each level (bottom rows, outside the
    # sweep), fused into super-tile gathers: the second touch stages the
    # level's plane in the plane cache, one level at a time
    t0 = time.perf_counter()
    for level in (top, top - 1):
        rows = (size >> (top - level)) // DZI_TILE
        bottom = dzi_sweep(size, level, (rows - 2, rows - 1), top)
        for k in range(2):
            block = [r for r in bottom if 2 * k * DZI_TILE <= r[1][1] < 2 * (k + 1) * DZI_TILE]
            out = run_requests(client, block, len(block))[0]
            require([s for s, _, _ in out] == [200] * 4, "path_dzi: a warm-up tile failed")
    warm_s = time.perf_counter() - t0
    sweep = dzi_sweep(size, top, range(4), top) + dzi_sweep(size, top - 1, range(8), top)
    before = get_json(client, "/healthz")
    out, secs = request_all(client, sweep, LANES)
    after = get_json(client, "/healthz")
    # DZI level 9 is coarser than the stored pyramid
    coarse = [(f"/dzi/4_files/{top - len(levels)}/{c}_0.png", None, 404) for c in range(4)]
    coarse_out = run_requests(client, coarse, len(coarse))[0]
    require([s for s, _, _ in coarse_out] == [404] * 4,
            f"path_dzi: a tile coarser than the pyramid answered {coarse_out[0][0]}")
    checked = twins = 0
    for k, ((status, hdr, body, _), (path, (res, x, y, w, h), _)) in enumerate(zip(out, sweep)):
        require(status == 200, f"{path} answered {status}")
        require(np.array_equal(decode_png(body), refs[res].rgb({"format": "png"}, x, y, w, h)),
                f"{path}: pixels differ from the numpy composite")
        etag = hdr.get("ETag")
        native = f"/render/4/0/0/0?x={x}&y={y}&w={w}&h={h}&resolution={res}&format=png"
        ns, nh, nb, _ = client.request("GET", native)
        require((ns, nb, nh.get("ETag"), nh.get("X-Cache")) == (200, body, etag, "hit"),
                f"{native}: {ns} X-Cache {nh.get('X-Cache')}, not the DZI tile's entry")
        checked += 1
        if k % 32:
            continue
        s = 1 << res
        x_tiles = -(-(size >> res) // DZI_TILE)
        for twin in (f"/iiif/4/{x * s},{y * s},{w * s},{h * s}/{w},{h}/0/default.png",
                     f"/iris/4/layers/{len(levels) - 1 - res}/tiles/"
                     f"{(y // DZI_TILE) * x_tiles + x // DZI_TILE}"):
            ts, th, tb, _ = client.request("GET", twin)
            require((ts, tb, th.get("ETag")) == (200, body, etag),
                    f"{twin}: {ts}, not the DZI tile's bytes and ETag")
            twins += 1
    launches = launch_counts()
    health = get_json(client, "/healthz")
    lat_ms = np.array([r[3] for r in out]) * 1e3
    window = timed_window(before, after, secs)
    bursts = after["batcher"]["burst_continuations"] - before["batcher"]["burst_continuations"]
    require(bursts > 0, "path_dzi: no coalesce window was extended by a burst")
    require(window["supertile"]["device_lanes"] > 0, "path_dzi: no lane was fused")
    require(launches["filter"] > 0 and launches["bitpack"] > 0,
            f"path_dzi: the filter or the SP packer never launched: {launches}")
    require(health["queue"]["failed"] == 0, "path_dzi: encode groups failed")
    return {"phase": "path_dzi", "image": 4, "requests": len(sweep),
            "dzi_levels": {str(level): sum(1 for _, r, _ in sweep if r[0] == top - level)
                           for level in (top, top - 1)}, "concurrency": LANES,
            "tiles_per_s": len(sweep) / secs, "p50_ms": float(np.percentile(lat_ms, 50)),
            "p99_ms": float(np.percentile(lat_ms, 99)), "warmup_s": warm_s,
            "tiles_verified": checked, "native_twins_hit": checked, "adapter_twins": twins,
            "coarse_404": len(coarse), "burst_continuations": bursts,
            "fused_lanes": window["supertile"]["device_lanes"],
            "supertile_groups": window["supertile"]["groups"],
            "stage_ms_mean": window["stage_ms_mean"], "timed_window": window,
            "reads": reads_delta(before, after, secs), "launches": launches,
            "protocols": health["protocols"], "gpu": health["gpu"]}


def drive_overload(client: Client, pipeline, levels, seed: int) -> dict:
    """``path_overload`` (phase 20 of the module docstring) on the small
    front ``client`` talks to; ``pipeline`` is the one it shares."""
    from omero_ms_pixel_buffer_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    from omero_ms_pixel_buffer_tpu_torch.render.model import RenderSpec
    from omero_ms_pixel_buffer_tpu_torch.tile_ctx import RegionDef, TileCtx

    level0, level1 = levels[0], levels[1]
    size = level0.shape[0]
    rng = np.random.default_rng(seed + 60)
    reset_launch_counts()
    grid = size // TILE
    cells = [(int(i) % grid * TILE, int(i) // grid * TILE) for i in rng.permutation(grid * grid)]
    burst = [(f"/tile/4/0/0/0?x={x}&y={y}&w={TILE}&h={TILE}&format=png", (x, y)) for x, y in cells]
    before = get_json(client, "/healthz")
    answers, rounds_s = [], []
    for _ in range(2):  # the same set twice: what served first is now a cache hit
        out, secs = request_all(client, burst, len(burst))
        answers += list(zip(out, burst))
        rounds_s.append(secs)
    after = get_json(client, "/healthz")
    counts = {200: 0, 503: 0, 504: 0, "degraded": 0, "hits": 0}
    for (status, hdr, body, _), (path, (x, y)) in answers:
        require(status in (200, 503, 504), f"{path} answered {status}")
        counts[status] += 1
        if status == 503:
            require(hdr.get("Retry-After") == "1", f"{path}: 503 without Retry-After: {hdr}")
        if status != 200:
            continue
        counts["hits"] += hdr.get("X-Cache") == "hit"
        if hdr.get("X-OMPB-Degraded") == "1":
            counts["degraded"] += 1
            want = degraded_reference(level0, level1, x, y, TILE, TILE)
        else:
            require("X-OMPB-Degraded" not in hdr, f"{path}: {hdr}")
            want = level0[y:y + TILE, x:x + TILE]
        require(np.array_equal(decode_png(body), want), f"{path}: pixels differ")
    d = {k: v - slo_totals(before)[k] for k, v in slo_totals(after).items()}
    require(counts[503] > 0, f"path_overload: no request was shed: {counts}")
    require(d["shed"] == counts[503],
            f"path_overload: {d['shed']} sheds counted, {counts[503]} answered 503")
    require(d["expired_in_queue"] + d["exceeded"] == counts[504],
            f"path_overload: {d['expired_in_queue']} + {d['exceeded']} expiries counted, "
            f"{counts[504]} answered 504")
    # a degraded grant answers degraded, or 504 once its budget ran out
    require(counts["degraded"] <= d["degraded"] <= counts["degraded"] + d["exceeded"],
            f"path_overload: {d['degraded']} degraded grants, {counts['degraded']} served")
    # a constant-stride session: the 17th step's observation marks the
    # session a sweep, so its 18th request is classified bulk
    sweeper = {"Cookie": "sessionid=sweeper"}
    pre = slo_totals(get_json(client, "/healthz"))
    step = 128
    for k in range(SWEEP_STEPS):
        x = k * step
        path = f"/tile/4/0/0/0?x={x}&y={size - step}&w={step}&h={step}&format=png"
        status, _, body, _ = client.request("GET", path, sweeper)
        require(status == 200 and np.array_equal(
            decode_png(body), level0[size - step:, x:x + step]), f"{path}: {status}")
    post = slo_totals(get_json(client, "/healthz"))
    require(post["sweeps"] - pre["sweeps"] == 1 and post["bulk"] - pre["bulk"] == 1,
            f"path_overload: the sweep was not classified bulk: {pre} -> {post}")
    # pressure gone: one at a time, all full resolution
    g1 = size // 2 // TILE
    quiet = [(f"/tile/4/0/0/0?x={x}&y={y}&w={TILE}&h={TILE}&format=png&resolution=1", (x, y))
             for x, y in ((int(i) % g1 * TILE, int(i) // g1 * TILE)
                          for i in rng.permutation(g1 * g1)[:LANES])]
    for path, (x, y) in quiet:
        status, hdr, body, _ = client.request("GET", path)
        require(status == 200 and "X-OMPB-Degraded" not in hdr
                and np.array_equal(decode_png(body), level1[y:y + TILE, x:x + TILE]),
                f"path_overload: after the burst {path} answered {status} {hdr}")
    served_launches = launch_counts()
    health = get_json(client, "/healthz")
    # degraded lanes straight through handle_batch, so the degraded path runs
    # on the card whatever the timing above
    reset_launch_counts()
    lanes = []
    for i in rng.permutation(grid * grid)[:32]:
        x, y = int(i) % grid * TILE, int(i) // grid * TILE
        lanes.append((TileCtx(4, 0, 0, 0, RegionDef(x, y, TILE, TILE), format="png",
                              omero_session_key="k", degraded=1), None))
    for _ in range(16):
        x, y = (int(v) * DZI_TILE for v in rng.integers(0, size // DZI_TILE, 2))
        ctx = TileCtx(4, 0, 0, 0, RegionDef(x, y, DZI_TILE, DZI_TILE), format="png",
                      omero_session_key="k", degraded=1,
                      render=RenderSpec.from_params({"format": "png"}))
        lanes.append((ctx, {"format": "png"}))
    t0 = time.perf_counter()
    bodies = pipeline.handle_batch([c for c, _ in lanes])
    direct_s = time.perf_counter() - t0
    direct_launches = launch_counts()
    for (ctx, query), body in zip(lanes, bodies):
        r = ctx.region
        require(isinstance(body, bytes) and ctx.degraded == 1,
                f"path_overload: a degraded lane answered {body!r:.80}")
        plane = degraded_reference(level0, level1, r.x, r.y, r.width, r.height)
        want = (plane if query is None else
                RenderReference(plane[None, None]).rgb(query, 0, 0, r.width, r.height))
        require(np.array_equal(decode_png(body), want),
                f"path_overload: degraded lane {r} differs from the replicated level 1")
    require(direct_launches["filter"] > 0 and direct_launches["bitpack"] > 0,
            f"path_overload: degraded lanes launched no kernel: {direct_launches}")
    require(served_launches["filter"] > 0 and served_launches["bitpack"] > 0,
            f"path_overload: the served lanes launched no kernel: {served_launches}")
    require(health["queue"]["failed"] == 0, "path_overload: encode groups failed")
    lat_ms = np.array([a[0][3] for a in answers]) * 1e3
    return {"phase": "path_overload", "image": 4, "limits": OVERLOAD,
            "requests": len(answers), "round_s": rounds_s,
            "statuses": {str(k): v for k, v in counts.items()},
            "p50_ms": float(np.percentile(lat_ms, 50)),
            "p99_ms": float(np.percentile(lat_ms, 99)),
            "slo_delta": d, "slo": health["slo"], "admission": health["admission"],
            "deadline": health["deadline"], "sweep_steps": SWEEP_STEPS,
            "quiet_tiles": len(quiet), "launches": served_launches,
            "degraded_direct": {"tile_lanes": 32, "render_lanes": 16, "seconds": direct_s,
                                "launches": direct_launches},
            "watchdog": health["watchdog"], "gpu": health["gpu"]}



class SmokeConnector:
    """Stands in for OMERO.web's ``omeroweb.connector.Connector`` in a
    pickled session (the store's unpickler never resolves the class)."""

    def __init__(self, key: str):
        self.omero_session_key = key
        self.server_id = 1


def django_pickled(session: dict) -> bytes:
    """A pre-3.1 Django session payload: base64(hash ":" pickle)."""
    import base64
    import pickle

    return base64.b64encode(b"0123456789abcdef:" + pickle.dumps(session))


def django_signed(session: dict) -> bytes:
    """A Django >= 3.1 session payload (``signing.dumps`` with the JSON
    serializer, compressed): "." urlsafe-b64(zlib(json)) ":" timestamp
    ":" urlsafe-b64(hmac)."""
    import base64
    import hashlib
    import hmac

    data = zlib.compress(json.dumps(session, separators=(",", ":")).encode())
    value = "." + base64.urlsafe_b64encode(data).rstrip(b"=").decode() + ":1tPqzV"
    sig = base64.urlsafe_b64encode(
        hmac.new(b"smoke-secret", value.encode(), hashlib.sha256).digest()).rstrip(b"=")
    return value.encode() + b":" + sig


class RespStubThread:
    """The port's RESP2 stub (``cache/plane/resp_stub.py``) on 127.0.0.1
    in this process, its event loop on a thread of its own."""

    def __init__(self):
        from omero_ms_pixel_buffer_tpu_torch.cache.plane.resp_stub import InMemoryRespServer

        self.stub = InMemoryRespServer()
        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self.loop.run_forever, name="smoke-resp",
                                       daemon=True)

    def start(self) -> int:
        self.thread.start()
        return asyncio.run_coroutine_threadsafe(
            self.stub.start("127.0.0.1", 0), self.loop).result(30)

    def close(self) -> None:
        asyncio.run_coroutine_threadsafe(self.stub.close(), self.loop).result(30)
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(30)


class SessionClient(Client):
    """Keep-alive connections, one per worker thread, each thread with an
    OMERO.web session cookie of its own."""

    def __init__(self, port: int, session_ids):
        super().__init__(port)
        self._sids = list(session_ids)
        self._assigned = 0

    def request(self, method: str, path: str, headers=None):
        sid = getattr(self._local, "sid", None)
        if sid is None:
            with self._lock:
                sid = self._local.sid = self._sids[self._assigned % len(self._sids)]
                self._assigned += 1
        return super().request(method, path, {"Cookie": f"sessionid={sid}", **(headers or {})})


def plain_request(port: int, path: str, headers=None):
    """(status, headers, body) of one request on a fresh connection, with
    only the headers given (no cookie unless one is given)."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request("GET", path, headers=headers or {})
        resp = conn.getresponse()
        return resp.status, dict(resp.getheaders()), resp.read()
    finally:
        conn.close()


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def port_env() -> dict:
    """The environment of a port subprocess: the port package this
    process imported (beside this script, or ``--port-root``) first on the
    path."""
    import omero_ms_pixel_buffer_tpu_torch as port

    root = os.path.dirname(os.path.dirname(os.path.abspath(port.__file__)))
    return {**os.environ, "PYTHONPATH": os.pathsep.join(
        [root] + [p for p in [os.environ.get("PYTHONPATH")] if p])}


class PortProcess:
    """``python -m omero_ms_pixel_buffer_tpu_torch ARGS`` as a subprocess
    (the real entry point), its stderr in a file under ``WORK``; a context
    manager that kills it if it is still running on exit. ``port`` (default:
    a free one) is the port it listens on; with ``wait=False`` the caller
    calls ``wait_listening`` (to start several at once)."""

    def __init__(self, args, name: str, port: int = 0, wait: bool = True):
        import subprocess

        self.port = port or free_port()
        self.err_path = os.path.join(WORK, f"{name}.stderr")
        with open(self.err_path, "w") as err:
            self._t0 = time.perf_counter()
            self.proc = subprocess.Popen(
                [sys.executable, "-m", "omero_ms_pixel_buffer_tpu_torch", *args,
                 "--port", str(self.port)], stdout=subprocess.PIPE, stderr=err, text=True,
                env=port_env(), cwd=WORK)
        self.pid = self.proc.pid
        if wait:
            self.wait_listening()

    def wait_listening(self) -> None:
        line = self.proc.stdout.readline()
        self.startup_s = time.perf_counter() - self._t0
        require(line.startswith("listening on"),
                f"the port did not start: {line!r} {self.log()}")

    def log(self) -> str:
        with open(self.err_path) as f:
            return f.read()[-3000:]

    def stop(self) -> int:
        """SIGTERM, then the exit code."""
        self.proc.send_signal(signal.SIGTERM)
        rc = self.proc.wait(60)
        self.proc = None
        return rc

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        if self.proc is not None:
            self.proc.kill()
            self.proc.wait(30)


def timed_run(client: Client, data: np.ndarray, reqs, seed: int) -> tuple:
    """Two warm-up rounds of 32 tiles (the plane is staged on its second
    touch, as in ``path``), then ``reqs`` at concurrency 32 between two
    ``/healthz`` views: (results, seconds, view before, view after)."""
    warm = tile_requests(np.random.default_rng(seed + 7), data.shape[0], 2 * LANES)
    for k in range(2):
        verify(run_requests(client, warm[k * LANES:(k + 1) * LANES], LANES)[0],
               warm[k * LANES:(k + 1) * LANES], data)
    before = get_json(client, "/healthz")
    out, secs = run_requests(client, reqs, LANES)
    return out, secs, before, get_json(client, "/healthz")


def drive_config(registry: str, data: np.ndarray, timed, bodies, n_requests: int,
                 seed: int, device: str = "cuda") -> dict:
    """``path_config``: the port started as an OMERO deployment starts it,
    ``python -m omero_ms_pixel_buffer_tpu_torch --config FILE``, with
    OMERO.web sessions in the RESP stub; then the same file with ``--dev``
    (the echo store), the same warm-up and timed tiles, so that the pair
    differs in the session store alone. See the module docstring."""
    import subprocess

    from omero_ms_pixel_buffer_tpu_torch.ops.png import encode_png

    stub = RespStubThread()
    stub_port = stub.start()
    try:
        sessions = {}
        for i in range(32):
            sid, key = f"smoke-session-{i:02d}", f"omero-key-{i:02d}"
            payload = ({"connector": SmokeConnector(key)} if i < 16 else
                       {"connector": {"omero_session_key": key, "server_id": 1,
                                      "is_secure": False}, "_auth_user_id": str(i)})
            raw = django_pickled(payload) if i < 16 else django_signed(payload)
            stub.stub.data[f":1:django.contrib.sessions.cache{sid}".encode()] = (raw, None)
            sessions[sid] = key
        stub.stub.data[b":1:django.contrib.sessions.cachesmoke-no-connector"] = (
            django_signed({"_auth_user_id": "99"}), None)
        config = {
            "session-store": {"type": "redis", "uri": f"redis://127.0.0.1:{stub_port}/1"},
            "image-registry": registry,
            "backend": {"png": {"device-deflate-mode": "dynamic"}},
            "slo": {"queue-size": 128},
            "resilience": {"breaker": {"failure-threshold": 3, "open-duration-ms": 2000}},
        }
        cfg_path = os.path.join(WORK, "path_config.yaml")
        with open(cfg_path, "w") as f:
            json.dump(config, f, indent=1)  # YAML's JSON subset
        # the wiring, built without serving
        t0 = time.perf_counter()
        dbg = subprocess.run(
            [sys.executable, "-m", "omero_ms_pixel_buffer_tpu_torch", "debug-context",
             "--config", cfg_path, "--device", device], capture_output=True, text=True,
            timeout=300, env=port_env(), cwd=WORK)
        debug_s = time.perf_counter() - t0
        require(dbg.returncode == 0, f"debug-context exit {dbg.returncode}: {dbg.stderr[-2000:]}")
        words = ["RedisSessionStore", f"device={device}"]
        if device == "cuda":
            words += ["kernel filter:", "kernel bitpack:"]
        for word in words:
            require(word in dbg.stdout, f"debug-context does not name {word!r}: {dbg.stdout}")
        reqs = list(timed[:n_requests])
        with PortProcess(["--config", cfg_path, "--device", device], "path_config") as srv:
            client = SessionClient(srv.port, sessions)
            try:
                commands0 = stub.stub.commands
                out, secs, health0, health1 = timed_run(client, data, reqs, seed)
                commands = stub.stub.commands - commands0
                checked = verify(out, reqs, data)
                # bodies against path's: equal, or one of the two took the
                # lone-lane host route (a batch of one), whose bytes differ
                # by design; at least 8 device bodies must be equal
                equal, host_route = 0, 0
                for (path, (x, y, w, h), _), (_, body, _), ref in zip(reqs, out, bodies):
                    if body == ref:
                        equal += 1
                        continue
                    host = encode_png(data[y:y + h, x:x + w])
                    require(host in (body, ref), f"{path}: body differs from path's")
                    host_route += 1
                require(equal >= 8, f"only {equal} bodies byte-equal to path's")
                # statuses a store or a session refuses
                statuses = {
                    "no_cookie": plain_request(srv.port, reqs[0][0])[0],
                    "unknown_session": plain_request(
                        srv.port, reqs[0][0], {"Cookie": "sessionid=smoke-unknown"})[0],
                    "no_connector": plain_request(
                        srv.port, reqs[0][0], {"Cookie": "sessionid=smoke-no-connector"})[0],
                }
                require(all(v == 403 for v in statuses.values()), f"refusals: {statuses}")
                cookie = {"Cookie": "sessionid=smoke-session-00"}
                stub.stub.fail_mode = "close"
                down = [plain_request(srv.port, reqs[1][0], cookie) for _ in range(6)]
                for status, hdrs, body in down:
                    require(status == 503 and "Retry-After" in hdrs
                            and body == b"Session store unavailable",
                            f"a closing store answered {status} {hdrs}")
                breaker_name = f"session-store:redis:127.0.0.1:{stub_port}"
                opened = get_json(client, "/healthz")["breakers"][breaker_name]
                require(opened["state"] == "open", f"the store's breaker did not open: {opened}")
                stub.stub.fail_mode = None
                time.sleep(2.2)
                healed = plain_request(srv.port, reqs[1][0], cookie)
                x, y, w, h = reqs[1][1]
                require(healed[0] == 200 and np.array_equal(
                    decode_png(healed[2]), data[y:y + h, x:x + w]), f"healed: {healed[0]}")
                health = get_json(client, "/healthz")
                families = sorted({ln.split()[2] for ln in metrics_text(client).splitlines()
                                   if ln.startswith("# TYPE ")
                                   and ln.split()[2].startswith(("process_", "python_gc_",
                                                                 "build_info"))})
            finally:
                client.close()
            rc = srv.stop()
            require(rc == 0, f"the port exited {rc} on SIGTERM: {srv.log()}")
        breaker = health["breakers"][breaker_name]
        require(breaker["state"] == "closed" and breaker["opened_total"] >= 1
                and breaker["transitions_total"] >= 3, f"breaker: {breaker}")
        launches = {k: health1["kernels"][k] - health0["kernels"][k] for k in health1["kernels"]}
        require(device != "cuda" or (launches["filter"] > 0 and launches["bitpack"] > 0
                                     and launches["bitpack_dense"] == 0),
                f"launches: {launches}")
        require(health["slo"]["queue_size"] == 128, f"slo: {health['slo']['queue_size']}")
        require(health["queue"]["failed"] == 0, f"encode groups failed: {health['queue']}")
        require(health["queue"]["deflate_mode"] == "dynamic", f"served with {health['queue']}")
        require(health["config"]["session_store"] == "RedisSessionStore", "store")
        require(health["config"]["absent"] == [], f"absent: {health['config']['absent']}")
        require("process_cpu_seconds_total" in families and "build_info" in families,
                f"/metrics process families: {families}")
        prefetch = {k: v - health0["prefetch"][k] for k, v in health1["prefetch"].items()
                    if isinstance(v, (int, float)) and not isinstance(v, bool)}
        lat_ms = np.array([r[2] for r in out]) * 1e3
        # the same file and tiles with the echo store: the store's share
        with PortProcess(["--config", cfg_path, "--device", device, "--dev"],
                         "path_config_echo") as echo:
            eclient = Client(echo.port)
            try:
                eout, esecs, e0, e1 = timed_run(eclient, data, reqs, seed)
                verify(eout, reqs, data)
            finally:
                eclient.close()
            require(echo.stop() == 0, f"the echo port's exit: {echo.log()}")
        elat_ms = np.array([r[2] for r in eout]) * 1e3
        return {
            "phase": "path_config", "requests": len(reqs), "concurrency": LANES,
            "sessions": len(sessions), "tiles_verified": checked,
            "bodies_equal_to_path": equal, "bodies_host_route": host_route,
            "tiles_per_s": len(reqs) / secs, "p50_ms": float(np.percentile(lat_ms, 50)),
            "p99_ms": float(np.percentile(lat_ms, 99)),
            "stub_commands": commands, "refusals_403": statuses,
            "store_down_503": len(down), "retry_after": [h["Retry-After"] for _, h, _ in down],
            "breaker": breaker, "startup_s": srv.startup_s, "debug_context_s": debug_s,
            "launches": launches, "timed_window": timed_window(health0, health1, secs),
            "absent": health["config"]["absent"], "slo_queue_size": health["slo"]["queue_size"],
            "process_families": families, "prefetch_timed_window": prefetch,
            "exit_code": rc,
            "echo_store": {"tiles_per_s": len(reqs) / esecs,
                           "p50_ms": float(np.percentile(elat_ms, 50)),
                           "p99_ms": float(np.percentile(elat_ms, 99)),
                           "startup_s": echo.startup_s,
                           "timed_window": timed_window(e0, e1, esecs)},
        }
    finally:
        stub.close()


# ---------------------------------------------------------------------------
# the session plane and the disk tier
# ---------------------------------------------------------------------------

SESSION_STEPS = 10  # under the sweep detector's 16 constant steps
SESSION_RECT = (1024, 512)  # the viewer's reported viewport: two tiles by one
SESSION_PING_S = 1.0
SESSION_SHAPE = {"type": "rect", "x": 40, "y": 60, "w": 300, "h": 200}


class LiveClient:
    """``GET /session/{image}/live`` on a stdlib socket: a WebSocket (the
    client's frames masked, RFC 6455) or server-sent events (chunked). A
    reader thread puts (arrival time, frame) on ``frames``; (t, None) at the
    close or EOF."""

    def __init__(self, port: int, image: int, cookie: str, transport: str):
        import base64
        import hashlib
        import queue
        import socket

        self.transport = transport
        self.frames = queue.Queue()
        self.sock = socket.create_connection(("127.0.0.1", port), timeout=120)
        head = (f"GET /session/{image}/live HTTP/1.1\r\nHost: 127.0.0.1\r\n"
                f"Cookie: sessionid={cookie}\r\n")
        key = base64.b64encode(os.urandom(16)).decode()
        if transport == "ws":
            head += ("Upgrade: websocket\r\nConnection: Upgrade\r\n"
                     f"Sec-WebSocket-Version: 13\r\nSec-WebSocket-Key: {key}\r\n")
        self.sock.sendall((head + "\r\n").encode())
        self.rfile = self.sock.makefile("rb")
        status = int(self.rfile.readline().split()[1])
        headers = {}
        while True:
            line = self.rfile.readline()
            if line in (b"\r\n", b""):
                break
            name, _, value = line.decode("latin-1").partition(":")
            headers[name.strip().lower()] = value.strip()
        if transport == "ws":
            accept = base64.b64encode(hashlib.sha1(
                key.encode() + b"258EAFA5-E914-47DA-95CA-C5AB0DC85B11").digest()).decode()
            require(status == 101 and headers.get("sec-websocket-accept") == accept,
                    f"WebSocket handshake: {status} {headers}")
        else:
            require(status == 200 and headers.get("content-type") == "text/event-stream"
                    and headers.get("transfer-encoding") == "chunked", f"SSE: {status} {headers}")
        self.thread = threading.Thread(target=self._read, name=f"live-{transport}", daemon=True)
        self.thread.start()

    def _read(self) -> None:
        read = self.rfile.read
        try:
            while True:
                if self.transport == "ws":
                    b0, b1 = read(2)
                    n = b1 & 0x7F
                    if n == 126:
                        (n,) = struct.unpack(">H", read(2))
                    elif n == 127:
                        (n,) = struct.unpack(">Q", read(8))
                    payload = read(n)
                    if b0 & 0x0F == 0x8:
                        break
                    self.frames.put((time.perf_counter(), json.loads(payload)))
                else:
                    n = int(self.rfile.readline().strip(), 16)
                    if n == 0:
                        break
                    chunk = read(n)
                    read(2)
                    for line in chunk.split(b"\n"):
                        if line.startswith(b"data: "):
                            self.frames.put((time.perf_counter(), json.loads(line[6:])))
        except (OSError, ValueError):
            pass
        self.frames.put((time.perf_counter(), None))

    def send_json(self, obj) -> None:
        """One masked text frame (WebSocket only)."""
        payload = json.dumps(obj).encode()
        mask = os.urandom(4)
        head = struct.pack(">BB", 0x81, 0x80 | 126) + struct.pack(">H", len(payload)) \
            if len(payload) >= 126 else struct.pack(">BB", 0x81, 0x80 | len(payload))
        self.sock.sendall(head + mask + bytes(b ^ mask[i % 4] for i, b in enumerate(payload)))

    def next(self, timeout: float = 30.0):
        """(arrival time, frame) of the next frame but the pings; frame None
        at the end."""
        end = time.perf_counter() + timeout
        while True:
            t, frame = self.frames.get(timeout=max(0.01, end - time.perf_counter()))
            if frame is None or frame.get("type") != "ping":
                return t, frame

    def close(self) -> None:
        try:
            if self.transport == "ws":
                self.sock.sendall(struct.pack(">BB", 0x88, 0x82) + b"\0\0\0\0"
                                  + struct.pack(">H", 1000))
        except OSError:
            pass
        self.sock.close()
        self.thread.join(10)


def _poll_health(client: Client, cond, what: str, timeout_s: float = 60.0) -> dict:
    """``/healthz`` once ``cond`` holds for it, polled for ``timeout_s``."""
    end = time.perf_counter() + timeout_s
    while True:
        health = get_json(client, "/healthz")
        if cond(health):
            return health
        require(time.perf_counter() < end, f"{what}: {health['result_cache']}")
        time.sleep(0.05)


def json_request(port: int, method: str, path: str, cookie: str, obj=None):
    """(status, headers, body, seconds at the answer) of one request with a
    JSON body, on a fresh connection."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        body = None if obj is None else json.dumps(obj).encode()
        headers = {"Cookie": f"sessionid={cookie}"}
        if body is not None:
            headers["Content-Type"] = "application/json"
        conn.request(method, path, body=body, headers=headers)
        resp = conn.getresponse()
        data = resp.read()
        return resp.status, dict(resp.getheaders()), data, time.perf_counter()
    finally:
        conn.close()


def drive_session(registry: str, data: np.ndarray, seed: int, device: str = "cuda") -> dict:
    """``path_session``: a fresh server with the session plane and the
    prefetcher on (``ping-interval-s`` 1, two channels an image). One
    WebSocket and one SSE client subscribe to image 1. The WebSocket client
    reports a 1024x512 viewport at each step of a pan of 512² one-channel
    ``/render`` tiles along a row, then asks for the tile at its left;
    after each step the prefetcher drains. From the third step on, the tile
    asked for and every tile of the rectangle's next position (asked by
    other sessions, which predict nothing) answer ``X-Cache: hit`` with the
    numpy composite's pixels; the filter and SP-packer launches over those
    steps (every device lane a prefetched one) equal ``/healthz``
    ``kernels``, and ``prefetch.viewport_true`` rises. Then an annotation
    is created, updated and deleted: after each write both channels get
    ``invalidate`` then ``annotations`` with the sub-epoch, and
    ``/render?annotations=1`` equals the explicit ``roi=`` request (body,
    ETag) and the numpy masked composite. A third channel answers 503;
    removing the channels' session from the store closes both with
    ``revoked`` within two ping intervals."""
    from urllib.parse import quote

    from omero_ms_pixel_buffer_tpu_torch.auth.stores import MemorySessionStore
    from omero_ms_pixel_buffer_tpu_torch.ops.kernels import launch_counts, reset_launch_counts

    size = data.shape[0]
    n_steps = min(SESSION_STEPS, size // TILE - 4)
    require(n_steps >= 4, f"a {size}^2 image is too small for the pan")
    ref = RenderReference(data[None, None])
    query = {"c": PREFETCH_RENDER[2:]}
    y = (size // 4) // TILE * TILE
    pan_key = "pan-key"
    sessions = {"chip-smoke": "smoke-key", "smoke-pan": pan_key, "smoke-live": pan_key,
                **{f"smoke-check-{i}": f"check-key-{i}" for i in range(2 * SESSION_STEPS)}}
    st = ServerThread(registry, device=device, prefetch=True,
                      session={"ping-interval-s": SESSION_PING_S, "max-per-image": 2})
    st.server.session_store = MemorySessionStore(sessions)
    drained, checks = _Drained(st), iter(range(2 * SESSION_STEPS))
    pf = st.server.prefetcher

    def render_path(x: int, yy: int, extra: str = "") -> str:
        return f"/render/1/0/0/0?x={x}&y={yy}&w={TILE}&h={TILE}&{PREFETCH_RENDER}{extra}&format=png"

    def noted(x: int) -> bool:
        with pf._extents_lock:
            return pf._viewports.get((pan_key, 1), {}).get("x") == x

    steps, t0 = [], time.perf_counter()
    with st as client:
        reset_launch_counts()
        live = [LiveClient(st.client.port, 1, "smoke-live", t) for t in ("ws", "sse")]
        try:
            for ch in live:
                _, hello = ch.next()
                require(hello == {"type": "hello", "image": 1, "transport": ch.transport,
                                  "epoch": None, "annotations": 0}, f"hello: {hello}")
            pan = {"Cookie": "sessionid=smoke-pan"}
            before = health_before = None
            checked = 0
            for k in range(n_steps):
                x = k * TILE
                live[0].send_json({"type": "viewport", "x": x, "y": y, "w": SESSION_RECT[0],
                                   "h": SESSION_RECT[1]})
                end = time.perf_counter() + 10
                while not noted(x):
                    require(time.perf_counter() < end, "the viewport frame was not noted")
                    time.sleep(0.002)
                if k == 2:
                    before, health_before = launch_counts(), get_json(client, "/healthz")
                status, hdrs, body, secs = client.request("GET", render_path(x, y), pan)
                verify_render([(status, body, secs)], [(render_path(x, y), (x, y, TILE, TILE),
                                                        200, query)], ref)
                require(k < 2 or hdrs.get("X-Cache") == "hit",
                        f"step {k}: a predicted tile answered X-Cache {hdrs.get('X-Cache')}")
                steps.append({"x": x, "x_cache": hdrs.get("X-Cache"), "ms": secs * 1e3})
                drained.wait()
                if k >= 2:
                    # the rectangle's next position, asked by sessions that
                    # have no stream (they predict nothing)
                    for cx in range(x + TILE, x + TILE + SESSION_RECT[0], TILE):
                        cookie = {"Cookie": f"sessionid=smoke-check-{next(checks) % 20}"}
                        status, hdrs, body, secs = client.request("GET", render_path(cx, y),
                                                                  cookie)
                        verify_render([(status, body, secs)],
                                      [(render_path(cx, y), (cx, y, TILE, TILE), 200, query)],
                                      ref)
                        require(hdrs.get("X-Cache") == "hit",
                                f"the rectangle's next tile x={cx} was not prefetched")
                        checked += 1
            after, health_after = launch_counts(), get_json(client, "/healthz")
            launches = {k: after[k] - before[k] for k in after}
            healthz_launches = {k: health_after["kernels"][k] - health_before["kernels"][k]
                                for k in after}
            require(healthz_launches == launches,
                    f"/healthz kernels {healthz_launches} against the counters {launches}")
            if device == "cuda":
                require(launches["filter"] > 0 and launches["bitpack"] > 0,
                        f"the prefetched lanes launched {launches}")
            viewport_true = (health_after["prefetch"]["viewport_true"]
                             - health_before["prefetch"]["viewport_true"])
            require(viewport_true > 0, "prefetch.viewport_true did not rise")
            # annotations: three writes, each seen by both channels
            ax, ay = 2 * TILE, size // 2
            shape = {**SESSION_SHAPE, "x": ax + SESSION_SHAPE["x"], "y": ay + SESSION_SHAPE["y"]}
            writes, latencies, overlays = [], [], 0
            for method, path, obj in (("POST", "/annotations/1", {"shape": shape, "label": "a"}),
                                      ("PUT", "/annotations/1/a1",
                                       {"shape": {**shape, "w": 180}}),
                                      ("DELETE", "/annotations/1/a1", None)):
                status, _, body, t_answer = json_request(st.client.port, method, path,
                                                         "smoke-pan", obj)
                require(status == (201 if method == "POST" else 200),
                        f"{method} {path}: {status} {body!r}")
                epoch = json.loads(body)["epoch"]
                seen = []
                for ch in live:
                    for want in ("invalidate", "annotations"):
                        t_frame, frame = ch.next()
                        require(frame is not None and frame["type"] == want
                                and frame["image"] == 1,
                                f"{ch.transport} after {method}: {frame}, expected {want}")
                        if want == "annotations":
                            require(frame["annotations"] == epoch, f"sub-epoch {frame}")
                        latencies.append((t_frame - t_answer) * 1e3)
                        seen.append(f"{ch.transport}:{want}")
                writes.append({"op": method, "epoch": epoch, "frames": seen})
                if method == "DELETE":
                    continue
                stored = json.loads(json_request(st.client.port, "GET", "/annotations/1",
                                                 "smoke-pan")[2])["annotations"]
                roi = json.dumps([r["shape"] for r in stored], separators=(",", ":"))
                s1, h1, b1, _ = client.request("GET", render_path(ax, ay, "&annotations=1"), pan)
                s2, h2, b2, _ = client.request("GET", render_path(ax, ay, "&roi=" + quote(roi)),
                                               pan)
                require(s1 == s2 == 200 and b1 == b2 and h1["ETag"] == h2["ETag"],
                        f"annotations=1 differs from roi= ({s1}, {s2})")
                verify_render([(s1, b1, 0.0)], [(render_path(ax, ay), (ax, ay, TILE, TILE), 200,
                                                 {**query, "roi": roi})], ref)
                overlays += 1
            # capacity, then revocation
            cap = plain_request(st.client.port, "/session/1/live",
                                {"Cookie": "sessionid=smoke-pan"})
            require(cap[0] == 503 and cap[1].get("Retry-After") == "1"
                    and cap[2] == b"Session plane at capacity", f"a third channel: {cap}")
            st.server.session_store.sessions.pop("smoke-live")
            t_revoke, revoked = time.perf_counter(), {}
            for ch in live:
                t_frame, frame = ch.next(timeout=4 * SESSION_PING_S)
                require(frame == {"type": "close", "reason": "revoked"}, f"revocation: {frame}")
                t_end, end_frame = ch.next(timeout=4 * SESSION_PING_S)
                require(end_frame is None, f"after the close: {end_frame}")
                revoked[ch.transport] = t_frame - t_revoke
                require(revoked[ch.transport] <= 2 * SESSION_PING_S,
                        f"{ch.transport} closed after {revoked[ch.transport]:.3f} s")
        finally:
            for ch in live:
                ch.close()
        health = _poll_health(client, lambda h: h["session"]["live"] == 0,
                              "a closed channel is still registered", timeout_s=30.0)
        phase_launches = launch_counts()
    hits = sum(1 for s in steps if s["x_cache"] == "hit")
    lat = np.array(latencies)
    return {
        "phase": "path_session", "steps": len(steps), "hits": hits,
        "rect_tiles_checked": checked, "viewport_true": viewport_true,
        "launches_prefetched_lanes": launches, "healthz_launches": healthz_launches,
        "writes": writes, "overlays_checked": overlays,
        "frame_latency_ms": {"p50": float(np.percentile(lat, 50)), "max": float(lat.max()),
                             "n": len(latencies)},
        "capacity_status": cap[0], "revoked_after_s": revoked,
        "session": {k: v for k, v in health["session"].items() if k != "annotations"},
        "prefetch": {k: health["prefetch"][k] for k in ("enqueued", "warmed", "failed",
                                                        "viewport_true")},
        "launches": phase_launches, "seconds": time.perf_counter() - t0,
    }


DISK_TILES = 256
DISK_MEMORY_MB = 16  # a 512² tile of image 1 is > 300 kB: at most ~50 of 256 in memory


def drive_disk(registry: str, data: np.ndarray, device: str = "cuda") -> dict:
    """``path_disk``: ``python -m omero_ms_pixel_buffer_tpu_torch --config``
    with ``cache.disk-dir`` in a temporary directory, ``cache.memory-mb``
    16 (a quarter of the 256 tiles at most) and the prefetcher off (the
    passes ask for every tile themselves). A cold pass of the 256 512²
    PNG tiles of image 1's level-0 grid (32 clients) through the kernels;
    once the spills have landed, a second pass whose memory and disk hits
    (``tile_cache_requests_total`` by tier) sum to 256, with the first
    pass's bytes. SIGTERM, a new process on the same directory
    (``/healthz`` ``result_cache.disk.manifest``: replayed entries, replay
    seconds), and a third pass over every spilled tile (the replayed
    journal's keys): each a disk hit with the first pass's bytes, and zero
    kernel launches."""
    import shutil
    import tempfile

    size = data.shape[0]
    grid = [(x, y) for y in range(0, size - TILE + 1, TILE) for x in range(0, size - TILE + 1, TILE)]
    require(len(grid) >= DISK_TILES, f"a {size}^2 image has {len(grid)} tiles")
    reqs = [(f"/tile/1/0/0/0?x={x}&y={y}&w={TILE}&h={TILE}&format=png", (x, y, TILE, TILE), 200)
            for x, y in grid[:DISK_TILES]]
    tmp = tempfile.mkdtemp(prefix="ompb-disk-")
    spill = os.path.join(tmp, "spill")
    cfg_path = os.path.join(WORK, "path_disk.yaml")
    with open(cfg_path, "w") as f:
        json.dump({"session-store": {"type": "memory"}, "image-registry": registry,
                   "cache": {"memory-mb": DISK_MEMORY_MB, "disk-dir": spill,
                             "prefetch": {"enabled": False}}}, f, indent=1)
    args = ["--config", cfg_path, "--device", device, "--dev"]

    def by_tier(after: dict, before: dict) -> dict:
        return {f"{tier}_{outcome}": metric_delta(after, before, "tile_cache_requests_total",
                                                  tier=tier, outcome=outcome)
                for tier in ("memory", "disk") for outcome in ("hit", "miss")}

    t0 = time.perf_counter()
    try:
        with PortProcess(args, "path_disk") as srv:
            client = Client(srv.port)
            try:
                h0 = get_json(client, "/healthz")
                cold, cold_s = run_requests(client, reqs, LANES)
                verify(cold, reqs, data)
                h1 = get_json(client, "/healthz")
                cold_launches = {k: h1["kernels"][k] - h0["kernels"][k] for k in h1["kernels"]}
                require(device != "cuda" or (cold_launches["filter"] > 0
                                             and cold_launches["bitpack"] > 0),
                        f"the cold pass launched {cold_launches}")

                def settled(h):
                    rc = h["result_cache"]
                    return rc["memory"]["entries"] + rc["disk"]["entries"] == DISK_TILES

                h2 = _poll_health(client, settled, "the spills did not land")
                memory_entries = h2["result_cache"]["memory"]["entries"]
                require(memory_entries <= DISK_TILES // 4,
                        f"{memory_entries} tiles fit in memory (at most a quarter)")
                m1 = metric_samples(metrics_text(client))
                warm, warm_s = run_requests(client, reqs, LANES)
                m2 = metric_samples(metrics_text(client))
                require(all(w[1] == c[1] for w, c in zip(warm, cold)),
                        "a second-pass body differs from the first")
                warm_tiers = by_tier(m2, m1)
                require(warm_tiers["memory_hit"] + warm_tiers["disk_hit"] == DISK_TILES,
                        f"second pass: {warm_tiers}")
                # a disk hit keeps its file, so the tiers now overlap: wait
                # until the re-admissions' spills have stopped
                last = [None]

                def still(h):
                    disk = h["result_cache"]["disk"]
                    now = (disk["entries"], disk["bytes"], disk["manifest"]["journal_bytes"])
                    done, last[0] = now == last[0], now
                    time.sleep(0.2)
                    return done

                h3 = _poll_health(client, still, "the re-admissions did not settle")
                spilled = h3["result_cache"]["disk"]["entries"]
                journal_before = h3["result_cache"]["disk"]["manifest"]["journal_bytes"]
            finally:
                client.close()
            rc = srv.stop()
            require(rc == 0, f"the port exited {rc} on SIGTERM: {srv.log()}")
        files = sorted(n for n in os.listdir(spill) if n.endswith(".tile"))
        with PortProcess(args, "path_disk_restart") as srv:
            client = Client(srv.port)
            try:
                h4 = get_json(client, "/healthz")
                manifest = h4["result_cache"]["disk"]["manifest"]
                require(manifest["replayed"] == spilled and not manifest["torn_tail"],
                        f"manifest after the restart: {manifest}")
                # the replay compacted the journal to one admit a live entry
                spilled_xy = set()
                with open(os.path.join(spill, "manifest.journal"), "rb") as f:
                    for line in f:
                        rec = json.loads(line[9:])
                        fields = dict(kv.split("=", 1) for kv in rec["key"].split("|"))
                        spilled_xy.add((int(fields["x"]), int(fields["y"])))
                require(len(files) == len(spilled_xy) == spilled,
                        f"{len(files)} files, {len(spilled_xy)} journaled, {spilled} entries")
                third_reqs = [r for r in reqs if r[1][:2] in spilled_xy]
                m3 = metric_samples(metrics_text(client))
                third, third_s = request_all(client, third_reqs, LANES)
                m4 = metric_samples(metrics_text(client))
                h5 = get_json(client, "/healthz")
                bodies = {r[0]: c[1] for r, c in zip(reqs, cold)}
                for (path, _, _), (status, hdrs, body, _) in zip(third_reqs, third):
                    require(status == 200 and hdrs.get("X-Cache") == "hit"
                            and body == bodies[path], f"{path}: {status} {hdrs.get('X-Cache')}")
                third_tiers = by_tier(m4, m3)
                require(third_tiers["disk_hit"] == len(third_reqs), f"third pass: {third_tiers}")
                third_launches = {k: h5["kernels"][k] - h4["kernels"][k] for k in h5["kernels"]}
                require(all(v == 0 for v in third_launches.values()),
                        f"the disk hits launched {third_launches}")
            finally:
                client.close()
            require(srv.stop() == 0, f"the restarted port's exit: {srv.log()}")
            restart_s = srv.startup_s
        return {
            "phase": "path_disk", "tiles": DISK_TILES, "memory_mb": DISK_MEMORY_MB,
            "memory_entries": memory_entries, "spilled": spilled,
            "cold_tiles_per_s": DISK_TILES / cold_s, "warm_tiles_per_s": DISK_TILES / warm_s,
            "disk_tiles_per_s_after_restart": len(third_reqs) / third_s,
            "warm_by_tier": warm_tiers, "after_restart_by_tier": third_tiers,
            "journal_bytes": journal_before, "files": len(files),
            "file_bytes": sum(os.path.getsize(os.path.join(spill, n)) for n in files),
            "manifest_after_restart": manifest, "restart_startup_s": restart_s,
            "launches": cold_launches, "launches_after_restart": third_launches,
            "seconds": time.perf_counter() - t0,
        }
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# ---------------------------------------------------------------------------
# the fleet plane
# ---------------------------------------------------------------------------

FLEET_SECRET = "chip-smoke-fleet"
FLEET_PEER_TIMEOUT_MS = 5000  # past the path's p99: a slow owner is still asked


def fleet_request(port: int, method: str, path: str, headers=None, body: bytes = b""):
    """(status, headers, body) of one request on a fresh connection, with
    only the headers given."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request(method, path, body=body or None, headers=headers or {})
        resp = conn.getresponse()
        return resp.status, dict(resp.getheaders()), resp.read()
    finally:
        conn.close()


def run_fleet(clients, reqs, replica_of, concurrency: int):
    """``reqs`` at ``concurrency``, request i to ``clients[replica_of(i)]``:
    ([(status, headers, body, seconds)], wall seconds)."""
    with concurrent.futures.ThreadPoolExecutor(concurrency) as pool:
        t0 = time.perf_counter()
        out = list(pool.map(lambda ir: clients[replica_of(ir[0])].request("GET", ir[1][0]),
                            enumerate(reqs)))
        return out, time.perf_counter() - t0


def fleet_delta(before, after) -> dict:
    """Per replica: launches of each kernel and lanes the batcher ran,
    between two ``/healthz`` views."""
    return [{"launches": {k: h1["kernels"][k] - h0["kernels"][k] for k in h1["kernels"]},
             "lanes": h1["batcher"]["lanes"] - h0["batcher"]["lanes"]}
            for h0, h1 in zip(before, after)]


def drive_fleet(registry: str, data: np.ndarray, timed, seed: int, device: str = "cuda") -> dict:
    """``path_fleet``: two replicas of ``python -m omero_ms_pixel_buffer_tpu_torch
    --config`` on the one card, a static ring of both (``cluster.members``,
    ``cluster.self``), the RESP stub as the shared L2 (``cluster.l2.uri``),
    a ``cluster.secret``, ``replication-factor`` 2, prefetch off. Four
    steps over ``path``'s timed tiles (image 1, ``dynamic``, 32 clients):
    cold (alternating the replicas: render-once, every PNG against the
    source), warm (each to the other replica: no launch, step 1's ETags
    and bodies), invalidate (an annotation write on A bumps the L2 epoch
    and fans a signed purge out to B; a signed purge to A; the re-reads
    render on their owners with step 1's bytes, each key once; unsigned,
    forged and replayed purges answer 403) and drain (a signed ``/internal/drain?
    wait=1`` to B hands its memory tier to A, which then serves every key
    with no launch). See the module docstring."""
    from omero_ms_pixel_buffer_tpu_torch.cluster.security import sign
    from omero_ms_pixel_buffer_tpu_torch.ops.png import encode_png

    t_phase = time.perf_counter()
    stub = RespStubThread()
    stub_port = stub.start()
    procs = []
    try:
        ports = [free_port(), free_port()]
        members = [f"http://127.0.0.1:{p}" for p in ports]
        for i, name in enumerate(("a", "b")):
            cfg_path = os.path.join(WORK, f"path_fleet_{name}.yaml")
            with open(cfg_path, "w") as f:
                json.dump({
                    "session-store": {"type": "memory"}, "image-registry": registry,
                    "backend": {"png": {"device-deflate-mode": "dynamic"}},
                    "slo": {"queue-size": 128}, "cache": {"prefetch": {"enabled": False}},
                    "cluster": {"members": members, "self": members[i],
                                "l2": {"uri": f"redis://127.0.0.1:{stub_port}/0"},
                                "secret": FLEET_SECRET, "replication-factor": 2,
                                "peer-timeout-ms": FLEET_PEER_TIMEOUT_MS},
                }, f, indent=1)  # YAML's JSON subset
            procs.append(PortProcess(["--config", cfg_path, "--device", device, "--dev"],
                                     f"path_fleet_{name}", port=ports[i], wait=False))
        for proc in procs:  # both start at once; the kernels are built already
            proc.wait_listening()
        a, b = procs
        clients = [Client(a.port), Client(b.port)]
        reqs = list(timed)
        keys = sorted({r[0] for r in reqs})
        try:
            health = lambda: [get_json(c, "/healthz") for c in clients]  # noqa: E731
            h_start = h0 = health()
            # 1. cold: alternating, render-once across the fleet
            cold, cold_s = run_fleet(clients, reqs, lambda i: i % 2, LANES)
            h1 = health()
            verify([(s, body, t) for s, _, body, t in cold], reqs, data)
            cold_delta = fleet_delta(h0, h1)
            require(sum(d["lanes"] for d in cold_delta) == len(keys),
                    f"cold: {cold_delta} lanes for {len(keys)} keys (render-once)")
            require(device != "cuda" or all(
                sum(d["launches"][k] for d in cold_delta) > 0 for k in ("filter", "bitpack")),
                f"cold launches: {cold_delta}")
            xc = [hd.get("X-Cache") for _, hd, _, _ in cold]
            first = {}
            for r, (_, hd, body, _) in zip(reqs, cold):
                first.setdefault(r[0], (hd["ETag"], body))
            # 2. warm: each request to the other replica
            warm, warm_s = run_fleet(clients, reqs, lambda i: (i + 1) % 2, LANES)
            h2 = health()
            warm_delta = fleet_delta(h1, h2)
            require(all(v == 0 for d in warm_delta for v in d["launches"].values()),
                    f"warm launches: {warm_delta}")
            for r, (status, hd, body, _) in zip(reqs, warm):
                require(status == 200 and (hd["ETag"], body) == first[r[0]],
                        f"warm {r[0]}: {status} {hd.get('X-Cache')} differs from step 1")
            wxc = [hd.get("X-Cache") for _, hd, _, _ in warm]
            # 3. invalidate: an annotation write on A is a purge of image 1
            # (epoch bump, L2 DELs, a signed purge fanned out to B)
            epoch_key = b"ompb:cluster:epoch:1"
            epoch0 = int(stub.stub.data.get(epoch_key, (b"0", None))[0])
            status, _, _, _ = json_request(a.port, "POST", "/annotations/1", "chip-smoke",
                                           {"type": "rect", "x": 1, "y": 1, "w": 8, "h": 8})
            require(status == 201, f"annotation write: {status}")
            deadline = time.time() + 30
            while int(stub.stub.data.get(epoch_key, (b"0", None))[0]) != epoch0 + 1:
                require(time.time() < deadline, "the L2 epoch did not rise")
                time.sleep(0.05)
            b_epochs = get_json(clients[1], "/healthz")["cluster"]["epochs"]
            purge = "/internal/purge/1"
            signed = {"X-OMPB-Peer": members[1], "X-OMPB-Epoch": str(epoch0 + 1),
                      "X-OMPB-Sig": sign(FLEET_SECRET, "POST", purge, b"", peer=members[1])}
            purged = fleet_request(a.port, "POST", purge, signed)
            require(purged[0] == 200 and json.loads(purged[2]) == {"purged": 1},
                    f"signed purge: {purged[0]} {purged[2]!r}")
            refusals = {
                "unsigned": fleet_request(a.port, "POST", purge,
                                          {"X-OMPB-Peer": members[1]})[0],
                "forged": fleet_request(a.port, "POST", purge, {
                    "X-OMPB-Peer": members[1],
                    "X-OMPB-Sig": sign("not-the-secret", "POST", purge, b"",
                                       peer=members[1])})[0],
                "replayed": fleet_request(a.port, "POST", purge, signed)[0],
            }
            require(all(v == 403 for v in refusals.values()), f"refusals: {refusals}")
            reread = list({r[0]: r for r in reqs}.values())  # each key once
            h3 = health()
            again, again_s = run_fleet(clients, reread, lambda i: i % 2, LANES)
            h4 = health()
            again_delta = fleet_delta(h3, h4)
            require(sum(d["lanes"] for d in again_delta) == len(reread),
                    f"re-reads: {again_delta} lanes for {len(reread)} keys")
            require(device != "cuda" or sum(d["launches"]["filter"] for d in again_delta) > 0,
                    f"re-read launches: {again_delta}")
            # a re-rendered body equals step 1's, or one of the two took the
            # lone-lane host route (a batch of one), whose bytes differ by
            # design; every one is checked against the source
            verify([(st, body, t) for st, _, body, t in again], reread, data)
            equal, host_route, latest = 0, 0, {}
            for r, (status, hd, body, _) in zip(reread, again):
                require(hd.get("X-Cache") in ("miss", "peer-hit"),
                        f"re-read {r[0]}: {hd.get('X-Cache')}")
                latest[r[0]] = (hd["ETag"], body)
                if (hd["ETag"], body) == first[r[0]]:
                    equal += 1
                    continue
                x, y, w, h = r[1]
                require(encode_png(data[y:y + h, x:x + w]) in (body, first[r[0]][1]),
                        f"re-read {r[0]}: body differs from step 1's")
                host_route += 1
            require(equal >= 8, f"only {equal} re-read bodies byte-equal to step 1's")
            # 4. drain B; A then serves every key without a launch
            drain = "/internal/drain?wait=1"
            status, _, body = fleet_request(b.port, "POST", drain, {
                "X-OMPB-Peer": members[0],
                "X-OMPB-Sig": sign(FLEET_SECRET, "POST", drain, b"", peer=members[0])})
            drained = json.loads(body)
            require(status == 200 and drained["state"] == "drained"
                    and drained["stats"]["handoff"]["pushed"] > 0, f"drain: {status} {body!r}")
            h5 = health()
            after, after_s = run_fleet([clients[0]], [(k, None, 200) for k in keys],
                                       lambda i: 0, LANES)
            h6 = health()
            drain_delta = fleet_delta(h5, h6)
            require(all(v == 0 for v in drain_delta[0]["launches"].values()),
                    f"A launched after the drain: {drain_delta}")
            for k, (status, hd, body, _) in zip(keys, after):
                require(status == 200 and (hd["ETag"], body) == latest[k],
                        f"after the drain {k}: {status} {hd.get('X-Cache')}")
            h_end = health()
        finally:
            for c in clients:
                c.close()
        rcs = [p.stop() for p in procs]
        require(rcs == [0, 0], f"exit codes on SIGTERM: {rcs} {a.log()} {b.log()}")
        phase_delta = fleet_delta(h_start, h_end)
        lat = np.array([t for _, _, _, t in cold]) * 1e3
        wlat = np.array([t for _, _, _, t in warm]) * 1e3
        counts = lambda tags: {t: tags.count(t) for t in sorted(set(tags))}  # noqa: E731
        return {
            "phase": "path_fleet", "replicas": 2, "requests": len(reqs), "keys": len(keys),
            "concurrency": LANES, "startup_s": [p.startup_s for p in procs],
            "cold": {"tiles_per_s": len(reqs) / cold_s, "p50_ms": float(np.percentile(lat, 50)),
                     "p99_ms": float(np.percentile(lat, 99)), "x_cache": counts(xc),
                     "peer_fetches": xc.count("peer-hit"), "l2_hits": xc.count("l2-hit"),
                     "per_replica": cold_delta},
            "warm": {"tiles_per_s": len(reqs) / warm_s,
                     "p50_ms": float(np.percentile(wlat, 50)),
                     "p99_ms": float(np.percentile(wlat, 99)), "x_cache": counts(wxc),
                     "per_replica": warm_delta},
            "invalidate": {"epoch": [epoch0, epoch0 + 1], "b_epochs": b_epochs,
                           "refusals_403": refusals, "rereads": len(reread),
                           "bodies_equal_to_cold": equal, "bodies_host_route": host_route,
                           "reread_tiles_per_s": len(reread) / again_s,
                           "per_replica": again_delta},
            "drain": {"stats": drained["stats"], "a_tiles_per_s": len(keys) / after_s,
                      "a_after": drain_delta[0]},
            "cluster": [{k: h["cluster"].get(k) for k in ("replication", "epochs", "integrity")}
                        for h in h_end],
            "l2_entries": sum(1 for k in stub.stub.data if k.startswith(b"ompb:tile:")),
            "launches": {k: sum(d["launches"][k] for d in phase_delta)
                         for k in phase_delta[0]["launches"]},
            "exit_codes": rcs, "seconds": time.perf_counter() - t_phase,
        }
    finally:
        for p in procs:
            p.__exit__(None, None, None)
        stub.close()


GOSSIP = {"enabled": True, "interval-s": 0.5, "fanout": 2, "fail-after-s": 5.0}
LEASE_TTL_S = 3.0


def member_views(ports) -> list:
    """Each replica's ``/healthz`` cluster view (members, draining), on
    fresh connections."""
    views = []
    for port in ports:
        status, _, body = fleet_request(port, "GET", "/healthz")
        require(status == 200, f"/healthz on {port} answered {status}")
        m = json.loads(body)["cluster"]["membership"]
        views.append((set(m["members"]), set(m["draining"])))
    return views


def wait_views(ports, want, what: str, timeout_s: float = 60.0, draining=None) -> float:
    """Seconds until every replica's member view is ``want`` (and its
    draining set ``draining``, when given), polled every 50 ms."""
    t0 = time.perf_counter()
    while True:
        views = member_views(ports)
        if all(m == set(want) and (draining is None or d == set(draining)) for m, d in views):
            return time.perf_counter() - t0
        require(time.perf_counter() - t0 < timeout_s, f"{what}: views {views}")
        time.sleep(0.05)


def start_replicas(registry: str, device: str, stub_port: int, specs, cluster: dict,
                   tag: str) -> list:
    """One ``PortProcess`` per (name, port, seed URLs) of ``specs``, all
    started at once: the ``path_fleet`` config with ``cluster`` on top."""
    procs = []
    for name, port, seeds in specs:
        cfg_path = os.path.join(WORK, f"{tag}_{name}.yaml")
        with open(cfg_path, "w") as f:
            json.dump({
                "session-store": {"type": "memory"}, "image-registry": registry,
                "backend": {"png": {"device-deflate-mode": "dynamic"}},
                "slo": {"queue-size": 128}, "cache": {"prefetch": {"enabled": False}},
                "cluster": {"members": seeds, "self": f"http://127.0.0.1:{port}",
                            "l2": {"uri": f"redis://127.0.0.1:{stub_port}/0"},
                            "secret": FLEET_SECRET, "replication-factor": 2,
                            "peer-timeout-ms": FLEET_PEER_TIMEOUT_MS, **cluster},
            }, f, indent=1)  # YAML's JSON subset
        procs.append(PortProcess(["--config", cfg_path, "--device", device, "--dev"],
                                 f"{tag}_{name}", port=port, wait=False))
    for proc in procs:
        proc.wait_listening()
    return procs


def stop_all(procs) -> list:
    """SIGTERM to every process at once (each drains), then the exit codes."""
    for p in procs:
        p.proc.send_signal(signal.SIGTERM)
    rcs = [p.proc.wait(60) for p in procs]
    for p in procs:
        p.proc = None
    return rcs


def cluster_counts(port: int) -> dict:
    """``cluster_gossip_rounds_total`` and ``cluster_membership_events_total``
    of one replica, by label."""
    status, _, body = fleet_request(port, "GET", "/metrics")
    require(status == 200, f"/metrics on {port} answered {status}")
    out = {}
    for (name, labels), v in metric_samples(body.decode()).items():
        if name in ("cluster_gossip_rounds_total", "cluster_membership_events_total") and v:
            out.setdefault(name, {})[labels.strip("{}")] = v
    return out


def latency(results) -> dict:
    lat = np.array([t for *_, t in results]) * 1e3
    return {"p50_ms": float(np.percentile(lat, 50)), "p99_ms": float(np.percentile(lat, 99))}


def drive_gossip(registry: str, data: np.ndarray, timed, seed: int, device: str = "cuda") -> dict:
    """``path_gossip``: dynamic membership. Three replicas of ``python -m
    omero_ms_pixel_buffer_tpu_torch --config`` on the one card with
    ``cluster.gossip`` (interval 0.5 s, fanout 2, fail-after 5 s), a
    ``cluster.secret``, the RESP stub in this process as the L2 and the
    join hint, ``replication-factor`` 2 and the prefetcher off; A and B
    seeded with each other, C with A alone. Steps: converge (every view
    lists all three); cold (``path``'s timed tiles over A, B and C:
    every PNG against the source, render-once, filter and SP launches);
    join (D seeded with C alone: all four views agree, D's warm-up pulls
    entries, then every key on D: no other replica renders, D renders
    only keys it answers itself); crash (SIGKILL B: A, C and D drop it
    within fail-after + 2 intervals, then every key once: re-rendered
    keys at most B's, every body against the source and step 2's bytes);
    lease (the fleet restarted with ``lease-ttl-s`` 3 on the same stub: a
    drain of one replica is seen as draining by the others within one
    heartbeat and leaves their views when its lease is deleted). SIGTERM
    exits 0 on every replica but B. See the module docstring."""
    from omero_ms_pixel_buffer_tpu_torch.cluster.security import sign
    from omero_ms_pixel_buffer_tpu_torch.ops.png import encode_png

    t_phase = time.perf_counter()
    interval, fail_after = GOSSIP["interval-s"], GOSSIP["fail-after-s"]
    stub = RespStubThread()
    stub_port = stub.start()
    procs, lease_procs, clients = [], [], []
    try:
        ports = [free_port() for _ in range(4)]
        a, b, c, d = urls = [f"http://127.0.0.1:{p}" for p in ports]
        procs = start_replicas(registry, device, stub_port,
                               [("a", ports[0], [a, b]), ("b", ports[1], [a, b]),
                                ("c", ports[2], [a, c])], {"gossip": GOSSIP}, "path_gossip")
        clients = [Client(p) for p in ports[:3]]
        health = lambda cs: [get_json(cl, "/healthz") for cl in cs]  # noqa: E731
        # 1. converge
        converge_s = wait_views(ports[:3], urls[:3], "the gossip views did not converge")
        # 2. cold: path's timed tiles over A, B and C
        reqs = list(timed)
        keys = sorted({r[0] for r in reqs})
        h0 = health(clients)
        cold, cold_s = run_fleet(clients, reqs, lambda i: i % 3, LANES)
        h1 = health(clients)
        verify([(s, body, t) for s, _, body, t in cold], reqs, data)
        cold_delta = fleet_delta(h0, h1)
        require(sum(x["lanes"] for x in cold_delta) == len(keys),
                f"cold: {cold_delta} lanes for {len(keys)} keys (render-once)")
        require(device != "cuda" or all(
            sum(x["launches"][k] for x in cold_delta) > 0 for k in ("filter", "bitpack")),
            f"cold launches: {cold_delta}")
        first = {}
        for r, (_, hd, body, _) in zip(reqs, cold):
            first.setdefault(r[0], (hd["ETag"], body))
        # 3. join: D seeded with C alone
        t_join = time.perf_counter()
        procs += start_replicas(registry, device, stub_port, [("d", ports[3], [d, c])],
                                {"gossip": GOSSIP}, "path_gossip")
        clients.append(Client(ports[3]))
        join_converge_s = wait_views(ports, urls, "D did not join every view")
        t_wait = time.perf_counter()
        while get_json(clients[3], "/healthz")["cluster"]["replication"][
                "transfers_pulled"] < 1:
            require(time.perf_counter() - t_wait < 60, "D's warm-up pulled nothing")
            time.sleep(0.05)
        hj0 = health(clients)
        d_entries = hj0[3]["result_cache"]["memory"]["entries"]
        require(d_entries > 0, "D's warm-up absorbed no entry")
        per_key = [(k, None, 200) for k in keys]
        on_d, on_d_s = run_fleet([clients[3]], per_key, lambda i: 0, LANES)
        hj1 = health(clients)
        join_delta = fleet_delta(hj0, hj1)
        d_tags = [hd.get("X-Cache") for _, hd, _, _ in on_d]
        d_local = sum(1 for t in d_tags if t in ("hit", "miss"))
        require(all(x["lanes"] == 0 for x in join_delta[:3]),
                f"join: a key re-rendered off D: {join_delta}")
        require(join_delta[3]["lanes"] <= d_local,
                f"join: D rendered {join_delta[3]['lanes']} keys, answered {d_local} itself")
        for k, (status, hd, body, _) in zip(keys, on_d):
            require(status == 200 and body == first[k][1], f"join {k}: {status} differs")
        join_s = time.perf_counter() - t_join
        # 4. crash: SIGKILL B
        hb = get_json(clients[1], "/healthz")
        b_before_kill = fleet_delta([h0[1]], [hb])[0]
        clients[1].close()
        survivors = [ports[0], ports[2], ports[3]]
        procs[1].proc.kill()
        t_kill = time.perf_counter()
        procs[1].proc.wait(30)
        procs[1].proc = None
        seen = {}
        while len(seen) < 3:
            for port, (members, _) in zip(survivors, member_views(survivors)):
                if port not in seen and b not in members:
                    seen[port] = time.perf_counter() - t_kill
            require(time.perf_counter() - t_kill < 60, f"B not dropped: {seen}")
            time.sleep(0.05)
        detect_s = max(seen.values())
        limit_s = fail_after + 2 * interval
        require(detect_s <= limit_s, f"B dropped after {detect_s:.2f} s > {limit_s} s: {seen}")
        live = [clients[0], clients[2], clients[3]]
        hc0 = health(live)
        again, again_s = run_fleet(live, per_key, lambda i: i % 3, LANES)
        hc1 = health(live)
        crash_delta = fleet_delta(hc0, hc1)
        rendered = sum(x["lanes"] for x in crash_delta)
        require(rendered <= cold_delta[1]["lanes"],
                f"crash: {rendered} re-rendered, B owned {cold_delta[1]['lanes']}")
        by_key = {r[0]: r for r in reqs}
        verify([(s, body, t) for s, _, body, t in again], [by_key[k] for k in keys], data)
        equal, host_route = 0, 0
        for k, (status, hd, body, _) in zip(keys, again):
            if body == first[k][1]:
                equal += 1
                continue
            x, y, w, h = by_key[k][1]  # a lone lane's host bytes differ by design
            require(encode_png(data[y:y + h, x:x + w]) == body, f"crash {k}: bytes differ")
            host_route += 1
        metrics = {url: cluster_counts(port) for url, port in zip(
            [a, c, d], survivors)}
        h_end = health(live)
        for cl in clients:
            cl.close()
        clients = []
        rcs = stop_all([procs[0], procs[2], procs[3]])
        require(rcs == [0, 0, 0], f"gossip exit codes on SIGTERM: {rcs}")
        # 5. lease mode on the same stub
        lports = [free_port() for _ in range(3)]
        lurls = [f"http://127.0.0.1:{p}" for p in lports]
        lease_procs = start_replicas(registry, device, stub_port,
                                     [(f"l{i}", p, lurls) for i, p in enumerate(lports)],
                                     {"lease-ttl-s": LEASE_TTL_S}, "path_gossip_lease")
        lease_converge_s = wait_views(lports, lurls, "the lease views did not converge")
        heartbeat = LEASE_TTL_S / 3.0
        drain = "/internal/drain?wait=1"
        box = {}

        def run_drain():
            box["answer"] = fleet_request(lports[2], "POST", drain, {
                "X-OMPB-Peer": lurls[0],
                "X-OMPB-Sig": sign(FLEET_SECRET, "POST", drain, b"", peer=lurls[0])})
            box["done"] = time.perf_counter()

        drainer = threading.Thread(target=run_drain)
        t_drain = time.perf_counter()
        drainer.start()
        seen_draining = None
        while seen_draining is None:
            views = member_views(lports[:2])
            if all(lurls[2] in dr and lurls[2] in m for m, dr in views):
                seen_draining = time.perf_counter() - t_drain
            require(time.perf_counter() - t_drain < 30, f"no drain marker seen: {views}")
            time.sleep(0.02)
        drainer.join(60)
        status, _, body = box["answer"]
        drained = json.loads(body)
        require(status == 200 and drained["state"] == "drained"
                and drained["stats"]["announced"] and drained["stats"]["lease_released"],
                f"lease drain: {status} {body!r}")
        left_s = wait_views(lports[:2], lurls[:2], "the drained replica did not leave",
                            timeout_s=30)
        require(seen_draining <= heartbeat * 1.5,
                f"draining seen after {seen_draining:.2f} s > one heartbeat")
        require(left_s <= heartbeat * 1.5, f"left the views {left_s:.2f} s after the drain")
        require(f"ompb:cluster:member:{lurls[2]}".encode() not in stub.stub.data,
                "the drained lease is still in the stub")
        lease_metrics = {url: cluster_counts(p) for url, p in zip(lurls[:2], lports[:2])}
        lrcs = stop_all(lease_procs)
        require(lrcs == [0, 0, 0], f"lease exit codes on SIGTERM: {lrcs}")
        per_replica = fleet_delta(h0[:1] + h0[2:] + [hj0[3]], h_end)
        launches = {k: sum(x["launches"][k] for x in per_replica) + b_before_kill["launches"][k]
                    for k in b_before_kill["launches"]}
        counts = lambda tags: {t: tags.count(t) for t in sorted(set(tags))}  # noqa: E731
        return {
            "phase": "path_gossip", "replicas": 4, "requests": len(reqs), "keys": len(keys),
            "concurrency": LANES, "gossip": GOSSIP,
            "startup_s": [p.startup_s for p in procs],
            "converge_s": converge_s,
            "cold": {"tiles_per_s": len(reqs) / cold_s, **latency(cold),
                     "x_cache": counts([hd.get("X-Cache") for _, hd, _, _ in cold]),
                     "per_replica": cold_delta},
            "join": {"converge_s": join_converge_s, "d_entries_warmed": d_entries,
                     "d_transfers_pulled": hj0[3]["cluster"]["replication"]["transfers_pulled"],
                     "tiles_per_s": len(keys) / on_d_s, **latency(on_d),
                     "x_cache": counts(d_tags), "per_replica": join_delta, "seconds": join_s},
            "crash": {"detect_s": {u: seen[p] for u, p in zip([a, c, d], survivors)},
                      "limit_s": limit_s, "tiles_per_s": len(keys) / again_s, **latency(again),
                      "rerendered": rendered, "b_owned": cold_delta[1]["lanes"],
                      "bodies_equal_to_cold": equal, "bodies_host_route": host_route,
                      "x_cache": counts([hd.get("X-Cache") for _, hd, _, _ in again]),
                      "per_replica": crash_delta},
            "lease": {"lease_ttl_s": LEASE_TTL_S, "heartbeat_s": heartbeat,
                      "converge_s": lease_converge_s, "draining_seen_s": seen_draining,
                      "left_s": left_s, "drain_s": box["done"] - t_drain,
                      "drain_stats": drained["stats"], "metrics": lease_metrics},
            "metrics": metrics, "launches": launches,
            "exit_codes": {"gossip": rcs, "lease": lrcs, "b": "SIGKILL"},
            "seconds": time.perf_counter() - t_phase,
        }
    finally:
        for cl in clients:
            cl.close()
        for p in procs + lease_procs:
            p.__exit__(None, None, None)
        stub.close()

# ---------------------------------------------------------------------------
# the ingest plane: Zarr shard writes while serving
# ---------------------------------------------------------------------------

INGEST_FILE, INGEST_S3 = 6, 7  # copies of image 5 on the filesystem and the S3 stub
INGEST_TILES, INGEST_S3_TILES = 8, 4  # 512² tile writes on each
INGEST_RACE_COMMITS = 3
INGEST_MULTIPART = (4 << 20, 5 << 20)  # the S3 store's threshold and part size in the phase


def write_ingest_fixtures() -> str:
    """Two copies of image 5's tree (``fixture_zarr``): image 6 on the
    filesystem, image 7 behind the S3 stub. Returns their registry."""
    import shutil

    src = os.path.join(WORK, "zarr5.zarr")
    for name in ("ingest6.zarr", "ingest7.zarr"):
        dst = os.path.join(WORK, name)
        shutil.rmtree(dst, ignore_errors=True)
        shutil.copytree(src, dst)
    registry = os.path.join(WORK, "registry_ingest.json")
    with open(registry, "w") as f:
        json.dump({"images": [
            {"id": INGEST_FILE, "path": os.path.join(WORK, "ingest6.zarr"), "name": "ingest"},
            {"id": INGEST_S3, "path": f"s3://{S3_BUCKET}/ingest7.zarr", "type": "zarr",
             "name": "ingest-s3"}]}, f)
    return registry


def _levels_of(plane: np.ndarray, levels: int):
    return [plane[::2 ** lv, ::2 ** lv] for lv in range(levels)]


def _readback(client: Client, image: int, c: int, x: int, y: int, w: int, h: int,
              planes: np.ndarray, levels: int = ZARR5_LEVELS) -> int:
    """The written region of channel ``c`` through ``/tile`` PNG at every
    level (stride 2 each), held against ``planes`` (the image as
    written); returns the tiles checked."""
    checked = 0
    for lv, level in enumerate(_levels_of(planes[c], levels)):
        s = 2 ** lv
        lx, ly, lw, lh = x // s, y // s, -(-w // s), -(-h // s)
        res = "" if lv == 0 else f"&resolution={lv}"
        path = f"/tile/{image}/0/{c}/0?x={lx}&y={ly}&w={lw}&h={lh}&format=png{res}"
        status, body, _ = client.get(path)
        require(status == 200, f"{path} answered {status}")
        require(np.array_equal(decode_png(body), level[ly:ly + lh, lx:lx + lw]),
                f"{path}: pixels differ from the written ones")
        checked += 1
    return checked


def _put(client: Client, image: int, c: int, x: int, y: int, tile: np.ndarray):
    h, w = tile.shape
    path = f"/image/{image}/tile/0/{c}/0?x={x}&y={y}&w={w}&h={h}"
    status, _, body, secs = client.request("PUT", path, body=tile.astype(">u2").tobytes())
    require(status == 200, f"PUT {path} answered {status}: {body[:200]!r}")
    return json.loads(body), secs


def _pct(values) -> dict:
    ms = np.array(values) * 1e3
    return {"n": len(values), "p50": float(np.percentile(ms, 50)),
            "p99": float(np.percentile(ms, 99)), "max": float(ms.max())}


def drive_ingest(registry: str, img5: np.ndarray, seed: int, device: str = "cuda") -> dict:
    """``path_ingest``: a server with ``ingest.enabled`` over two copies of
    image 5's layout (NGFF 0.5, (1, 3, 1, 4096, 4096) uint16, 2048² shards
    of 512² inner chunks, blosc lz4 with shuffle, crc32c, 3 levels): image
    6 on the filesystem, image 7 behind the S3 stub (its store's multipart
    threshold lowered to 4 MiB, parts of 5 MiB). Three new 4096² planes in
    one ``POST .../planes`` (96 MiB); every tile of every level read back
    through ``/tile`` PNG (the kernels) against the written pixels; then
    ``INGEST_TILES`` 512² ``PUT``s at distinct cells, each read back at
    every level; then ``INGEST_RACE_COMMITS`` commits over one tile while
    a reader thread reads it: every read the old or a new tile, none
    mixed; then ``INGEST_S3_TILES`` ``PUT``s on image 7 (multipart), each
    read back. Reports commit ms per plane and per tile (p50, p99), MB/s
    written, read-after-write tiles/s and the kernel launches."""
    from omero_ms_pixel_buffer_tpu_torch.ops.kernels import launch_counts, reset_launch_counts

    t_phase = time.perf_counter()
    size = ZARR5_SIZE
    planes = np.stack([make_field(size, seed + 60 + c) for c in range(3)])
    s3_planes = img5[0][:, 0].copy()  # image 7 starts as image 5
    rng = np.random.default_rng(seed + 61)
    stub = S3Stub(WORK)
    env = {"OMPB_S3_ENDPOINT": stub.start(), "AWS_ACCESS_KEY_ID": S3_ACCESS,
           "AWS_SECRET_ACCESS_KEY": S3_SECRET, "AWS_REGION": "us-east-1",
           "AWS_SHARED_CREDENTIALS_FILE": os.path.join(WORK, "no-aws-credentials"),
           "AWS_CONFIG_FILE": os.path.join(WORK, "no-aws-config")}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    st = ServerThread(registry, device=device, ingest={"enabled": True})
    try:
        with st as client:
            reset_launch_counts()
            body = planes.astype(">u2").tobytes()
            status, _, out, plane_s = client.request(
                "POST", f"/image/{INGEST_FILE}/planes?planes=0:0:0,0:1:0,0:2:0", body=body)
            require(status == 200, f"planes POST answered {status}: {out[:200]!r}")
            plane_stats = json.loads(out)
            require(plane_stats["tiles"] == 3 and plane_stats["epoch"] is None,
                    f"planes POST: {plane_stats}")
            reads = []
            for lv in range(ZARR5_LEVELS):
                ls, res = size >> lv, "" if lv == 0 else f"&resolution={lv}"
                side = min(TILE, ls)
                for c in range(3):
                    for y in range(0, ls, side):
                        for x in range(0, ls, side):
                            reads.append((f"/tile/{INGEST_FILE}/0/{c}/0?x={x}&y={y}&w={side}"
                                          f"&h={side}&format=png{res}", (lv, c, x, y), 200))
            read_out, read_s = run_requests(client, reads, LANES)
            checked = verify_zarr(read_out, reads,
                                  lambda lv, c: planes[c, ::2 ** lv, ::2 ** lv])
            tile_s, tile_bytes = [], 0
            cells = rng.permutation((size // TILE) ** 2)[:INGEST_TILES]
            for k, cell in enumerate(cells):
                y, x = (int(v) * TILE for v in divmod(int(cell), size // TILE))
                c = k % 3
                tile = make_field(TILE, seed + 70 + k)
                stats, secs = _put(client, INGEST_FILE, c, x, y, tile)
                tile_s.append(secs)
                tile_bytes += stats["bytes"]
                planes[c, y:y + TILE, x:x + TILE] = tile
                checked += _readback(client, INGEST_FILE, c, x, y, TILE, TILE, planes)
            # a reader during commits: only the old tile or a new one
            race_path = f"/tile/{INGEST_FILE}/0/0/0?x=0&y=0&w={TILE}&h={TILE}&format=png"
            legal = [planes[0, :TILE, :TILE].copy()]
            legal += [make_field(TILE, seed + 90 + k) for k in range(INGEST_RACE_COMMITS)]
            stop, seen, mixed = threading.Event(), [], []

            def reader():
                while not stop.is_set():
                    status, body, _ = client.get(race_path)
                    got = decode_png(body) if status == 200 else None
                    seen.append(status)
                    if got is None or not any(np.array_equal(got, t) for t in legal):
                        mixed.append(status)

            thread = threading.Thread(target=reader, name="ingest-reader")
            thread.start()
            try:
                for k in range(INGEST_RACE_COMMITS):
                    _put(client, INGEST_FILE, 0, 0, 0, legal[1 + k])
                    time.sleep(0.05)
            finally:
                stop.set()
                thread.join(60)
            planes[0, :TILE, :TILE] = legal[-1]
            checked += _readback(client, INGEST_FILE, 0, 0, 0, TILE, TILE, planes)
            # the same commits through the S3 stub, multipart included
            store = st.server.pipeline.pixels_service.get_pixel_buffer(INGEST_S3).store
            store.multipart_threshold, store.multipart_part_size = INGEST_MULTIPART
            s3_s, s3_bytes = [], 0
            for k, cell in enumerate(rng.permutation((size // TILE) ** 2)[:INGEST_S3_TILES]):
                y, x = (int(v) * TILE for v in divmod(int(cell), size // TILE))
                c = k % 3
                tile = make_field(TILE, seed + 100 + k)
                stats, secs = _put(client, INGEST_S3, c, x, y, tile)
                s3_s.append(secs)
                s3_bytes += stats["bytes"]
                s3_planes[c, y:y + TILE, x:x + TILE] = tile
                checked += _readback(client, INGEST_S3, c, x, y, TILE, TILE, s3_planes)
            launches = launch_counts()
            health = get_json(client, "/healthz")
    finally:
        stub.stop()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    require(mixed == [] and len(seen) > 0,
            f"path_ingest: {len(mixed)} of {len(seen)} racing reads were neither old nor new")
    require(launches["filter"] > 0 and launches["bitpack"] > 0,
            f"path_ingest: the filter or the SP packer never launched: {launches}")
    require(health["queue"]["failed"] == 0, "path_ingest: encode groups failed")
    ingest = health["ingest"]
    commits = 1 + INGEST_TILES + INGEST_RACE_COMMITS + INGEST_S3_TILES
    require(ingest["commits"] == commits and ingest["failures"] == 0,
            f"path_ingest: /healthz ingest {ingest}")
    require(stub.writes.get("CompleteMultipartUpload", 0) > 0,
            f"path_ingest: no multipart upload on the S3 stub: {stub.writes}")
    lat = np.array([r[2] for r in read_out]) * 1e3
    return {"phase": "path_ingest", "layout": "image 5's: NGFF 0.5, (1, 3, 1, 4096, 4096) "
            "uint16, 2048² shards of 512² chunks, blosc lz4 shuffle, crc32c, 3 levels",
            "planes": {"body_bytes": len(body), "commit_s": plane_s,
                       "commit_ms_per_plane": plane_s * 1e3 / 3, **plane_stats,
                       "mb_per_s_written": plane_stats["bytes"] / plane_s / 1e6,
                       "mb_per_s_body": len(body) / plane_s / 1e6},
            "read_after_write": {"tiles": len(reads), "tiles_per_s": len(reads) / read_s,
                                 "p50_ms": float(np.percentile(lat, 50)),
                                 "p99_ms": float(np.percentile(lat, 99))},
            "tile_commit_ms": _pct(tile_s),
            "tile_mb_per_s_written": tile_bytes / sum(tile_s) / 1e6,
            "racing_reads": {"reads": len(seen), "mixed": len(mixed),
                             "commits": INGEST_RACE_COMMITS},
            "s3": {"tile_commit_ms": _pct(s3_s), "mb_per_s_written": s3_bytes / sum(s3_s) / 1e6,
                   "multipart": list(INGEST_MULTIPART), "stub_writes": stub.writes},
            "tiles_verified": checked, "launches": launches, "ingest": ingest,
            "phase_s": time.perf_counter() - t_phase}


# ---------------------------------------------------------------------------
# the multi-device plane: two mesh slots on the one card
# ---------------------------------------------------------------------------

MESH_SLOTS = 2
MESH_PROBE_MS = 200
MESH_FULL = 4096  # the full-plane lane's side: larger than every bucket
MESH_FULL_TRIES = 6


def _mesh_requests(rng, data: np.ndarray, stack: np.ndarray) -> dict:
    # the full-plane lane goes with 15 tiles at once (a batch of one would
    # take the host route of a lone request); up to MESH_FULL_TRIES groups,
    # each at another origin, until one is batched
    full = [[(f"/tile/1/0/0/0?x={64 * k}&y=0&w={MESH_FULL}&h={MESH_FULL}&format=png",
              (64 * k, 0, MESH_FULL, MESH_FULL), 200)] + tile_requests(rng, data.shape[0], 15)
            for k in range(MESH_FULL_TRIES)]
    return {
        "warm": tile_requests(rng, data.shape[0], LANES),
        "render": render_requests(rng, stack.shape[-1], LANES),
        "histogram": [(p, spec, 200) for p, spec in histogram_requests(rng, stack, 8)],
        "pans": viewport_requests(rng, stack.shape[-1], 2),
        "full": full,
        "chaos": tile_requests(rng, data.shape[0], LANES),
        "healed": tile_requests(rng, data.shape[0], LANES),
    }


def _same_tiles(got, want, reqs, data: np.ndarray) -> int:
    """Two servers' ``/tile`` PNG bodies of ``reqs``: equal, or (a batch of
    one: the lone request's host route, on either side) one of them the
    host encode of the region and both the source's pixels. Returns the
    bodies that were equal."""
    from omero_ms_pixel_buffer_tpu_torch.ops.png import encode_png

    equal = 0
    for a, b, (path, (x, y, w, h), _) in zip(got, want, reqs):
        if a == b:
            equal += 1
            continue
        region = data[y:y + h, x:x + w]
        require(encode_png(region) in (a, b), f"path_mesh: {path} bodies differ")
        require(np.array_equal(decode_png(a), region) and np.array_equal(decode_png(b), region),
                f"path_mesh: {path} pixels differ from the source")
    return equal


def _serve_mesh_arm(registry: str, data: np.ndarray, stack: np.ndarray, mode: str, mesh: bool,
                    timed, extra: dict, device: str, full_groups=None) -> dict:
    """One server of ``path_mesh``: ``mode``, with or without the injected
    mesh of two slots on the card; the timed tiles, then (``dynamic``)
    render, histogram, pans and the full-plane lane, then (mesh) slot 1
    failed and healed. Returns bodies, rates and views."""
    import torch

    from omero_ms_pixel_buffer_tpu_torch.ops.kernels import launch_counts, slot_launch_counts
    from omero_ms_pixel_buffer_tpu_torch.parallel.mesh import make_mesh
    from omero_ms_pixel_buffer_tpu_torch.resilience.faultinject import INJECTOR, always, first_n

    st = ServerThread(registry, device=device, deflate_mode=mode, packer="pallas",
                      mesh={"probe-interval-ms": MESH_PROBE_MS} if mesh else None)
    if mesh:
        card = torch.device(device, 0)
        st.server.pipeline.mesh = make_mesh([card] * MESH_SLOTS)
    out = {"bodies": {}, "distributed_lanes": 0}
    before, slots_before = launch_counts(), slot_launch_counts()
    with st as client:
        run_requests(client, extra["warm"], LANES)
        main_before = get_json(client, "/healthz")
        main_out, secs = run_requests(client, timed, LANES)
        main_after = get_json(client, "/healthz")
        lat = np.array([r[2] for r in main_out]) * 1e3
        out.update({"tiles_per_s": len(timed) / secs, "p50_ms": float(np.percentile(lat, 50)),
                    "p99_ms": float(np.percentile(lat, 99)),
                    "timed_window": timed_window(main_before, main_after, secs)})
        out["bodies"]["tiles"] = [r[1] for r in main_out]
        if mode == "dynamic":
            for name in ("render", "histogram"):
                reqs = extra[name]
                res, secs = run_requests(client, reqs, LANES)
                out["bodies"][name] = [r[1] for r in res]
                require(all(r[0] == 200 for r in res), f"path_mesh {name}: {[r[0] for r in res]}")
                out[f"{name}_s"] = secs
            out["bodies"]["full"], groups = [], 0
            for reqs in extra["full"][:full_groups]:
                res = run_requests(client, reqs, len(reqs))[0]
                require(all(r[0] == 200 for r in res), f"path_mesh full: {[r[0] for r in res]}")
                out["bodies"]["full"] += [r[1] for r in res]
                groups += 1
                if full_groups is None and st.server.pipeline.distributed_lanes:
                    break
            out["full_groups"] = groups
            out["distributed_lanes"] = st.server.pipeline.distributed_lanes
            pans = []
            t0 = time.perf_counter()
            for view in extra["pans"]:
                res = run_requests(client, view, len(view))[0]
                require(all(r[0] == 200 for r in res), "path_mesh: a pan tile failed")
                pans += [r[1] for r in res]
            out["pans_s"] = time.perf_counter() - t0
            out["bodies"]["pans"] = pans
            if mesh:
                # slot 1 fails: the dispatch retries on the survivor
                INJECTOR.install("device.mesh-dispatch", first_n(1, RuntimeError("wedged")))
                INJECTOR.install(f"device.chip:{MESH_SLOTS - 1}",
                                 always(RuntimeError("slot down")))
                try:
                    res = run_requests(client, extra["chaos"], LANES)[0]
                    down = get_json(client, "/healthz")
                finally:
                    INJECTOR.clear()
                t0 = time.perf_counter()
                while (get_json(client, "/healthz")["render"]["mesh"]["healthy"] < MESH_SLOTS
                       and time.perf_counter() - t0 < 30):
                    time.sleep(0.05)
                out["readmitted_s"] = time.perf_counter() - t0
                healed_res = run_requests(client, extra["healed"], LANES)[0]
                t0 = time.perf_counter()
                while (set(get_json(client, "/healthz")["queue"]["mesh"]["warmed"])
                       != {1, MESH_SLOTS} and time.perf_counter() - t0 < 30):
                    time.sleep(0.05)
                out["down"] = {"mesh": down["render"]["mesh"],
                               "breaker": down["breakers"].get(f"device:{MESH_SLOTS - 1}")}
            else:
                res = run_requests(client, extra["chaos"], LANES)[0]
                healed_res = run_requests(client, extra["healed"], LANES)[0]
            out["bodies"]["chaos"] = [r[1] for r in res]
            out["bodies"]["healed"] = [r[1] for r in healed_res]
        health = get_json(client, "/healthz")
    out["mesh_built"] = st.server.pipeline.mesh is not None
    out["render_mesh"] = health["render"].get("mesh")
    out["supertile"] = health["supertile"]
    out["queue"] = health["queue"]
    out["launches"] = {k: v - before.get(k, 0) for k, v in launch_counts().items()}
    after_slots = slot_launch_counts()
    out["slot_launches"] = {i: after_slots.get(i, 0) - slots_before.get(i, 0)
                            for i in range(MESH_SLOTS)}
    return out


def mesh_programs(data: np.ndarray, stack: np.ndarray, seed: int) -> dict:
    """The sharded programs alone on the card, over a mesh of two slots on
    it and of one: device ms per call (torch.profiler, every kernel and
    copy of the call) beside the byte bound (inputs read and outputs
    written once at ``HBM_BYTES_PER_S``)."""
    import torch

    from omero_ms_pixel_buffer_tpu_torch.ops.convert import bits_tensor
    from omero_ms_pixel_buffer_tpu_torch.ops.device_deflate import build_dynamic_tables
    from omero_ms_pixel_buffer_tpu_torch.parallel import sharding as sh
    from omero_ms_pixel_buffer_tpu_torch.parallel.mesh import make_mesh
    from omero_ms_pixel_buffer_tpu_torch.render import analysis as ran
    from omero_ms_pixel_buffer_tpu_torch.render import engine as rengine
    from omero_ms_pixel_buffer_tpu_torch.render.luts import LutRegistry
    from omero_ms_pixel_buffer_tpu_torch.render.model import RenderSpec
    from omero_ms_pixel_buffer_tpu_torch.render.supertile import plan_mesh_partition

    card = torch.device("cuda", 0)
    tiles = bits_tensor(lane_tiles(data, seed)).to(card)  # (32, 512, 512)
    planes = bits_tensor(np.ascontiguousarray(render_lanes(stack, seed))).to(card)
    plane = bits_tensor(np.ascontiguousarray(data[:MESH_FULL, :MESH_FULL])).to(card)
    tables, luts = rengine.build_tables(RenderSpec.from_params({"c": RENDER_C}),
                                        np.dtype(np.uint16), LutRegistry())
    span = 4 * TILE
    st_stack = np.ascontiguousarray(stack[:, 0, :span, :span])
    rects = [(x, y, TILE, TILE) for y in range(0, span, TILE) for x in range(0, span, TILE)]
    hist_planes = np.ascontiguousarray(stack[:, 0, :TILE, :TILE].repeat(3, axis=0)[:8])
    hist_tabs = np.stack([ran.build_bin_table(np.dtype(np.uint16), (0.0, 65535.0), 256)] * 8)
    rows, row_bytes = TILE, 1 + TILE * 2
    out = {}
    for n in (MESH_SLOTS, 1):
        mesh = make_mesh([card] * n)
        flat, counts, extras = sh.sharded_filter_histogram(mesh, tiles, rows, row_bytes, 2)
        plan = build_dynamic_tables(counts.cpu().numpy(), extras.cpu().numpy(),
                                    real=tiles.shape[0])
        origins, (sub_h, sub_w), coords, _ = plan_mesh_partition(rects, span, span, n)
        sub = np.stack([st_stack[:, y:y + sub_h, x:x + sub_w] for y, x in origins])
        streams_rle = sh.sharded_filter_deflate(mesh, tiles, rows, row_bytes, 2)
        streams_dyn = sh.sharded_dynamic_emit(mesh, flat, plan)
        streams_render = sh.sharded_render_filter_deflate(mesh, planes, tables, luts, rows,
                                                          1 + TILE * 3)
        streams_st = sh.sharded_supertile_carve_deflate(mesh, sub, tables, luts, coords, TILE,
                                                        TILE)
        calls = {
            "sharded_batch_filter": (lambda: sh.sharded_batch_filter(mesh, tiles, 2),
                                     tiles.numel() * 2 + tiles.shape[0] * rows * row_bytes),
            "sharded_filter_deflate": (
                lambda: sh.sharded_filter_deflate(mesh, tiles, rows, row_bytes, 2),
                tiles.numel() * 2 + int(streams_rle[1].sum())),
            "sharded_filter_histogram": (
                lambda: sh.sharded_filter_histogram(mesh, tiles, rows, row_bytes, 2),
                tiles.numel() * 2 + flat.numel() + counts.numel() * 4),
            "sharded_dynamic_emit": (
                lambda: sh.sharded_dynamic_emit(mesh, flat, plan),
                flat.numel() + sum(np.asarray(t).nbytes for t in plan)
                + int(streams_dyn[1].sum())),
            "distributed_filter_plane": (
                lambda: sh.distributed_filter_plane(mesh, plane),
                plane.numel() * 2 + MESH_FULL * (1 + MESH_FULL * 2)),
            "sharded_render_filter_deflate": (
                lambda: sh.sharded_render_filter_deflate(mesh, planes, tables, luts, rows,
                                                         1 + TILE * 3),
                planes.numel() * 2 + int(streams_render[1].sum())),
            "sharded_supertile_carve_deflate": (
                lambda: sh.sharded_supertile_carve_deflate(mesh, sub, tables, luts, coords,
                                                           TILE, TILE),
                sub.nbytes + int(streams_st[1].sum())),
            "sharded_histogram_batch": (
                lambda: ran.sharded_histogram_batch(mesh, hist_planes, hist_tabs, 256),
                hist_planes.nbytes + hist_tabs.nbytes + 8 * 256 * 4),
        }
        for name, (call, nbytes) in calls.items():
            row = out.setdefault(name, {"bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
                                        "bound_by": "bytes"})
            row[f"device_ms_{n}_slot{'s' if n > 1 else ''}"] = call_device_ms(torch, call,
                                                                              iters=5)
            row[f"call_ms_{n}_slot{'s' if n > 1 else ''}"] = time_ms(torch, call, iters=5,
                                                                     warmup=1)
    return out


def drive_mesh(registry: str, data: np.ndarray, stack: np.ndarray, seed: int,
               device: str = "cuda") -> dict:
    """``path_mesh``: image 1 and image 2 served through a mesh of
    ``MESH_SLOTS`` slots injected on the one card (``reduced``: one card
    stands for two) and through the same pipeline without one (``"auto"``,
    which must build no mesh on a one-card host), in ``dynamic`` and in
    ``rle``: 256 timed ``/tile`` tiles, then (``dynamic``) 32 ``/render``
    tiles, 16 ``/histogram`` requests, two fused 4x4 pans and one 4096²
    full-plane lane (rows over the mesh), each body byte-equal between the
    two servers. Then slot 1 fails (``device.chip:1`` and one failed
    dispatch): the group retries at width 1 with the same bytes, the
    breaker ``device:1`` opens and the width listener warms the known
    shapes at 1; the prober (``mesh.probe-interval-ms`` 200) readmits slot
    1 and the width listener fires at 2. Reports tiles/s with and without
    the mesh, the launches per slot and the sharded programs alone."""
    from omero_ms_pixel_buffer_tpu_torch.ops.kernels import launch_counts, reset_launch_counts

    t_phase = time.perf_counter()
    rng = np.random.default_rng(seed + 80)
    timed = tile_requests(rng, data.shape[0], 256)
    extra = _mesh_requests(rng, data, stack)
    reset_launch_counts()
    arms = {}
    for mode in ("dynamic", "rle"):
        # the mesh first: it sends full-plane groups until one is batched,
        # and the server without the mesh then sends as many
        arms[(mode, True)] = _serve_mesh_arm(registry, data, stack, mode, True, timed, extra,
                                             device)
        arms[(mode, False)] = _serve_mesh_arm(registry, data, stack, mode, False, timed, extra,
                                              device, arms[(mode, True)].get("full_groups"))
    launches = launch_counts()
    checked = equal = 0
    tile_reqs = {"tiles": timed, "full": [r for g in extra["full"] for r in g],
                 "chaos": extra["chaos"], "healed": extra["healed"]}
    for mode in ("dynamic", "rle"):
        plain, meshed = arms[(mode, False)], arms[(mode, True)]
        require(not plain["mesh_built"] and plain["render_mesh"] is None,
                f"path_mesh: 'auto' built a mesh on a one-card host ({mode})")
        require(meshed["render_mesh"] is not None, "path_mesh: the mesh has no manager")
        for name, bodies in plain["bodies"].items():
            if name in tile_reqs:
                equal += _same_tiles(meshed["bodies"][name], bodies, tile_reqs[name], data)
            else:
                require(meshed["bodies"][name] == bodies,
                        f"path_mesh {mode}: {name} bodies differ with the mesh")
                equal += len(bodies)
            checked += len(bodies)
        slots = meshed["slot_launches"]
        require(all(slots[i] > 0 for i in range(MESH_SLOTS)),
                f"path_mesh {mode}: a slot never launched: {slots}")
        require(meshed["queue"]["failed"] == 0 and plain["queue"]["failed"] == 0,
                f"path_mesh {mode}: encode groups failed")
    verify([(200, b, 0) for b in arms[("dynamic", False)]["bodies"]["tiles"]], timed, data)
    ref = RenderReference(stack)
    verify_render([(200, b, 0) for b in arms[("dynamic", True)]["bodies"]["render"]],
                  extra["render"], ref)
    for body, (path, spec, _) in zip(arms[("dynamic", True)]["bodies"]["histogram"],
                                     extra["histogram"]):
        verify_histogram(body, stack, spec)
    verify([(200, b, 0) for b in arms[("dynamic", True)]["bodies"]["full"]],
           tile_reqs["full"], data)
    require(arms[("dynamic", True)]["distributed_lanes"] > 0,
            "path_mesh: the full-plane lane did not take the distributed route")
    meshed = arms[("dynamic", True)]
    down = meshed["down"]
    require(down["mesh"]["healthy"] == MESH_SLOTS - 1
            and down["mesh"]["last_dispatch"]["n_devices"] == MESH_SLOTS - 1
            and down["breaker"]["state"] == "open",
            f"path_mesh: slot {MESH_SLOTS - 1} did not drop out: {down}")
    require(meshed["render_mesh"]["healthy"] == MESH_SLOTS
            and meshed["render_mesh"]["last_dispatch"]["n_devices"] == MESH_SLOTS,
            f"path_mesh: the prober did not readmit the slot: {meshed['render_mesh']}")
    require(set(meshed["queue"]["mesh"]["warmed"]) == {1, MESH_SLOTS},
            f"path_mesh: the width listener warmed {meshed['queue']['mesh']}")
    require(launches["filter"] > 0 and launches["bitpack"] > 0,
            f"path_mesh: the filter or the SP packer never launched: {launches}")
    report = {"phase": "path_mesh", "slots": MESH_SLOTS,
              "reduced": "two mesh slots on one card stand for two cards",
              "bodies_compared": checked, "bodies_equal": equal, "launches": launches,
              "programs": mesh_programs(data, stack, seed) if device == "cuda" else None}
    for (mode, mesh), arm in arms.items():
        key = f"{mode}_{'mesh' if mesh else 'single'}"
        report[key] = {k: v for k, v in arm.items()
                       if k not in ("bodies", "queue", "mesh_built")}
        report[key]["stage_ms_mean"] = arm["queue"]["stage_ms_mean"]
    report["phase_s"] = time.perf_counter() - t_phase
    return report


# ---------------------------------------------------------------------------
# slice 18: the PNG policy, the whole-host engine, the planes turned off and
# the kernel microbenchmarks
# ---------------------------------------------------------------------------

POLICY_MODES = (("up", 6, "fast"), ("none", 6, "fast"), ("sub", 6, "fast"),
                ("average", 6, "fast"), ("paeth", 6, "fast"), ("adaptive", 9, "default"))
POLICY_REQUESTS = 64
POLICY_RENDER = 32  # /render lanes of image 2 under paeth


def png_scanlines(body: bytes):
    """(filtered scanlines (H, 1 + row bytes) uint8, width, height, colour
    type) of a PNG, its CRCs checked."""
    require(body[:8] == b"\x89PNG\r\n\x1a\n", "not a PNG")
    pos, idat = 8, b""
    while pos < len(body):
        (n,) = struct.unpack(">I", body[pos:pos + 4])
        tag, data = body[pos + 4:pos + 8], body[pos + 8:pos + 8 + n]
        require(zlib.crc32(tag + data) & 0xFFFFFFFF
                == struct.unpack(">I", body[pos + 8 + n:pos + 12 + n])[0], "bad CRC")
        if tag == b"IHDR":
            w, h, depth, color = struct.unpack(">IIBB", data[:10])
        elif tag == b"IDAT":
            idat += data
        pos += 12 + n
    rb = w * (3 if color == 2 else 1) * depth // 8
    return np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + rb), w, h, color


def check_filtered(body: bytes, pixels: np.ndarray, mode: str) -> set:
    """A PNG body held against its source pixels under filter ``mode``:
    its inflated scanlines must equal the port's numpy filter of the
    pixels' big-endian rows (``filter_rows_np``: the reference the kernel
    and the JAX filter are pinned to), so every pixel and every row's
    filter-type byte is right. Returns the set of filter-type bytes."""
    from omero_ms_pixel_buffer_tpu_torch.ops.png import filter_rows_np

    rows, w, h, _ = png_scanlines(body)
    be = np.ascontiguousarray(pixels.astype(pixels.dtype.newbyteorder(">")))
    src = be.view(np.uint8).reshape(pixels.shape[0], -1)
    bpp = (3 if pixels.ndim == 3 else 1) * pixels.dtype.itemsize
    require((w, h) == (pixels.shape[1], pixels.shape[0]), "PNG size differs from the source")
    require(np.array_equal(rows, filter_rows_np(src, bpp, mode)),
            f"{mode}: scanlines differ from the source filtered in numpy")
    return set(rows[:, 0].tolist())


def drive_png_policy(registry: str, data: np.ndarray, stack: np.ndarray, seed: int,
                     device: str = "cuda") -> dict:
    """``path_png_policy``: image 1 through one server per PNG policy
    (``backend.png`` filter, level, strategy), the device engine,
    ``dynamic``: ``up`` (the reference arm), the filter kernel's four other
    modes and ``adaptive`` at level 9, strategy ``default``. Each serves
    one warm-up round of 32 tiles and the same ``POLICY_REQUESTS`` timed
    512² PNG tiles at 32 clients; every body's scanlines equal the source
    filtered in numpy in the server's mode (the filter-type byte of every
    row is the mode's, or for ``adaptive`` the row's choice). The device
    modes launch the filter kernel and the SP packer; ``adaptive`` lanes
    launch nothing, take the host route (``host_png_lanes``, or the lone
    host route) and their ETags differ from ``up``'s. The ``paeth`` server
    also renders ``POLICY_RENDER`` three-channel ``/render`` lanes of
    image 2, held against the numpy composite filtered with paeth."""
    from omero_ms_pixel_buffer_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    from omero_ms_pixel_buffer_tpu_torch.ops.png import FILTER_CODES

    size = data.shape[0]
    rng = np.random.default_rng(seed + 21)
    warm = tile_requests(rng, size, LANES)
    timed = tile_requests(rng, size, POLICY_REQUESTS)
    ref = RenderReference(stack)
    renders = render_requests(np.random.default_rng(seed + 22), stack.shape[-1], POLICY_RENDER)
    arms, etags = {}, {}
    for mode, level, strategy in POLICY_MODES:
        png = {"filter": mode, "level": level, "strategy": strategy}
        with ServerThread(registry, device=device, png=png) as client:
            reset_launch_counts()
            for (path, (x, y, w, h), _), (status, body, _) in zip(
                    warm, run_requests(client, warm, LANES)[0]):
                require(status == 200, f"{mode}: {path} answered {status}")
                check_filtered(body, data[y:y + h, x:x + w], mode)
            before = get_json(client, "/healthz")
            with concurrent.futures.ThreadPoolExecutor(LANES) as pool:
                t0 = time.perf_counter()
                out = list(pool.map(lambda r: client.request("GET", r[0]), timed))
                secs = time.perf_counter() - t0
            after = get_json(client, "/healthz")
            tile_launches = launch_counts()
            render = None
            if mode == "paeth":
                r_out, r_secs = run_requests(client, renders, LANES)
                for (status, body, _), (path, (x, y, w, h), _, query) in zip(r_out, renders):
                    require(status == 200, f"paeth render: {path} answered {status}")
                    types = check_filtered(body, ref.rgb(query, x, y, w, h), "paeth")
                    require(types == {FILTER_CODES["paeth"]}, f"render filter types {types}")
                render = {"requests": len(renders), "tiles_per_s": len(renders) / r_secs,
                          **latency(r_out)}
            launches = launch_counts()
            health = get_json(client, "/healthz")
        types_seen = set()
        for (status, hdrs, body, _), (path, (x, y, w, h), _) in zip(out, timed):
            require(status == 200, f"{mode}: {path} answered {status}")
            types = check_filtered(body, data[y:y + h, x:x + w], mode)
            if mode != "adaptive":
                require(types == {FILTER_CODES[mode]}, f"{mode}: filter types {types}")
            types_seen |= types
            etags.setdefault(path, {})[mode] = hdrs["ETag"]
        window = timed_window(before, after, secs)
        if mode == "adaptive":
            require(tile_launches["filter"] == 0 and tile_launches["bitpack"] == 0,
                    f"adaptive lanes launched a kernel: {tile_launches}")
            require(window["lanes"] == 0 and window["host_png_lanes"] > 0,
                    f"adaptive lanes left the host route: {window}")
        else:
            require(tile_launches["filter"] > 0 and tile_launches["bitpack"] > 0,
                    f"{mode}: the filter or the SP packer never launched: {tile_launches}")
        require(health["queue"]["failed"] == 0, f"{mode}: encode groups failed")
        arms[f"{mode}.{level}.{strategy}"] = {
            "tiles_per_s": POLICY_REQUESTS / secs, **latency([(o[3],) for o in out]),
            "launches": tile_launches, "filter_types": sorted(types_seen),
            "stream_bytes_mean": float(np.mean([png_stream_len(o[2]) for o in out])),
            "device_lanes": window["lanes"], "lone_lanes": window["lone_lanes"],
            "host_png_lanes": window["host_png_lanes"], "groups": window["groups"],
            "stage_ms_mean": window["stage_ms_mean"], "render": render,
            "render_launches": ({k: launches[k] - tile_launches[k] for k in launches}
                                if render else None)}
    for path, by_mode in etags.items():
        others = [m for m in by_mode if m != "up"]
        require(all(by_mode[m] != by_mode["up"] for m in others),
                f"{path}: an ETag equals the up policy's: {by_mode}")
    return {"phase": "path_png_policy", "requests": POLICY_REQUESTS, "concurrency": LANES,
            "arms": arms, "tiles_checked": len(POLICY_MODES) * (LANES + POLICY_REQUESTS),
            "renders_checked": POLICY_RENDER, "etags_differ_from_up": len(etags)}


HOST_TILES, HOST_RENDERS, HOST_HISTOGRAMS = 256, 64, 8  # the histograms add 8 full planes


def compute_pids() -> list:
    """The pids ``nvidia-smi`` lists with a compute context."""
    import subprocess

    out = subprocess.run(["nvidia-smi", "--query-compute-apps=pid", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=30, check=True).stdout
    return [int(ln) for ln in out.split() if ln.strip().isdigit()]


def drive_host_engine(registry: str, data: np.ndarray, stack: np.ndarray, seed: int,
                      device: str = "cuda") -> dict:
    """``path_host_engine``: the port as a ``--config`` subprocess with
    ``backend.engine: host``, then with ``backend.batching.device-encode:
    false`` (``--device cuda`` both times: the host engine reads no
    device), the two started together. Each serves ``HOST_TILES`` image-1
    ``/tile`` PNG tiles and ``HOST_RENDERS`` image-2 ``/render`` tiles at
    32 clients, ``HOST_HISTOGRAMS`` region and 8 full-plane ``/histogram``
    requests, and a 4x4 super-tile viewport at once: every tile against
    its source pixels, the first arm's renders and histograms against the
    numpy composite and ``np.bincount``, the second's against the first's
    bytes. Each subprocess's ``/healthz`` must show no plane
    cache, no encode queue, no GPU, no CUDA context and zero launches, its
    pid must be absent from ``nvidia-smi --query-compute-apps``, and this
    process's launch counters must not move."""
    from omero_ms_pixel_buffer_tpu_torch.ops.kernels import launch_counts

    os.makedirs(WORK, exist_ok=True)
    size = data.shape[0]
    tiles = tile_requests(np.random.default_rng(seed + 31), size, HOST_TILES)
    renders = render_requests(np.random.default_rng(seed + 32), stack.shape[-1], HOST_RENDERS)
    hists = histogram_requests(np.random.default_rng(seed + 33), stack, HOST_HISTOGRAMS)
    view = viewport_requests(np.random.default_rng(seed + 34), stack.shape[-1], 1)[0]
    ref = RenderReference(stack)
    smi_self = os.getpid() in compute_pids()
    launches0 = launch_counts()
    arms, first = {}, None
    with contextlib.ExitStack() as stack_ctx:
        procs = {}
        for name, backend in (("engine_host", {"engine": "host"}),
                              ("device_encode_false", {"batching": {"device-encode": False}})):
            cfg = os.path.join(WORK, f"{name}.yaml")
            with open(cfg, "w") as f:
                json.dump({"session-store": {"type": "memory"}, "image-registry": registry,
                           "backend": backend, "cache": {"prefetch": {"enabled": False}}}, f)
            procs[name] = stack_ctx.enter_context(
                PortProcess(["--config", cfg, "--dev", "--device", "cuda"], name, wait=False))
        for proc in procs.values():  # started together
            proc.wait_listening()
        for name, proc in procs.items():
            client = Client(proc.port)
            try:
                t_out, t_secs = run_requests(client, tiles, LANES)
                checked = verify(t_out, tiles, data)
                r_out, r_secs = run_requests(client, renders, LANES)
                with concurrent.futures.ThreadPoolExecutor(LANES) as pool:
                    t0 = time.perf_counter()
                    h_out = list(pool.map(lambda r: client.request("GET", r[0]), hists))
                    h_secs = time.perf_counter() - t0
                v_out, v_secs = run_requests(client, view, len(view))
                health = get_json(client, "/healthz")
                pids = compute_pids()
            finally:
                client.close()
            bodies = ([b for _, b, _ in r_out], [o[2] for o in h_out], [b for _, b, _ in v_out])
            if first is None:
                # the first arm against the sources; the second must answer
                # the same bytes (renders and histograms take one route)
                checked += verify_render(r_out, renders, ref) + verify_render(v_out, view, ref)
                for (status, _, body, _), (path, spec) in zip(h_out, hists):
                    require(status == 200, f"{name}: {path} answered {status}")
                    verify_histogram(body, stack, spec)
                first = bodies
            else:
                require(bodies == first, f"{name}: render or histogram bodies differ from "
                        "the first arm's")
                checked += len(r_out) + len(v_out)
            pid, rc = proc.pid, proc.stop()
            require(rc == 0, f"{name}: the port exited {rc}")
            require(health["config"]["pipeline_engine"] == "host"
                    and health["device"] == "host",
                    f"{name}: not the host engine: {health['config']}")
            require(health["plane_cache"] is None and health["queue"] is None
                    and health["gpu"] is None and not health["cuda_initialized"],
                    f"{name}: a device object or a CUDA context: {health['gpu']}")
            require(all(v == 0 for v in health["kernels"].values()),
                    f"{name}: a kernel launched: {health['kernels']}")
            require(pid not in pids, f"{name}: nvidia-smi lists the host engine's pid {pid}")
            arms[name] = {
                "tiles": {"requests": len(tiles), "tiles_per_s": len(tiles) / t_secs,
                          **latency(t_out)},
                "render": {"requests": len(renders), "tiles_per_s": len(renders) / r_secs,
                           **latency(r_out)},
                "histogram": {"requests": len(hists), "per_s": len(hists) / h_secs,
                              **latency([(o[3],) for o in h_out])},
                "supertile_view": {"requests": len(view), "seconds": v_secs,
                                   "groups": health["supertile"]["groups"],
                                   "host_lanes": health["supertile"]["host_lanes"]},
                "bodies_checked": checked + len(h_out), "startup_s": proc.startup_s,
                "host_png_lanes": health["host_png_lanes"], "lone": health["batcher"]["lone"],
                "render_host_lanes": health["render"]["host_lanes"],
                "host_engine": health["host_engine"], "kernels": health["kernels"],
                "cuda_initialized": health["cuda_initialized"], "compute_pids": pids,
                "exit_code": rc}
    require(launch_counts() == launches0, "this process launched a kernel during the phase")
    return {"phase": "path_host_engine", "arms": arms, "smi_lists_this_process": smi_self}


PLANES_OFF_REPEATS, PLANES_OFF_BURST, PLANES_OFF_INFLIGHT = 32, 64, 4


def drive_planes_off(registry: str, data: np.ndarray, seed: int, device: str = "cuda") -> dict:
    """``path_planes_off``: a server with ``cache.enabled: false`` and
    ``slo.enabled: false``, ``resilience.admission.max-inflight`` 4 (the
    binary door gate). One tile asked ``PLANES_OFF_REPEATS`` times in turn:
    every answer 200 with the source's pixels and no ``ETag``,
    ``Cache-Control`` or ``X-Cache``, each one executed (the batcher's
    lanes). Then ``PLANES_OFF_BURST`` distinct tiles at once: 200s with
    the source's pixels and 503s, each with ``Retry-After``, the 503s equal
    to the gate's sheds; ``/healthz`` and ``/metrics`` answer 200 during
    the burst."""
    from omero_ms_pixel_buffer_tpu_torch.ops.kernels import launch_counts, reset_launch_counts

    size = data.shape[0]
    one = tile_requests(np.random.default_rng(seed + 41), size, 1) * PLANES_OFF_REPEATS
    burst = tile_requests(np.random.default_rng(seed + 42), size, PLANES_OFF_BURST)
    with ServerThread(registry, device=device, cache=False, slo=False,
                      max_inflight=PLANES_OFF_INFLIGHT) as client:
        reset_launch_counts()
        h0 = get_json(client, "/healthz")
        repeat_out = [client.request("GET", one[0][0]) for _ in one]
        h1 = get_json(client, "/healthz")
        side = Client(client.port)
        try:
            with concurrent.futures.ThreadPoolExecutor(PLANES_OFF_BURST) as pool:
                t0 = time.perf_counter()
                futs = [pool.submit(client.request, "GET", r[0]) for r in burst]
                time.sleep(0.05)
                health_mid = side.request("GET", "/healthz")
                metrics_mid = side.request("GET", "/metrics")
                burst_out = [f.result() for f in futs]
                secs = time.perf_counter() - t0
        finally:
            side.close()
        h2 = get_json(client, "/healthz")
        launches = launch_counts()
    for status, hdrs, body, _ in repeat_out:
        require(status == 200, f"a repeat answered {status}")
        require(not {"ETag", "Cache-Control", "X-Cache"} & set(hdrs),
                f"a cache header with the cache off: {hdrs}")
    verify([(s, b, t) for s, _, b, t in repeat_out], one, data)
    executed = h1["batcher"]["lanes"] - h0["batcher"]["lanes"]
    require(executed == PLANES_OFF_REPEATS, f"{executed} of {PLANES_OFF_REPEATS} repeats executed")
    statuses = [s for s, _, _, _ in burst_out]
    require(set(statuses) <= {200, 503} and 503 in statuses and 200 in statuses,
            f"burst statuses {sorted(set(statuses))}")
    ok = [(s, b, t) for s, _, b, t in burst_out if s == 200]
    verify(ok, [r for r, (s, *_) in zip(burst, burst_out) if s == 200], data)
    require(all("Retry-After" in h for s, h, _, _ in burst_out if s == 503),
            "a 503 without Retry-After")
    shed = h2["admission"]["shed_total"] - h1["admission"]["shed_total"]
    require(shed == statuses.count(503), f"{shed} sheds for {statuses.count(503)} 503s")
    require(health_mid[0] == 200 and metrics_mid[0] == 200,
            f"/healthz {health_mid[0]}, /metrics {metrics_mid[0]} during the burst")
    require(h2["slo"] == {"enabled": False} and h2["result_cache"] == {"enabled": False},
            "a plane is on")
    return {"phase": "path_planes_off", "repeats": PLANES_OFF_REPEATS, "executed": executed,
            "hits": 0, "burst": PLANES_OFF_BURST, "max_inflight": PLANES_OFF_INFLIGHT,
            "ok": statuses.count(200), "shed_503": statuses.count(503), "seconds": secs,
            **latency([(o[3],) for o in burst_out if o[0] == 200]),
            "healthz_during_burst": health_mid[0], "metrics_during_burst": metrics_mid[0],
            "launches": launches, "lone": h2["batcher"]["lone"] - h1["batcher"]["lone"]}


def drive_microbench(device: str = "cuda") -> dict:
    """``microbench``: ``runtime/microbench.run_microbench()`` at the JAX
    defaults (32 lanes of 512², a 4096² resident plane) on the card, with
    the launches it made; ``project_throughput`` at a 12.5 GB/s link."""
    from omero_ms_pixel_buffer_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    from omero_ms_pixel_buffer_tpu_torch.runtime.microbench import (
        project_throughput,
        run_microbench,
    )

    reset_launch_counts()
    t0 = time.perf_counter()
    micro = run_microbench(device=device)
    secs = time.perf_counter() - t0
    launches = launch_counts()
    require(micro["backend"] == "cuda" or device != "cuda", "the microbench left the card")
    require(launches["filter"] > 0 and launches["bitpack"] > 0,
            f"microbench: the filter or the SP packer never launched: {launches}")
    return {"phase": "microbench", **micro, "launches": launches, "seconds": secs,
            "projection": project_throughput(micro, 12500.0)}


def smi_line() -> str:
    import subprocess

    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=30, check=True,
    ).stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--size", type=int, default=8192)
    p.add_argument("--requests", type=int, default=256,
                   help="timed requests of the dynamic phase")
    p.add_argument("--rle-requests", type=int, default=128,
                   help="timed requests of each rle phase")
    p.add_argument("--stored-requests", type=int, default=32,
                   help="requests of the stored phase")
    p.add_argument("--render-size", type=int, default=4096,
                   help="width and height of the render stack (image 2)")
    p.add_argument("--render-requests", type=int, default=128,
                   help="timed requests of the render phase")
    p.add_argument("--histogram-requests", type=int, default=128,
                   help="timed region requests of the histogram phase (plus 8 full planes)")
    p.add_argument("--viewports", type=int, default=8,
                   help="4x4 viewports of the super-tile phases")
    p.add_argument("--wsi-size", type=int, default=8192,
                   help="width and height of the RGB JPEG pyramid (image 3)")
    p.add_argument("--wsi-requests", type=int, default=256,
                   help="timed tiles of path_wsi (path_wsi_device_idct takes a quarter)")
    p.add_argument("--zarr-size", type=int, default=8192,
                   help="width and height of the NGFF 0.4 image (image 4)")
    p.add_argument("--zarr-requests", type=int, default=128,
                   help="timed level-0 tiles of path_zarr")
    p.add_argument("--zarr-s3-requests", type=int, default=64,
                   help="timed tiles of path_zarr_s3")
    p.add_argument("--config-requests", type=int, default=256,
                   help="timed requests of path_config (at most --requests)")
    p.add_argument("--paths-only", action="store_true",
                   help="only build, then the path (dynamic), path_obs, path_prefetch, "
                        "path_session, path_render, path_config, path_disk, path_fleet and "
                        "path_gossip phases, e.g. to pair two versions with --port-root "
                        "(no result line)")
    p.add_argument("--slice-paths", action="store_true",
                   help="only build, the fixtures of images 1 and 2, then the path_png_policy, "
                        "path_host_engine, path_planes_off and microbench phases "
                        "(no result line)")
    p.add_argument("--filter-sweep", action="store_true",
                   help="only build, then time the filter kernel over launch shapes "
                        "(no path phases, no result line)")
    p.add_argument("--bitpack-time", action="store_true",
                   help="only build, then time the scalar-prefetch packer on the real "
                        "pass-2 tokens (no path phases, no result line)")
    p.add_argument("--dense-time", action="store_true",
                   help="only build, then time the dense packer on the real rle tokens "
                        "(no path phases, no result line)")
    p.add_argument("--bitpack-sweep", action="store_true",
                   help="only build, then time the scalar-prefetch kernel's default and "
                        "stamped builds, with the CTAs' phase times "
                        "(no path phases, no result line)")
    p.add_argument("--port-root", default=None,
                   help="import the port package from this checkout instead of the one "
                        "beside this script (to time another version with this code)")
    args = p.parse_args(argv)
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    if args.port_root:
        sys.path.insert(0, os.path.abspath(args.port_root))
    try:
        from omero_ms_pixel_buffer_tpu_torch.ops.kernels import _build
    except ImportError as e:
        print(f"chip_smoke: the port package is not beside this script: {e}",
              file=sys.stderr)
        return 2
    closers = []
    try:
        t0 = time.perf_counter()
        report = _build.build()
        emit({"phase": "build", "seconds": time.perf_counter() - t0,
              "compiled": {k: v["seconds"] for k, v in report.items()},
              "ptxas": {k: [ln.strip() for ln in v["log"].splitlines()
                            if "registers" in ln or "spill" in ln]
                        for k, v in report.items()}})
        t0 = time.perf_counter()
        data = make_field(args.size, args.seed)
        stack = make_stack(args.render_size, args.seed)
        registry = write_fixture(data, stack)
        emit({"phase": "fixture", "size": args.size, "render_stack": list(stack.shape),
              "seconds": time.perf_counter() - t0})
        if args.slice_paths:
            emit(drive_png_policy(registry, data, stack, args.seed))
            emit(drive_host_engine(registry, data, stack, args.seed))
            emit(drive_planes_off(registry, data, args.seed))
            emit(drive_microbench())
            print(smi_line(), flush=True)
            return 0
        if args.paths_only:
            path = drive_path(registry, data, args.seed, args.requests, "dynamic", "pallas",
                              launched=("filter", "bitpack"), idle=("bitpack_dense",))
            path_timed = path.pop("_timed")
            emit(path)
            emit(drive_obs(registry, data, path_timed[0], args.seed))
            emit(drive_prefetch(registry, data, args.seed))
            emit(drive_session(registry, data, args.seed))
            emit(drive_render(registry, stack, args.seed, args.render_requests))
            emit(drive_config(registry, data, *path_timed, args.config_requests, args.seed))
            emit(drive_disk(registry, data))
            emit(drive_fleet(registry, data, path_timed[0], args.seed))
            emit(drive_gossip(registry, data, path_timed[0], args.seed))
            print(smi_line(), flush=True)
            return 0
        t0 = time.perf_counter()
        wsi = make_wsi(args.wsi_size, args.seed)
        layouts = layout_data(args.seed)
        wsi_registry, wsi_path, real_zstd = write_wsi_fixtures(wsi, layouts)
        del wsi
        emit({"phase": "fixture_wsi", "size": args.wsi_size, "tile": WSI_TILE,
              "levels": wsi_levels(args.wsi_size), "jpeg": "quality 85, 4:2:0",
              "file_bytes": os.path.getsize(wsi_path), "zstandard": real_zstd,
              "layouts": {rid: name for rid, (name, _) in LAYOUTS.items()},
              "seconds": time.perf_counter() - t0})
        t0 = time.perf_counter()
        img4, img5 = make_zarr_images(args.zarr_size, args.seed)
        zarr_fx = write_zarr_fixtures(img4, img5)
        emit({"phase": "fixture_zarr",
              "image4": {"ngff": "0.4", "zarr_format": 2, "shape": list(img4.shape),
                         "chunks": [ZARR_CHUNK, ZARR_CHUNK], "levels": zarr_levels(args.zarr_size),
                         "codec": "blosc lz4 clevel 5, byte shuffle",
                         "absent_chunk": list(ZARR_ABSENT), "frames": zarr_fx["frames"][0],
                         "bytes": zarr_fx["bytes"][0], "write_s": zarr_fx["write_s"][0]},
              "image5": {"ngff": "0.5", "zarr_format": 3, "shape": list(img5.shape),
                         "shards": [ZARR5_SHARD] * 2, "inner_chunks": [ZARR5_INNER] * 2,
                         "levels": ZARR5_LEVELS, "codec": "blosc lz4, shuffle, crc32c",
                         "frames": zarr_fx["frames"][1], "bytes": zarr_fx["bytes"][1],
                         "write_s": zarr_fx["write_s"][1], "store": f"s3://{S3_BUCKET} (stub)"},
              "pool_workers": zarr_fx["workers"], "seconds": time.perf_counter() - t0})
        device = torch.device("cuda", 0)
        if args.filter_sweep:
            emit(filter_sweep(torch, device, lane_tiles(data, args.seed)))
            print(smi_line(), flush=True)
            return 0
        if args.bitpack_time or args.dense_time:
            emit(packer_time(torch, device, lane_tiles(data, args.seed), args.dense_time))
            print(smi_line(), flush=True)
            return 0
        if args.bitpack_sweep:
            bitpack_sweep(torch, device, lane_tiles(data, args.seed), args.seed)
            print(smi_line(), flush=True)
            return 0
        kernels = check_kernels(torch, device, lane_tiles(data, args.seed), args.seed)
        render_rows, render_line = check_render_kernels(torch, device, stack, args.seed)
        emit(render_line)
        kernels += render_rows
        # the WSI shapes and the IDCT are timed beside the other kernels,
        # before any server has run in this process
        ref = HostDecode(wsi_path)
        closers.append(ref.close)
        kernels += check_wsi_kernels(torch, device, wsi_tiles(ref, args.seed))
        emit(check_idct(torch, device, wsi_path, args.seed))
        emit(http_contract(registry, data))
        path = drive_path(registry, data, args.seed, args.requests, "dynamic", "pallas",
                          launched=("filter", "bitpack"), idle=("bitpack_dense",))
        require(path["plane_cache"]["hits"] > 0, "plane cache had no hits")
        path_timed = path.pop("_timed")
        emit(path)
        obs = drive_obs(registry, data, path_timed[0], args.seed)
        emit(obs)
        prefetch = drive_prefetch(registry, data, args.seed)
        emit(prefetch)
        session = drive_session(registry, data, args.seed)
        emit(session)
        rle = drive_path(registry, data, args.seed, args.rle_requests, "rle", "pallas_dense",
                         launched=("filter", "bitpack_dense"), idle=("bitpack",))
        require(rle["plane_cache"]["hits"] > 0, "plane cache had no hits (rle)")
        rle.pop("_timed")
        rle["stream_bytes_mean_dynamic"] = path["stream_bytes_mean"]
        rle["stream_bytes_ratio_rle_to_dynamic"] = (
            rle["stream_bytes_mean"] / path["stream_bytes_mean"])
        emit(rle)
        # the same mode with the dynamic phase's packer: against ``path`` it
        # changes the mode alone
        rle_sp = drive_path(registry, data, args.seed, args.rle_requests, "rle", "pallas",
                            launched=("filter", "bitpack"), idle=("bitpack_dense",),
                            phase="path_rle_sp")
        require(rle_sp["plane_cache"]["hits"] > 0, "plane cache had no hits (rle, pallas)")
        rle_sp.pop("_timed")
        emit(rle_sp)
        stored = drive_path(registry, data, args.seed, args.stored_requests, "stored", "pallas",
                            launched=("filter",), idle=("bitpack", "bitpack_dense"),
                            warm_rounds=0, edges=False)
        stored.pop("_timed")
        emit(stored)
        render = drive_render(registry, stack, args.seed, args.render_requests)
        emit(render)
        emit(drive_host_deflate(registry, data, args.seed))
        policy = drive_png_policy(registry, data, stack, args.seed)
        emit(policy)
        emit(drive_histogram(registry, stack, args.seed, args.histogram_requests))
        emit(supertile_pair(registry, stack, args.seed, args.viewports))
        wsi_run = drive_wsi(wsi_registry, ref, args.seed, args.wsi_requests)
        emit(wsi_run)
        emit(drive_wsi(wsi_registry, ref, args.seed, max(LANES, args.wsi_requests // 4),
                       device_idct=True))
        emit(drive_layouts(wsi_registry, layouts, real_zstd))
        emit(drive_zarr(zarr_fx["registry"], img4, args.seed, args.zarr_requests))
        emit(drive_zarr_s3(zarr_fx["registry"], img5, args.seed, args.zarr_s3_requests))
        for line in drive_viewer(zarr_fx["registry"], img4, args.seed):
            emit(line)
        emit(drive_config(registry, data, *path_timed, args.config_requests, args.seed))
        emit(drive_host_engine(registry, data, stack, args.seed))
        planes_off = drive_planes_off(registry, data, args.seed)
        emit(planes_off)
        disk = drive_disk(registry, data)
        emit(disk)
        fleet = drive_fleet(registry, data, path_timed[0], args.seed)
        emit(fleet)
        gossip = drive_gossip(registry, data, path_timed[0], args.seed)
        emit(gossip)
        ingest = drive_ingest(write_ingest_fixtures(), img5, args.seed)
        emit(ingest)
        mesh = drive_mesh(registry, data, stack, args.seed)
        emit(mesh)
        micro = drive_microbench()
        emit(micro)
        # each kernel's launches come from the phases that run it; the
        # filter's paeth and average rows from their path_png_policy arms
        arms = policy["arms"]
        main_phases = (path, obs, prefetch, session, planes_off, disk, fleet, gossip, ingest,
                       mesh, micro, arms["up.6.fast"], arms["none.6.fast"], arms["sub.6.fast"])
        launches = {"filter": sum(ph["launches"]["filter"] for ph in main_phases),
                    "bitpack": (sum(ph["launches"]["bitpack"] for ph in main_phases)
                                + arms["average.6.fast"]["launches"]["bitpack"]
                                + arms["paeth.6.fast"]["launches"]["bitpack"]),
                    "filter_u16_average": arms["average.6.fast"]["launches"]["filter"],
                    "filter_u16_paeth": arms["paeth.6.fast"]["launches"]["filter"],
                    "bitpack_dense": rle["launches"]["bitpack_dense"],
                    "filter_render_rgb8": render["launches"]["filter"],
                    "bitpack_render_rle": render["launches"]["bitpack"],
                    "filter_wsi_rgb8": wsi_run["launches"]["filter"],
                    "bitpack_wsi": wsi_run["launches"]["bitpack"]}
        for k in kernels:
            k["launches"] = launches[k["name"]]
        emit({"kernels": kernels})
        print(smi_line(), flush=True)
        emit({"ok": True, "device": {"platform": "gpu",
                                     "kind": torch.cuda.get_device_name(0),
                                     "count": torch.cuda.device_count()}})
        return 0
    except Exception:
        traceback.print_exc()
        return 1
    finally:
        for close in closers:
            close()


if __name__ == "__main__":
    sys.exit(main())
