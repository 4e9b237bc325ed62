"""Serve /tile, /render and /histogram from the port, as an OMERO
deployment runs the JAX package:

    python -m omero_ms_pixel_buffer_tpu_torch [--config conf/config.yaml] \\
        [--port P] [--dev] [--registry registry.json] [--device cuda|cpu] \\
        [--host 127.0.0.1] [--buckets 256,512,1024] [--queue-depth 2] \\
        [--deflate-mode dynamic|rle|stored] [--no-device-deflate] \\
        [--lut-dir DIR] [--no-supertile]
    python -m omero_ms_pixel_buffer_tpu_torch debug-context [--config X] \\
        [--registry R] [--device cuda|cpu]

The YAML config (``utils/config.py``, the JAX package's schema; the env
overrides ``OMPB_PORT`` and ``OMPB_SESSION_STORE``) wires everything
(``http.server.wire``): the session store (OMERO.web's Django sessions in
Redis or Postgres), the Glacier2 validator with
``omero.validate-sessions``, the OMERO metadata plane with
``omero.db.uri``, and every knob of the batcher, PNG chain, caches,
scheduler and resilience layer. ``--port`` and ``--registry`` override
the config's ``port`` and ``image-registry``; ``--dev`` takes the echo
session store (every ``sessionid`` cookie is its own key; never in
production) and reads no session-store block when the file has none.
The other flags, when given, override their YAML keys: ``--buckets``
``backend.batching.buckets``, ``--queue-depth`` ``backend.png.queue-depth``,
``--deflate-mode`` ``backend.png.device-deflate-mode``,
``--no-device-deflate`` ``backend.png.device-deflate: false`` (PNG lanes
filtered on the device, deflated on the host), ``--lut-dir``
``render.lut-dir``, ``--no-supertile`` ``supertile.enabled: false``. The
bit packer comes from ``OMPB_BITPACK`` (``scan|pallas|pallas_dense|gather``;
default ``pallas`` on CUDA). ``OMPB_JPEG_DEVICE_IDCT=1`` moves JPEG
tiles' IDCT to the device.

On ``cuda`` the kernels are built (or found built) before the port opens;
without a GPU the command fails unless ``--device cpu`` is given. With
``backend.engine: host`` (or ``backend.batching.device-encode: false``)
the service runs the whole-host engine: no kernel is built, no CUDA call
is made and ``--device`` is not read, so no card is needed. A config the
parser refuses stops start-up with the ``ConfigError`` that names the key
(exit code 2).
``debug-context`` builds the same wiring without serving, prints it and
exits (``debug.py``). The line ``listening on HOST:PORT`` is printed once
serving. SIGINT stops (exit code 0); SIGTERM too, after the graceful drain
when a ``cluster:`` block builds the fleet plane (``cluster.drain.signal``).
A fleet replica's config names the members, itself, the shared Redis and
the secret:

    cluster: {members: [http://a:8082, http://b:8082], self: http://a:8082,
              l2: {uri: redis://redis:6379/0}, secret: s3cret,
              replication-factor: 2}
"""

from __future__ import annotations

import argparse
import asyncio
import signal
import sys

from .ops.device_deflate import DEFLATE_MODES
from .utils.config import Config, ConfigError

# flags that override a YAML key only when given
_OVERRIDES = ("--buckets", "--queue-depth", "--deflate-mode", "--no-device-deflate",
              "--lut-dir", "--no-supertile")


def _parser(description: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=description, allow_abbrev=False)
    p.add_argument("--config", default="conf/config.yaml")
    p.add_argument("--registry", default=None,
                   help="image registry JSON (overrides image-registry)")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    return p


def _parse(argv):
    p = _parser("PyTorch/CUDA pixel-buffer tile service")
    p.add_argument("--port", type=int, default=None, help="overrides port")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--dev", action="store_true",
                   help="accept any sessionid cookie as its own session key "
                   "(never in production)")
    p.add_argument("--buckets", default="256,512,1024",
                   help="comma-separated square shape buckets")
    p.add_argument("--queue-depth", type=int, default=2,
                   help="encode groups in flight on the device")
    p.add_argument("--deflate-mode", default="dynamic",
                   help="device deflate mode: dynamic, rle or stored")
    p.add_argument("--no-device-deflate", dest="device_deflate", action="store_false",
                   help="filter PNG lanes on the device, deflate them on the host")
    p.add_argument("--lut-dir", default=None, help="directory of ImageJ .lut files")
    p.add_argument("--no-supertile", dest="supertile", action="store_false",
                   help="render adjacent /render lanes of a batch one by one, not fused")
    argv = list(sys.argv[1:] if argv is None else argv)
    args = p.parse_args(argv)
    if args.deflate_mode not in DEFLATE_MODES:
        raise ValueError(f"Unknown device deflate mode: {args.deflate_mode}")
    args.given = {flag for flag in _OVERRIDES
                  if any(a == flag or a.startswith(flag + "=") for a in argv)}
    return args


def load_config(args, dev: bool = False) -> Config:
    """The config file under its env overrides, then the command line's."""
    config = Config.load(args.config, default_memory_store=dev)
    if getattr(args, "port", None) is not None:
        config.port = args.port
    if args.registry is not None:
        config.image_registry = args.registry
    given = getattr(args, "given", ())
    be = config.backend
    if "--buckets" in given:
        be.batching.buckets = tuple(int(b) for b in args.buckets.split(","))
    if "--queue-depth" in given:
        be.png.queue_depth = Config._parse_queue_depth(args.queue_depth)
    if "--deflate-mode" in given:
        be.png.device_deflate_mode = args.deflate_mode
    if "--no-device-deflate" in given:
        be.png.device_deflate = False
    if "--lut-dir" in given:
        config.render.lut_dir = args.lut_dir
    if "--no-supertile" in given:
        config.supertile.enabled = False
    return config


async def _serve(server, host: str, port: int) -> None:
    port = await server.start(host, port)
    print(f"listening on {host}:{port}", flush=True)
    stop = asyncio.Event()
    loop = asyncio.get_running_loop()
    loop.add_signal_handler(signal.SIGINT, stop.set)
    # SIGTERM is a planned leave: with the cluster plane (and
    # cluster.drain.signal) the drain runs first, then the stop
    loop.add_signal_handler(signal.SIGTERM,
                            lambda: server.drain_on_signal(stop.set) or stop.set())
    try:
        await stop.wait()
    finally:
        await server.close()
        server.pipeline.close()


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] == "debug-context":
        from .debug import main as debug_main

        return debug_main(argv[1:])
    args = _parse(argv)
    from .utils.logging_setup import configure_logging

    try:
        config = load_config(args, dev=args.dev)
        configure_logging(config.logging)
        from .http.server import wire

        # built before the loop starts: wiring builds the native library
        # and the CUDA kernels, which must not block a running loop
        server = wire(config, device=args.device, dev=args.dev)
        asyncio.run(_serve(server, args.host, config.port))
    except ConfigError as e:
        print(f"configuration error: {e}", file=sys.stderr)
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main())
