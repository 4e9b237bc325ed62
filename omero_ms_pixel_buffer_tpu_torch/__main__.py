"""Serve /tile, /render and /histogram from the port:

    python -m omero_ms_pixel_buffer_tpu_torch --dev --registry registry.json \\
        --port 8082 [--device cuda|cpu] [--buckets 256,512,1024] [--queue-depth 2] \\
        [--deflate-mode dynamic|rle|stored] [--no-device-deflate] [--lut-dir DIR] \\
        [--no-supertile]

On ``cuda`` the kernels are built (or found built) before the port
opens; without a GPU the command fails unless ``--device cpu`` is
given. ``--deflate-mode`` is the YAML key ``backend.png.device-deflate-mode``
of the JAX package; the bit packer comes from ``OMPB_BITPACK``
(``scan|pallas|pallas_dense|gather``; default ``pallas`` on CUDA), as
there. ``--no-device-deflate`` is the YAML key
``backend.png.device-deflate: false``: PNG lanes are filtered on the
device and deflated on the host, and render lanes take the host mirror.
``--lut-dir`` is ``render.lut-dir``: ImageJ ``.lut`` files that ``/render``
channels may name. ``--no-supertile`` is ``supertile.enabled: false``:
adjacent ``/render`` lanes of a batch are no longer fused into one
composite (fusion is on by default, as in the JAX package).
``OMPB_JPEG_DEVICE_IDCT=1`` moves JPEG tiles' IDCT to the device and
``OMPB_MEMO_DIR`` keeps parsed TIFF IFD chains, as in the JAX package.
The line ``listening on HOST:PORT`` is printed once serving.
SIGINT/SIGTERM drain and stop.
"""

from __future__ import annotations

import argparse
import asyncio
import logging
import signal
import sys

from .ops.device_deflate import DEFLATE_MODES


def _parse(argv):
    p = argparse.ArgumentParser(description="PyTorch/CUDA pixel-buffer tile service")
    p.add_argument("--registry", required=True, help="image registry JSON")
    p.add_argument("--port", type=int, default=8082)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--dev", action="store_true",
                   help="accept any sessionid cookie as its own session key "
                   "(never in production)")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
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
    args = p.parse_args(argv)
    if args.deflate_mode not in DEFLATE_MODES:
        raise ValueError(f"Unknown device deflate mode: {args.deflate_mode}")
    return args


async def _serve(args) -> None:
    from .http.server import create_server

    server = create_server(
        args.registry, dev=args.dev, device=args.device,
        buckets=[int(b) for b in args.buckets.split(",")],
        queue_depth=args.queue_depth, deflate_mode=args.deflate_mode,
        device_deflate=args.device_deflate, lut_dir=args.lut_dir,
        supertile_enabled=args.supertile,
    )
    port = await server.start(args.host, args.port)
    print(f"listening on {args.host}:{port}", flush=True)
    stop = asyncio.Event()
    loop = asyncio.get_running_loop()
    for sig in (signal.SIGINT, signal.SIGTERM):
        loop.add_signal_handler(sig, stop.set)
    try:
        await stop.wait()
    finally:
        await server.close()
        server.pipeline.close()


def main(argv=None) -> int:
    args = _parse(argv)
    logging.basicConfig(level=logging.INFO, stream=sys.stderr,
                        format="%(asctime)s %(levelname)s %(name)s %(message)s")
    asyncio.run(_serve(args))
    return 0


if __name__ == "__main__":
    sys.exit(main())
