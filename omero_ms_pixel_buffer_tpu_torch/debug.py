"""The wiring smoke test (counterpart of ``omero_ms_pixel_buffer_tpu/
debug.py``, the reference's ``Main.main``):

    python -m omero_ms_pixel_buffer_tpu_torch debug-context \\
        [--config conf/config.yaml] [--registry R] [--device cuda|cpu]

Loads the config, builds the session store, pixels service, pipeline,
batcher and front exactly as serving would (``http.server.wire``: on
``cuda`` the kernels are built or found), prints what was resolved and
exits without serving. Exit code 0, or 2 with the ``ConfigError`` of a
config the port cannot honour.
"""

from __future__ import annotations

import logging
import sys
from typing import Optional


def main(argv: Optional[list] = None) -> int:
    from .__main__ import _parser, load_config
    from .utils.config import ConfigError

    args = _parser("Build the service wiring standalone and print it").parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    from .http.server import wire
    from .io.pixels_service import ImageRegistry
    from .runtime.native import get_engine

    try:
        config = load_config(args, dev=True)
        server = wire(config, device=args.device)
    except ConfigError as e:
        print(f"configuration error: {e}", file=sys.stderr)
        return 2
    try:
        pipeline = server.pipeline
        svc = pipeline.pixels_service
        print(f"config: {args.config} port={config.port} "
              f"event-bus-send-timeout={config.event_bus_send_timeout_ms}ms "
              f"engine={config.backend.engine}")
        print(f"session store: {type(server.session_store).__name__} "
              f"({config.session_store.type}, {config.session_store.uri or 'no uri'}); "
              f"validator: {type(server.session_validator).__name__}")
        if isinstance(svc.registry, ImageRegistry):
            images = f"images registered: {len(svc.registry._images)}"
        else:
            images = "images resolved from the OMERO database"
        resolver = type(svc.metadata_resolver).__name__ if svc.metadata_resolver else "none"
        print(f"pixels service: {type(svc).__name__} ({images}; metadata resolver: {resolver})")
        if pipeline.engine == "host":
            print(f"pipeline: engine=host buckets={pipeline.buckets} "
                  f"png={pipeline.encode_signature()}")
        else:
            print(f"pipeline: device={pipeline.device} buckets={pipeline.buckets} "
                  f"deflate_mode={pipeline.device_deflate_mode} "
                  f"packer={pipeline.dispatcher.packer} "
                  f"device_deflate={pipeline.device_deflate} "
                  f"png={pipeline.encode_signature()}")
        if pipeline.engine == "host":
            print("kernels: none (the host engine)")
        elif server.kernel_libraries:
            for name, lib in server.kernel_libraries.items():
                print(f"kernel {name}: {'built' if lib['built'] else 'found'} {lib['path']}")
        else:
            print(f"kernels: none on {pipeline.device} (the plain PyTorch versions run)")
        engine = get_engine()
        print("native engine: " + (f"v{engine.version} ({engine.pool_size} threads)"
                                   if engine else "unavailable (Python zlib)"))
        print("absent planes: " + (", ".join(server.absent) or "none"))
    finally:
        pipeline.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
