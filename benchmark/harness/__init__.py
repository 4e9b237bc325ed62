"""The benchmark harness of the PyTorch/CUDA port: it drives the port's
HTTP server in a process of its own, from traffic, configurations and
per-layer metric readers that it finds by name (see ``manifest``)."""
