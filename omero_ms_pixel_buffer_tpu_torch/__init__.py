"""PyTorch/CUDA port of the pixel-buffer tile service.

Serves ``GET /tile/{imageId}/{z}/{c}/{t}`` (raw, PNG and TIFF) and
``GET /render/{imageId}/{z}/{c}/{t}`` (multi-channel composites, z/t
projections, ROI masks; PNG and JPEG) end to end on an NVIDIA GPU:
asyncio HTTP front, result cache, coalescing batcher, tile pipeline with
a GPU-resident plane cache, and a streaming encode queue whose PNG filter
and deflate bit packers are hand-written CUDA kernels (``csrc/``). Module paths mirror ``omero_ms_pixel_buffer_tpu``
so each counterpart is found by name; this package imports nothing of it
and never imports ``jax``.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``,
which only the tests do: on the CPU every kernel wrapper takes its plain
PyTorch version.
"""

# the service version the discovery document reports (the JAX package's)
__version__ = "0.1.0"
