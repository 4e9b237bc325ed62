"""The rendering engine of the port (counterpart of
``omero_ms_pixel_buffer_tpu/render``): the ``/render`` surface's
per-channel window/level, gamma, reverse and logarithmic quantization,
LUT or solid colour, additive composite, ROI masks and z/t projection.

Modules:

- ``model``      — ``RenderSpec``, the parse of the render query dialect
                   (copied); its signature keys caches and batches
- ``luts``       — built-in colormaps and the ImageJ ``.lut`` loader (copied)
- ``masks``      — ROI shapes, rasters and their cache (copied)
- ``engine``     — table builder (copied), the torch composite and the
                   fused composite -> filter kernel -> deflate chain, the
                   host mirror
- ``projection`` — the torch max/mean projection and its numpy mirror
- ``analysis``   — ``HistogramSpec`` and the bin tables, stats and JSON
                   body of ``/histogram`` (copied); the torch histogram
- ``supertile``  — the adjacency bucketing of render lanes (copied) and
                   the torch composite + carve of a super-tile
"""
