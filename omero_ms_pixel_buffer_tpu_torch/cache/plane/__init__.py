"""The cache plane (counterpart of ``omero_ms_pixel_buffer_tpu/cache/plane/``):
the TinyLFU admission gate (``tinylfu.py``), the disk tier's
crash-consistent manifest (``manifest.py``) and the in-process RESP2 stub
(``resp_stub.py``); the L2 and peer tiers are ``ROADMAP.md`` §1 item 8."""
