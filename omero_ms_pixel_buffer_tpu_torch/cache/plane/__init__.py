"""The cache plane (counterpart of ``omero_ms_pixel_buffer_tpu/cache/plane/``):
the TinyLFU admission gate (``tinylfu.py``) and the in-process RESP2 stub
(``resp_stub.py``); the disk tier, L2 and peers are ``ROADMAP.md`` §1
items 6 and 8."""
