"""The ingest plane: Zarr chunk and shard writes while serving
(counterpart of ``omero_ms_pixel_buffer_tpu/ingest/``).

Authenticated HTTP writes (``PUT /image/{id}/tile/{z}/{c}/{t}``, ``POST
/image/{id}/planes``, served by ``http/server.py``) land as Zarr chunk
objects or ``sharding_indexed`` shards through the same codec chain the
read path decodes (``io/zarr.py`` ``encode_chunk``). Every commit is
followed by the epoch contract: the image epoch is bumped first, then
every cache tier is purged and the written tiles are pushed to the live
channels, so a concurrent reader sees only the old or the new bytes.

- ``ShardAssembler`` stages tiles into whole inner chunks (read, modify,
  write against the live array) and commits each touched object as one
  atomic ``store.put``.
- ``IngestPlane`` serializes writes per image, bounds them (``ingest:``
  ``max-inflight-shards``, ``staging-bytes``; 413 over either), holds
  the fault points ``ingest.commit`` and ``ingest.index`` and counts
  commits for ``/healthz``.

Writes take a scheduler permit that cannot be degraded and never train
the sweep detector or the prefetcher (``http/server.py``).
"""

from .assembler import IngestError, IngestPlane, ShardAssembler

__all__ = ["IngestError", "IngestPlane", "ShardAssembler"]
