"""The multi-device plane: the serving mesh and its health
(``mesh.py``) and the sharded device programs over it (``sharding.py``),
counterparts of ``omero_ms_pixel_buffer_tpu/parallel/``."""
