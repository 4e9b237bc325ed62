"""Database clients, copied from ``omero_ms_pixel_buffer_tpu/db/``: the
Postgres wire client, the OMERO metadata resolver and the image source
(no external driver)."""

from .metadata import OmeroPostgresMetadataResolver  # noqa: F401
from .postgres import PostgresClient, PostgresError  # noqa: F401
