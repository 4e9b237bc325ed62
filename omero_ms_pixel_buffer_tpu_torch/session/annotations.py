"""Annotation store: shapes that are the render plane's ROI grammar (copy
of ``omero_ms_pixel_buffer_tpu/session/annotations.py``).

Annotations are stored as validated ``render/masks.ShapeSpec`` JSON: the
CRUD surface parses inbound bodies with the same ``parse_shape`` the
``roi=`` query parameter rides, so an annotation can never hold a shape
the render path would reject, and compositing stored annotations is
appending their specs to the request's mask tuple. A
``/render?annotations=1`` request whose stored shapes equal an explicit
``roi=`` request has the same RenderSpec signature, cache key and ETag.

Every write bumps the image's annotation sub-epoch, a monotonic
per-image counter the session plane pushes to subscribers (the tile
epoch says "your tiles are stale"; the sub-epoch says "the overlay set
changed"). The shape set itself keys the cache, so a changed overlay is
a changed key, never a stale hit.

Bounds: ``max_images`` LRU of per-image tables, ``max_per_image``
annotations each (a create beyond it is a 400). Loop-affine: all access
happens on the serving loop; the store spawns no tasks. ``clock`` gives
the records' ``created``/``updated`` stamps (default ``time.time``).

Scope: the store is process-local and in memory.
"""

from __future__ import annotations

import time
from collections import OrderedDict
from typing import Optional, Tuple

from ..errors import BadRequestError
from ..render.masks import MAX_SHAPES, ShapeSpec, parse_shape
from ..utils.metrics import REGISTRY

ANNOTATION_OPS = REGISTRY.counter(
    "session_annotation_ops_total",
    "Annotation CRUD operations by op and outcome",
)


class AnnotationStore:
    """Per-image annotation tables with LRU image bounds and a monotonic
    sub-epoch per image."""

    def __init__(self, max_images: int = 1024, max_per_image: int = MAX_SHAPES,
                 clock=time.time):
        self.max_images = max(1, int(max_images))
        # never above the render path's MAX_SHAPES: a stored set the
        # overlay composite would refuse is useless
        self.max_per_image = max(1, min(int(max_per_image), MAX_SHAPES))
        self._clock = clock
        self._next_id = 0
        # image_id -> {"epoch": int, "annotations": OrderedDict[id -> record]}
        self._images: "OrderedDict[int, dict]" = OrderedDict()
        self._stats = {"created": 0, "updated": 0, "deleted": 0,
                       "rejected_full": 0, "evicted_images": 0}

    def _table(self, image_id: int, create: bool = False) -> Optional[dict]:
        table = self._images.get(image_id)
        if table is not None:
            self._images.move_to_end(image_id)
            return table
        if not create:
            return None
        table = {"epoch": 0, "annotations": OrderedDict()}
        self._images[image_id] = table
        while len(self._images) > self.max_images:
            self._images.popitem(last=False)
            self._stats["evicted_images"] += 1
        return table

    # -- CRUD ----------------------------------------------------------

    def create(self, image_id: int, body: dict) -> Tuple[dict, int]:
        """Validate and store one annotation: (record, new sub-epoch).
        Raises ``BadRequestError`` on a grammar violation or a full
        table."""
        shape = parse_shape(self._shape_of(body))
        table = self._table(image_id, create=True)
        if len(table["annotations"]) >= self.max_per_image:
            self._stats["rejected_full"] += 1
            ANNOTATION_OPS.inc(op="create", outcome="rejected_full")
            raise BadRequestError(
                f"Image {image_id} has {len(table['annotations'])} "
                f"annotations (limit {self.max_per_image})")
        self._next_id += 1
        ann_id = f"a{self._next_id}"
        record = {"id": ann_id, "shape": shape.to_json(), "label": self._label_of(body),
                  "created": self._clock(), "updated": self._clock()}
        table["annotations"][ann_id] = record
        table["epoch"] += 1
        self._stats["created"] += 1
        ANNOTATION_OPS.inc(op="create", outcome="ok")
        return dict(record), table["epoch"]

    def update(self, image_id: int, ann_id: str, body: dict) -> Optional[Tuple[dict, int]]:
        """Replace one annotation's shape and label; None when unknown."""
        table = self._table(image_id)
        if table is None or ann_id not in table["annotations"]:
            ANNOTATION_OPS.inc(op="update", outcome="missing")
            return None
        shape = parse_shape(self._shape_of(body))
        record = table["annotations"][ann_id]
        record["shape"] = shape.to_json()
        record["label"] = self._label_of(body, record.get("label"))
        record["updated"] = self._clock()
        table["epoch"] += 1
        self._stats["updated"] += 1
        ANNOTATION_OPS.inc(op="update", outcome="ok")
        return dict(record), table["epoch"]

    def delete(self, image_id: int, ann_id: str) -> Optional[int]:
        """Remove one annotation: the new sub-epoch, or None."""
        table = self._table(image_id)
        if table is None or table["annotations"].pop(ann_id, None) is None:
            ANNOTATION_OPS.inc(op="delete", outcome="missing")
            return None
        table["epoch"] += 1
        self._stats["deleted"] += 1
        ANNOTATION_OPS.inc(op="delete", outcome="ok")
        return table["epoch"]

    def get(self, image_id: int, ann_id: str) -> Optional[dict]:
        table = self._table(image_id)
        if table is None:
            return None
        record = table["annotations"].get(ann_id)
        return None if record is None else dict(record)

    def list(self, image_id: int) -> dict:
        """The ``GET /annotations/{imageId}`` document: the records and the
        sub-epoch push frames will carry."""
        table = self._table(image_id)
        if table is None:
            return {"image": image_id, "epoch": 0, "annotations": []}
        return {"image": image_id, "epoch": table["epoch"],
                "annotations": [dict(r) for r in table["annotations"].values()]}

    # -- the render-plane join -----------------------------------------

    def shapes(self, image_id: int) -> Tuple[ShapeSpec, ...]:
        """The stored shapes, insertion-ordered, so the joined RenderSpec
        signature (and its cache key and ETag) is stable."""
        table = self._table(image_id)
        if table is None:
            return ()
        return tuple(ShapeSpec.from_json(r["shape"]) for r in table["annotations"].values())

    def sub_epoch(self, image_id: int) -> int:
        table = self._table(image_id)
        return 0 if table is None else table["epoch"]

    # -- plumbing ------------------------------------------------------

    @staticmethod
    def _shape_of(body) -> dict:
        if not isinstance(body, dict):
            raise BadRequestError("Annotation body must be a JSON object")
        shape = body.get("shape", body)
        if not isinstance(shape, dict):
            raise BadRequestError("Annotation 'shape' must be an object")
        return shape

    @staticmethod
    def _label_of(body, default: str = "") -> str:
        label = body.get("label", default) if isinstance(body, dict) else default
        if not isinstance(label, str):
            raise BadRequestError("Annotation 'label' must be a string")
        return label[:256]  # bounded: labels ride push frames

    def snapshot(self) -> dict:
        return {"enabled": True, "images": len(self._images),
                "annotations": sum(len(t["annotations"]) for t in self._images.values()),
                **self._stats}
