"""Super-tile fusion: render the viewport, not the tile (counterpart of
``omero_ms_pixel_buffer_tpu/render/supertile.py``).

A pan requests neighbouring tiles that share planes, windows and LUTs.
Spatially adjacent render lanes of one (image, RenderSpec, resolution,
plane) bucket into a super-tile: one plane gather over the bounding
rectangle, one composite, then per-tile regions carved out of the shared
result and fed to the per-lane filter + deflate chain.

The bytes are the independent lanes' bytes: every stage up to the carve
is pointwise (table gathers, integer projection, integer composite), so a
pixel's value does not depend on the rectangle it was rendered in; the
PNG filter looks only up and left inside the tile, and the stream is
built from the tile's own scanline bytes.

- ``assign_supertiles`` (copied, with ``SuperTileGroup``, ``BurstHint``
  and the clustering helpers): the batcher stamps adjacent lanes of each
  coalesced batch with a shared group token (``ctx.supertile``). Masked,
  analysis, expired and full-plane lanes never fuse; degraded lanes fuse
  only with degraded lanes (the flag is in the fuse key; the pipeline
  keeps the lanes of one resolved level). Lanes that share one
  ``BurstHint`` (the adapters' tile grid) cluster by an O(n) walk of
  their grid cells and split by the pixel budget at whole grid rows;
  other lanes take the pairwise touch sweep and a greedy row-major split.
- ``composite_carve_torch``: the fused device program
  (``composite_carve_batch`` in the JAX package): one composite of the
  bounding stack with the port's ``render_torch``, zero-padded by the
  bucket, then a gather of each lane's (bh, bw) bucket at its origin.
  The pad region of a carved bucket holds neighbour pixels or zeros;
  the stream build slices it away.
- ``carve_host``: the host mirror's carve (a view), copied.

The JAX package's mesh partition (``plan_mesh_partition``) waits for the
port's multi-device plane.

The bucketing limits are the JAX package's ``supertile:`` defaults
(``utils/config.py``): ``MAX_PIXELS`` bounds the bounding rectangle one
fusion gathers, ``MIN_LANES`` is the smallest neighbourhood worth fusing,
``MIN_COVERAGE`` the least share of the rectangle its tiles must cover.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..utils.metrics import REGISTRY
from .engine import render_torch

SUPERTILE_LANES = REGISTRY.counter(
    "supertile_lanes_total",
    "Render lanes served through a fused super-tile, by path",
)
SUPERTILE_FALLBACK = REGISTRY.counter(
    "supertile_fallback_total",
    "Lanes returned from a super-tile to the independent path",
)
SUPERTILE_SIZE = REGISTRY.histogram(
    "supertile_lanes_per_group", "Lanes fused per super-tile",
    buckets=(2, 4, 8, 16, 32, 64, float("inf")),
)


MAX_PIXELS = 4 << 20  # 4 Mpx, a 2048x2048 viewport
MIN_LANES = 2
MIN_COVERAGE = 0.5


@dataclasses.dataclass(frozen=True)
class BurstHint:
    """An adapter's tile grid (DZI TileSize, IIIF tile width, Iris layer
    grid), attached to its lanes' ``ctx.burst``. Transient: never part of
    a key; it only lets ``assign_supertiles`` cluster by grid cell."""

    tile_w: int
    tile_h: int


class SuperTileGroup:
    """The batcher's stamp: one planned super-tile. Lanes sharing the
    same object fuse; the pipeline re-validates every lane against the
    resolved metadata first, so a stale stamp can only fall back."""

    __slots__ = ("key", "n")

    def __init__(self, key: tuple, n: int):
        self.key, self.n = key, n


def _fuse_key(ctx) -> Optional[tuple]:
    """The same-spec bucketing key, or None when the lane must never
    fuse: render lanes only, no ROI masks, explicit regions only, no
    expired deadline. The degraded flag is part of the key. No session
    component: every lane still resolves itself."""
    spec = ctx.render
    if spec is None or ctx.analysis is not None:
        return None
    if getattr(spec, "masks", None):
        return None
    r = ctx.region
    if r.width <= 0 or r.height <= 0:
        return None
    if ctx.expired:
        return None
    return (ctx.image_id, ctx.resolution, ctx.z, ctx.t, ctx.format, spec.signature(),
            bool(ctx.degraded))


def _rect(ctx) -> Tuple[int, int, int, int]:
    r = ctx.region
    return (r.x, r.y, r.width, r.height)


def _touching(a, b) -> bool:
    """Edge- or corner-adjacent (1px-dilated intersection)."""
    ax, ay, aw, ah = a
    bx, by, bw, bh = b
    return ax <= bx + bw and bx <= ax + aw and ay <= by + bh and by <= ay + ah


def _components(rects: List[tuple]) -> List[List[int]]:
    """Connected components under ``_touching``: union-find over the
    (batch-bounded) rectangles."""
    n = len(rects)
    parent = list(range(n))

    def find(i):
        while parent[i] != i:
            parent[i] = parent[parent[i]]
            i = parent[i]
        return i

    for i in range(n):
        for j in range(i + 1, n):
            if _touching(rects[i], rects[j]):
                ri, rj = find(i), find(j)
                if ri != rj:
                    parent[ri] = rj
    comps: Dict[int, List[int]] = {}
    for i in range(n):
        comps.setdefault(find(i), []).append(i)
    return list(comps.values())


def _grid_components(rects: List[tuple], hint: BurstHint) -> Optional[List[List[int]]]:
    """O(n) clustering of lanes on the hint's tile grid by the
    8-neighbourhood of their cells; None when a lane is off the grid."""
    tw, th = hint.tile_w, hint.tile_h
    if tw <= 0 or th <= 0:
        return None
    cells: Dict[Tuple[int, int], int] = {}
    for i, (x, y, w, h) in enumerate(rects):
        if x % tw or y % th or w > tw or h > th:
            return None
        cells[(x // tw, y // th)] = i
    seen: set = set()
    comps: List[List[int]] = []
    for cell in cells:
        if cell in seen:
            continue
        stack, comp = [cell], []
        seen.add(cell)
        while stack:
            cx, cy = stack.pop()
            comp.append(cells[(cx, cy)])
            for dx in (-1, 0, 1):
                for dy in (-1, 0, 1):
                    nb = (cx + dx, cy + dy)
                    if nb in cells and nb not in seen:
                        seen.add(nb)
                        stack.append(nb)
        comps.append(comp)
    return comps


def bounding_rect(rects: Sequence[Tuple[int, int, int, int]]) -> Tuple[int, int, int, int]:
    x0 = min(r[0] for r in rects)
    y0 = min(r[1] for r in rects)
    x1 = max(r[0] + r[2] for r in rects)
    y1 = max(r[1] + r[3] for r in rects)
    return (x0, y0, x1 - x0, y1 - y0)


def _fits(trial: List[int], rects: List[tuple], max_pixels: int, min_coverage: float) -> bool:
    bx, by, bw, bh = bounding_rect([rects[j] for j in trial])
    area = bw * bh
    covered = sum(rects[j][2] * rects[j][3] for j in trial)
    return area <= max_pixels and covered >= min_coverage * area


def _split_by_budget(
    comp: List[int], rects: List[tuple], max_pixels: int, min_coverage: float,
    hint: Optional[BurstHint] = None,
) -> List[List[int]]:
    """Split one spatial component to fit the pixel budget while the
    covered share of the bounding rectangle stays above ``min_coverage``.
    With a ``BurstHint`` whole grid rows accumulate until the next would
    bust the budget, and a row too wide alone splits greedily (its lanes
    are one band, so the cut falls between grid columns); without one,
    lanes accumulate greedily in row-major order."""
    order = sorted(comp, key=lambda i: (rects[i][1], rects[i][0]))
    groups: List[List[int]] = []
    cur: List[int] = []
    if hint is not None and hint.tile_w > 0 and hint.tile_h > 0:
        rows: Dict[int, List[int]] = {}
        for i in order:
            rows.setdefault(rects[i][1] // hint.tile_h, []).append(i)
        for _, row in sorted(rows.items()):
            if cur and not _fits(cur + row, rects, max_pixels, min_coverage):
                groups.append(cur)
                cur = []
            if not cur and not _fits(row, rects, max_pixels, min_coverage):
                groups.extend(_split_by_budget(row, rects, max_pixels, min_coverage))
                continue
            cur += row
        if cur:
            groups.append(cur)
        return groups
    for i in order:
        trial = cur + [i]
        if cur and not _fits(trial, rects, max_pixels, min_coverage):
            groups.append(cur)
            cur = [i]
        else:
            cur = trial
    if cur:
        groups.append(cur)
    return groups


def assign_supertiles(
    ctxs: Sequence,
    max_pixels: int = MAX_PIXELS,
    min_lanes: int = MIN_LANES,
    min_coverage: float = MIN_COVERAGE,
) -> int:
    """Stamp ``ctx.supertile`` group tokens onto spatially adjacent
    render lanes of one batch; returns the number of lanes stamped. Lanes
    that do not qualify, or whose neighbourhood is too small, too sparse
    or over budget, keep ``supertile=None`` (the independent path)."""
    by_key: Dict[tuple, List[int]] = {}
    for i, ctx in enumerate(ctxs):
        ctx.supertile = None  # a retried ctx must not carry a stale stamp
        key = _fuse_key(ctx)
        if key is not None:
            by_key.setdefault(key, []).append(i)
    stamped = 0
    for key, lane_ids in by_key.items():
        if len(lane_ids) < min_lanes:
            continue
        rects = [_rect(ctxs[i]) for i in lane_ids]
        # one tile over the budget makes the neighbourhood unfusable
        if any(w * h > max_pixels for (_, _, w, h) in rects):
            continue
        # one hint shared by every lane of the key clusters on its grid
        hints = {ctxs[i].burst for i in lane_ids}
        hint = next(iter(hints)) if len(hints) == 1 else None
        comps = None
        if hint is not None:
            comps = _grid_components(rects, hint)
            if comps is None:
                hint = None  # off-grid lanes: no grid-aligned cuts
        if comps is None:
            comps = _components(rects)
        for comp in comps:
            for group in _split_by_budget(comp, rects, max_pixels, min_coverage, hint=hint):
                if len(group) < min_lanes:
                    continue
                token = SuperTileGroup(key, len(group))
                for j in group:
                    ctxs[lane_ids[j]].supertile = token
                stamped += len(group)
    return stamped


# ---------------------------------------------------------------------------
# the fused device program: composite once, carve per-lane buckets
# ---------------------------------------------------------------------------


def composite_carve_torch(planes: torch.Tensor, index_tables, color_luts,
                          coords: Sequence[Tuple[int, int]], bh: int, bw: int,
                          packed=None) -> torch.Tensor:
    """(C, H, W) unsigned super-tile planes (their bits) -> (B, bh, bw, 3)
    uint8 carved bucket batch at the relative (y, x) tile origins, on the
    planes' device: one ``render_torch`` composite, zero-padded by (bh,
    bw) so no carve clamps at the rectangle's edge, then one gather of
    every lane's bucket. ``packed`` is ``packed_rgb_tables`` of the
    tables when the caller has it."""
    rgb = render_torch(planes[None], index_tables, color_luts, packed=packed)[0]
    h, w = rgb.shape[:2]
    padded = torch.zeros((h + bh, w + bw, 3), dtype=torch.uint8, device=rgb.device)
    padded[:h, :w] = rgb
    starts = torch.tensor(list(coords), dtype=torch.int64).reshape(-1, 2).to(
        rgb.device, non_blocking=True)
    rows = starts[:, 0, None] + torch.arange(bh, device=rgb.device)
    cols = starts[:, 1, None] + torch.arange(bw, device=rgb.device)
    return padded[rows[:, :, None], cols[:, None, :]]


def carve_host(rgb: np.ndarray, x: int, y: int, w: int, h: int) -> np.ndarray:
    """Host mirror of the carve: a view into the composited super-tile
    RGB (its pixels equal the device carve's real region)."""
    return rgb[y : y + h, x : x + w]


# ---------------------------------------------------------------------------
# mesh partition planning (JAX ``render/supertile.py:389``): per-slot
# overlapped windows of a super-tile
# ---------------------------------------------------------------------------


def plan_mesh_partition(
    rel_rects: Sequence[Tuple[int, int, int, int]],
    stack_h: int,
    stack_w: int,
    n_slots: int,
) -> Tuple[
    List[Tuple[int, int]], Tuple[int, int], np.ndarray, List[int]
]:
    """Carve a super-tile's lanes into per-slot overlapped sub-rect
    windows of the staged bounding stack, for the mesh-fused chain
    (parallel/sharding.sharded_supertile_carve_deflate).

    ``rel_rects`` are the lanes' (x, y, w, h) rectangles RELATIVE to
    the bounding rect (one homogeneous (w, h) size class — the caller
    partitions by size first). Lanes sort row-major and split into
    balanced contiguous chunks, one per slot; each slot's window is
    the bounding rect of its lanes extended to the common (sub_h,
    sub_w) by sliding the origin WITHIN the full stack — so windows
    overlap rather than zero-fill, and the overlap between neighboring
    slots' windows IS the halo (sized by whatever the carve footprint
    needs; the composite itself is pointwise, so the halo exists
    purely so each lane's rectangle lies wholly inside one slot's
    window).

    Returns ``(origins, (sub_h, sub_w), coords, rows)``:

    - ``origins``: n_slots (sy, sx) window origins into the stack;
    - ``(sub_h, sub_w)``: the common window size (fits inside the
      stack by construction, so slicing never clamps);
    - ``coords``: (n_slots, L, 2) int32 window-local (y, x) tile
      origins with L = pow2(max lanes/slot), dummy places at (0, 0)
      (their carved bytes are simply never read back);
    - ``rows``: for each input lane (in ``rel_rects`` order) its
      global output row ``slot * L + place`` in the sharded program's
      slot-major result.
    """
    n = len(rel_rects)
    order = sorted(
        range(n), key=lambda i: (rel_rects[i][1], rel_rects[i][0])
    )
    base, rem = divmod(n, n_slots)
    chunks: List[List[int]] = []
    pos = 0
    for c in range(n_slots):
        size = base + (1 if c < rem else 0)
        chunks.append(order[pos : pos + size])
        pos += size
    cap = max((len(ch) for ch in chunks), default=1) or 1
    L = 1 << (cap - 1).bit_length()
    sub_h = sub_w = 1
    boxes: List[Optional[Tuple[int, int, int, int]]] = []
    for ch in chunks:
        if not ch:
            boxes.append(None)
            continue
        box = bounding_rect([rel_rects[i] for i in ch])
        boxes.append(box)
        sub_w = max(sub_w, box[2])
        sub_h = max(sub_h, box[3])
    sub_h = min(sub_h, stack_h)
    sub_w = min(sub_w, stack_w)
    origins: List[Tuple[int, int]] = []
    coords = np.zeros((n_slots, L, 2), dtype=np.int32)
    rows = [0] * n
    for c, (ch, box) in enumerate(zip(chunks, boxes)):
        if box is None:
            origins.append((0, 0))
            continue
        # slide the origin back inside the stack instead of padding:
        # the window reads real neighbor pixels (the halo), which the
        # pointwise composite renders identically everywhere
        sy = max(0, min(box[1], stack_h - sub_h))
        sx = max(0, min(box[0], stack_w - sub_w))
        origins.append((sy, sx))
        for place, i in enumerate(ch):
            x, y, _, _ = rel_rects[i]
            coords[c, place, 0] = y - sy
            coords[c, place, 1] = x - sx
            rows[i] = c * L + place
    return origins, (sub_h, sub_w), coords, rows
