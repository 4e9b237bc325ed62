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

- ``assign_supertiles`` (copied, with ``SuperTileGroup`` and the
  pairwise clustering helpers): the batcher stamps adjacent lanes of each
  coalesced batch with a shared group token (``ctx.supertile``). Masked,
  analysis, expired and full-plane lanes never fuse. The JAX package's
  fuse key also carries the degraded flag, and its ``BurstHint`` grid
  clustering serves the protocol adapters and the prefetcher; the port
  has neither degraded reads nor those callers yet.
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

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .engine import render_torch


MAX_PIXELS = 4 << 20  # 4 Mpx, a 2048x2048 viewport
MIN_LANES = 2
MIN_COVERAGE = 0.5


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
    expired deadline. No session component: every lane still resolves
    itself."""
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
    return (ctx.image_id, ctx.resolution, ctx.z, ctx.t, ctx.format, spec.signature())


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
    comp: List[int], rects: List[tuple], max_pixels: int, min_coverage: float
) -> List[List[int]]:
    """Split one spatial component to fit the pixel budget while the
    covered share of the bounding rectangle stays above ``min_coverage``:
    lanes accumulate greedily in row-major order."""
    order = sorted(comp, key=lambda i: (rects[i][1], rects[i][0]))
    groups: List[List[int]] = []
    cur: List[int] = []
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
        for comp in _components(rects):
            for group in _split_by_budget(comp, rects, max_pixels, min_coverage):
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
