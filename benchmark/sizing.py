"""The size of a configuration's image before it becomes a cell: write it
with the harness's writer, then read random tiles of some levels back
through the port's OME-TIFF reader (its host IDCT for JPEG) and compare
them with the harness's reference.

    python3 benchmark/sizing.py --config FILE --seed N --work DIR
        [--levels 0,4,8] [--reads 300]

``FILE`` holds ``image`` and ``content`` blocks as a configuration does.
Prints one JSON line: each level's tiles, bytes, the workers' seconds
and the seconds from the start until its last tile was written; the
file's bytes and the write's seconds; the peak RSS of this process and
of the largest worker; and the reads (their seconds and the numbers
compared). The image is removed at the end."""

import argparse
import json
import os
import resource
import sys
import time
from pathlib import Path

if __name__ == "__main__":
    sys.path[:0] = [str(Path(__file__).resolve().parent), str(Path(__file__).resolve().parents[1])]
    from harness import check, fixture, manifest

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--config", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--work", required=True)
    p.add_argument("--levels", default="0")
    p.add_argument("--reads", type=int, default=300)
    args = p.parse_args()
    with open(args.config) as f:
        config = json.load(f)
    img, content = config["image"], config["content"]
    bad = fixture.problems(img)
    if bad:
        sys.exit(f"sizing: {'; '.join(bad)}")
    os.makedirs(args.work, exist_ok=True)
    path = os.path.join(args.work, "sizing.ome.tiff")
    out = {"image": img}
    t = time.monotonic()
    source = fixture.write(path, img, content, args.seed, fixture.default_workers())
    out.update(write_s=time.monotonic() - t, file_bytes=os.path.getsize(path),
               levels=source.stats,
               peak_rss_bytes=resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024,
               worker_peak_rss_bytes=resource.getrusage(
                   resource.RUSAGE_CHILDREN).ru_maxrss * 1024)
    print(json.dumps(out), file=sys.stderr, flush=True)

    import numpy as np

    from omero_ms_pixel_buffer_tpu_torch.io.ometiff import OmeTiffPixelBuffer

    os.environ.pop("OMPB_JPEG_DEVICE_IDCT", None)  # the host IDCT
    kind = manifest.load_module(Path(__file__).resolve().parent / "kinds" / "tile.py",
                                "bench_kind_tile")
    rng = np.random.default_rng([args.seed, 7])
    levels = [int(k) for k in args.levels.split(",")]
    t_ = img["tile"]
    specs = []
    for i in range(args.reads):
        k = levels[i % len(levels)]
        size_x, size_y = fixture.level_size(img, k)
        x = int(rng.integers(-(-size_x // t_))) * t_
        y = int(rng.integers(-(-size_y // t_))) * t_
        specs.append(dict(i=i, level=k, c=int(rng.integers(img["size_c"])),
                          z=int(rng.integers(img["size_z"])), x=x, y=y,
                          w=min(t_, size_x - x), h=min(t_, size_y - y), sample=True))
    buf = OmeTiffPixelBuffer(path, image_id=img["id"])
    t = time.monotonic()
    try:
        got = [buf.get_tile_at(s["level"], s["z"], s["c"], 0, s["x"], s["y"], s["w"], s["h"])
               for s in specs]
    finally:
        buf.close()
    out["read_s"] = time.monotonic() - t
    numbers = check.judge_arrays(specs, lambda level, s: got[s["i"]], kind, source)
    source.close()
    out["reads"] = {str(k): sum(1 for s in specs if s["level"] == k) for k in levels}
    out["compared"] = numbers
    out["correct"] = check.verdict(numbers)
    out["peak_rss_bytes_after_reads"] = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    os.remove(path)
    print(json.dumps(out))
