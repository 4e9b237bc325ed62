"""The control of a cell's ``correct``: the plain reference put in the
program's place at the precision below the configuration's (pixels
stored as float16, ``kinds/<kind>.py`` ``control``), judged by the same
comparison as a run, over the same traffic: the steps of every client,
drawn from the seed, until as many answers as a run gives. A sound
comparison reports it not correct.

    python3 benchmark/control.py --workload NAME --answers N SEED [SEED ...]

One JSON line per seed with the numbers compared and the verdict."""

import argparse
import json
import os
import sys
import tempfile
import time
from pathlib import Path

if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from harness import check, fixture, manifest, traffic

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--answers", type=int, required=True)
    p.add_argument("seeds", type=int, nargs="+")
    args = p.parse_args()
    cell = manifest.resolve(args.workload)
    for seed in args.seeds:
        t = time.monotonic()
        img, content = cell.config["image"], cell.config["content"]
        work = tempfile.TemporaryDirectory(prefix="bench-control-")
        # a JPEG source's reference is its file's tiles
        source = (fixture.write(os.path.join(work.name, "image.ome.tiff"), img, content, seed,
                                fixture.default_workers()) if fixture.lossy(img)
                  else fixture.pixels(img, content, seed, fixture.default_workers()))
        streams = [traffic.Client(cell.kind, cell.config, cell.traffic, seed, k)
                   for k in range(cell.traffic["clients"])]
        specs = []
        while len(specs) < args.answers:
            for s in streams:
                specs += s.step()
        specs = specs[:args.answers]
        numbers = check.judge_arrays(specs, cell.kind.control, cell.kind, source)
        reference = check.judge_arrays(specs, cell.kind.expected, cell.kind, source)
        source.close()
        work.cleanup()
        print(json.dumps({"workload": args.workload, "seed": seed, "answers": len(specs),
                          "control": numbers, "control_correct": check.verdict(numbers),
                          "reference_as_answer": reference,
                          "seconds": time.monotonic() - t}), flush=True)
