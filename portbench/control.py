"""The controls that the limits are set against, at a cell's own size.

    python3 -m portbench.control --workload <name> --seeds 1,2,3

runs, for each seed, what stands in the program's place in the cell's
driver (``control_readings`` of ``portbench/drivers/<driver>.py``): the
control, the reference in the nearest precision below the configuration's
(f32 with TF32 off, so TF32), and any faults the driver plants.  Each is
judged by the same checks and limits as a run, and has to come out not
correct.  The benchmark's own runs never run this.  It prints one JSON
line per seed and stand-in, and needs the card.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from portbench import harness
from portbench.check import Check


def readings(cell: harness.Cell, seed: int, device) -> dict[str, list[Check]]:
    """Each stand-in's checks: ``control`` and the driver's faults."""
    return harness.driver_for(cell.config).control_readings(cell, seed,
                                                            device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("portbench.control: no CUDA card", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    cell = harness.find_cell(harness.load_manifest(), args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        got = readings(cell, seed, device)
        for what, checks in got.items():
            print(json.dumps({
                "workload": cell.name, "seed": seed, "stand_in": what,
                "correct": all(c.ok for c in checks),
                "checks": {c.name: {"value": c.value, "limit": c.limit}
                           for c in checks},
                "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
