"""Reads a cell's check numbers over many seeds in one process, for setting its limits.

    python3 portbench/calibrate.py --workload <cell> --seeds 1 2 3 --control-seeds 4 5 6 [--seconds 2]

Runs the cell's program on each seed and its control on each control seed (a short
window each; the numbers judge the answers, not the time), and prints one JSON line a
run with every number the check computes: against the reference, against the reference
computed wholly in float32 from float32 weights, and for the reference put in the
program's place with int8 products. The benchmark's own runs never run this.
"""

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from portbench.harness import runner, spec  # noqa: E402


def main(argv: list[str]) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="*", default=[])
    parser.add_argument("--control-seeds", type=int, nargs="*", default=[])
    parser.add_argument("--seconds", type=float, default=2.0)
    args = parser.parse_args(argv)
    benchmark = spec.load_benchmark()
    cell = spec.load_cell(benchmark, args.workload)
    variants = {"float32_reference": {"reference": {}},
                "int8_products": {"control": {"reference_product": "int8"}}}
    for control, seeds in ((False, args.seeds), (True, args.control_seeds)):
        for seed in seeds:
            started = time.perf_counter()
            result, _, readings = runner.run(cell, seed, args.seconds, False, started=started, control=control,
                                             benchmark=benchmark, variants=variants)
            print(json.dumps({"cell": cell.name, "seed": seed, "control": control, "correct": result["correct"],
                              "readings": readings}, default=runner._plain), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
