"""The readings a cell's output limits are set from.

    python3 -m portbench.readings --workload <cell> --seeds <n> ... --seconds <s> [--control]

runs the cell's driver once a seed in this process, each run a short window
at the cell's own size and load, and prints one JSON line a seed with every
number its comparison computed. ``--control`` runs the cell's control
instead: the workload's ``check.control`` settings laid over its
configuration (for the segmenter, the program's own int8 path; for the
trainer, the reference in fp8 in the program's place); ``--stand-in``
puts a fault of the cell's driver in the program's place. The
benchmark's runs never run the control; ``PERF.md`` gives the readings each
limit was set from.
"""

from __future__ import annotations

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

from . import run, spec  # noqa: E402


def control_cell(cell: spec.Cell) -> spec.Cell:
    """The cell with its control's settings over its configuration."""
    return cell._replace(config=dict(cell.config, **cell.workload["check"]["control"]))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=5.0)
    p.add_argument("--control", action="store_true")
    p.add_argument("--stand-in", default=None,
                   help="a fault of the cell's driver, planted under the timed path or run in "
                        "the program's place by its check (segment: half_rows, altered, shifted; "
                        "train: half_batch)")
    args = p.parse_args(argv)
    run.set_environment()
    import torch

    if not torch.cuda.is_available():
        print("portbench.readings: no CUDA device", file=sys.stderr)
        return 2
    cell = spec.cell(args.workload)
    if args.control:
        cell = control_cell(cell)
    if args.stand_in:
        cell = cell._replace(config=dict(cell.config, _stand_in=args.stand_in))
    for seed in args.seeds:
        started = time.perf_counter()
        res = run.run_cell(cell, seed, args.seconds, False, "cuda", started)
        print(json.dumps({"workload": args.workload, "control": args.control,
                          "stand_in": args.stand_in, "seed": seed,
                          "correct": res["correct"], "failed": res["failed"],
                          "metrics": {k: v["value"] for k, v in res["metrics"].items()},
                          "numbers": res["_numbers"]}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
