"""Run one cell of the benchmark and print its result line.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the cards the cell asks for.
The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer metrics), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each number the output check compared,
with its limit. The same numbers end standard error.

Without CUDA, with fewer cards than the cell asks for, or with JAX or the
JAX package loaded once the window has closed, it prints no result and
exits non-zero.
"""

from __future__ import annotations

import time

STARTED = time.perf_counter()  # set-up is timed from here

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from typing import Any, Dict, List, Optional  # noqa: E402

from . import spec  # noqa: E402
from .profile import breakdown  # noqa: E402

# top-level module names the process may not hold: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "sylber_tpu")
# the kernel and extension caches of the program and of torch, fixed paths
# inside the checkout (listed in .gitignore)
CACHE_DIRS = {"TORCH_EXTENSIONS_DIR": "build/portbench/torch_extensions",
              "TRITON_CACHE_DIR": "build/portbench/triton"}


def forbidden_modules(modules=None) -> List[str]:
    """The forbidden top-level names among the loaded modules, compared whole
    (``sylber_tpu_torch`` is not ``sylber_tpu``)."""
    names = {m.split(".")[0] for m in (sys.modules if modules is None else modules)}
    return sorted(names & set(FORBIDDEN))


# the host's thread pools, one thread each: the harness is one process with
# few threads (the host pads and copies on one thread; idle pool threads
# that spin take cores from it on a shared host)
THREADS = ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS")


def keep_freed_memory() -> None:
    """glibc's allocator set to keep what the process frees: no block of its
    own mapping (each of which would be unmapped when freed and its pages
    faulted in afresh when allocated again) and no trimming of the heap. The
    host's batches (padded audio, the results copied back) then reuse pages
    that set-up faulted in, and the window pays no page faults whose cost
    depends on the machine's state. Nothing where the C library is not glibc."""
    import ctypes

    try:
        mallopt = ctypes.CDLL(None).mallopt
    except AttributeError:
        return
    mallopt(M_MMAP_MAX, 0)
    mallopt(M_TRIM_THRESHOLD, 2 ** 31 - 1)


M_TRIM_THRESHOLD, M_MMAP_MAX = -1, -4  # glibc's mallopt parameters


def set_environment() -> None:
    """Before torch is imported: the caches inside the checkout, the host's
    thread pools at one thread, the allocator keeping freed memory, and no
    library loading JAX by itself."""
    for key, rel in CACHE_DIRS.items():
        os.environ[key] = str(spec.CHECKOUT / rel)
    for key in THREADS:
        os.environ[key] = "1"
    keep_freed_memory()
    # libraries that would load JAX or TensorFlow by themselves
    os.environ["USE_FLAX"] = os.environ["USE_JAX"] = "0"
    os.environ["USE_TF"] = "0"


def _number(x: float) -> Optional[float]:
    """A finite number, or ``None`` (JSON's null) for one that is not."""
    return float(x) if math.isfinite(float(x)) else None


def run_cell(cell: spec.Cell, seed: int, seconds: float, trace: bool, device: str,
             started: float) -> Dict[str, Any]:
    """The result of one run of ``cell`` (no JAX check, no printing)."""
    outcome = spec.driver(cell.workload["driver"]).run(cell, seed, seconds, trace, device,
                                                       started)
    if trace:
        metrics = {}
        for m in cell.per_layer:
            value = spec.reader(m["name"])(outcome.observed)
            if value is not None and _number(value) is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": _number(outcome.end_to_end[m["name"]]),
                               "unit": m["unit"]} for m in cell.end_to_end}
    dev = dict(outcome.device, memory_peak_bytes=outcome.memory_peak_bytes)
    if outcome.trace is not None:
        dev.update(busy_s=outcome.trace.busy_s, window_s=outcome.trace.window_s)
    checks, numbers = outcome.check()
    correct = outcome.failed == 0 and all(_number(v) is not None and v <= limit
                                          for _, v, limit in checks)
    result = {"correct": bool(correct), "attempted": outcome.attempted,
              "failed": outcome.failed, "metrics": metrics, "device": dev}
    if outcome.trace is not None:
        result["breakdown"] = breakdown(outcome.trace)
    result["checks"] = {name: {"value": _number(v), "limit": limit}
                        for name, v, limit in checks}
    result["_numbers"] = numbers
    return result


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    set_environment()
    cell = spec.cell(args.workload)

    import torch

    chips = cell.workload["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: {args.workload} needs {chips} CUDA device(s), found {found}",
              file=sys.stderr)
        return 2
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda", STARTED)
    loaded = forbidden_modules()
    if loaded:
        print(f"portbench: the process holds {', '.join(loaded)}", file=sys.stderr)
        return 3
    numbers = result.pop("_numbers")
    print("portbench: compared numbers " + json.dumps(numbers), file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
