"""What a driver hands back to ``run.py``."""

from __future__ import annotations

from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

from .profile import Trace

# a compared number: (name, value, limit); correct needs value <= limit
Check = Tuple[str, float, float]


class Outcome(NamedTuple):
    end_to_end: Dict[str, float]      # every end-to-end number the driver measured
    observed: Dict[str, Any]          # what the per-layer readers read
    attempted: int                    # answers due in the window
    failed: int                       # answers that are malformed
    memory_peak_bytes: int            # the process's peak before the check
    trace: Optional[Trace]            # the traced stretch (--trace 1)
    # frees the program, runs the reference: the compared numbers, and every
    # number the comparison computed (printed for the record)
    check: Callable[[], Tuple[List[Check], Dict[str, float]]]
    device: Dict[str, Any]            # platform, kind, count
