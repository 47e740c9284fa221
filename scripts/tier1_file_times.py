"""Seconds per test file of a pytest run, from its JUnit XML (``--junitxml``).

    python scripts/tier1_file_times.py run.xml [--before parent.xml] [--over 20]

Sums each file's ``testcase`` times (setup, call and teardown, as pytest
writes them) and prints one line a file, slowest first: the seconds, the
count of test cases and the path, with the ``--before`` run's seconds beside
when given. Lists the files over ``--over`` seconds in either run, then the
totals: the suite's wall as the XML records it, the summed test time, and
the share of it in the port's files (``tests/test_torch_*``). Under
``pytest-xdist`` a file's tests run on one worker, so a file's sum is the
time it holds that worker.
"""

from __future__ import annotations

import argparse
import collections
import sys
import xml.etree.ElementTree as ET


def file_times(path: str):
    """``({file: seconds}, {file: cases}, suite seconds)`` of a JUnit XML."""
    root = ET.parse(path).getroot()
    suite = root if root.tag == "testsuite" else root.find("testsuite")
    seconds, cases = collections.defaultdict(float), collections.Counter()
    for tc in root.iter("testcase"):
        name = tc.get("classname", "").replace(".", "/") + ".py"
        seconds[name] += float(tc.get("time", 0))
        cases[name] += 1
    return seconds, cases, float(suite.get("time", 0))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("xml")
    ap.add_argument("--before", help="the JUnit XML of the run to compare with")
    ap.add_argument("--over", type=float, default=20.0)
    args = ap.parse_args(argv)
    after, cases, wall = file_times(args.xml)
    before, _, wall_before = file_times(args.before) if args.before else ({}, None, None)
    names = sorted(set(after) | set(before), key=lambda n: -max(after.get(n, 0),
                                                                before.get(n, 0)))
    for name in names:
        if max(after.get(name, 0), before.get(name, 0)) <= args.over:
            continue
        was = f"{before.get(name, 0):8.1f} -> " if args.before else ""
        print(f"{was}{after.get(name, 0):8.1f} s {cases.get(name, 0):4d} cases  {name}")

    def total(d, port=None):
        return sum(v for k, v in d.items()
                   if port is None or k.startswith("tests/test_torch_") == port)
    for label, d, w in (("before", before, wall_before), ("after", after, wall)):
        if d:
            print(f"{label}: wall {w:.1f} s, summed {total(d):.1f} s (port files "
                  f"{total(d, True):.1f}, others {total(d, False):.1f})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
