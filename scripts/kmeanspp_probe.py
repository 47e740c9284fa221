"""Time the k-means++ seeding kernel of two package trees on one card, in turns.

    python scripts/kmeanspp_probe.py --parent <tree> [--turns parent,change,change,parent]
        [--sweep 64,128,256,512] [--threads 256,512,1024] [--out report.json]

``<tree>`` is another checkout of the repository (for example ``git archive``
of the parent commit unpacked into ``build/parent``); ``change`` is this
checkout. Each turn is a process of its own that imports
``sylber_tpu_torch`` from its tree, builds that tree's kernels and times
``kmeanspp`` with CUDA events (one warm-up, three timed calls) at
``SHAPES`` on seeded clustered points made on the card. The rows of every
turn are compared with the first turn's (they may differ only at a float64
tie of the draw). Where the tree has ``MIN_ROWS_PER_BLOCK`` (the
cooperative kernel), the first such turn also times each ``--sweep`` value
of the fewest rows a block, each ``--threads`` value of a block's most
threads, and the round trip of the kernel's exchange of every block's sum
(a launch of k exchange-only steps). Prints one JSON line a turn and a
summary; needs a card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
# (n, d, the k), with the clusters the points are drawn from
SHAPES = [
    (65536, 144, (5000, 10000, 20000), 8500),  # fit_kmeans's pool at the codebooks' width
    (110109, 144, (5000, 20000), 8500),        # the production codebooks' segments
    (65536, 768, (2000,), 64),                 # the full-width seed pool
    (4096, 144, (1024,), 64),                  # the mini fits
    (4096, 24, (256,), 64),                    # the VQ widths
    (4096, 8, (64,), 64),
]


def mixture(torch, n, d, seed, clusters):
    g = torch.Generator(device="cuda").manual_seed(seed)
    means = torch.randn(clusters, d, generator=g, device="cuda") * 3
    pick = torch.randint(0, clusters, (n,), generator=g, device="cuda")
    return means[pick] + torch.randn(n, d, generator=g, device="cuda")


def time_ms(torch, fn, reps=3, warmup=1):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def worker(tree: str, sweep, threads, out: str) -> None:
    sys.path.insert(0, tree)
    import torch

    from sylber_tpu_torch import kernels
    from sylber_tpu_torch.flow import kmeans as km

    assert Path(km.__file__).resolve().is_relative_to(Path(tree).resolve()), km.__file__
    kernels.build()
    kernels.lib()
    cooperative = hasattr(km, "MIN_ROWS_PER_BLOCK")
    recs = []
    for n, d, ks, clusters in SHAPES:
        x = mixture(torch, n, d, seed=n + d, clusters=clusters)
        for k in ks:
            u = km.seeding_uniforms(k, k).cuda()
            rows = km.kmeanspp(x, u)[1].cpu().numpy().tolist()
            rec = dict(n=n, d=d, k=k, ms=time_ms(torch, lambda: km.kmeanspp(x, u)), rows=rows)
            if cooperative and sweep:
                rec["plan"] = km.seeding_plan(n, d)
                rec["exchange_round_trip_us"] = time_ms(
                    torch, lambda: km.kmeanspp_barrier_probe(n, d, k)) * 1e3 / k
                rec["sweep"], rec["threads"] = {}, {}
                for m in sweep:
                    rec["sweep"][m] = dict(
                        plan=km.seeding_plan(n, d, min_rows=m),
                        ms=time_ms(torch, lambda: km._launch(x, u, -1, m)),
                        exchange_round_trip_us=time_ms(
                            torch, lambda: km.kmeanspp_barrier_probe(n, d, k, min_rows=m))
                        * 1e3 / k)
                for th in threads:
                    rec["threads"][th] = dict(
                        plan=km.seeding_plan(n, d, max_threads=th),
                        ms=time_ms(torch, lambda: km._launch(x, u, -1, km.MIN_ROWS_PER_BLOCK, th)))
            recs.append(rec)
        del x
    Path(out).write_text(json.dumps(dict(tree=tree, cooperative=cooperative, records=recs)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True, help="the other checkout's root")
    ap.add_argument("--turns", default="parent,change,change,parent")
    ap.add_argument("--sweep", default="64,128,256,512",
                    help="the fewest rows a block to time on the cooperative kernel")
    ap.add_argument("--threads", default="256,512,1024",
                    help="a block's most threads to time on the cooperative kernel")
    ap.add_argument("--out", help="also write the report as JSON to this path")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    ap.add_argument("--worker-out", help=argparse.SUPPRESS)
    args = ap.parse_args()
    sweep = [int(m) for m in args.sweep.split(",") if m]
    threads = [int(m) for m in args.threads.split(",") if m]
    if args.worker:
        worker(args.worker, sweep, threads, args.worker_out)
        return 0

    import torch

    if not torch.cuda.is_available():
        print("kmeanspp_probe: no CUDA device available", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    trees = {"parent": str(Path(args.parent).resolve()), "change": str(ROOT)}
    turns, swept = [], False
    with tempfile.TemporaryDirectory(prefix="kmeanspp_probe_") as tmp:
        for i, name in enumerate(args.turns.split(",")):
            out = Path(tmp) / f"{i}.json"
            cmd = [sys.executable, str(Path(__file__).resolve()), "--parent", args.parent,
                   "--worker", trees[name], "--worker-out", str(out),
                   "--sweep", "" if swept else args.sweep, "--threads", args.threads]
            subprocess.run(cmd, check=True)
            turn = json.loads(out.read_text())
            swept = swept or turn["cooperative"]
            turn["name"] = name
            turns.append(turn)
    first = turns[0]["records"]
    for turn in turns:
        for rec, ref in zip(turn["records"], first):
            rec["rows_differing_from_first_turn"] = sum(a != b for a, b in zip(rec["rows"],
                                                                              ref["rows"]))
    for turn in turns:
        for rec in turn["records"]:
            del rec["rows"]
        print(json.dumps(dict(turn=turn["name"], card=smi, records=turn["records"])), flush=True)
    for j, ref in enumerate(first):
        times = " / ".join(f"{t['name']} {t['records'][j]['ms']:.3f}" for t in turns)
        print(f"n {ref['n']} d {ref['d']} k {ref['k']}: {times} ms  [{smi}]")
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(dict(card=smi, turns=turns), indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
