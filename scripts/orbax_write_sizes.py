"""Bytes of the port's Orbax saves beside the JAX package's saves of the same trees.

    python scripts/orbax_write_sizes.py [--out report.json]

The committed fixtures ``tests/fixtures/orbax/mini_ckpt_params`` and
``mini_synth_params`` are the JAX package's ``save_params`` of
``tests/fixtures/mini_ckpt.npz`` (as float16, the ``.npz``'s own dtype) and
``mini_synth.npz`` (float32), zstd-compressed chunks. This script writes the
same trees with the port's ``io/checkpoint.py::save_params`` (uncompressed
chunks) into a temporary directory and prints, for each, the bytes of every
file, of the data files (``d/``) and of ``_METADATA`` on both sides, and
checks that the port's save reads back bit-equal. Imports only
``sylber_tpu_torch``; runs on the host, no card needed.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
FIXTURES = ROOT / "tests" / "fixtures"


def sizes(item_dir: Path) -> dict:
    files = [f for f in item_dir.rglob("*") if f.is_file()]
    return dict(files=len(files), total=sum(f.stat().st_size for f in files),
                data=sum(f.stat().st_size for f in files if f.parent.name == "d"),
                metadata=(item_dir / "_METADATA").stat().st_size)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", help="also write the report as JSON to this path")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from sylber_tpu_torch.io.checkpoint import load_params_npz, save_params
    from sylber_tpu_torch.io.orbax import read_tree

    report = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, npz, dtype in (("mini_ckpt_params", "mini_ckpt.npz", np.float16),
                                 ("mini_synth_params", "mini_synth.npz", np.float32)):
            tree = load_params_npz(str(FIXTURES / npz), dtype=dtype)
            save_params(str(Path(tmp) / name), tree)
            port, jax = Path(tmp) / name / "params", FIXTURES / "orbax" / name / "params"
            back = read_tree(port)

            def same(a, b):
                if isinstance(b, dict):
                    return a.keys() == b.keys() and all(same(a[k], b[k]) for k in b)
                a, b = np.asarray(a), np.asarray(b)
                return a.dtype == b.dtype and a.tobytes() == b.tobytes()

            rec = dict(dtype=np.dtype(dtype).name, port=sizes(port), jax=sizes(jax),
                       read_back_bit_equal=same(back, tree))
            rec["port_over_jax_data"] = rec["port"]["data"] / rec["jax"]["data"]
            report[name] = rec
            print(json.dumps({name: rec}))
    if args.out:
        Path(args.out).write_text(json.dumps(report, indent=1))
    return 0 if all(r["read_back_bit_equal"] for r in report.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
