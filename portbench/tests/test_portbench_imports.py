"""What the benchmark loads: no JAX and no JAX package, compared by whole
top-level names; the reference loads nothing of the program."""

import json
import os
import subprocess
import sys

from portbench.run import FORBIDDEN, forbidden_modules

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _modules_after(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys, json\n"
                          "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
                         cwd=ROOT, capture_output=True, text=True, check=True,
                         env=dict(os.environ, PYTHONPATH=ROOT))
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_whole_names_are_compared():
    assert forbidden_modules(["sylber_tpu_torch", "sylber_tpu_torch.api", "jaxtyping"]) == []
    assert forbidden_modules(["sylber_tpu.api", "jax.numpy", "flax", "jaxlib.xla"]) == \
        ["flax", "jax", "jaxlib", "sylber_tpu"]


def test_harness_and_drivers_load_no_jax():
    loaded = _modules_after(
        "import portbench.run, portbench.readings\n"
        "from portbench import spec\n"
        "for name in [w['name'] for w in spec.benchmark()['workloads']]:\n"
        "    cell = spec.cell(name)\n"
        "    spec.driver(cell.workload['driver'])\n"
        "    [spec.reader(m['name']) for m in cell.per_layer]\n"
        "import sylber_tpu_torch.api, sylber_tpu_torch.train.distill, "
        "sylber_tpu_torch.train.dispatch")
    assert "sylber_tpu_torch" in loaded
    assert not loaded & set(FORBIDDEN)


def test_reference_loads_nothing_of_the_program():
    loaded = _modules_after("import portbench.reference.hubert, portbench.reference.segment, "
                            "portbench.reference.distill, portbench.reference.precision")
    assert not loaded & (set(FORBIDDEN) | {"sylber_tpu_torch"})
