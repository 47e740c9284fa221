"""The benchmark of ``sylber_tpu_torch`` on an NVIDIA H100.

Run one cell with ``python3 -m portbench.run --workload <cell> --seed <n>
--seconds <s> --trace <0|1>`` from the root of a checkout. See
``portbench/README.md`` for the layout and for how a cell, a configuration,
a driver or a per-layer metric is added by adding files.
"""
