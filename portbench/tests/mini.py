"""Cells at the mini fixtures' widths for the CPU tests: the configuration
of ``tests/fixtures/mini_ckpt.json`` (read, never written) in float32, and
a few short utterances."""

from __future__ import annotations

import copy
import json
from pathlib import Path

from portbench import spec

MINI = Path(spec.CHECKOUT) / "tests" / "fixtures" / "mini_ckpt.json"


def mini_config(name: str, dtype: str = "float32") -> dict:
    cfg = copy.deepcopy(spec.config(name))
    widths = json.loads(MINI.read_text())["hubert"]
    cfg.update(widths)
    cfg["num_hidden_layers"] = 2
    cfg["dtype"] = cfg["frontend_dtype"] = dtype
    cfg["precision"] = "highest"
    if dtype == "float32":  # the program's rule: exact GELU in float32 ops
        cfg["gelu"] = {k: "erf" for k in cfg["gelu"]}
    return cfg


def mini_segment_cell(batch: int = 4, utterances: int = 8) -> spec.Cell:
    """``seg-corpus-b64`` at the mini widths: two small batches."""
    cell = spec.cell("seg-corpus-b64")
    wl = copy.deepcopy(cell.workload)
    wl["traffic"].update(utterances=utterances, batch=batch, median_s=1.5, log_sigma=0.3,
                         min_s=1.0, max_s=2.5, pool=2, pool_s=3.0, length_bucket_s=1.0)
    wl["check"]["sample"] = 4
    return cell._replace(workload=wl, config=mini_config(cell.config["name"]))


def mini_train_cell(batch: int = 4, crops: int = 12) -> spec.Cell:
    """``train-stage2-b100`` at the mini widths: 1 s crops, K 2."""
    cell = spec.cell("train-stage2-b100")
    wl = copy.deepcopy(cell.workload)
    wl["traffic"].update(crops=crops, batch=batch, crop_s=1.0, pool=2, pool_s=3.0,
                         steps_per_dispatch=2, traced_dispatches=1)
    cfg = mini_config(cell.config["name"])
    cfg["gelu_student"] = dict(cfg["gelu"])
    return cell._replace(workload=wl, config=cfg)
