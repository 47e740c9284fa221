"""Training entry point of the port:

    python -m sylber_tpu_torch.train --config configs/sylber_base.yaml \\
        [--out-dir DIR] [--max-steps N] [--log-every N] [--ckpt-every N] \\
        [--val-every N] [--device cpu]

The same YAML recipes as the JAX package's ``train.py``. ``speech_model_ckpt``
(encoder initialisation) or ``model_ckpt`` (the previous stage's parameters)
take a PyTorch state dict (HF ``HubertModel`` or ``sylber.ckpt``), a
JAX-layout ``.npz`` or an Orbax directory of the JAX package (the JAX
trainer's ``params_final``). Runs on the GPU unless
``--device cpu`` is given, and refuses to start without one.

Several GPUs: ``torchrun --nproc_per_node N -m sylber_tpu_torch.train
--config ...`` (one process a GPU; the recipe's ``mesh:`` lays them out),
or on several hosts a ``distributed:`` block or the ``SYLBER_TPU_DIST``,
``SYLBER_TPU_COORDINATOR``, ``SYLBER_TPU_NUM_PROCESSES`` and
``SYLBER_TPU_PROCESS_ID`` variables (``parallel/mesh.py``); the output
directory must then be one all hosts see.
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m sylber_tpu_torch.train")
    ap.add_argument("--config", required=True)
    ap.add_argument("--out-dir", default=None)
    ap.add_argument("--max-steps", type=int, default=None)
    ap.add_argument("--log-every", type=int, default=50)
    ap.add_argument("--ckpt-every", type=int, default=1000)
    ap.add_argument("--val-every", type=int, default=None)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    import yaml

    import torch.distributed as dist

    from ..api import resolve_device
    from ..io.checkpoint import load_state_dict
    from ..parallel.mesh import maybe_distributed_init
    from .loop import train

    resolve_device(args.device)  # no GPU and no --device cpu: refuse to start
    with open(args.config) as f:
        cfg = yaml.safe_load(f)
    formed = maybe_distributed_init(cfg.get("distributed"), args.device)
    device = resolve_device(args.device)  # cuda:LOCAL_RANK in a process group
    path = cfg.get("speech_model_ckpt") or cfg.get("model_ckpt")
    init = None
    if path:
        init = load_state_dict(path, cfg.get("model", {}).get("encoding_layer", 9))
    train(cfg, out_dir=args.out_dir or f"runs/{cfg.get('name', 'sylber')}",
          max_steps=args.max_steps or cfg.get("max_steps"), log_every=args.log_every,
          ckpt_every=args.ckpt_every, val_every=args.val_every,
          limit_val_batches=cfg.get("limit_val_batches", 100), init_params=init,
          device=device)
    if formed:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
