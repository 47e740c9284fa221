"""Resynthesis training entry point of the port:

    python -m sylber_tpu_torch.train_synthesis --config configs/sylber_resynthesis_mini.yaml \\
        [--out-dir DIR] [--max-steps N] [--log-every N] [--eval-steps N] \\
        [--fixture-dir DIR] [--fixture-prefix NAME] [--tokens] [--device cpu]

The flags of the JAX package's ``train_synthesis.py``. Trains the CFM stack
(``train/synthesis_loop.py``) or, with ``--tokens``, the quantizer jointly
with it (``train/vq_synthesis.py``; the recipe needs
``model.quantizer_configs``). ``--fixture-dir`` also writes the trained
``input_mlp`` and ``regressor`` as ``<prefix>.npz`` (default ``mini_synth``,
or ``mini_vq_synth`` with ``--tokens``, plus ``mini_vq_tokenizer.npz``) with
a ``<prefix>.json`` of the recipe and the eval, the fixtures' layout;
nothing is written there unless the flag names the directory. Runs on the
GPU unless ``--device cpu`` is given, and refuses to start without one.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from pathlib import Path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m sylber_tpu_torch.train_synthesis")
    ap.add_argument("--config", required=True)
    ap.add_argument("--out-dir", default=None)
    ap.add_argument("--max-steps", type=int, default=None)
    ap.add_argument("--log-every", type=int, default=50)
    ap.add_argument("--eval-steps", type=int, default=50,
                    help="ODE steps of the held-out gate")
    ap.add_argument("--fixture-dir", default=None,
                    help="also write the trained weights and the eval here, as fixtures")
    ap.add_argument("--fixture-prefix", default=None,
                    help="the fixtures' basename (default mini_synth, or mini_vq_synth "
                         "with --tokens)")
    ap.add_argument("--tokens", action="store_true",
                    help="train the grouped-residual-VQ quantizer jointly (needs "
                         "model.quantizer_configs) and gate the wav -> tokens -> CFM chain")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    import yaml

    from .api import resolve_device
    from .io.checkpoint import save_tree_npz, tree_from_state_dict

    device = resolve_device(args.device)
    with open(args.config) as f:
        cfg = yaml.safe_load(f)
    out_dir = args.out_dir or f"runs/{cfg.get('name', 'synthesis')}"
    seed = int(cfg.get("seed", 0))
    kw = dict(out_dir=out_dir, max_steps=args.max_steps, log_every=args.log_every,
              eval_steps=args.eval_steps, seed=seed, device=device)
    if args.tokens:
        from .train.vq_synthesis import tokenizer_of, train_vq_synthesis

        state, qcfg, metrics = train_vq_synthesis(cfg, **kw)
        base = args.fixture_prefix or "mini_vq_synth"
        meta = {"config": cfg, "quantizer_config": dataclasses.asdict(qcfg), "eval": metrics}
    else:
        from .train.synthesis_loop import train_synthesis

        state, metrics = train_synthesis(cfg, **kw)
        base = args.fixture_prefix or "mini_synth"
        meta = {"config": cfg, "eval": metrics}
    if args.fixture_dir:
        fx = Path(args.fixture_dir)
        fx.mkdir(parents=True, exist_ok=True)
        synth = state.synth
        save_tree_npz(str(fx / f"{base}.npz"),
                      {"input_mlp": tree_from_state_dict(synth.input_mlp.state_dict()),
                       "regressor": tree_from_state_dict(synth.regressor.state_dict())})
        if args.tokens:
            tokenizer_of(state, qcfg).save_npz(str(fx / f"{base.replace('_synth', '_tokenizer')}.npz"))
        (fx / f"{base}.json").write_text(json.dumps(meta, indent=1))
        print(f"fixture written to {fx}/{base}.npz")
    return 0


if __name__ == "__main__":
    sys.exit(main())
