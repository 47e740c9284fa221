"""Stage-by-stage ridge probes of the trainable VQ's pitch decodability.

Port of ``scripts/vq_pitch_probe.py``, on the mini fixtures (the trained
encoder ``mini_ckpt.npz`` as ``mini_vq_synth.json``'s model block builds
it, the committed tokenizer ``mini_vq_tokenizer.npz``). Per-frame log-pitch
over the voiced, non-blank frames of 64 training (seed 0) and 24 held-out
(seed 90001) utterances of 5 s, from:

  (a) the raw segment-averaged encoder features;
  (b) the unit-normed features (the quantizer's input);
  (c) the committed tokenizer's pre-VQ pitch embedding;
  (d) its quantized pitch embedding;
  (e) its quantized art embedding;

each a ridge fit on the training frames with the train and held-out r, and

  (f) a supervised encoder and linear head alone (no CFM): ``unit_norm`` ->
      ``FFEncoder`` -> ``unit_norm_sep`` -> the pitch VQ's straight-through
      ``vq_forward`` -> the head, Adam at 3e-4 on the masked MSE plus the
      commitment loss, ``vq_ema_update`` after each step, 600 steps of 4,096
      frames drawn by ``RandomState(0).randint`` (JAX's draws): the
      achievable pitch-loss floor, printed every 100 steps.

The encoder and VQ start from ``quantizer_init`` on a ``torch.Generator``
seeded 0 (JAX's draws differ), or from ``main(init=...)``'s state.
``--n-train``, ``--n-heldout``, ``--steps`` and ``--batch`` are the script's
constants. Writes ``<out-dir>/vq_pitch_probe.json``:

    python -m sylber_tpu_torch.vq_pitch_probe [--out-dir runs/vq_pitch_probe]

It runs on ``cuda`` unless ``--device cpu`` is given, and raises without a
GPU.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import Any, Dict

import numpy as np
import torch

from .token_chain_proof import FIXTURES, HELDOUT_SEED
from .utils.metrics import pearson


def ridge(X, y, Xh, yh, lam=1e-3):
    """Fit ridge on (X,y), report train/heldout pearson r."""
    X = np.asarray(X, np.float64)
    y = np.asarray(y, np.float64)
    mu, sd = X.mean(0), X.std(0) + 1e-8
    Xn = (X - mu) / sd
    A = Xn.T @ Xn + lam * len(X) * np.eye(X.shape[1])
    w = np.linalg.solve(A, Xn.T @ (y - y.mean()))

    def pred(Z):
        return ((np.asarray(Z, np.float64) - mu) / sd) @ w + y.mean()

    return pearson(pred(X), y), pearson(pred(Xh), np.asarray(yh, np.float64))


def load_fixtures(device):
    """The encoder of ``mini_vq_synth.json``'s model block with the weights
    of ``mini_ckpt.npz``, its norm threshold, the quantizer's config and the
    committed tokenizer."""
    from .io.checkpoint import load_state_dict
    from .models.hubert import HubertModel
    from .synthesis import synthesis_config_from_dict
    from .vq_tokenizer import TrainedVQTokenizer, quantizer_config_from_dict

    meta = json.loads((FIXTURES / "mini_vq_synth.json").read_text())
    model_cfg = meta["config"]["model"]
    hub = synthesis_config_from_dict(model_cfg).hubert
    encoder = HubertModel(hub)
    encoder.load_state_dict(load_state_dict(str(FIXTURES / "mini_ckpt.npz"),
                                            hub.num_hidden_layers))
    qd = meta["quantizer_config"]
    qcfg = quantizer_config_from_dict(
        {k: qd[k] for k in ("output_dim", "pitch_emb_dim", "hidden_dims", "art_vq", "pitch_vq")},
        input_dim=qd["input_dim"])
    tok = TrainedVQTokenizer.load_npz(str(FIXTURES / "mini_vq_tokenizer.npz"), qcfg,
                                      device=device)
    return encoder.to(device).eval(), float(model_cfg["norm_threshold"]), qcfg, tok


def supervised_floor(feats, art, mask, qcfg, state, steps: int, batch: int, device,
                     log_every: int = 100) -> Dict[int, float]:
    """Probe (f): the supervised encoder and head from ``state``'s encoder
    and pitch VQ over every frame of ``feats`` (N, L, d) (the loss masked by
    ``mask``); the masked MSE at every ``log_every`` steps and at the last."""
    from .flow.quantizer import FFEncoder, unit_norm, unit_norm_sep, vq_ema_update, vq_forward

    pd = qcfg.pitch_emb_dim
    enc = [{k: v.clone().requires_grad_() for k, v in layer.items()} for layer in state.encoder]
    head = [torch.zeros(pd, device=device, requires_grad=True),
            torch.zeros((), device=device, requires_grad=True)]
    opt = torch.optim.Adam([t for layer in enc for t in layer.values()] + head, lr=3e-4)
    x_all = torch.from_numpy(np.ascontiguousarray(feats.reshape(-1, feats.shape[-1]))).to(device)
    y_all = torch.from_numpy(np.ascontiguousarray(art[..., 12].reshape(-1))).to(device)
    m_all = torch.from_numpy(mask.reshape(-1).astype(np.float32)).to(device)
    pvq = state.pitch_vq
    order = np.random.RandomState(0)
    mse = {}
    for i in range(steps):
        idx = torch.from_numpy(order.randint(0, x_all.shape[0], batch)).to(device)
        x, y, m = x_all[idx], y_all[idx], m_all[idx]
        t = FFEncoder.apply(enc, unit_norm(x), len(qcfg.hidden_dims))
        pre = unit_norm_sep(t, True, pd)[..., -pd:]
        pq, pidx, closs = vq_forward(pvq, qcfg.pitch_vq, pre)
        err = ((pq @ head[0] + head[1] - y) ** 2 * m).sum() / m.sum().clamp_min(1.0)
        opt.zero_grad()
        (err + closs).backward()
        opt.step()
        pvq = vq_ema_update(pvq, qcfg.pitch_vq, pre.detach(), pidx)
        if (i + 1) % log_every == 0 or i + 1 == steps:
            mse[i + 1] = float(err.detach())
    return mse


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n-train", type=int, default=64)
    ap.add_argument("--n-heldout", type=int, default=24)
    ap.add_argument("--steps", type=int, default=600, help="probe (f)'s steps")
    ap.add_argument("--batch", type=int, default=4096, help="probe (f)'s frames a step")
    ap.add_argument("--out-dir", default="runs/vq_pitch_probe")
    ap.add_argument("--device", default=None,
                    help="cuda (the default; raises without a GPU) or cpu")
    return ap.parse_args(argv)


def main(argv=None, init=None) -> Dict[str, Any]:
    """Print the probes' lines and write their numbers; ``init``: probe
    (f)'s starting ``QuantizerState`` (default ``quantizer_init`` from a
    generator seeded 0)."""
    args = parse_args(argv)
    from .api import resolve_device
    from .flow.quantizer import quantizer_forward, quantizer_init, quantizer_to, unit_norm
    from .train.synthesis_loop import build_synthesis_corpus, precompute_features

    device = resolve_device(args.device)
    encoder, norm_thr, qcfg, tok = load_fixtures(device)
    tr = build_synthesis_corpus(args.n_train, 5.0, seed=0)
    ho = build_synthesis_corpus(args.n_heldout, 5.0, seed=HELDOUT_SEED)
    # both sets in one pass (an utterance's features are its own)
    feats = precompute_features(encoder, np.concatenate([tr["wav"], ho["wav"]]), norm_thr,
                                0.8).cpu().numpy()
    f_tr, f_ho = feats[:args.n_train], feats[args.n_train:]
    L = min(f_tr.shape[1], tr["art"].shape[1])

    def sel(feats, art):
        feats, art = feats[:, :L], art[:, :L]
        m = ((feats ** 2).sum(-1) > 0) & (art[..., 13] > 0.02)
        return feats[m], art[..., 12][m], m

    Xtr, ytr, mtr = sel(f_tr, tr["art"])
    Xho, yho, mho = sel(f_ho, ho["art"])
    print(f"frames: train {len(ytr)}, heldout {len(yho)}; "
          f"pitch var train {ytr.var():.4f} mean {ytr.mean():.4f}")
    probes = {}

    def report(key, label, A, B):
        r_tr, r_ho = ridge(A, ytr, B, yho)
        probes[key] = {"r_train": r_tr, "r_heldout": r_ho}
        print(f"{label} r_train={r_tr:.3f} r_heldout={r_ho:.3f}")

    report("a", "(a) raw features -> pitch:       ", Xtr, Xho)
    normed = [unit_norm(torch.from_numpy(X).to(device)).cpu().numpy() for X in (Xtr, Xho)]
    report("b", "(b) unit-normed features -> pitch:", *normed)

    pd = qcfg.pitch_emb_dim
    with torch.no_grad():
        outs = [quantizer_forward(tok.state, qcfg, torch.from_numpy(f[:, :L]).to(device))
                for f in (f_tr, f_ho)]
    pre = [o["non_quantized"].cpu().numpy()[m] for o, m in zip(outs, (mtr, mho))]
    q = [o["quantize"].cpu().numpy()[m] for o, m in zip(outs, (mtr, mho))]
    report("c", "(c) pre-VQ pitch emb -> pitch:", pre[0][:, -pd:], pre[1][:, -pd:])
    report("d", "(d) quantized pitch emb -> pitch:", q[0][:, -pd:], q[1][:, -pd:])
    report("e", "(e) quantized ART emb -> pitch:", q[0][:, :-pd], q[1][:, :-pd])

    state = (quantizer_to(init, device) if init is not None
             else quantizer_init(qcfg, torch.Generator().manual_seed(0), device))
    mse = supervised_floor(f_tr[:, :L], tr["art"][:, :L], mtr, qcfg, state, args.steps,
                           args.batch, device)
    for step, err in mse.items():
        if step % 100 == 0:
            print(f"  (f) step {step}: supervised-only pitch MSE {err:.4f} "
                  f"(var {ytr.var():.4f})")
    out = {"frames_train": int(len(ytr)), "frames_heldout": int(len(yho)),
           "pitch_var_train": float(ytr.var()), "pitch_mean_train": float(ytr.mean()),
           "probes": probes, "supervised_mse": mse, "steps": args.steps, "batch": args.batch}
    path = Path(args.out_dir) / "vq_pitch_probe.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(out, indent=2))
    return out


if __name__ == "__main__":
    main()
