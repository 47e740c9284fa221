"""Mini vocoder training proof: articulatory features -> audible waveform.

Port of ``scripts/train_vocoder_proof.py``. Trains the port's HiFi-GAN
(``vocoder/hifigan.py::make_vocoder_train_step``: adversarial,
feature-matching and log-mel L1 losses, the NSF harmonic source) on
synthetic (art, wav) pairs with analytic articulatory ground truth
(``data/synthetic.py::synth_utterance(return_art=True)``), then scores
held-out utterances (:func:`evaluate`): log-mel L1, the spectral
correlation of the log-mel frames, and the correlation and periodicity of
an autocorrelation F0 track against the real audio.

Writes ``<out-dir>/<prefix>.npz`` (the generator in the JAX layout, float16,
which both packages' ``SparcDecoder`` read) and ``<prefix>.json`` (the keys
of ``tests/fixtures/mini_vocoder.json``), every ``--save-every`` steps and
at the end. ``--state-out`` also writes the whole train state (generator,
discriminators, both Adam states, the step, the batch order's generator and
the rest of its epoch), and ``--resume-from`` continues from one: a resumed
run gives the parameters of an uninterrupted one, bit for bit on one device
(with cuDNN deterministic on the card). ``--steps`` counts the steps of
this call; the metadata reports the total. The recipes of
``tests/fixtures/mini_vocoder.json`` and ``mini_vocoder_rich.json``:

    python -m sylber_tpu_torch.vocoder_proof --steps 8000
    python -m sylber_tpu_torch.vocoder_proof --steps 8000 --style rich \\
        --fixture-prefix mini_vocoder_rich

It runs on ``cuda`` unless ``--device cpu`` is given, and raises without a
GPU. ``--dp N`` runs data parallel over a process group of N ranks
(``torchrun --nproc_per_node N -m sylber_tpu_torch.vocoder_proof --dp N``):
each rank takes its rows of every batch, the gradients are averaged, rank 0
evaluates and writes. The script fails when the final eval misses the JAX
package's gates (:func:`gate_failures`).
"""

from __future__ import annotations

import argparse
import json
import os
import time
from pathlib import Path
from typing import Any, Dict, List

import numpy as np

SECONDS = 1.0          # crop length: 50 frames -> 16000 samples
FRAMES = int(SECONDS * 50)

GEN_CFG = {            # a scaled-down HiFi-GAN v1 with the NSF harmonic source
    "in_channels": 14,
    "cond_channels": 64,
    "upsample_initial_channel": 128,
    "harmonic_source": True,
}


def build_corpus(n_utts: int, seed: int, style: str = "v1"):
    """1 s (wav, art) crops, frame-aligned, biased into each utterance:
    ``(wavs (n, 16000), arts (n, 50, 14), PITCH_MEAN)``."""
    from .data.synthetic import PITCH_MEAN, synth_utterance

    rng = np.random.RandomState(seed)
    wavs, arts = [], []
    n = int(SECONDS * 16000)
    for _ in range(n_utts):
        wav, _segs, art = synth_utterance(rng, 2 * n, return_art=True, style=style)
        s = rng.randint(0, FRAMES)
        wavs.append(wav[s * 320: s * 320 + n])
        arts.append(art[s: s + FRAMES])
    return np.stack(wavs), np.stack(arts), PITCH_MEAN


def f0_track_autocorr(wav: np.ndarray, sr=16000, frame=1024, hop=320,
                      fmin=70.0, fmax=400.0):
    """Per-frame F0 and periodicity strength by normalized autocorrelation
    (the lag of the largest value in the pitch band): ``(f0, strength)``,
    float32, 0 on silent frames."""
    lmin, lmax = int(sr / fmax), int(sr / fmin)
    n_frames = max((len(wav) - frame) // hop + 1, 0)
    f0 = np.zeros(n_frames, np.float32)
    strength = np.zeros(n_frames, np.float32)
    for t in range(n_frames):
        seg = wav[t * hop: t * hop + frame].astype(np.float64)
        seg = seg - seg.mean()
        ac = np.correlate(seg, seg, "full")[frame - 1:]
        if ac[0] <= 1e-9:
            continue
        ac = ac / ac[0]
        lag = lmin + int(np.argmax(ac[lmin: lmax + 1]))
        f0[t] = sr / lag
        strength[t] = ac[lag]
    return f0, strength


def features_from_art(arts: np.ndarray, pitch_mean: float) -> np.ndarray:
    """The generator's input from articulatory tracks, as ``SparcDecoder``
    conditions ``decode_audio`` (``vocoder/sparc.py::features_from_art``)."""
    import torch

    from .vocoder.sparc import features_from_art as from_art

    return from_art(torch.from_numpy(np.asarray(arts, np.float32)), pitch_mean).numpy()


def evaluate(generator, feats: np.ndarray, wavs: np.ndarray, mel_cfg=None,
             precision: str = "default", noise=None) -> Dict[str, float]:
    """log-mel L1 and spectral correlation of ``generator``'s audio against
    ``wavs``, and over the first 8 utterances the F0 track's correlation and
    the generated audio's median periodicity on the real audio's strongly
    periodic frames. ``noise``: the harmonic source's noise channel (B, T *
    320), else the generator's own seeded draw."""
    import torch

    from .models.hubert import matmul_precision
    from .utils.metrics import pearson
    from .vocoder.mel import MelConfig, log_mel

    mel_cfg = mel_cfg or MelConfig()
    device = next(generator.parameters()).device
    cond = torch.zeros(feats.shape[0], generator.config.cond_channels, device=device)
    with torch.no_grad(), matmul_precision(precision):
        f = torch.as_tensor(np.asarray(feats, np.float32)).to(device)
        fake_t = generator(f, cond, noise=None if noise is None
                           else torch.as_tensor(noise).to(device))
        mel_f = log_mel(fake_t, mel_cfg).cpu().numpy()
        mel_r = log_mel(torch.as_tensor(np.asarray(wavs, np.float32)).to(device),
                        mel_cfg).cpu().numpy()
    fake = fake_t.cpu().numpy()
    f0_corrs, periodicity = [], []
    for i in range(min(8, len(wavs))):
        f_real, s_real = f0_track_autocorr(wavs[i])
        f_fake, s_fake = f0_track_autocorr(fake[i])
        voiced = s_real > 0.4
        periodicity.append(float(np.median(s_fake[voiced])) if voiced.sum() > 10 else 0.0)
        if voiced.sum() > 10:
            f0_corrs.append(pearson(f_real[voiced], f_fake[voiced]))
    return {"mel_l1": float(np.abs(mel_f - mel_r).mean()), "spec_corr": pearson(mel_f, mel_r),
            "f0_corr": float(np.mean(f0_corrs)) if f0_corrs else 0.0,
            "periodicity": float(np.mean(periodicity))}


def gate_failures(meta: Dict[str, Any]) -> List[str]:
    """The JAX package's gates on a vocoder proof's ``.json``: for v1
    ``tests/parity/test_mini_vocoder.py:50-54``, for the rich corpus
    ``tests/parity/test_rich_fixtures.py:187-190``. Returns the gates
    missed (none: it passes)."""
    ev, base = meta["eval"], meta["eval_random_init"]
    rich = meta.get("train", {}).get("style", "v1") == "rich"
    gates = [("mel_l1 < 0.6 x random init's", ev["mel_l1"] < 0.6 * base["mel_l1"]),
             ("spec_corr > 0.85", ev["spec_corr"] > 0.85),
             ("f0_corr > 0.9" if rich else "f0_corr > 0.7",
              ev["f0_corr"] > (0.9 if rich else 0.7)),
             ("periodicity > 0.55", ev["periodicity"] > 0.55)]
    if not rich:
        gates.insert(1, ("mel_l1 < 0.45", ev["mel_l1"] < 0.45))
    return [f"{name}: {json.dumps(ev)}" for name, ok in gates if not ok]


# ---------------------------------------------------------------- train state

def save_state(path: str, state, rng: np.random.RandomState, order: np.ndarray) -> None:
    """The whole train state (tensors, the step, the batch order's
    generator and the rest of its epoch), written atomically."""
    import torch

    _, keys, pos, has_gauss, gauss = rng.get_state()
    blob = {"generator": state.generator.state_dict(), "mpd": state.mpd.state_dict(),
            "msd": state.msd.state_dict(), "opt_gen": state.opt_gen.state_dict(),
            "opt_disc": state.opt_disc.state_dict(), "step": int(state.step),
            "rng_keys": torch.from_numpy(keys.astype(np.int64)), "rng_pos": int(pos),
            "rng_has_gauss": int(has_gauss), "rng_gauss": float(gauss),
            "order": torch.from_numpy(np.asarray(order, np.int64))}
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    tmp = f"{path}.tmp"
    torch.save(blob, tmp)
    os.replace(tmp, path)


def load_state(path: str, state):
    """Restore :func:`save_state`'s file into ``state`` (made by
    ``init_fn`` on the run's device): ``(rng, order)``."""
    import torch

    blob = torch.load(path, map_location="cpu", weights_only=True)
    state.generator.load_state_dict(blob["generator"])
    state.mpd.load_state_dict(blob["mpd"])
    state.msd.load_state_dict(blob["msd"])
    state.opt_gen.load_state_dict(blob["opt_gen"])
    state.opt_disc.load_state_dict(blob["opt_disc"])
    state.step = int(blob["step"])
    rng = np.random.RandomState()
    rng.set_state(("MT19937", blob["rng_keys"].numpy().astype(np.uint32), blob["rng_pos"],
                   blob["rng_has_gauss"], blob["rng_gauss"]))
    return rng, blob["order"].numpy()


def write_generator(path: str, generator) -> None:
    """The generator as a JAX-layout float16 ``.npz`` (the fixtures' form)."""
    from .io.checkpoint import jax_tree_from_generator, save_tree_npz

    save_tree_npz(path, jax_tree_from_generator(generator.state_dict()), dtype=np.float16)


# ---------------------------------------------------------------- the run

def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=4000, help="steps of this call (chainable)")
    ap.add_argument("--batch-size", type=int, default=16)
    ap.add_argument("--n-utts", type=int, default=256)
    ap.add_argument("--out-dir", default="runs/vocoder_proof",
                    help="where <prefix>.npz and <prefix>.json go")
    ap.add_argument("--log-every", type=int, default=100)
    ap.add_argument("--save-every", type=int, default=2000,
                    help="evaluate and write the generator every N steps (0: at the end only)")
    ap.add_argument("--state-out", default="",
                    help="also write the whole train state here (with --save-every and at "
                         "the end)")
    ap.add_argument("--resume-from", default="", help="continue from a --state-out file")
    ap.add_argument("--dp", type=int, default=0,
                    help="data-parallel ranks (0: this process alone); needs a process group "
                         "of that size (torchrun)")
    ap.add_argument("--style", default="v1", choices=["v1", "rich"],
                    help="synthetic corpus style (rich: multi-speaker + phrase intonation)")
    ap.add_argument("--fixture-prefix", default="mini_vocoder",
                    help="the outputs' basename (rich runs: mini_vocoder_rich)")
    ap.add_argument("--skip-gates", action="store_true",
                    help="report the gates the final eval misses without failing (short "
                         "runs)")
    ap.add_argument("--device", default=None,
                    help="cuda (the default; raises without a GPU) or cpu")
    return ap.parse_args(argv)


def main(argv=None) -> Dict[str, Any]:
    """Train, evaluate and write; returns the ``.json``'s contents with the
    run's wall times (``"timing"``, not written) and the final state
    (``"state"``, not written)."""
    args = parse_args(argv)
    import torch

    from .api import resolve_device
    from .parallel.mesh import is_main, make_mesh, maybe_distributed_init, shard_batch
    from .vocoder import HiFiGANConfig, VocoderTrainConfig, make_vocoder_train_step

    resolve_device(args.device)  # no GPU and no --device cpu: refuse to start
    mesh = None
    if args.dp > 1:
        maybe_distributed_init({}, args.device)
        device = resolve_device(args.device)
        mesh = make_mesh(args.dp, 1, device_type=device.type)
        if args.batch_size % args.dp:
            raise ValueError(f"--dp {args.dp} does not divide --batch-size {args.batch_size}")
    device = resolve_device(args.device)
    main_rank = is_main()
    if main_rank:
        print(f"device: {device}"
              + (f" {torch.cuda.get_device_name(device)}" if device.type == "cuda" else "")
              + (f"; mesh dp={args.dp}" if mesh else ""), flush=True)

    vcfg = VocoderTrainConfig(model=HiFiGANConfig(**GEN_CFG))
    wavs, arts, pitch_mean = build_corpus(args.n_utts, seed=0, style=args.style)
    feats = features_from_art(arts, pitch_mean)
    ho_wavs, ho_arts, _ = build_corpus(24, seed=777, style=args.style)
    ho_feats = features_from_art(ho_arts, pitch_mean)

    init_fn, step_fn = make_vocoder_train_step(vcfg, mesh=mesh)
    state = init_fn(device)
    # the baseline is the fresh init, evaluated before any resume
    base = evaluate(state.generator, ho_feats, ho_wavs, vcfg.mel)
    if main_rank:
        print("random-init eval:", json.dumps(base), flush=True)
    rng = np.random.RandomState(1)
    order = np.array([], np.int64)
    if args.resume_from:
        rng, order = load_state(args.resume_from, state)
        if main_rank:
            print(f"resumed the train state from {args.resume_from} @ step {state.step}",
                  flush=True)
    step0 = state.step

    d_feats = torch.from_numpy(feats).to(device)
    d_wavs = torch.from_numpy(wavs).to(device)
    d_cond = shard_batch(torch.zeros(args.batch_size, GEN_CFG["cond_channels"],
                                     device=device), mesh)
    out = Path(args.out_dir)

    def write_outputs(gstep: int) -> Dict[str, Any]:
        ev = evaluate(state.generator, ho_feats, ho_wavs, vcfg.mel)
        meta = {"generator": GEN_CFG, "pitch_mean": pitch_mean,
                "train": {"steps": gstep, "batch_size": args.batch_size,
                          "n_utts": args.n_utts, "style": args.style},
                "eval": ev, "eval_random_init": base}
        if main_rank:
            print(f"eval @ {gstep}:", json.dumps(ev), flush=True)
            out.mkdir(parents=True, exist_ok=True)
            write_generator(str(out / f"{args.fixture_prefix}.npz"), state.generator)
            (out / f"{args.fixture_prefix}.json").write_text(json.dumps(meta, indent=2))
            if args.state_out:
                save_state(args.state_out, state, rng, order)
        return meta

    t0 = time.perf_counter()
    for step_i in range(args.steps):
        if len(order) < args.batch_size:
            order = np.arange(args.n_utts)
            rng.shuffle(order)
        idx = torch.from_numpy(order[: args.batch_size]).to(device)
        order = order[args.batch_size:]
        feats_b, wavs_b = shard_batch((d_feats[idx], d_wavs[idx]), mesh)
        metrics = step_fn(state, feats_b, wavs_b, d_cond)
        gstep = state.step
        if (step_i + 1) % args.log_every == 0 and main_rank:
            m = {k: float(v) for k, v in metrics.items()}
            sps = (step_i + 1) / (time.perf_counter() - t0)
            print(f"step {gstep}: " + " ".join(f"{k}={v:.4g}" for k, v in m.items())
                  + f" steps_per_sec={sps:.2f}", flush=True)
        if args.save_every and (step_i + 1) % args.save_every == 0 and step_i + 1 < args.steps:
            write_outputs(gstep)
    train_s = time.perf_counter() - t0
    meta = write_outputs(step0 + args.steps)
    if main_rank:
        print("final eval:", json.dumps(meta["eval"]))
    failed = gate_failures(meta)
    if failed and main_rank and not args.skip_gates:
        raise AssertionError(f"the vocoder proof misses the JAX package's gates: {failed}")
    return dict(meta, timing={"train_s": train_s, "steps": args.steps}, state=state,
                gates_missed=failed)


if __name__ == "__main__":
    main()
