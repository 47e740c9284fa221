"""End-to-end walkthrough: segment, resynthesize, decode to audio.

Port of ``examples/demo.py`` (the script form of the reference's
``demo.ipynb``):

1. segment an utterance into syllables (``Segmenter``);
2. optionally plot the frames' cosine similarity with the boundaries
   (``--plot``, needs matplotlib);
3. resynthesize articulatory trajectories from the segment features
   (``SegmentSynthesis.resynthesize(features=...)``, each frame carrying its
   segment's feature);
4. with ``--audio-out``, decode them to a 16 kHz waveform with the HiFi-GAN
   articulatory vocoder (``--vocoder-ckpt``: a JAX-layout ``.npz`` or a
   torch generator checkpoint; else the checked-in ``mini_vocoder`` fixture;
   random-init weights only demonstrate the pipeline).

``--mini-fixtures`` runs every stage on the trained mini fixtures of
``tests/fixtures`` (the 144-wide encoder, the CFM and the vocoder trained on
the synthetic corpus). Everything is written into ``--out-dir``:
``articulation.npy``, ``similarity.png`` and the ``--audio-out`` file (a
relative name lands there).

    python -m sylber_tpu_torch.demo --wav utt.wav [--ckpt sylber.ckpt]
        [--synthesis-ckpt synthesis.npz] [--audio-out resynth.wav
        [--vocoder-ckpt hifigan.pt]] [--mini-fixtures] [--out-dir runs/demo]

It runs on ``cuda`` unless ``--device cpu`` is given, and raises without a
GPU. Without checkpoints it runs on seeded random weights (the structure
only).
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import Any, Dict

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
FIXTURES = ROOT / "tests" / "fixtures"


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--wav", required=True)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--synthesis-ckpt", default=None)
    ap.add_argument("--steps", type=int, default=50, help="ODE steps")
    ap.add_argument("--plot", action="store_true")
    ap.add_argument("--encoding-layer", type=int, default=9)
    ap.add_argument("--audio-out", default=None,
                    help="write the resynthesized waveform here (under --out-dir if relative)")
    ap.add_argument("--vocoder-ckpt", default=None,
                    help="a JAX-layout generator .npz or a torch HiFi-GAN generator "
                         "checkpoint, at SparcDecoderConfig()'s widths")
    ap.add_argument("--spk-emb", default=None, help=".npy speaker embedding (default: zeros)")
    ap.add_argument("--pitch-mean", type=float, default=120.0)
    ap.add_argument("--mini-fixtures", action="store_true",
                    help="run every stage on the trained mini fixtures")
    ap.add_argument("--out-dir", default="runs/demo")
    ap.add_argument("--device", default=None,
                    help="cuda (the default; raises without a GPU) or cpu")
    return ap.parse_args(argv)


def build_models(args, device):
    """``(Segmenter, SegmentSynthesis)`` of the mini fixtures or of the
    checkpoints (seeded random weights where none is given)."""
    import yaml

    from .api import Segmenter
    from .io.checkpoint import load_params_npz
    from .models.hubert import HubertConfig
    from .synthesis import SegmentSynthesis, synthesis_config_from_dict

    if args.mini_fixtures:
        mmeta = json.loads((FIXTURES / "mini_ckpt.json").read_text())
        enc = load_params_npz(str(FIXTURES / "mini_ckpt.npz"))
        segmenter = Segmenter(
            params=enc, device=device,
            hubert_config=HubertConfig(num_hidden_layers=mmeta["encoding_layer"], **{
                k: tuple(v) if isinstance(v, list) else v for k, v in mmeta["hubert"].items()}),
            norm_threshold=mmeta["norm_threshold"], merge_threshold=mmeta["merge_threshold"])
        smeta = json.loads((FIXTURES / "mini_synth.json").read_text())
        synth = SegmentSynthesis(config=synthesis_config_from_dict(smeta["config"]["model"]),
                                 params={"hubert": enc,
                                         **load_params_npz(str(FIXTURES / "mini_synth.npz"))},
                                 device=device)
        return segmenter, synth
    segmenter = Segmenter(model_ckpt=args.ckpt, encoding_layer=args.encoding_layer,
                          device=device)
    cfg = yaml.safe_load((ROOT / "configs" / "sylber_resynthesis.yaml").read_text())
    return segmenter, SegmentSynthesis(model_ckpt=args.synthesis_ckpt, device=device, **cfg)


def build_vocoder(args, device):
    """The vocoder of ``--vocoder-ckpt``, else the ``mini_vocoder`` fixture,
    else None (``decode_audio`` then warns and uses random-init weights)."""
    from .vocoder import HiFiGANConfig, SparcDecoderConfig
    from .vocoder.sparc import load_decoder

    if args.vocoder_ckpt:
        return load_decoder(args.vocoder_ckpt, device=device)
    fx, meta_p = FIXTURES / "mini_vocoder.npz", FIXTURES / "mini_vocoder.json"
    if fx.exists() and meta_p.exists():
        meta = json.loads(meta_p.read_text())
        print(f"using the mini vocoder fixture {fx} (spec_corr {meta['eval']['spec_corr']:.2f} "
              "on synthetic held-out audio)")
        return load_decoder(str(fx), SparcDecoderConfig(
            generator=HiFiGANConfig(**meta["generator"])), device=device)
    print("note: no --vocoder-ckpt and no mini_vocoder fixture; decoding with random-init "
          "weights (a pipeline demo, not intelligible audio)")
    return None


def main(argv=None) -> Dict[str, Any]:
    """Run the walkthrough; returns the segments, the art and the waveform
    (None without ``--audio-out``)."""
    args = parse_args(argv)
    from .api import resolve_device

    device = resolve_device(args.device)
    out_dir = Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    segmenter, synth = build_models(args, device)

    out = segmenter(wav_file=args.wav, in_second=True)
    segments = out["segments"]
    n_frames = out["hidden_states"].shape[0]
    print(f"{len(segments)} syllable segments "
          f"({len(segments) / max(n_frames / 50.0, 1e-9):.2f} tokens/s):")
    for s, e in segments[:20]:
        print(f"  [{s:7.3f}s, {e:7.3f}s)")

    if args.plot:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        h = out["hidden_states"]
        norms = np.linalg.norm(h, axis=1)
        sim = h @ h.T / (norms[:, None] * norms[None, :] + 1e-8)
        plt.figure(figsize=(8, 8))
        plt.imshow(sim, origin="lower")
        for s, _ in (segments * 50).astype(int):
            plt.axvline(s, color="w", lw=0.3)
        plt.savefig(out_dir / "similarity.png", dpi=120)
        print(f"wrote {out_dir / 'similarity.png'}")

    # each frame carries its segment's feature
    filled = np.zeros((n_frames, out["hidden_states"].shape[1]), np.float32)
    for (s, e), f in zip((segments * 50).astype(int), out["segment_features"]):
        filled[s:e] = f
    art, _ = synth.resynthesize(features=filled[None], steps=args.steps)
    print(f"articulatory trajectory: {art.shape} (12 EMA dims + log-pitch + loudness)")
    np.save(out_dir / "articulation.npy", art[0])
    print(f"wrote {out_dir / 'articulation.npy'}")

    wav_out = None
    if args.audio_out:
        vocoder = build_vocoder(args, device)
        spk = (np.zeros(64, np.float32) if args.spk_emb is None
               else np.load(args.spk_emb).astype(np.float32))
        wav_out = synth.decode_audio(art, spk, pitch_mean=args.pitch_mean, vocoder=vocoder)[0]
        from scipy.io import wavfile

        path = out_dir / args.audio_out
        wavfile.write(path, 16000, np.clip(wav_out * 32767, -32768, 32767).astype(np.int16))
        print(f"wrote {path} ({len(wav_out) / 16000.0:.2f}s)")
    else:
        print("pass --audio-out out.wav to decode to a waveform")
    return {"segments": segments, "art": art, "waveform": wav_out}


if __name__ == "__main__":
    main()
