"""Synthetic speech with ground-truth syllable boundaries.

A numpy copy of ``sylber_tpu/data/synthetic.py`` (the port imports nothing of
the JAX package); it must generate the same audio from the same seed.

LibriSpeech is not in the repository, so end-to-end training proofs and
precision-agreement gates run on generated speech-like audio where the true
syllable segmentation is known analytically. Each utterance is a sequence of
"syllables": a voiced span with a random pitch contour whose harmonics are
shaped by a per-syllable pair of formant resonances drawn from a fixed
discrete bank (a stand-in for phoneme categories, so different syllables have
genuinely different spectral content for the model to separate), under a
raised-cosine amplitude envelope; syllables are separated by short optional
closures and occasional longer inter-word silences.

Average syllable rate is calibrated to ~4.3/s of voiced audio — the
reference's measured token rate (4.27 tok/s, Sylber's README).

Returns ground truth as 50 Hz frame spans aligned to the model's 320-sample
stride, in the same ``[start, end)`` convention as ``get_segment``
(Sylber's ``segment_utils.get_segment``).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

SR = 16000
FRAME = 320  # 50 Hz

# fixed "phoneme" bank: (F1, F2) formant pairs, deterministic across runs
_BANK_RNG = np.random.RandomState(20240901)
FORMANT_BANK = np.stack([
    _BANK_RNG.uniform(280, 900, 40),     # F1
    _BANK_RNG.uniform(900, 2800, 40),    # F2
], axis=1)

# --- "rich" corpus style (style="rich") -----------------------------------
# The v1 corpus saturates at ~265 distinct segment clusters (40 phonemes ×
# small pitch/duration variation), which caps trainable-codebook proofs at
# km1024 and makes pitch-correlation gates seed-sensitive on small evals.
# The rich style widens every axis while keeping the analytic ground truth:
#   - 160 phonemes with THREE formants (F1, F2, F3) — more spectral classes;
#   - a discrete 12-speaker bank: vocal-tract length scaling of all formants
#     plus a per-speaker pitch register spanning 85-280 Hz;
#   - per-utterance phrase intonation — declination, 2-4 accent bumps, and
#     an occasional final rise — that the f0 track follows CONTINUOUSLY, so
#     per-utterance pitch *modulation* (mean-removed F0 dynamics) is a real
#     learnable signal for the resynthesis stack, not jitter.
# style="v1" (default) consumes the exact RNG sequence of the original
# implementation, so every committed fixture and gate stays bit-identical.
_RICH_BANK_RNG = np.random.RandomState(20250801)
RICH_FORMANT_BANK = np.stack([
    _RICH_BANK_RNG.uniform(280, 900, 160),      # F1
    _RICH_BANK_RNG.uniform(900, 2500, 160),     # F2
    _RICH_BANK_RNG.uniform(2500, 3400, 160),    # F3
], axis=1)
_RICH_ART_RNG = np.random.RandomState(20250802)
RICH_ART_BANK = np.tanh(_RICH_ART_RNG.randn(160, 12) * 0.7).astype(np.float32)
# (formant_scale, register_hz): 12 "speakers" covering short/long vocal
# tracts and low/high pitch registers, deterministic across runs
_SPK_RNG = np.random.RandomState(20250803)
SPEAKER_BANK = np.stack([
    _SPK_RNG.uniform(0.86, 1.14, 12),                      # formant scale
    np.exp(_SPK_RNG.uniform(np.log(85.0), np.log(280.0), 12)),  # register
], axis=1)

# Analytic articulatory ground truth for the resynthesis stack. The real
# corpus pairs speech with 12 EMA articulator dims + log-pitch + loudness
# (SPARC features, Sylber's ``segment_synthesis.py``,
# 14 channels at 50 Hz). The synthetic stand-in derives the 12 "articulator"
# dims from the phoneme identity: each formant-bank entry maps to a fixed
# bounded target vector (distinct per phoneme, like articulator positions),
# traversed under the syllable's amplitude envelope — smooth move-to-target-
# and-back trajectories, zero in silence.
_ART_RNG = np.random.RandomState(20241002)
ART_BANK = np.tanh(_ART_RNG.randn(len(FORMANT_BANK), 12) * 0.7) \
    .astype(np.float32)
# corpus-level reference F0: art channel 12 is log(f0 / PITCH_MEAN), matching
# the demo's exp(pitch) * pitch_mean decode convention (demo.ipynb cell 11)
PITCH_MEAN = 120.0

# --- "continuum" corpus style (style="continuum") --------------------------
# The rich style's segment features still live on a DISCRETE grid (160
# phonemes x 12 speakers): k-means at 4096 centroids recovers only ~1100
# distinct clusters with near-zero inertia, so the reference's headline
# 5K/10K/20K-unit codebooks (Sylber's project page) cannot be
# meaningfully fitted. The continuum style keeps the rich machinery (three
# formants, phrase intonation, analytic ground truth) but makes the feature
# distribution continuous, like real speech:
#   - speaker parameters sampled per utterance from CONTINUOUS ranges
#     (formant scale 0.84-1.16, register 82-285 Hz) instead of a 12-row bank;
#   - per-syllable formant perturbation (lognormal sigma 0.035 per formant),
#     so every syllable token is a unique point near its phoneme class;
#   - per-syllable articulatory perturbation (sigma 0.12, clipped) so the
#     analytic art truth tracks the perturbed acoustics and quantized-feature
#     decodability evals stay well-posed.
# New style => no RNG-sequence compatibility constraints; v1/rich fixtures
# are untouched.
_CONT_F_SIGMA = 0.035
_CONT_ART_SIGMA = 0.12


def _syllable(rng: np.random.RandomState, n: int, f0: float,
              formants: np.ndarray, f0_track: np.ndarray = None):
    """Returns (waveform, per-sample f0 track, per-sample envelope).

    With ``f0_track`` (n,) given (rich style), the harmonics follow it;
    otherwise the v1 per-syllable declination+vibrato shape is used.
    ``f0`` still sets the harmonic count / formant sampling midpoint."""
    t = np.arange(n) / SR
    if f0_track is None:
        # mild pitch declination + jitter
        f0_t = f0 * (1.0 - 0.08 * t / max(t[-1], 1e-6)) \
            * (1.0 + 0.01 * np.sin(2 * np.pi * 5.0 * t))
    else:
        f0_t = f0_track
    phase = np.cumsum(2 * np.pi * f0_t / SR)
    x = np.zeros(n)
    max_h = int(3500 / f0)
    for k in range(1, max_h + 1):
        fk = k * f0
        # formant-shaped harmonic amplitude (two resonances, bw ~120 Hz)
        a = sum(1.0 / (1.0 + ((fk - fc) / 120.0) ** 2) for fc in formants)
        a *= 1.0 / k ** 0.5
        x += a * np.sin(k * phase)
    x /= np.abs(x).max() + 1e-9
    # raised-cosine-ish envelope with faster attack than decay
    tau = np.linspace(0, 1, n)
    env = np.sin(np.pi * tau ** 0.8) ** 0.7
    return ((x * env).astype(np.float32), f0_t.astype(np.float32),
            env.astype(np.float32))


def _phrase_contour(rng: np.random.RandomState, n_samples: int):
    """Per-utterance log-pitch intonation contour (rich style).

    Declination (0.10-0.35 log-units over the utterance) + 2-4 Gaussian
    accent bumps (height 0.05-0.25 log-units) + a 30% final rise. Returned
    as a callable over absolute sample positions so the f0 track follows
    one continuous contour across syllables."""
    decl = rng.uniform(0.10, 0.35)
    n_acc = rng.randint(2, 5)
    pos = rng.uniform(0.05, 0.9, n_acc)
    width = rng.uniform(0.04, 0.12, n_acc)
    height = rng.uniform(0.05, 0.25, n_acc)
    rise = rng.uniform(0.10, 0.30) if rng.rand() < 0.3 else 0.0

    def contour(samples: np.ndarray) -> np.ndarray:
        u = samples / max(n_samples - 1, 1)
        c = -decl * u
        for p, w, h in zip(pos, width, height):
            c = c + h * np.exp(-0.5 * ((u - p) / w) ** 2)
        if rise:
            c = c + rise * np.exp(-0.5 * ((u - 1.0) / 0.05) ** 2)
        return c

    return contour


def synth_utterance(
    rng: np.random.RandomState,
    n_samples: int,
    f0_range: Tuple[float, float] = (100.0, 240.0),
    noise_level: float = 0.003,
    return_ids: bool = False,
    return_art: bool = False,
    style: str = "v1",
) -> Tuple[np.ndarray, ...]:
    """Generate ``n_samples`` of audio.

    Returns ``(wav float32 (n_samples,), segments int64 (K, 2))`` where
    segments are ground-truth ``[start, end)`` voiced spans in 50 Hz frames.
    With ``return_ids`` also returns the per-segment phoneme-bank index
    (K,) — the discrete "syllable identity" drawn from :data:`FORMANT_BANK`,
    used by token-purity evaluations. With ``return_art`` also returns the
    analytic 50 Hz articulatory ground truth ``(n_samples // FRAME, 14)``:
    channels 0-11 = envelope-weighted :data:`ART_BANK` target of the active
    phoneme, 12 = log(f0 / PITCH_MEAN) (0 when unvoiced), 13 = frame RMS
    loudness — the synthetic stand-in for SPARC features
    (Sylber's ``segment_synthesis.py``). Both flags consume no extra RNG draws,
    so cached datasets and fixtures remain bit-identical either way.

    ``style="rich"`` switches to the enriched corpus: 160 three-formant
    phonemes (:data:`RICH_FORMANT_BANK`), a 12-entry speaker bank
    (formant scaling + 85-280 Hz pitch registers, :data:`SPEAKER_BANK`),
    and a continuous per-utterance phrase-intonation contour
    (:func:`_phrase_contour`). ``f0_range`` is ignored for rich (the
    speaker register replaces it). ``style="continuum"`` additionally makes
    speakers and syllable tokens CONTINUOUS (see the module-level comment) —
    the corpus for production-scale (5K-20K unit) codebook fits. The default
    ``"v1"`` consumes the exact original RNG sequence, so existing fixtures
    stay bit-identical.
    """
    if style not in ("v1", "rich", "continuum"):
        raise ValueError(f"unknown corpus style: {style!r}")
    rich = style in ("rich", "continuum")
    continuum = style == "continuum"
    bank = RICH_FORMANT_BANK if rich else FORMANT_BANK
    art_bank = RICH_ART_BANK if rich else ART_BANK
    wav = np.zeros(n_samples, np.float32)
    f0_track = np.zeros(n_samples, np.float32)
    env_track = np.zeros(n_samples, np.float32)
    id_track = np.zeros(n_samples, np.int64)
    segments = []
    ids = []
    syl_arts = []  # continuum: per-syllable perturbed articulatory targets
    if continuum:
        spk_scale = rng.uniform(0.84, 1.16)
        spk_reg = float(np.exp(rng.uniform(np.log(82.0), np.log(285.0))))
        contour = _phrase_contour(rng, n_samples)
        f0_base = spk_reg
    elif rich:
        spk_scale, spk_reg = SPEAKER_BANK[rng.randint(len(SPEAKER_BANK))]
        contour = _phrase_contour(rng, n_samples)
        f0_base = spk_reg
    else:
        f0_base = rng.uniform(*f0_range)
    pos = rng.randint(0, 3) * FRAME  # small lead-in silence
    while pos < n_samples - 4 * FRAME:
        # syllable length 120-300 ms, snapped to whole frames
        dur_frames = int(rng.uniform(6, 15))
        dur = dur_frames * FRAME
        if pos + dur > n_samples:
            dur = (n_samples - pos) // FRAME * FRAME
            dur_frames = dur // FRAME
            if dur_frames < 4:
                break
        phoneme_id = rng.randint(len(bank))
        phoneme = bank[phoneme_id]
        ids.append(phoneme_id)
        if continuum:
            # unique point near the phoneme class: continuous formant +
            # articulatory perturbation, tracked so the art truth follows
            phoneme = phoneme * np.exp(
                rng.normal(0.0, _CONT_F_SIGMA, size=phoneme.shape))
            syl_arts.append(np.clip(
                art_bank[phoneme_id]
                + _CONT_ART_SIGMA * rng.randn(12), -1.0, 1.0
            ).astype(np.float32))
        if rich:
            phoneme = phoneme * spk_scale
            # f0 follows the phrase contour continuously (+ per-syllable
            # jitter); the midpoint value sets the harmonic count
            jitter = rng.normal(0.0, 0.03)
            samples = np.arange(pos, pos + dur)
            f0_syl = (f0_base
                      * np.exp(contour(samples) + jitter)).astype(np.float32)
            f0 = float(f0_syl[dur // 2])
            amp = rng.uniform(0.5, 1.0)
            syl, f0_t, env = _syllable(rng, dur, f0, phoneme,
                                       f0_track=f0_syl)
        else:
            f0 = f0_base * rng.uniform(0.85, 1.2)
            amp = rng.uniform(0.5, 1.0)
            syl, f0_t, env = _syllable(rng, dur, f0, phoneme)
        wav[pos: pos + dur] = amp * syl
        f0_track[pos: pos + dur] = f0_t
        env_track[pos: pos + dur] = env
        # continuum: track the syllable ORDINAL so the art truth can look up
        # the per-syllable perturbed target instead of the shared bank row
        id_track[pos: pos + dur] = (len(ids) - 1) if continuum else phoneme_id
        s = pos // FRAME
        segments.append([s, s + dur_frames])
        pos += dur
        # word boundary: 20% chance of a 60-200 ms silence; else a short
        # closure of 0-1 frames
        if rng.rand() < 0.2:
            pos += int(rng.uniform(3, 10)) * FRAME
        else:
            pos += rng.randint(0, 2) * FRAME
    wav += noise_level * rng.randn(n_samples).astype(np.float32)
    segs = (np.array(segments, np.int64) if segments
            else np.zeros((0, 2), np.int64))
    out = [wav, segs]
    if return_ids:
        out.append(np.asarray(ids, np.int64))
    if return_art:
        n_frames = n_samples // FRAME
        centers = np.arange(n_frames) * FRAME + FRAME // 2
        art = np.zeros((n_frames, 14), np.float32)
        # envelope is nonzero only inside voiced spans, so silent frames
        # stay at the blank value (0) in every channel
        lut = (np.stack(syl_arts) if continuum and syl_arts else art_bank)
        art[:, :12] = env_track[centers, None] * lut[id_track[centers]]
        voiced = f0_track[centers] > 0
        art[voiced, 12] = np.log(f0_track[centers][voiced] / PITCH_MEAN)
        art[:, 13] = np.sqrt(
            (wav[: n_frames * FRAME].reshape(n_frames, FRAME) ** 2).mean(-1))
        out.append(art)
    return tuple(out)


def boundary_set(segments: np.ndarray) -> np.ndarray:
    """Unique sorted boundary frames (starts and ends) of a segment list."""
    if len(segments) == 0:
        return np.zeros((0,), np.int64)
    return np.unique(np.concatenate([segments[:, 0], segments[:, 1]]))
