"""The port's vocoder (``sylber_tpu_torch/vocoder``) against
``sylber_tpu/vocoder`` on the CPU.

- ``log_mel`` and the Slaney filterbank: within 1e-5;
- the HiFi-GAN ``Generator`` without the harmonic source (a JAX init):
  waveform within 1e-5; with it (the trained ``mini_vocoder.npz``, JAX's
  own noise draw passed in): the source within 5e-5 and the waveform within
  1e-4 at 0.2 s; at 2 s, where JAX's float32 phase sum has drifted from the
  port's (summed in float64), through ``log_mel``: mean difference within
  1e-2;
- ``SparcDecoder`` on ``mini_vocoder.npz`` (the demo's pitch handling);
- a jik876-style torch generator checkpoint (weight norms, transposed
  convs) converted by both packages gives one waveform (1e-5), which holds
  the layouts of the flax ``ConvTranspose`` against torch's;
- the generator's weight carry gives back the same arrays bit for bit.
"""

import json
import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sylber_tpu.io.checkpoint import load_params_npz
from sylber_tpu.io.torch_convert import hifigan_params_from_torch as jax_hifigan_from_torch
from sylber_tpu.vocoder import hifigan as jh
from sylber_tpu.vocoder import mel as jmel
from sylber_tpu.vocoder.sparc import SparcDecoder as JSparc
from sylber_tpu.vocoder.sparc import SparcDecoderConfig as JSparcConfig
from sylber_tpu_torch.io.checkpoint import (generator_state_dict_from_jax,
                                            jax_tree_from_generator, save_tree_npz)
from sylber_tpu_torch.io.torch_convert import hifigan_params_from_torch
from sylber_tpu_torch.vocoder import HiFiGANConfig, SparcDecoder, SparcDecoderConfig, hifigan, mel
from _torch_threads import _few_threads  # noqa: E402,F401 (autouse)

FIXTURES = Path(__file__).parent / "fixtures"
META = json.loads((FIXTURES / "mini_vocoder.json").read_text())
SMALL = dict(in_channels=14, cond_channels=8, upsample_initial_channel=32)


@pytest.fixture(scope="module")
def mini():
    tree = load_params_npz(str(FIXTURES / "mini_vocoder.npz"))
    jdec = JSparc(JSparcConfig(generator=jh.HiFiGANConfig(**META["generator"])), params=tree)
    tdec = SparcDecoder(SparcDecoderConfig(generator=HiFiGANConfig(**META["generator"])),
                        params=tree, device="cpu", precision="highest")
    return jdec, tdec, tree


def _jax_noise(shape):
    return np.array(jax.random.normal(jax.random.PRNGKey(0), shape, jnp.float32))


def test_log_mel_and_filterbank_match_jax():
    np.testing.assert_array_equal(mel.mel_filterbank(16000, 1024, 80, 0.0, 8000.0),
                                  jmel.mel_filterbank(16000, 1024, 80, 0.0, 8000.0))
    x = np.random.RandomState(0).randn(3, 5000).astype(np.float32)
    want = np.asarray(jmel.log_mel(jnp.asarray(x)))
    got = mel.log_mel(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_generator_without_source_matches_jax():
    cfg = jh.HiFiGANConfig(**SMALL)
    feats = np.random.RandomState(1).randn(2, 12, 14).astype(np.float32)
    cond = np.random.RandomState(2).randn(2, 8).astype(np.float32)
    gen = jh.Generator(cfg)
    params = jax.device_get(jax.jit(gen.init)(jax.random.PRNGKey(3), jnp.asarray(feats),
                                              jnp.asarray(cond))["params"])
    want = np.asarray(jax.jit(gen.apply)({"params": params}, jnp.asarray(feats),
                                         jnp.asarray(cond)))
    port = hifigan.Generator(HiFiGANConfig(**SMALL))
    port.load_state_dict(generator_state_dict_from_jax(params))
    with torch.no_grad():
        got = port(torch.from_numpy(feats), torch.from_numpy(cond)).numpy()
    assert got.shape == (2, 12 * 320)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_harmonic_source_and_mini_vocoder_match_jax(mini):
    jdec, tdec, _ = mini
    art = np.random.RandomState(4).randn(2, 10, 14).astype(np.float32) * 0.5
    spk = np.random.RandomState(5).randn(2, 64).astype(np.float32)
    feats = np.array(jdec.features_from_art(jnp.asarray(art), 120.0))
    np.testing.assert_allclose(tdec.features_from_art(torch.from_numpy(art), 120.0).numpy(),
                               feats, atol=1e-6)
    noise = _jax_noise((2, 10 * 320))
    gcfg = jh.HiFiGANConfig(**META["generator"])
    want = np.asarray(jh.harmonic_noise_source(jnp.asarray(feats), gcfg, jax.random.PRNGKey(0)))
    got = hifigan.harmonic_noise_source(torch.from_numpy(feats), tdec.config.generator,
                                        torch.from_numpy(noise)).numpy()
    np.testing.assert_allclose(got, want, atol=5e-5, rtol=0)
    want = jdec(art, spk, 120.0)  # JAX's generator draws PRNGKey(0) itself
    got = tdec.waveform(art, spk, 120.0, noise=torch.from_numpy(noise)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_mini_vocoder_two_seconds_through_log_mel(mini):
    from sylber_tpu_torch.data.synthetic import PITCH_MEAN, synth_utterance

    jdec, tdec, _ = mini
    rng = np.random.RandomState(90909)
    arts = np.stack([synth_utterance(rng, 32000, return_art=True)[2] for _ in range(2)])
    spk = np.zeros((2, 64), np.float32)
    want = jdec(arts, spk, PITCH_MEAN)
    got = tdec.waveform(arts, spk, PITCH_MEAN,
                        noise=torch.from_numpy(_jax_noise(want.shape)))
    diff = (mel.log_mel(got) - mel.log_mel(torch.tensor(want))).abs()
    assert got.shape == want.shape and float(diff.mean()) <= 1e-2, float(diff.mean())
    assert not tdec.random_init and SparcDecoder(device="cpu").random_init


def _weight_norm(rng, shape, dim):
    """(g, v) of a torch weight norm over every axis but ``dim``."""
    v = rng.randn(*shape).astype(np.float32) * 0.3
    g_shape = [1] * len(shape)
    g_shape[dim] = shape[dim]
    return rng.uniform(0.5, 1.5, g_shape).astype(np.float32), v


def test_torch_generator_checkpoint_converts_like_jax():
    """A jik876-style generator state dict: ``weight_g``/``weight_v`` on the
    convs (dim 0), ConvTranspose1d weights (in, out, k) normed over dim 0,
    flat ``resblocks.{i * K + j}``."""
    cfg_kw = dict(in_channels=14, cond_channels=0, upsample_initial_channel=16,
                  upsample_rates=(5, 4), upsample_kernel_sizes=(11, 8))
    rng = np.random.RandomState(6)
    sd = {}

    def conv(name, cout, cin, k):
        sd[f"{name}.weight_g"], sd[f"{name}.weight_v"] = _weight_norm(rng, (cout, cin, k), 0)
        sd[f"{name}.bias"] = (rng.randn(cout) * 0.1).astype(np.float32)

    conv("conv_pre", 16, 14, 7)
    ch = 16
    for i, (u, k) in enumerate(zip((5, 4), (11, 8))):
        sd[f"ups.{i}.weight_g"], sd[f"ups.{i}.weight_v"] = _weight_norm(rng, (ch, ch // 2, k), 0)
        sd[f"ups.{i}.bias"] = (rng.randn(ch // 2) * 0.1).astype(np.float32)
        ch //= 2
        for j, rk in enumerate((3, 7, 11)):
            for m in range(3):
                conv(f"resblocks.{i * 3 + j}.convs1.{m}", ch, ch, rk)
                conv(f"resblocks.{i * 3 + j}.convs2.{m}", ch, ch, rk)
    conv("conv_post", 1, ch, 7)
    sd = {f"generator.{k}": v for k, v in sd.items()}

    feats = np.random.RandomState(7).randn(1, 9, 14).astype(np.float32)
    params = jax_hifigan_from_torch(sd, jh.HiFiGANConfig(**cfg_kw))
    want = np.asarray(jax.jit(jh.Generator(jh.HiFiGANConfig(**cfg_kw)).apply)(
        {"params": params}, jnp.asarray(feats)))
    port = hifigan.Generator(HiFiGANConfig(**cfg_kw))
    port.load_state_dict(hifigan_params_from_torch(
        {k: torch.from_numpy(v) for k, v in sd.items()}, HiFiGANConfig(**cfg_kw)))
    with torch.no_grad():
        got = port(torch.from_numpy(feats)).numpy()
    assert got.shape == (1, 9 * 20)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_generator_weight_carry_round_trip_is_bit_exact(mini, tmp_path):
    _, tdec, tree = mini
    back = jax_tree_from_generator(tdec.generator.state_dict())
    save_tree_npz(str(tmp_path / "gen.npz"), back)
    again = load_params_npz(str(tmp_path / "gen.npz"))
    a = jax.tree_util.tree_flatten_with_path(tree)[0]
    b = jax.tree_util.tree_flatten_with_path(again)[0]
    assert [p for p, _ in a] == [p for p, _ in b] and len(a) == 204
    for (path, x), (_, y) in zip(a, b):
        assert np.array_equal(x, y), path
    assert math.prod(HiFiGANConfig().upsample_rates) == HiFiGANConfig().total_upsample == 320
