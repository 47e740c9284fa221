"""What the proof modules' CPU tests share: the JAX package's synthesis on
the trained mini fixtures, built with its weights, and JAX's noise draw.

``scripts/token_chain_proof.py::build_synth`` first runs an eager random
init that it then discards (about 20 s on the CPU); here the synthesis is
built with the fixtures' weights directly, and its encoder's ``apply``, its
segmentation and its pitch conditioning are jitted (the same functions;
eager, their op-by-op compile dominates the run).
"""

import contextlib
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import yaml

from sylber_tpu.io.checkpoint import load_params_npz as jax_load_npz
from sylber_tpu.synthesis import SegmentSynthesis, SynthesisParams
from sylber_tpu.train.synthesis_loop import synthesis_config_from_dict

ROOT = Path(__file__).resolve().parents[1]
FIXTURES = ROOT / "tests" / "fixtures"
SCRIPTS = ROOT / "scripts"
if str(SCRIPTS) not in sys.path:  # the JAX scripts import each other by name
    sys.path.insert(0, str(SCRIPTS))


class JittedApply:
    """A flax module whose ``apply`` is jitted."""

    def __init__(self, module):
        self.module = module
        self.apply = jax.jit(module.apply)

    def __getattr__(self, name):
        return getattr(self.module, name)


def jax_synth(config_name, cfm_name, quantizer=None, pitch_quantizer=None):
    """JAX's ``SegmentSynthesis`` of the mini encoder and a CFM fixture, its
    model block from ``configs/<config_name>`` (the scripts' ``build_synth``
    and ``build_pitch_synth`` without their discarded init)."""
    cfg = yaml.safe_load((ROOT / "configs" / config_name).read_text())
    cfm = jax_load_npz(str(FIXTURES / cfm_name))
    synth = SegmentSynthesis(config=synthesis_config_from_dict(dict(cfg["model"])),
                             quantizer=quantizer, pitch_quantizer=pitch_quantizer,
                             params=SynthesisParams(jax_load_npz(str(FIXTURES / "mini_ckpt.npz")),
                                                    cfm["input_mlp"], cfm["regressor"]))
    synth.hubert = JittedApply(synth.hubert)
    return synth


@contextlib.contextmanager
def jitted_chain_ops():
    """JAX's wav path with its segmentation and pitch conditioning jitted
    (the same functions; eager, each op compiles on its own)."""
    import sylber_tpu.ops.pitch as jax_pitch
    import sylber_tpu.synthesis as jax_synthesis

    saved = jax_synthesis.segment_batch, jax_pitch.segment_pitch_cond
    jax_synthesis.segment_batch = jax.jit(saved[0])
    jax_pitch.segment_pitch_cond = jax.jit(saved[1], static_argnums=(3,),
                                           static_argnames=("pitch_mean", "voiced_threshold",
                                                            "pitch_quantizer"))
    try:
        yield
    finally:
        jax_synthesis.segment_batch, jax_pitch.segment_pitch_cond = saved


def jax_noise(shape):
    """The harmonic source's noise channel as JAX's generator draws it."""
    return np.array(jax.random.normal(jax.random.PRNGKey(0), shape, jnp.float32))


def rel_err(a, b):
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-12))
