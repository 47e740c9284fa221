"""The port imports torch, never JAX, and nothing of ``sylber_tpu``.

A fresh interpreter imports every module of ``sylber_tpu_torch`` (walked
with ``pkgutil``, ``parallel.mesh``, ``parallel.launch`` and the Orbax
reader's ``io.zstd``, ``io.ocdbt`` and ``io.orbax`` among them) and checks
``sys.modules``: no JAX, no ``sylber_tpu``, and none of ``orbax``,
``tensorstore`` or ``zstandard``, which the Orbax reader and writer do
without (the writer's ``write_store``, ``write_tree``,
``write_checkpoint_metadata``, ``save_params``, ``train_state_to_jax``,
``SegmentSynthesis.save`` and the manager's ``wait`` and ``close`` must be
there); then, with no GPU, the entry
points (the resynthesis chain's and its trainers', ``fit_kmeans`` and
``Sylber`` included, the corpus path's runners and ``mini_proof``, and the
evaluation entry points: ``vocoder_proof``, ``token_chain_proof``,
``pitch_chain_proof``, ``production_codebooks``, ``fit_quantizer``, ``demo``,
and the analyses: ``pitch_modulation_ceiling_probe``,
``pitch_decodability_probe``, ``vq_pitch_probe``, ``parity_vs_reference``)
refuse to run unless the caller asks for the CPU.
"""

import subprocess
import sys
from pathlib import Path
from _torch_threads import _few_threads  # noqa: E402,F401 (autouse)

ROOT = Path(__file__).resolve().parents[1]

SCRIPT = r"""
import importlib, pkgutil, sys
import torch
import sylber_tpu_torch

names = ["sylber_tpu_torch"] + [m.name for m in pkgutil.walk_packages(
    sylber_tpu_torch.__path__, "sylber_tpu_torch.")]
assert {"sylber_tpu_torch.parallel.mesh", "sylber_tpu_torch.parallel.launch",
        "sylber_tpu_torch.io.zstd", "sylber_tpu_torch.io.ocdbt",
        "sylber_tpu_torch.io.orbax"} <= set(names)
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib"))
             or m == "sylber_tpu" or m.startswith("sylber_tpu.")
             or m.split(".")[0] in ("orbax", "tensorstore", "zstandard"))
assert not bad, bad
# the Orbax writer: the OCDBT store, the zarr tree, the JAX layouts, the manager
from sylber_tpu_torch.io.ocdbt import write_store
from sylber_tpu_torch.io.orbax import write_checkpoint_metadata, write_tree
from sylber_tpu_torch.io.checkpoint import (TrainCheckpointManager, save_params,
                                            train_state_to_jax)
from sylber_tpu_torch.synthesis import SegmentSynthesis
assert all(map(callable, (write_store, write_tree, write_checkpoint_metadata, save_params,
                          train_state_to_jax, SegmentSynthesis.save,
                          TrainCheckpointManager.wait, TrainCheckpointManager.close)))
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("orbax", "tensorstore", "zstandard")
             or m == "jax" or m.startswith(("jax.", "jaxlib", "sylber_tpu.")))
assert not bad, bad
print(len(names), "modules")

torch.cuda.is_available = lambda: False  # as on a machine with no GPU
from sylber_tpu_torch import Segmenter
from sylber_tpu_torch.longform import LongFormSegmenter
from sylber_tpu_torch.quantizer import KMQuantizer
from sylber_tpu_torch.train.loop import train
from sylber_tpu_torch.train.__main__ import main as train_cli
from sylber_tpu_torch.synthesis import SegmentSynthesis
from sylber_tpu_torch.vocoder import SparcDecoder
from sylber_tpu_torch.vq_tokenizer import TrainedVQTokenizer
from sylber_tpu_torch.flow.quantizer import load_quantizer
from sylber_tpu_torch.flow.kmeans import fit_kmeans
from sylber_tpu_torch.models.sylber import Sylber
from sylber_tpu_torch.train.synthesis_loop import train_synthesis
from sylber_tpu_torch.train.vq_synthesis import train_vq_synthesis
from sylber_tpu_torch.train_synthesis import main as train_synthesis_cli
from sylber_tpu_torch.vocoder import VocoderTrainConfig, make_vocoder_train_step
from sylber_tpu_torch import mini_proof, precompute_segments, segment_corpus
from sylber_tpu_torch import (demo, fit_quantizer, pitch_chain_proof, production_codebooks,
                              token_chain_proof, vocoder_proof)
from sylber_tpu_torch import (parity_vs_reference, pitch_decodability_probe,
                              pitch_modulation_ceiling_probe, vq_pitch_probe)
for make in (lambda: LongFormSegmenter(Segmenter()), lambda: KMQuantizer([[0.0, 1.0]]),
             lambda: train({"data": {"synthetic": True}}, out_dir="/nonexistent"),
             lambda: train_cli(["--config", "/nonexistent.yaml"]),
             lambda: SegmentSynthesis(), lambda: SparcDecoder(),
             lambda: TrainedVQTokenizer(None, None), lambda: load_quantizer({}),
             lambda: fit_kmeans([[0.0, 1.0]] * 4, 2), lambda: Sylber(),
             lambda: train_synthesis({}, out_dir="/nonexistent"),
             lambda: train_vq_synthesis({"speech_model_ckpt": "x"}, out_dir="/nonexistent"),
             lambda: train_synthesis_cli(["--config", "/nonexistent.yaml"]),
             lambda: make_vocoder_train_step(VocoderTrainConfig())[0](),
             lambda: segment_corpus.main(["--audio-dir", "/nonexistent", "--out", "/nonexistent"]),
             lambda: precompute_segments.main(["--manifest", "/nonexistent", "--wav-dir", "/x",
                                               "--out-dir", "/nonexistent"]),
             lambda: mini_proof.main(["--out-dir", "/nonexistent"]),
             lambda: mini_proof.evaluate({}, mini_proof.hubert_config({}), 1.0),
             lambda: mini_proof.measure_norm_stats({}, mini_proof.hubert_config({})),
             lambda: vocoder_proof.main(["--out-dir", "/nonexistent"]),
             lambda: token_chain_proof.main(["--out-dir", "/nonexistent"]),
             lambda: pitch_chain_proof.main(["--out-dir", "/nonexistent"]),
             lambda: production_codebooks.main(["--out-dir", "/nonexistent"]),
             lambda: fit_quantizer.main(["--manifest", "/nonexistent", "--wav-dir", "/x",
                                         "--out", "/nonexistent/c.npy"]),
             lambda: demo.main(["--wav", "/nonexistent.wav", "--out-dir", "/nonexistent"]),
             lambda: pitch_modulation_ceiling_probe.main(["--out-dir", "/nonexistent"]),
             lambda: pitch_decodability_probe.main(["--out-dir", "/nonexistent"]),
             lambda: vq_pitch_probe.main(["--out-dir", "/nonexistent"]),
             lambda: parity_vs_reference.main(["--ckpt", "/nonexistent.pt",
                                               "--out-dir", "/nonexistent"])):
    try:
        make()
    except RuntimeError as e:
        assert "device='cpu'" in str(e), e
    else:
        raise AssertionError("an entry point ran without a GPU and without device='cpu'")
print("ok")
"""


def test_port_imports_no_jax_and_needs_a_gpu_or_cpu_choice():
    run = subprocess.run([sys.executable, "-c", SCRIPT], capture_output=True, text=True,
                         cwd=ROOT, env={"PYTHONPATH": str(ROOT), "PATH": "/usr/bin:/bin"},
                         timeout=300)
    assert run.returncode == 0, run.stderr[-3000:]
    count, ok = run.stdout.split("\n")[:2]
    assert ok == "ok"
    # the modules this test must reach, whatever else the package holds
    # (the trainer's train/, data/ and utils/ modules, the resynthesis
    # chain's flow/, vocoder/, models/voicebox, ops/pitch, synthesis and
    # vq_tokenizer, and its trainers, flow/kmeans and models/sylber included,
    # and the corpus path's utils/native, utils/sndfile, ops/segment_np,
    # segment_corpus, precompute_segments and mini_proof, the mesh's
    # parallel/, the six evaluation entry points, the four analyses and the
    # Orbax reader's three modules)
    assert int(count.split()[0]) >= 77, count
