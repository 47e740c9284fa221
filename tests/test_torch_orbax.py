"""The port's Orbax reader (``io/ocdbt.py``, ``io/orbax.py``) against orbax.

Checkpoints are written here by the JAX package's own ``save_params`` and by
an orbax ``CheckpointManager``; every leaf of ``read_tree`` must be bit-equal
to orbax's restore of the same directory (``bfloat16`` compared as the
float32 it widens to exactly; a ``None`` leaf, which the reader drops from a
dict, left out of orbax's side):

- the ``mini_ckpt.npz`` tree, and the ``Segmenter`` on its directory
  bit-equal to the ``Segmenter`` on the ``.npz``;
- a tree of every dtype the reader takes, with sequences, an empty dict, a
  ``None`` and a 2 MB leaf (stored out of line, in a data file);
- a save sharded over 4 simulated CPU devices (``tests/conftest.py`` makes
  8), so several chunks a leaf;
- an optax AdamW train state (clip + AdamW on a schedule) under a
  ``CheckpointManager``;
- ``SegmentSynthesis`` and the vocoder on Orbax directories bit-equal to the
  port on the ``.npz`` trees; the port's stage-2 ``model_ckpt`` taking the
  JAX trainer's ``params_final`` layout; the committed fixtures under
  ``tests/fixtures/orbax`` equal to the ``.npz`` they were written from;
- a full-width HuBERT-base tree (two layers deep) from seeded weights, whose
  hidden states on 1 s through the port match JAX on the same tree within
  2e-4 (``test_torch_hubert.py``'s tolerance).

A flipped CRC-32C, an unknown ``.zarray`` filter and an unknown dtype each
raise ``ValueError``.
"""

import json
import os
import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import orbax.checkpoint as ocp
import pytest
import torch
import yaml

from sylber_tpu.io.checkpoint import load_params_npz as jax_load_npz
from sylber_tpu.io.checkpoint import save_params
from sylber_tpu.models import hubert as jax_hubert
from sylber_tpu_torch import Segmenter
from sylber_tpu_torch import synthesis as tsyn
from sylber_tpu_torch.io.checkpoint import (jax_params_from_state_dict, load_state_dict,
                                            state_dict_from_jax_params, state_dict_from_tree)
from sylber_tpu_torch.io.ocdbt import OcdbtStore
from sylber_tpu_torch.io.orbax import load_params, read_tree
from sylber_tpu_torch.models import hubert as port_hubert
from sylber_tpu_torch.models.hubert import HubertConfig
from sylber_tpu_torch.vocoder import HiFiGANConfig, SparcDecoderConfig
from sylber_tpu_torch.vocoder.sparc import load_decoder

ROOT = Path(__file__).resolve().parents[1]
FIXTURES = ROOT / "tests" / "fixtures"


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def orbax_restore(path):
    with ocp.StandardCheckpointer() as ckptr:
        return ckptr.restore(os.path.abspath(path))


def _drop_none(tree):
    if isinstance(tree, dict):
        return {k: _drop_none(v) for k, v in tree.items() if v is not None}
    if isinstance(tree, (list, tuple)):
        return [_drop_none(v) for v in tree]
    return tree


def assert_bit_equal(got, want, path="tree"):
    """``got`` (read_tree's) against ``want`` (orbax's), leaf by leaf."""
    if want is None:
        assert got is None, path
        return
    if isinstance(want, dict):
        assert isinstance(got, dict) and got.keys() == want.keys(), (path, got, want)
        for k in want:
            assert_bit_equal(got[k], want[k], f"{path}/{k}")
        return
    if isinstance(want, (list, tuple)):
        assert isinstance(got, list) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_bit_equal(g, w, f"{path}/{i}")
        return
    w = np.asarray(want)
    if w.dtype == jnp.bfloat16:
        w = w.astype(np.float32)
    g = np.asarray(got)
    assert g.dtype == w.dtype and g.shape == w.shape, (path, g.dtype, w.dtype, g.shape, w.shape)
    assert g.tobytes() == w.tobytes(), path


def _mini_hub(layers=None):
    meta = json.loads((FIXTURES / "mini_ckpt.json").read_text())
    hub = {k: tuple(v) if isinstance(v, list) else v for k, v in meta["hubert"].items()}
    hub["num_hidden_layers"] = layers or meta["encoding_layer"]
    return hub, meta


def _wav(seconds, seed):
    return np.random.RandomState(seed).randn(int(seconds * 16000)).astype(np.float32)


def test_mini_ckpt_tree_and_segmenter(tmp_path):
    tree = jax_load_npz(str(FIXTURES / "mini_ckpt.npz"))
    save_params(str(tmp_path / "mini"), tree)
    assert_bit_equal(read_tree(tmp_path / "mini" / "params"),
                     orbax_restore(tmp_path / "mini" / "params"))
    hub, meta = _mini_hub()
    kw = dict(hubert_config=HubertConfig(**hub), norm_threshold=meta["norm_threshold"],
              merge_threshold=meta["merge_threshold"], device="cpu")
    wavs = [_wav(2.3, 1), _wav(1.6, 2)]
    want = Segmenter(model_ckpt=str(FIXTURES / "mini_ckpt.npz"), **kw).process(wavs)
    for ckpt in (tmp_path / "mini", FIXTURES / "orbax" / "mini_ckpt_params"):
        got = Segmenter(model_ckpt=str(ckpt), **kw).process(wavs)
        for g, w in zip(got, want):
            assert len(w["segments"]) > 0
            for key in ("segments", "segment_features", "hidden_states"):
                assert np.array_equal(g[key], w[key]), (ckpt, key)


def test_every_dtype_sequences_empty_states_and_a_large_leaf(tmp_path):
    rng = np.random.default_rng(0)
    tree = {"f4": rng.standard_normal((3, 5)).astype(np.float32),
            "f8": rng.standard_normal(4), "f2": rng.standard_normal((2, 2)).astype(np.float16),
            "bf16": jnp.asarray(rng.standard_normal(7), jnp.bfloat16),
            "i4": np.arange(-2, 3, dtype=np.int32), "i8": np.arange(3, dtype=np.int64) - 2 ** 40,
            "u4": np.array([1, 2 ** 32 - 1], np.uint32), "b1": np.array([True, False, True]),
            "scalar": np.float32(2.5), "int": 7,
            "seq": [np.ones(2, np.float32), {"x": np.zeros((2, 3), np.float32)}, None],
            "empty": {}, "none": None,
            "big": rng.standard_normal(512 * 1024).astype(np.float32)}  # 2 MB
    save_params(str(tmp_path / "t"), tree)
    got = read_tree(tmp_path / "t" / "params")
    assert_bit_equal(got, _drop_none(orbax_restore(tmp_path / "t" / "params")))
    assert got["seq"][2] is None and got["empty"] == {} and "none" not in got
    store = OcdbtStore(tmp_path / "t" / "params")
    assert store.max_inline_value_bytes < 2 ** 21 and "big/0" in store


@pytest.fixture(scope="module")
def manager_saves(tmp_path_factory):
    """``(directory, orbax's restored leaves keyed by name + keystr)`` of two
    orbax ``CheckpointManager`` saves: ``sharded/3``, arrays sharded over 4
    of the CPU devices ``tests/conftest.py`` makes, and ``train/3``, an optax
    AdamW train state after one update."""
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    import optax

    out = tmp_path_factory.mktemp("saves")
    devices = np.array(jax.devices()[:4])
    assert len(devices) == 4
    mesh = Mesh(devices.reshape(2, 2), ("a", "b"))
    rng = np.random.default_rng(1)
    sharded = {
        "w": jax.device_put(jnp.asarray(rng.standard_normal((8, 6)), jnp.float32),
                            NamedSharding(mesh, P("a", "b"))),
        "v": jax.device_put(jnp.asarray(rng.standard_normal((6, 5)), jnp.bfloat16),
                            NamedSharding(mesh, P("a", None))),
        "n": jax.device_put(jnp.arange(16, dtype=jnp.int32),
                            NamedSharding(Mesh(devices, ("d",)), P("d"))),
        "r": jnp.float32(3.0),
    }
    params = {"dense": {"kernel": jnp.asarray(rng.standard_normal((4, 3)), jnp.float32),
                        "bias": jnp.zeros(3)}, "scale": jnp.ones(2)}
    tx = optax.chain(optax.clip_by_global_norm(0.5),
                     optax.adamw(optax.linear_schedule(1e-3, 0.0, 10), b1=0.9, b2=0.95))
    opt = tx.init(params)
    _, opt = tx.update(jax.tree.map(lambda p: jnp.full_like(p, 0.3), params), opt, params)
    train = {"step": jnp.int32(1), "params": params, "opt_state": opt}
    restored = {}
    for name, state in (("sharded", sharded), ("train", train)):
        with ocp.CheckpointManager(str(out / name)) as mgr:
            mgr.save(3, args=ocp.args.StandardSave(state))
            mgr.wait_until_finished()
        with ocp.CheckpointManager(str(out / name)) as mgr:
            back = mgr.restore(3, args=ocp.args.StandardRestore(state))
        for path, leaf in jax.tree_util.tree_leaves_with_path(back):
            restored[name + jax.tree_util.keystr(path)] = np.asarray(leaf)
    return out, restored


def test_sharded_save_over_four_devices(manager_saves):
    out, want = manager_saves
    got = read_tree(out / "sharded" / "3" / "default")
    assert_bit_equal(got, {k: want[f"sharded['{k}']"] for k in ("w", "v", "n", "r")})
    keys = OcdbtStore(out / "sharded" / "3" / "default").list()
    assert [k for k in keys if k.startswith("w/") and k != "w/.zarray"] == \
        ["w/0.0", "w/0.1", "w/1.0", "w/1.1"]
    assert sum(k.startswith("n/") for k in keys) == 5  # 4 chunks and the .zarray


def test_optax_adamw_train_state_under_a_checkpoint_manager(manager_saves):
    out, want = manager_saves
    got = read_tree(out / "train" / "3" / "default")
    # optax's empty states (clip_by_global_norm's, add_decayed_weights') stay
    # as None in the chain's sequences; a NamedTuple's fields are dict keys
    assert got["opt_state"][0] is None and got["opt_state"][1][1] is None
    adam, sched = got["opt_state"][1][0], got["opt_state"][1][2]
    leaves = {"train['step']": got["step"],
              "train['opt_state'][1][0].count": adam["count"],
              "train['opt_state'][1][2].count": sched["count"]}
    for moment in ("mu", "nu"):
        leaves[f"train['opt_state'][1][0].{moment}['scale']"] = adam[moment]["scale"]
        for leaf in ("kernel", "bias"):
            leaves[f"train['opt_state'][1][0].{moment}['dense']['{leaf}']"] = \
                adam[moment]["dense"][leaf]
    for leaf in ("kernel", "bias"):
        leaves[f"train['params']['dense']['{leaf}']"] = got["params"]["dense"][leaf]
    leaves["train['params']['scale']"] = got["params"]["scale"]
    assert {k for k in want if k.startswith("train")} == set(leaves)
    assert_bit_equal(leaves, {k: want[k] for k in leaves})
    assert float(adam["count"]) == 1 and np.abs(adam["mu"]["dense"]["kernel"]).max() > 0


def test_synthesis_vocoder_and_stage2_model_ckpt_on_orbax_directories(tmp_path):
    from sylber_tpu_torch.train.__main__ import main as train_cli

    enc = jax_load_npz(str(FIXTURES / "mini_ckpt.npz"))
    trained = jax_load_npz(str(FIXTURES / "mini_synth.npz"))
    mc = json.loads((FIXTURES / "mini_synth.json").read_text())["config"]["model"]
    cfg = tsyn.synthesis_config_from_dict(mc)
    # the layout of the JAX package's SegmentSynthesis.save
    save_params(str(tmp_path / "synth"), {"hubert": enc, **trained})
    wav = _wav(1.2, 5)
    want = tsyn.SegmentSynthesis(config=cfg, params={"hubert": enc, **trained},
                                 device="cpu").resynthesize(input_values=wav, steps=2)
    got = tsyn.SegmentSynthesis(model_ckpt=str(tmp_path / "synth"), config=cfg,
                                device="cpu").resynthesize(input_values=wav, steps=2)
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[1][0], want[1][0])
    fixture = load_params(FIXTURES / "orbax" / "mini_synth_params")
    for name in ("input_mlp", "regressor"):
        a, b = state_dict_from_tree(fixture[name]), state_dict_from_tree(trained[name])
        assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)

    voc = jax_load_npz(str(FIXTURES / "mini_vocoder.npz"))
    save_params(str(tmp_path / "voc"), voc)
    vcfg = SparcDecoderConfig(generator=HiFiGANConfig(
        **json.loads((FIXTURES / "mini_vocoder.json").read_text())["generator"]))
    art = np.random.RandomState(6).randn(1, 20, 14).astype(np.float32)
    spk = np.random.RandomState(7).randn(vcfg.spk_emb_dim).astype(np.float32)
    ref = load_decoder(str(FIXTURES / "mini_vocoder.npz"), vcfg, device="cpu")(art, spk)
    assert np.array_equal(load_decoder(str(tmp_path / "voc"), vcfg, device="cpu")(art, spk), ref)

    # stage 2: model_ckpt is the JAX trainer's params_final (save_params' layout)
    recipe = yaml.safe_load((FIXTURES / "orbax" / "tiny_train.yaml").read_text())
    params = read_tree(FIXTURES / "orbax" / "tiny_train_ckpts" / "2" / "default")["params"]
    save_params(str(tmp_path / "params_final"), params)
    sd = load_state_dict(str(tmp_path / "params_final"), 1)
    ref = state_dict_from_jax_params(params)
    assert sd.keys() == ref.keys() and all(torch.equal(sd[k], ref[k]) for k in sd)
    recipe["model_ckpt"] = str(tmp_path / "params_final")
    recipe["data"].update(n_utts=4, batch_size=2, max_len=8000)
    (tmp_path / "stage2.yaml").write_text(yaml.safe_dump(recipe))
    assert train_cli(["--config", str(tmp_path / "stage2.yaml"), "--out-dir",
                      str(tmp_path / "run"), "--max-steps", "1", "--log-every", "1",
                      "--ckpt-every", "0", "--device", "cpu"]) == 0
    row = json.loads((tmp_path / "run" / "metrics.jsonl").read_text().splitlines()[0])
    assert np.isfinite(row["loss"])


def test_full_width_hubert_base_tree_matches_jax(tmp_path):
    """HuBERT-base widths (768 wide, 3072 feed-forward, 512-channel convs,
    128-tap positional conv in 16 groups), two layers deep."""
    cfg = dict(num_hidden_layers=2)
    model = port_hubert.init_weights(port_hubert.HubertModel(port_hubert.HubertConfig(**cfg)),
                                     torch.Generator().manual_seed(0))
    tree = jax_params_from_state_dict(model.state_dict())
    save_params(str(tmp_path / "base"), tree)
    sd = load_state_dict(str(tmp_path / "base"), 2)
    ref = model.state_dict()
    assert sd.keys() == ref.keys() and all(torch.equal(sd[k], ref[k]) for k in sd)
    loaded = port_hubert.HubertModel(port_hubert.HubertConfig(**cfg))
    loaded.load_state_dict(sd)
    wav = _wav(1.0, 8)[None]
    mask = np.ones_like(wav, np.int32)
    with torch.no_grad():
        got = loaded.eval()(torch.from_numpy(wav), torch.from_numpy(mask)).numpy()
    jcfg = jax_hubert.HubertConfig(precision="highest", **cfg)
    want = np.asarray(jax.jit(jax_hubert.HubertModel(jcfg).apply)(
        {"params": read_tree(tmp_path / "base" / "params")}, jnp.asarray(wav),
        jnp.asarray(mask)))
    assert got.shape == want.shape == (1, 49, 768)
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=0)


def test_flipped_crc_unknown_filter_and_dtype_raise(tmp_path, monkeypatch):
    save_params(str(tmp_path / "ok"), {"a": np.arange(6, dtype=np.float32).reshape(2, 3)})
    src = tmp_path / "ok" / "params"
    bad = tmp_path / "crc"
    shutil.copytree(src, bad)
    raw = bytearray((bad / "manifest.ocdbt").read_bytes())
    raw[-1] ^= 1
    (bad / "manifest.ocdbt").write_bytes(bytes(raw))
    with pytest.raises(ValueError, match="CRC-32C"):
        read_tree(bad)

    meta = json.loads(OcdbtStore(src).read("a/.zarray"))
    read = OcdbtStore.read

    def zarray_says(zarray):
        """The store's ``a/.zarray`` reads as ``zarray``."""
        monkeypatch.setattr(OcdbtStore, "read", lambda store, key: (
            json.dumps(zarray).encode() if key == "a/.zarray" else read(store, key)))

    zarray_says(dict(meta, filters=[{"id": "delta", "dtype": "<f4"}]))
    with pytest.raises(ValueError, match="filters"):
        read_tree(src)
    zarray_says(dict(meta, dtype=">f4"))
    with pytest.raises(ValueError, match="dtype '>f4'"):
        read_tree(src)
    zarray_says(meta)
    assert np.array_equal(read_tree(src)["a"], np.arange(6, dtype=np.float32).reshape(2, 3))
