"""The port's Orbax writer (``io/ocdbt.py::write_store``, ``io/orbax.py::write_tree``,
``io/checkpoint.py::save_params``, ``SegmentSynthesis.save``) against the
JAX package's reader and writer.

- ``write_tree`` then the port's ``read_tree`` is bit-equal, and orbax's
  restore of the same directory too, for every dtype the reader takes, a
  scalar, ``None``, empty containers and a leaf stored out of line; once
  with orbax's node-size limit (one leaf node) and once with a limit of
  512 bytes, so that leaves split and interior nodes stack up, which
  tensorstore then reads key for key; and a tree with no array (an empty
  store).
- The port's ``save_params`` of ``mini_ckpt.npz``'s tree has the
  ``_METADATA`` paths, value types, shapes and dtypes of the JAX package's
  own ``save_params`` of the same tree (the chunks are uncompressed, so the
  files differ), and ``sylber_tpu.io.checkpoint.load_params`` (orbax and
  tensorstore) returns the same arrays, bit for bit.
- ``sylber_tpu``'s ``SegmentSynthesis`` loads the port's
  ``SegmentSynthesis.save`` output: its parameter tree equals the port's
  ``jax_tree()`` leaf for leaf.
"""

import json
import os
from pathlib import Path

import jax
import numpy as np
import orbax.checkpoint as ocp
import pytest
import tensorstore as ts
import torch

from sylber_tpu.io.checkpoint import load_params as jax_load_params
from sylber_tpu.io.checkpoint import load_params_npz as jax_load_npz
from sylber_tpu.io.checkpoint import save_params as jax_save_params
from sylber_tpu.synthesis import SegmentSynthesis as JaxSynthesis
from sylber_tpu.train.synthesis_loop import synthesis_config_from_dict as jax_synth_config
from sylber_tpu_torch import synthesis as tsyn
from sylber_tpu_torch.io.checkpoint import save_params
from sylber_tpu_torch.io.ocdbt import OcdbtStore
from sylber_tpu_torch.io.orbax import read_tree, write_tree
from _torch_threads import _few_threads  # noqa: E402,F401 (autouse)

FIXTURES = Path(__file__).resolve().parent / "fixtures"


def _bits(a):
    a = np.asarray(a)
    if a.dtype == jax.numpy.bfloat16:
        a = a.astype(np.float32)
    return a.dtype, a.shape, a.tobytes()


def assert_same(got, want, path="tree"):
    """Nested dicts / sequences of arrays, bit for bit (bfloat16 widened)."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and got.keys() == want.keys(), (path, got, want)
        for k in want:
            assert_same(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, (list, tuple)):
        assert isinstance(got, (list, tuple)) and len(got) == len(want), (path, got, want)
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, f"{path}/{i}")
    elif want is None:
        assert got is None, path
    else:
        assert _bits(got) == _bits(want), path


def _tree():
    rng = np.random.default_rng(0)
    bf16 = torch.from_numpy(rng.standard_normal((3, 5)).astype(np.float32)).to(torch.bfloat16)
    tree = {"f4": rng.standard_normal((3, 5)).astype(np.float32),
            "f8": rng.standard_normal(4), "f2": rng.standard_normal((2, 2)).astype(np.float16),
            "bf16": bf16, "i4": np.arange(-2, 3, dtype=np.int32),
            "i8": np.arange(3, dtype=np.int64) - 2 ** 40,
            "u4": np.array([1, 2 ** 32 - 1], np.uint32), "b1": np.array([True, False, True]),
            "scalar": np.int32(7), "t32": torch.arange(6, dtype=torch.float32).reshape(2, 3).T,
            "seq": [np.ones(2, np.float32), None, {"x": np.zeros((2, 3), np.float32)}],
            "empty_dict": {}, "empty_list": [], "empty_tuple": (), "none": None,
            "big": rng.standard_normal((300, 700)).astype(np.float32)}
    # the same values as the readers give them back: bfloat16 widened to
    # float32, tensors as numpy arrays
    want = dict(tree, bf16=bf16.float().numpy(), t32=tree["t32"].numpy())
    return tree, want


@pytest.mark.parametrize("node_bytes", [100_000_000, 512], ids=["one-node", "split-nodes"])
def test_write_tree_round_trips_bit_equal(tmp_path, node_bytes):
    tree, want = _tree()
    stats = write_tree(tmp_path / "t", tree, max_decoded_node_bytes=node_bytes)
    assert (stats["height"] > 1) == (node_bytes == 512)
    got = read_tree(tmp_path / "t")
    # the port's reader drops a None from a dict and keeps it in a sequence
    assert "none" not in got and got["seq"][1] is None
    assert got["empty_dict"] == {} and got["empty_list"] == [] and got["empty_tuple"] == []
    assert_same(got, {k: v for k, v in want.items() if k not in ("none", "empty_tuple")}
                | {"empty_tuple": []})
    with ocp.StandardCheckpointer() as ckptr:
        restored = ckptr.restore(os.path.abspath(tmp_path / "t"))
    assert restored["none"] is None and restored["empty_tuple"] == ()
    assert_same(restored, want)
    # tensorstore walks the same keys and values as the port's reader
    kv = ts.KvStore.open(f"file://{tmp_path / 't'}/|ocdbt:").result()
    store = OcdbtStore(tmp_path / "t")
    keys = sorted(k.decode() for k in kv.list().result())
    assert keys == store.list() and "big/0.0" in keys
    for k in keys:
        assert kv.read(k).result().value == store.read(k), k
    assert len(store.read("big/0.0")) > store.max_inline_value_bytes
    # no array at all: an empty store, whose root the manifest marks missing
    write_tree(tmp_path / "e", {"none": None, "empty": [], "d": {}},
               max_decoded_node_bytes=node_bytes)
    assert OcdbtStore(tmp_path / "e").list() == []
    assert read_tree(tmp_path / "e") == {"empty": [], "d": {}}
    with ocp.StandardCheckpointer() as ckptr:
        assert ckptr.restore(os.path.abspath(tmp_path / "e")) == {"none": None, "empty": [],
                                                                   "d": {}}


def _metadata(item_dir):
    """``{tree path: (key metadata, value type, shape, dtype)}`` of a saved item."""
    meta = json.loads((Path(item_dir) / "_METADATA").read_text())
    store = OcdbtStore(item_dir)
    out = {}
    for path, entry in meta["tree_metadata"].items():
        keys = entry["key_metadata"]
        zarray = json.loads(store.read(".".join(k["key"] for k in keys) + "/.zarray"))
        out[path] = (keys, entry["value_metadata"]["value_type"], zarray["shape"],
                     zarray["dtype"])
    return out, {k: v for k, v in meta.items() if k != "tree_metadata"}


def test_save_params_matches_the_jax_packages_save(tmp_path):
    tree = jax_load_npz(str(FIXTURES / "mini_ckpt.npz"))
    save_params(str(tmp_path / "port"), tree)
    jax_save_params(str(tmp_path / "jax"), tree)
    got, got_top = _metadata(tmp_path / "port" / "params")
    want, want_top = _metadata(tmp_path / "jax" / "params")
    assert got == want and got_top == want_top
    for name in ("port", "jax"):
        meta = json.loads((tmp_path / name / "params" / "_CHECKPOINT_METADATA").read_text())
        assert meta["item_handlers"].endswith("StandardCheckpointHandler")
    # every chunk uncompressed: the port's files hold the raw float32 bytes
    store = OcdbtStore(tmp_path / "port" / "params")
    assert all(json.loads(store.read(k))["compressor"] is None
               for k in store.list() if k.endswith(".zarray"))
    loaded = jax_load_params(str(tmp_path / "port"))
    assert_same(jax.tree.map(np.asarray, loaded), tree)
    assert_same(read_tree(tmp_path / "port" / "params"), tree)


def test_jax_segment_synthesis_loads_the_ports_save(tmp_path):
    mc = json.loads((FIXTURES / "mini_synth.json").read_text())["config"]["model"]
    params = {"hubert": jax_load_npz(str(FIXTURES / "mini_ckpt.npz")),
              **jax_load_npz(str(FIXTURES / "mini_synth.npz"))}
    port = tsyn.SegmentSynthesis(config=tsyn.synthesis_config_from_dict(mc), params=params,
                                 device="cpu")
    port.save(str(tmp_path / "synth"))
    jax_synth = JaxSynthesis(model_ckpt=str(tmp_path / "synth"), config=jax_synth_config(mc))
    got = {k: jax.tree.map(np.asarray, getattr(jax_synth.params, k))
           for k in ("hubert", "input_mlp", "regressor")}
    assert_same(got, port.jax_tree())
    assert_same(got, params)
