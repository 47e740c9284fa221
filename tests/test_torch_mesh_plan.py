"""The port's sharding plan and mesh rules (``sylber_tpu_torch/parallel/mesh.py``)
against ``sylber_tpu/parallel/mesh.py``.

``hubert_param_specs`` of the port, on the state dict of a hubert-base
encoder of two layers (shapes only, on the meta device), against JAX's on
the same tree in its layout (``jax.eval_shape`` of its init): every TP split
(a Linear weight's spec is the transpose of its kernel's) and the set of
leaves FSDP shards, and on which dim, for ``fsdp_dp`` 2 and 8 and
``fsdp_min_size`` 1024 and 2^16, with and without TP. Then the port of JAX's
``test_fsdp_extend_spec_rules`` and ``test_maybe_distributed_init_disabled_by_default``,
and the refusals: a mesh larger than what exists, a ``dp`` that does not
divide the batch, tensor parallelism that does not divide the heads or of
an inference form.
"""

import re

import jax
import numpy as np
import pytest
import torch

from sylber_tpu.models.hubert import HubertConfig as JaxHubertConfig, HubertModel as JaxHubert
from sylber_tpu.parallel import mesh as jax_mesh
from sylber_tpu_torch.models.hubert import HubertConfig, HubertModel
from sylber_tpu_torch.parallel import mesh as port_mesh
from _torch_threads import _few_threads  # noqa: E402,F401 (autouse)

_TO_PORT = ((re.compile(r"^feature_extractor\.conv_(\d+)\."), r"feature_extractor.convs.\1."),
            (re.compile(r"^layer_(\d+)\."), r"layers.\1."))


@pytest.fixture(scope="module")
def trees():
    """(port state-dict shapes, JAX {port name: (jax leaf shape)} and JAX's
    tree of shapes) of a hubert-base encoder with two layers."""
    with torch.device("meta"):
        sd = {k: v for k, v in HubertModel(HubertConfig(num_hidden_layers=2)).state_dict().items()}
    model = JaxHubert(JaxHubertConfig(num_hidden_layers=2))
    tree = jax.eval_shape(lambda: model.init_params(jax.random.PRNGKey(0), example_len=4800))
    return sd, tree


def _port_name(path) -> str:
    name = ".".join(str(p.key) for p in path)
    *head, leaf = name.split(".")
    leaf = {"kernel": "weight", "scale": "weight"}.get(leaf, leaf)
    name = ".".join(head + [leaf])
    for pattern, repl in _TO_PORT:
        name = pattern.sub(repl, name)
    return name


def _as_port_spec(spec, ndim):
    """A JAX spec of a flax leaf in the port's layout: a kernel's dims
    reversed (Dense (in, out) -> Linear (out, in); Conv (k, in, out) ->
    (out, in, k)), others as they are."""
    dims = tuple(spec) + (None,) * (ndim - len(spec))
    return dims[::-1] if ndim >= 2 else dims


@pytest.mark.parametrize("use_tp", [True, False], ids=["tp", "no_tp"])
@pytest.mark.parametrize("fsdp_dp,min_size", [(0, 2 ** 16), (2, 1024), (2, 2 ** 16),
                                              (8, 1024), (8, 2 ** 16)])
def test_param_specs_match_jax(trees, use_tp, fsdp_dp, min_size):
    sd, tree = trees
    want = {}
    specs = jax_mesh.hubert_param_specs(tree, use_tp=use_tp, fsdp_dp=fsdp_dp,
                                        fsdp_min_size=min_size)
    for path, leaf in jax.tree_util.tree_leaves_with_path(tree):
        spec = specs
        for p in path:
            spec = spec[p.key]
        want[_port_name(path)] = _as_port_spec(spec, len(leaf.shape))
    got = port_mesh.hubert_param_specs(sd, use_tp=use_tp, fsdp_dp=fsdp_dp,
                                       fsdp_min_size=min_size)
    assert got == want
    sharded = {k for k, s in got.items() if "dp" in s}
    assert bool(sharded) == bool(fsdp_dp)
    assert all("mp" not in s for s in got.values()) or use_tp


def test_tp_rules_split_the_megatron_leaves(trees):
    sd, _ = trees
    split = {k: port_mesh.tp_dim(k) for k in sd if port_mesh.tp_dim(k) is not None}
    assert split["layers.0.attention.q_proj.weight"] == 0
    assert split["layers.0.attention.v_proj.bias"] == 0
    assert split["layers.1.attention.out_proj.weight"] == 1
    assert split["layers.1.intermediate_dense.weight"] == 0
    assert split["layers.1.output_dense.weight"] == 1
    assert "layers.0.attention.out_proj.bias" not in split   # added once, after the sum
    assert "layers.0.output_dense.bias" not in split
    assert len(split) == 2 * 10


def test_fsdp_extend_spec_rules():
    ext = port_mesh._fsdp_extend
    # picks the largest free divisible axis
    assert ext((), (128, 64), 8, min_size=1) == ("dp", None)
    assert ext((), (64, 128), 8, min_size=1) == (None, "dp")
    # respects an mp-occupied axis (Megatron + ZeRO compose)
    assert ext((None, "mp"), (128, 64), 8, min_size=1) == ("dp", "mp")
    assert ext(("mp", None), (128, 64), 8, min_size=1) == ("mp", "dp")
    # indivisible dims are skipped; fully-indivisible leaves stay put
    assert ext((), (127, 64), 8, min_size=1) == (None, "dp")
    assert ext((), (127, 63), 8, min_size=1) == (None, None)
    # small leaves stay replicated under the default threshold
    assert ext((), (64, 64), 8) == (None, None)


def test_maybe_distributed_init_disabled_by_default(monkeypatch):
    for var in ("SYLBER_TPU_DIST", "SYLBER_TPU_COORDINATOR", "TORCHELASTIC_RUN_ID",
                "WORLD_SIZE", "MASTER_ADDR"):
        monkeypatch.delenv(var, raising=False)
    assert port_mesh.maybe_distributed_init(None) is False
    assert port_mesh.maybe_distributed_init({"enabled": False}) is False
    assert not torch.distributed.is_initialized()


def test_a_distributed_block_without_its_place_raises(monkeypatch):
    for var in ("SYLBER_TPU_NUM_PROCESSES", "SYLBER_TPU_PROCESS_ID", "WORLD_SIZE", "RANK",
                "MASTER_ADDR", "SYLBER_TPU_COORDINATOR"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(ValueError, match="num_processes"):
        port_mesh.maybe_distributed_init({"coordinator_address": "127.0.0.1:1"}, "cpu")
    with pytest.raises(ValueError, match="coordinator_address"):
        port_mesh.maybe_distributed_init({"num_processes": 2, "process_id": 0}, "cpu")


def test_meshes_larger_than_what_exists_raise():
    with pytest.raises(ValueError, match="exceeds"):
        port_mesh.make_mesh(3, devices=["cpu", "cpu"])
    with pytest.raises(ValueError, match="data parallel only"):
        port_mesh.make_mesh(1, mp=2, devices=["cpu", "cpu"])
    mesh = port_mesh.make_mesh(devices=["cpu", "cpu"])
    assert (mesh.dp, mesh.mp, mesh.shape) == (2, 1, {"dp": 2, "mp": 1})
    # no process group: one process is one rank
    with pytest.raises(ValueError, match="alone"):
        port_mesh.mesh_from_config({"dp": 2}, "cpu")
    with pytest.raises(ValueError, match="alone"):
        port_mesh.mesh_from_config({"dp": -1, "mp": 2}, "cpu")
    assert port_mesh.mesh_from_config({"dp": -1, "mp": 1}, "cpu") is None
    assert port_mesh.mesh_from_config(None, "cpu") is None


def test_shard_batch_takes_the_ranks_rows_and_refuses_a_ragged_split():
    class Rank1Of2(port_mesh.Mesh):
        dp_rank = 1

    mesh = Rank1Of2(2, 1)
    x = torch.arange(12).reshape(4, 3)
    got = port_mesh.shard_batch({"x": x, "none": None, "t": (x, x)}["x"], mesh)
    np.testing.assert_array_equal(got.numpy(), x[2:].numpy())
    assert port_mesh.shard_batch({"x": x, "n": None}, mesh)["n"] is None
    assert port_mesh.shard_batch(x, None) is x
    with pytest.raises(ValueError, match="does not divide"):
        port_mesh.shard_batch(torch.zeros(3, 2), mesh)


def test_tensor_parallel_refuses_what_it_cannot_split():
    tiny = dict(hidden_size=48, intermediate_size=96, conv_dim=(8,) * 7,
                num_conv_pos_embeddings=4, num_conv_pos_embedding_groups=2,
                num_hidden_layers=1)
    mesh = port_mesh.Mesh(1, 4)
    with pytest.raises(ValueError, match="divide"):
        port_mesh.tensor_parallel(HubertModel(HubertConfig(num_attention_heads=6, **tiny)), mesh)
    for form in ("int8_encoder", "fused_qkv"):
        model = HubertModel(HubertConfig(num_attention_heads=4, **tiny, **{form: True}))
        with pytest.raises(ValueError, match="inference"):
            port_mesh.tensor_parallel(model, mesh)


def test_put_global_takes_the_ranks_piece_of_each_named_dim():
    class Dp1Mp2(port_mesh.Mesh):
        dp_rank, mp_rank = 1, 1

    x = torch.arange(48).reshape(4, 12)
    got = port_mesh.put_global(x, Dp1Mp2(2, 2), ("dp", "mp"))
    np.testing.assert_array_equal(got.numpy(), x[2:, 6:].numpy())
    np.testing.assert_array_equal(port_mesh.put_global(x, Dp1Mp2(2, 2), (None, None)), x)
    np.testing.assert_array_equal(port_mesh.put_global(x, Dp1Mp2(1, 1), ("dp", "mp")), x)
