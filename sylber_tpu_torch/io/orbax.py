"""Orbax checkpoint trees to and from numpy, with no JAX, orbax or tensorstore.

An Orbax item directory (``params/`` of the JAX package's ``save_params``,
``<step>/default`` of its ``TrainCheckpointManager``) holds:

- ``_METADATA``: JSON whose ``tree_metadata`` maps each leaf's tree path to
  its keys (``key_type`` 2 a dict key, 1 a sequence index) and its
  ``value_type`` ("jax.Array", "np.ndarray"; "Dict", "List" or
  "Tuple" for an empty container; "None" for ``None`` or an empty state
  such as optax's ``EmptyState``);
- an OCDBT store (``io/ocdbt.py``) with one zarr v2 array per leaf, named by
  the path's keys joined with ``.``: ``<name>/.zarray`` (JSON: shape, chunk
  shape, dtype, compressor, fill value, order, filters) and a chunk per
  grid cell under ``<name>/<i>.<j>...`` (``0`` for a scalar).

:func:`read_tree` rebuilds the nested tree: dicts for dict keys, lists for
sequence indices (optax's chain states and NamedTuples come back as lists
and dicts of their fields). A "None" leaf (an empty state) is dropped from a
dict and kept as ``None`` in a list, so that indices hold; an empty
container comes back as ``{}`` or ``[]``. Each array is assembled from its
chunks over the chunk grid (a sharded save writes chunks smaller than the
array), decoding each with the port's zstd decoder; a missing chunk takes
the fill value. ``bfloat16`` leaves come back as float32 numpy arrays, the
bits widened exactly (every bfloat16 is a float32).

:func:`write_tree` is the inverse: the layout of the JAX package's saves
(``_METADATA`` with ``value_type`` "np.ndarray" for an array, "None" with
``skip_deserialize`` for ``None``, "Dict", "List" or "Tuple" for an empty
container; one zarr v2 array a leaf in one chunk, uncompressed), written
through ``io/ocdbt.py::write_store``. A ``torch.bfloat16`` tensor is written
as "bfloat16". :func:`write_checkpoint_metadata` writes the
``_CHECKPOINT_METADATA`` that orbax puts beside an item.

Read: dtypes ``<f4``, ``<f8``, ``<f2``, ``bfloat16``, ``<i4``, ``<i8``,
``<u4``, ``|b1``; compressor zstd or none; order C; no filters; dimension
separator ``.``. Anything else raises ``ValueError`` by name: other dtypes
(big-endian ones included), compressors, order F, any filter, another
separator, zarr v3 (``use_zarr3``), a checkpoint written without OCDBT, and
an unknown ``key_type`` or ``value_type`` (a Python scalar's "scalar" among
them: the JAX package saves numpy arrays).
"""

from __future__ import annotations

import json
import math
import os
import time
from itertools import product
from pathlib import Path
from typing import Any, Dict, List, Tuple, Union

import numpy as np
import torch

from .ocdbt import MAX_DECODED_NODE_BYTES, OcdbtStore, write_store
from .zstd import decompress

_DTYPES = {"<f4": np.float32, "<f8": np.float64, "<f2": np.float16, "<i4": np.int32,
           "<i8": np.int64, "<u4": np.uint32, "|b1": np.bool_}
_ARRAY_TYPES = ("jax.Array", "np.ndarray")
_EMPTY_CONTAINERS = {"Dict": dict, "List": list, "Tuple": list}


def _fill(fill_value):
    if fill_value is None:
        return 0
    if isinstance(fill_value, str):  # zarr v2 writes non-finite floats as strings
        return {"NaN": np.nan, "Infinity": np.inf, "-Infinity": -np.inf}[fill_value]
    return fill_value


def read_array(store: OcdbtStore, name: str) -> np.ndarray:
    """The zarr v2 array ``name`` of ``store`` as a numpy array."""
    meta = json.loads(store.read(f"{name}/.zarray"))
    what = f"{store.root}:{name}"
    if meta.get("zarr_format") != 2:
        raise ValueError(f"{what}: zarr format {meta.get('zarr_format')} (2 is read)")
    if meta.get("order", "C") != "C":
        raise ValueError(f"{what}: order {meta['order']!r} is not supported (C is read)")
    if meta.get("filters"):
        raise ValueError(f"{what}: filters {meta['filters']} are not supported")
    compressor = meta.get("compressor")
    if compressor is not None and compressor.get("id") != "zstd":
        raise ValueError(f"{what}: compressor {compressor.get('id')!r} is not supported")
    if meta.get("dimension_separator", ".") != ".":
        raise ValueError(f"{what}: dimension separator {meta['dimension_separator']!r} is not "
                         "supported")
    dtype_name = meta["dtype"]
    bf16 = dtype_name == "bfloat16"
    if not bf16 and dtype_name not in _DTYPES:
        raise ValueError(f"{what}: dtype {dtype_name!r} is not supported")
    stored = np.dtype(np.uint16 if bf16 else _DTYPES[dtype_name])
    shape, chunks = tuple(meta["shape"]), tuple(meta["chunks"])
    if len(chunks) != len(shape) or any(c < 1 for c in chunks):
        raise ValueError(f"{what}: chunk shape {chunks} does not fit shape {shape}")
    out = np.empty(shape, stored)
    fill = _fill(meta.get("fill_value"))
    if bf16 and fill != 0:
        fill = np.array([fill], np.float32).view(np.uint32)[0] >> 16
    grid = [math.ceil(s / c) for s, c in zip(shape, chunks)]
    chunk_bytes = math.prod(chunks) * stored.itemsize
    for idx in product(*(range(g) for g in grid)):
        key = f"{name}/{'.'.join(map(str, idx)) if idx else '0'}"
        region = tuple(slice(i * c, min((i + 1) * c, s)) for i, c, s in zip(idx, chunks, shape))
        if key not in store:
            out[region] = fill
            continue
        raw = store.read(key)
        if compressor is not None:
            raw = decompress(raw)
        if len(raw) != chunk_bytes:
            raise ValueError(f"{what}: chunk {key} holds {len(raw)} bytes, {chunk_bytes} expected")
        block = np.frombuffer(raw, stored).reshape(chunks)
        if chunks == shape and isinstance(raw, bytearray):  # one chunk, already our copy
            out = block
            continue
        out[region] = block[tuple(slice(0, r.stop - r.start) for r in region)]
    if bf16:
        return (out.astype(np.uint32) << 16).view(np.float32)
    return out


class _Node(dict):
    """An inner node while the tree is gathered: ``{(key, key_type): child}``."""


def _build(node):
    """Nested :class:`_Node` -> dicts and lists."""
    if not isinstance(node, _Node):
        return node
    types = {t for _, t in node}
    if types == {1}:
        items = sorted((int(k), _build(v)) for (k, _), v in node.items())
        out: List[Any] = [None] * (items[-1][0] + 1)
        for i, v in items:
            out[i] = None if v is _EMPTY else v
        return out
    if types == {2}:
        return {k: _build(v) for (k, _), v in node.items() if v is not _EMPTY}
    raise ValueError(f"a tree node mixes dict keys and sequence indices: {sorted(node)}")


_EMPTY = object()


def read_tree(path: Union[str, Path]) -> Any:
    """The tree of the Orbax item directory ``path`` (the directory holding
    ``_METADATA``): nested dicts and lists of numpy arrays."""
    path = Path(path)
    if not (path / "_METADATA").is_file():
        raise FileNotFoundError(f"{path}: no _METADATA; not an Orbax checkpoint directory")
    meta = json.loads((path / "_METADATA").read_text())
    if meta.get("use_zarr3"):
        raise ValueError(f"{path}: zarr v3 checkpoints (use_zarr3) are not supported")
    if not meta.get("use_ocdbt", False):
        raise ValueError(f"{path}: checkpoints written without OCDBT are not supported")
    store = OcdbtStore(path)
    root = _Node()
    for entry in meta["tree_metadata"].values():
        keys = [(k["key"], k["key_type"]) for k in entry["key_metadata"]]
        for k, t in keys:
            if t not in (1, 2):
                raise ValueError(f"{path}: key {k!r} has unknown key_type {t}")
        vtype = entry["value_metadata"].get("value_type")
        if vtype in (None, "None"):
            leaf = _EMPTY
        elif vtype in _EMPTY_CONTAINERS:
            leaf = _EMPTY_CONTAINERS[vtype]()
        elif vtype in _ARRAY_TYPES:
            leaf = read_array(store, ".".join(str(k) for k, _ in keys))
        else:
            raise ValueError(f"{path}: leaf {'.'.join(str(k) for k, _ in keys)} has "
                             f"value_type {vtype!r}, which is not supported")
        node = root
        for key in keys[:-1]:
            node = node.setdefault(key, _Node())
        node[keys[-1]] = leaf
    return _build(root)


def load_params(path: Union[str, Path]) -> Any:
    """A parameter tree saved by the JAX package's ``save_params``: reads
    ``path/params`` when that exists, else ``path`` (as
    ``sylber_tpu.io.checkpoint.load_params`` does)."""
    sub = Path(path) / "params"
    return read_tree(sub if sub.is_dir() else path)


# ---------------------------------------------------------------- the writer

_ZARR_DTYPES = {np.dtype(v): k for k, v in _DTYPES.items()}
_EMPTY_TYPES = {dict: "Dict", list: "List", tuple: "Tuple"}
STANDARD_HANDLER = ("orbax.checkpoint._src.handlers.standard_checkpoint_handler."
                    "StandardCheckpointHandler")


def _leaves(tree, keys=()) -> List[Tuple[tuple, Any]]:
    """``(keys, leaf)`` in the tree's order; ``keys`` are ``(key, key_type)``."""
    if isinstance(tree, dict) and tree:
        return [x for k, v in tree.items() for x in _leaves(v, keys + ((str(k), 2),))]
    if isinstance(tree, (list, tuple)) and tree:
        return [x for i, v in enumerate(tree) for x in _leaves(v, keys + ((str(i), 1),))]
    return [(keys, tree)]


def _array(leaf, what: str) -> Tuple[str, np.ndarray]:
    """The zarr dtype of a leaf and its C-ordered bytes as a numpy array."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.device.type != "cpu":
            raise ValueError(f"{what}: a tensor on {t.device}; copy it to the host first")
        t = t.contiguous()
        if t.dtype == torch.bfloat16:
            return "bfloat16", t.view(torch.int16).numpy()
        leaf = t.numpy()
    if not isinstance(leaf, (np.ndarray, np.generic)):
        raise TypeError(f"{what}: a {type(leaf).__name__} leaf; the JAX package saves numpy "
                        "arrays")
    a = np.asarray(leaf)
    if not a.flags.c_contiguous:
        a = a.copy(order="C")
    if a.dtype.byteorder == ">":
        a = a.astype(a.dtype.newbyteorder("<"))
    if a.dtype not in _ZARR_DTYPES:
        raise ValueError(f"{what}: dtype {a.dtype} is not written")
    return _ZARR_DTYPES[a.dtype], a


def write_tree(path: Union[str, Path], tree: Any,
               max_decoded_node_bytes: int = MAX_DECODED_NODE_BYTES) -> Dict[str, int]:
    """Write ``tree`` (nested dicts, lists and tuples of numpy arrays, CPU
    tensors and ``None``) as the Orbax item directory ``path``, which
    :func:`read_tree` and orbax's restore read: the OCDBT store, then
    ``_METADATA``. Returns the store's byte counts
    (``io/ocdbt.py::write_store``)."""
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    tree_metadata, items = {}, []
    for keys, leaf in _leaves(tree):
        if not keys:
            raise ValueError(f"{path}: the tree is a single leaf; orbax saves a container")
        name = ".".join(k for k, _ in keys)
        if leaf is None:
            value = {"value_type": "None", "skip_deserialize": True}
        elif type(leaf) in _EMPTY_TYPES:
            value = {"value_type": _EMPTY_TYPES[type(leaf)], "skip_deserialize": True}
        else:
            dtype, a = _array(leaf, f"{path}:{name}")
            value = {"value_type": "np.ndarray", "skip_deserialize": False}
            zarray = {"chunks": [max(s, 1) for s in a.shape], "compressor": None,
                      "dimension_separator": ".", "dtype": dtype, "fill_value": None,
                      "filters": None, "order": "C", "shape": list(a.shape), "zarr_format": 2}
            items.append((f"{name}/.zarray", json.dumps(zarray, separators=(",", ":")).encode()))
            if a.size:
                items.append((f"{name}/{'.'.join(['0'] * a.ndim) or '0'}", a.reshape(-1)))
        tree_metadata[str(tuple(k for k, _ in keys))] = {
            "key_metadata": [{"key": k, "key_type": t} for k, t in keys],
            "value_metadata": value}
    stats = write_store(path, items, max_decoded_node_bytes=max_decoded_node_bytes)
    meta = {"tree_metadata": tree_metadata, "use_ocdbt": True, "use_zarr3": False,
            "store_array_data_equal_to_fill_value": True, "custom_metadata": None}
    tmp = path / f"_METADATA.{os.urandom(4).hex()}.tmp"
    tmp.write_text(json.dumps(meta))
    os.replace(tmp, path / "_METADATA")
    return stats


def write_checkpoint_metadata(directory: Union[str, Path], item_handlers: Any,
                              init_ns: int) -> None:
    """``directory/_CHECKPOINT_METADATA`` as orbax writes it: the item
    handlers (one class name, or a dict of item name to class name) and the
    times the save began (``init_ns``) and ended, in nanoseconds."""
    meta = {"item_handlers": item_handlers, "metrics": {}, "performance_metrics": {},
            "init_timestamp_nsecs": int(init_ns), "commit_timestamp_nsecs": time.time_ns(),
            "custom_metadata": {}}
    (Path(directory) / "_CHECKPOINT_METADATA").write_text(json.dumps(meta))
