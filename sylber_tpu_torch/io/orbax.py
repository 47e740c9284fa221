"""Orbax checkpoint trees to numpy, with no JAX, orbax or tensorstore.

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
from itertools import product
from pathlib import Path
from typing import Any, List, Union

import numpy as np

from .ocdbt import OcdbtStore
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
