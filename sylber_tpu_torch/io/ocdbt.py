"""A read-only OCDBT key-value store: the container Orbax writes its arrays in.

OCDBT (tensorstore's "optionally-cooperative distributed B+tree") keeps a
key-value store in a directory: a ``manifest.ocdbt`` that names the latest
version's root B+tree node, and data files under ``d/`` that hold the nodes
and the values too large to sit in a node. This module reads that format
with numpy-free Python and the port's own zstd decoder (``io/zstd.py``); it
never writes.

Every manifest and B+tree node is a container:

- the magic (``0c db 3a 2a`` a manifest, ``0c db 20 de`` a node), a u64
  little-endian length of the whole container, a varint version (0) and a
  varint compression (0 none, 1 zstd);
- the body, compressed as that byte says;
- a little-endian CRC-32C of everything before it, which is checked.

A manifest's body holds the config (uuid, manifest kind, the inline-value
limit, the node-size limit, the version tree's arity, the compression and
its level), the data-file table, the latest versions (generation, root
height and node reference, statistics, commit time, each a column) and the
references to older version-tree nodes. A node's body holds its height, its
own data-file table, and its entries: keys prefix-compressed against the
entry before and, in an interior node, against the subtree's common prefix,
then either child references (interior) or values (leaf: inline, or an
indirect ``(file, offset, length)`` reference into a data file).

Data-file paths carry a base path, which Orbax's multi-process layout uses:
its top-level ``manifest.ocdbt`` points into ``ocdbt.process_<i>/d/...``,
where each process wrote its own nodes and values.

Refused by name: a numbered manifest (the kind that keeps versions in
separate files), an unknown container version, compression or value kind, a
failed CRC-32C, a node whose height does not follow its parent's, and a
tree whose key count is not the manifest's.
"""

from __future__ import annotations

import struct
from pathlib import Path
from typing import Dict, List, Tuple, Union

from .zstd import crc32c, decompress

MANIFEST_MAGIC = bytes.fromhex("0cdb3a2a")
NODE_MAGIC = bytes.fromhex("0cdb20de")


class OcdbtError(ValueError):
    pass


class _Cursor:
    def __init__(self, data: bytes, what: str):
        self.data, self.pos, self.what = data, 0, what

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise OcdbtError(f"{self.what}: truncated")
        b = self.data[self.pos:self.pos + n]
        self.pos += n
        return b

    def u8(self) -> int:
        return self.take(1)[0]

    def u32(self) -> int:
        return struct.unpack("<I", self.take(4))[0]

    def varint(self) -> int:
        v = shift = 0
        while True:
            b = self.u8()
            v |= (b & 0x7F) << shift
            if b < 0x80:
                return v
            shift += 7
            if shift > 63:
                raise OcdbtError(f"{self.what}: varint longer than 64 bits")

    def varints(self, n: int) -> List[int]:
        return [self.varint() for _ in range(n)]


def _unwrap(raw: bytes, magic: bytes, what: str) -> bytes:
    """The body of a container, its header and CRC-32C checked."""
    if len(raw) < 4 + 8 + 2 + 4 or raw[:4] != magic:
        raise OcdbtError(f"{what}: not an OCDBT {'manifest' if magic == MANIFEST_MAGIC else 'node'}"
                         f" (magic {raw[:4].hex()})")
    length = struct.unpack("<Q", raw[4:12])[0]
    if length != len(raw):
        raise OcdbtError(f"{what}: container says {length} bytes, holds {len(raw)}")
    stored = struct.unpack("<I", raw[-4:])[0]
    if crc32c(raw[:-4]) != stored:
        raise OcdbtError(f"{what}: CRC-32C mismatch")
    c = _Cursor(raw[:-4], what)
    c.pos = 12
    version = c.varint()
    if version != 0:
        raise OcdbtError(f"{what}: unknown format version {version}")
    compression = c.varint()
    body = raw[c.pos:-4]
    if compression == 0:
        return body
    if compression == 1:
        return decompress(body)
    raise OcdbtError(f"{what}: unknown compression {compression}")


def _data_file_table(c: _Cursor, base: str) -> List[Tuple[str, str]]:
    """The table's files as ``(base path, relative path)``, relative to the
    store's root: each entry's base path follows ``base``, the base path of
    the file the table was read from."""
    n = c.varint()
    prefix = [0] + c.varints(n - 1) if n else []
    suffix = c.varints(n)
    base_len = c.varints(n)
    paths, prev = [], b""
    for i in range(n):
        if prefix[i] > len(prev):
            raise OcdbtError(f"{c.what}: data-file path prefix past the previous path")
        path = prev[:prefix[i]] + c.take(suffix[i])
        if base_len[i] > len(path):
            raise OcdbtError(f"{c.what}: data-file base path longer than its path")
        paths.append((base + path[:base_len[i]].decode(), path[base_len[i]:].decode()))
        prev = path
    return paths


def _keys(c: _Cursor, n: int, interior: bool) -> Tuple[List[bytes], List[int]]:
    prefix = [0] + c.varints(n - 1) if n else []
    suffix = c.varints(n)
    common = c.varints(n) if interior else [0] * n
    keys, prev = [], b""
    for i in range(n):
        if prefix[i] > len(prev):
            raise OcdbtError(f"{c.what}: key prefix past the previous key")
        key = prev[:prefix[i]] + c.take(suffix[i])
        if common[i] > len(key):
            raise OcdbtError(f"{c.what}: subtree prefix longer than its key")
        keys.append(key)
        prev = key
    return keys, common


class OcdbtStore:
    """The latest version of the OCDBT database under ``root`` (the directory
    holding ``manifest.ocdbt``): :meth:`list` its keys, :meth:`read` a value."""

    def __init__(self, root: Union[str, Path]):
        self.root = Path(root)
        manifest = self.root / "manifest.ocdbt"
        if not manifest.is_file():
            raise FileNotFoundError(f"{manifest}: no OCDBT manifest")
        c = _Cursor(_unwrap(manifest.read_bytes(), MANIFEST_MAGIC, str(manifest)), str(manifest))
        c.take(16)  # uuid
        kind = c.varint()
        if kind != 0:
            raise OcdbtError(f"{manifest}: numbered manifest (kind {kind}) is not supported")
        self.max_inline_value_bytes = c.varint()
        c.varint()  # the node-size limit
        c.u8()  # version tree arity (log2)
        compression = c.varint()
        if compression == 1:
            c.u32()  # zstd level
        elif compression != 0:
            raise OcdbtError(f"{manifest}: unknown compression method {compression}")
        files = _data_file_table(c, "")
        n = c.varint()  # the latest versions, column by column
        generation = c.varints(n)
        height = [c.u8() for _ in range(n)]
        file_id, offset, length, num_keys = (c.varints(n) for _ in range(4))
        self._index: Dict[bytes, tuple] = {}  # key -> inline bytes or (file, offset, length)
        if not n:  # an empty database
            return
        last = max(range(n), key=generation.__getitem__)
        if length[last]:
            if file_id[last] >= len(files):
                raise OcdbtError(f"{manifest}: root in data file {file_id[last]} of {len(files)}")
            self._walk(files[file_id[last]], offset[last], length[last], height[last], b"")
        if len(self._index) != num_keys[last]:
            raise OcdbtError(f"{manifest}: the tree holds {len(self._index)} keys, the manifest "
                             f"says {num_keys[last]}")

    def _slice(self, file: Tuple[str, str], offset: int, length: int) -> bytes:
        path = "".join(file)
        with open(self.root / path, "rb") as f:
            f.seek(offset)
            data = f.read(length)
        if len(data) != length:
            raise OcdbtError(f"{path}: {length} bytes at {offset} truncated to {len(data)}")
        return data

    def _walk(self, file: Tuple[str, str], offset: int, length: int, height: int,
              prefix: bytes) -> None:
        what = f"{''.join(file)}@{offset}"
        c = _Cursor(_unwrap(self._slice(file, offset, length), NODE_MAGIC, what), what)
        if c.u8() != height:
            raise OcdbtError(f"{what}: node height does not follow its parent's")
        files = _data_file_table(c, file[0])
        n = c.varint()
        keys, common = _keys(c, n, interior=height > 0)
        if height > 0:
            file_id, offs, lens = c.varints(n), c.varints(n), c.varints(n)
            for i in range(n):
                if file_id[i] >= len(files):
                    raise OcdbtError(f"{what}: child in data file {file_id[i]} of {len(files)}")
                self._walk(files[file_id[i]], offs[i], lens[i], height - 1,
                           prefix + keys[i][:common[i]])
            return
        sizes = c.varints(n)
        kinds = c.varints(n)
        indirect = [i for i in range(n) if kinds[i] == 1]
        if any(k not in (0, 1) for k in kinds):
            raise OcdbtError(f"{what}: unknown value kind {max(kinds)}")
        file_id, offs = c.varints(len(indirect)), c.varints(len(indirect))
        refs = dict(zip(indirect, zip(file_id, offs)))
        for i in range(n):
            key = prefix + keys[i]
            if i in refs:
                f, o = refs[i]
                if f >= len(files):
                    raise OcdbtError(f"{what}: value in data file {f} of {len(files)}")
                self._index[key] = (files[f], o, sizes[i])
            else:
                self._index[key] = c.take(sizes[i])

    def list(self) -> List[str]:
        """Every key of the latest version, sorted."""
        return sorted(k.decode() for k in self._index)

    def __contains__(self, key: str) -> bool:
        return key.encode() in self._index

    def read(self, key: str) -> bytes:
        """The value stored under ``key`` (``KeyError`` if none)."""
        v = self._index[key.encode()]
        return v if isinstance(v, bytes) else self._slice(*v)
