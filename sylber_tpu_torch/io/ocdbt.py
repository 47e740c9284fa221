"""The OCDBT key-value store: the container Orbax writes its arrays in.

OCDBT (tensorstore's "optionally-cooperative distributed B+tree") keeps a
key-value store in a directory: a ``manifest.ocdbt`` that names the latest
version's root B+tree node, and data files under ``d/`` that hold the nodes
and the values too large to sit in a node. :class:`OcdbtStore` reads that
format with numpy-free Python and the port's own zstd decoder
(``io/zstd.py``); :func:`write_store` writes one process's store,
uncompressed.

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

An interior node's entries end with their subtrees' statistics (key count,
node bytes, out-of-line value bytes), as the manifest's version does, which
also holds its commit time (a u64 of nanoseconds) and then the count of
older version-tree nodes. A version whose tree is empty points its root at
the table's empty path with offset and length ``2**64 - 1``.

Refused by name: a numbered manifest (the kind that keeps versions in
separate files), an unknown container version, compression or value kind, a
failed CRC-32C, a node whose height does not follow its parent's, and a
tree whose key count is not the manifest's.
"""

from __future__ import annotations

import os
import struct
import time
from pathlib import Path
from typing import Dict, Iterable, List, Tuple, Union

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
        if length[last] and length[last] != _MISSING:
            if file_id[last] >= len(files):
                raise OcdbtError(f"{manifest}: root in data file {file_id[last]} of {len(files)}")
            self._walk(files[file_id[last]], offset[last], length[last], height[last], b"")
        if len(self._index) != num_keys[last]:
            raise OcdbtError(f"{manifest}: the tree holds {len(self._index)} keys, the manifest "
                             f"says {num_keys[last]}")

    def _slice(self, file: Tuple[str, str], offset: int, length: int) -> bytearray:
        path = "".join(file)
        data = bytearray(length)
        with open(self.root / path, "rb") as f:
            f.seek(offset)
            got = f.readinto(data)
        if got != length:
            raise OcdbtError(f"{path}: {length} bytes at {offset} truncated to {got}")
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
                self._index[key] = bytes(c.take(sizes[i]))

    def list(self) -> List[str]:
        """Every key of the latest version, sorted."""
        return sorted(k.decode() for k in self._index)

    def __contains__(self, key: str) -> bool:
        return key.encode() in self._index

    def read(self, key: str) -> Union[bytes, bytearray]:
        """The value stored under ``key`` (``KeyError`` if none); an
        out-of-line value comes as a new ``bytearray``."""
        v = self._index[key.encode()]
        return self._slice(*v) if isinstance(v, tuple) else v


# ---------------------------------------------------------------- the writer

# the configuration Orbax's saves give (``tests/fixtures/orbax``' manifests)
MAX_INLINE_VALUE_BYTES = 1024
MAX_DECODED_NODE_BYTES = 100_000_000
VERSION_TREE_ARITY_LOG2 = 4
_MISSING = 2 ** 64 - 1
_VARINT_MAX = 10  # bytes of a 64-bit varint, for the node-size estimate


def _varint(v: int) -> bytes:
    out = bytearray()
    while v >= 0x80:
        out.append(v & 0x7F | 0x80)
        v >>= 7
    out.append(v)
    return bytes(out)


def _varints(vs) -> bytes:
    return b"".join(map(_varint, vs))


def _container(magic: bytes, body: bytes) -> bytes:
    """A container holding ``body`` uncompressed, with its CRC-32C."""
    head = _varint(0) + _varint(0)  # format version 0, compression none
    raw = magic + struct.pack("<Q", 4 + 8 + len(head) + len(body) + 4) + head + body
    return raw + struct.pack("<I", crc32c(raw))


def _common(a, b) -> int:
    """The length of the prefix ``a`` and ``b`` share."""
    n = 0
    while n < min(len(a), len(b)) and a[n] == b[n]:
        n += 1
    return n


def _shared(items) -> List[int]:
    """Each item's prefix shared with the item before (0 for the first)."""
    return [0] + [_common(a, b) for a, b in zip(items, items[1:])]


def _table(paths: List[str]) -> bytes:
    """A data-file table of ``paths`` (base path empty), prefix-compressed."""
    prefix = _shared(paths)
    return (_varint(len(paths)) + _varints(prefix[1:]) +
            _varints(len(p) - n for p, n in zip(paths, prefix)) + _varints([0] * len(paths)) +
            b"".join(p[n:].encode() for p, n in zip(paths, prefix)))


def _key_columns(keys: List[bytes], common: List[int] = None) -> bytes:
    """A node's keys: prefix and suffix lengths, the subtrees' common prefix
    lengths (an interior node's), then the suffixes."""
    prefix = _shared(keys)
    out = _varints(prefix[1:]) + _varints(len(k) - n for k, n in zip(keys, prefix))
    if common is not None:
        out += _varints(common)
    return out + b"".join(k[n:] for k, n in zip(keys, prefix))


def _groups(sizes: List[int], limit: int, least: int) -> List[Tuple[int, int]]:
    """Consecutive ``(start, stop)`` runs of entries whose estimated sizes sum
    to at most ``limit``, each of at least ``least`` entries where there are
    that many."""
    runs, start, total = [], 0, 0
    for i, s in enumerate(sizes):
        if i - start >= least and total + s > limit:
            runs.append((start, i))
            start, total = i, 0
        total += s
    runs.append((start, len(sizes)))
    if len(runs) > 1 and runs[-1][1] - runs[-1][0] < least:  # fold a short tail back
        (a, _), (_, b) = runs[-2], runs.pop()
        runs[-1] = (a, b)
    return runs


def write_store(root: Union[str, Path], items: Iterable[Tuple[str, object]],
                max_decoded_node_bytes: int = MAX_DECODED_NODE_BYTES) -> Dict[str, int]:
    """Write the OCDBT database of ``items`` (``(key, value)`` pairs; a value
    is anything with the buffer protocol) under ``root``, as one process's
    store: one data file under ``d/`` holding the values longer than
    ``MAX_INLINE_VALUE_BYTES`` and then the B+tree, whose nodes split past
    ``max_decoded_node_bytes``, and ``manifest.ocdbt`` with the one version,
    written under a temporary name and renamed. Returns the bytes of the
    data file, the tree and the out-of-line values, and the height."""
    root = Path(root)
    entries = sorted(((k.encode() if isinstance(k, str) else bytes(k), memoryview(v).cast("B"))
                      for k, v in items), key=lambda e: e[0])
    for (a, _), (b, _) in zip(entries, entries[1:]):
        if a == b:
            raise OcdbtError(f"{root}: key {a!r} given twice")
    (root / "d").mkdir(parents=True, exist_ok=True)
    data = f"d/{os.urandom(16).hex()}"
    with open(root / data, "wb") as f:
        refs = []  # per entry: offset of an out-of-line value, or None
        for _, v in entries:
            if v.nbytes > MAX_INLINE_VALUE_BYTES:
                refs.append(f.tell())
                f.write(v)
            else:
                refs.append(None)

        def put(body: bytes) -> Tuple[int, int]:
            raw = _container(NODE_MAGIC, body)
            offset = f.tell()
            f.write(raw)
            return offset, len(raw)

        # leaves: (first key, last key, offset, length, keys, tree bytes, value bytes)
        sizes = [len(k) + 6 * _VARINT_MAX + (0 if r is not None else v.nbytes)
                 for (k, v), r in zip(entries, refs)]
        runs = _groups(sizes, max_decoded_node_bytes - 64, 1) if entries else []
        level = []
        for a, b in runs:
            keys = [k for k, _ in entries[a:b]]
            cut = 0 if len(runs) == 1 else _common(keys[0], keys[-1])
            vals, rs = [v for _, v in entries[a:b]], refs[a:b]
            out_of_line = [r for r in rs if r is not None]
            body = (bytes([0]) + _table([data] if out_of_line else []) + _varint(b - a) +
                    _key_columns([k[cut:] for k in keys]) + _varints(v.nbytes for v in vals) +
                    _varints(int(r is not None) for r in rs) +
                    _varints([0] * len(out_of_line)) + _varints(out_of_line) +
                    b"".join(bytes(v) for v, r in zip(vals, rs) if r is None))
            offset, length = put(body)
            level.append((keys[0], keys[-1], offset, length, b - a, length,
                          sum(v.nbytes for v, r in zip(vals, rs) if r is not None)))
        height = 0
        while len(level) > 1:  # interior nodes, up to one root
            height += 1
            runs = _groups([len(c[0]) + 9 * _VARINT_MAX for c in level],
                           max_decoded_node_bytes - 64, 2)
            parents = []
            for a, b in runs:
                kids = level[a:b]
                cut = 0 if len(runs) == 1 else _common(kids[0][0], kids[-1][1])
                common = [_common(c[0], c[1]) - cut for c in kids]
                body = (bytes([height]) + _table([data]) + _varint(b - a) +
                        _key_columns([c[0][cut:] for c in kids], common) +
                        _varints([0] * len(kids)) + _varints(c[2] for c in kids) +
                        _varints(c[3] for c in kids) + _varints(c[4] for c in kids) +
                        _varints(c[5] for c in kids) + _varints(c[6] for c in kids))
                offset, length = put(body)
                parents.append((kids[0][0], kids[-1][1], offset, length,
                                sum(c[4] for c in kids), length + sum(c[5] for c in kids),
                                sum(c[6] for c in kids)))
            level = parents
        data_bytes = f.tell()
    if level:
        (_, _, offset, length, num_keys, tree_bytes, value_bytes), = level
        table = _table([data])
    else:  # an empty tree: the root is missing
        offset = length = _MISSING
        num_keys = tree_bytes = value_bytes = 0
        table = _table([""])
    body = (os.urandom(16) + _varint(0) + _varint(MAX_INLINE_VALUE_BYTES) +
            _varint(max_decoded_node_bytes) + bytes([VERSION_TREE_ARITY_LOG2]) + _varint(0) +
            table + _varint(1) + _varint(1) + bytes([height]) +
            _varints([0, offset, length, num_keys, tree_bytes, value_bytes]) +
            struct.pack("<Q", time.time_ns()) + _varint(0))
    tmp = root / f"manifest.ocdbt.{os.urandom(4).hex()}.tmp"
    tmp.write_bytes(_container(MANIFEST_MAGIC, body))
    os.replace(tmp, root / "manifest.ocdbt")
    return dict(data_file_bytes=data_bytes, tree_bytes=tree_bytes, value_bytes=value_bytes,
                height=height)
