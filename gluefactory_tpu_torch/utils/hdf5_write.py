"""A streaming HDF5 writer for the files this package writes where h5py is
absent (the feature caches of `scripts/export_megadepth.py`, depth maps of
procedural scenes): the subset that `data/hdf5.py` reads and h5py writes by
default, which h5py reads back.

    with H5Writer(path) as f:
        grp = f.create_group("scene/im0.jpg")   # nested groups, as h5py makes them
        grp.create_dataset("keypoints", data=kpts)
    write_datasets(path, {"depth": depth})      # one root group of datasets

Each dataset's bytes and object header go to disk when it is created; only
names and addresses stay in memory (a scene's cache is 1-3 GB). `close()`
then writes each group, members first: a local heap of its names, symbol
nodes of up to 2 * GROUP_LEAF_K entries in HDF5's name order (bytewise),
and a v1 B-tree over them, with levels above the leaves where a group has
more than 2 * GROUP_INTERNAL_K symbol nodes; then the superblock (v0,
8-byte addresses and lengths) with the end of file and the root's entry.

Datasets are contiguous, in C order: little-endian integers of 1-8 bytes,
float16/32/64, `bool` as h5py stores it (an enum of base int8, FALSE = 0
and TRUE = 1), and text (numpy `str`, `bytes` or an object array of
either) as h5py's `special_dtype(vlen=str)`: a variable-length UTF-8 string
(datatype class 9) whose elements are (length, global heap id), the bytes
in a global heap collection written just before the dataset, one object a
string. An empty dataset has no storage. Object headers are version 1
(dataspace v1, datatype v1, fill value v2, layout v3).
"""

from __future__ import annotations

import struct
from pathlib import Path

import numpy as np

UNDEF = b"\xff" * 8
SUPERBLOCK = 96  # v0: 56 bytes of fields, then the root's 40-byte symbol entry
GROUP_LEAF_K, GROUP_INTERNAL_K = 4, 16  # h5py's defaults
ENTRY = 40  # symbol-table entry: name offset, header, cache type, reserved, scratch
BTREE = 24 + (2 * GROUP_INTERNAL_K + 1) * 8 + 2 * GROUP_INTERNAL_K * 8
SNOD = 8 + 2 * GROUP_LEAF_K * ENTRY
GCOL_MIN = 4096  # the least size of a global heap collection, as the HDF5 library writes it
GCOL_OBJECTS = 0xFFFF  # object indices are 16 bits, 0 the free space


def _pad8(b: bytes) -> bytes:
    return b + b"\0" * (-len(b) % 8)


def _message(mtype: int, data: bytes, flags: int = 0) -> bytes:
    data = _pad8(data)
    return struct.pack("<HHB3x", mtype, len(data), flags) + data


def _object_header(messages: list) -> bytes:
    body = b"".join(messages)
    return struct.pack("<BxHII4x", 1, len(messages), 1, len(body)) + body


def _integer(size: int, signed: bool) -> bytes:
    return struct.pack("<BBBBIHH", 0x10, 0x08 if signed else 0, 0, 0, size, 0, 8 * size)


def _is_text(dtype: np.dtype) -> bool:
    return dtype.kind in "USO"


def _datatype(dtype: np.dtype) -> bytes:
    if _is_text(dtype):  # variable-length string (class 9, version 1), UTF-8, of unsigned bytes
        return struct.pack("<BBBBI", 0x19, 0x01, 0x01, 0, 16) + _integer(1, False)
    size = dtype.itemsize
    if dtype.kind == "b":  # h5py's bool: enum (class 8, version 1) of 2 members over int8
        names = _pad8(b"FALSE\0") + _pad8(b"TRUE\0")
        return struct.pack("<BBBBI", 0x18, 2, 0, 0, 1) + _integer(1, True) + names + b"\0\1"
    if dtype.kind == "f":
        ieee = {2: (15, 10, 5, 0, 10, 15), 4: (31, 23, 8, 0, 23, 127), 8: (63, 52, 11, 0, 52, 1023)}
        sign, e_loc, e_size, m_loc, m_size, bias = ieee[size]
        return struct.pack("<BBBBIHHBBBBI", 0x11, 0x20, sign, 0, size, 0, 8 * size, e_loc, e_size,
                           m_loc, m_size, bias)
    return _integer(size, dtype.kind == "i")


def _dataset_header(shape: tuple, dtype: np.dtype, addr: int | None, nbytes: int) -> bytes:
    dims = struct.pack(f"<{len(shape)}Q", *shape)
    where = UNDEF if addr is None else struct.pack("<Q", addr)
    return _object_header([
        _message(1, struct.pack("<BBB5x", 1, len(shape), 1) + dims + dims),  # dataspace, max dims
        _message(3, _datatype(dtype), flags=1),
        _message(5, struct.pack("<BBBBI", 2, 2, 2, 1, 0), flags=1),  # fill value: the default
        _message(8, struct.pack("<BB", 3, 1) + where + struct.pack("<Q", nbytes)),  # contiguous
    ])


def _check_array(name: str, a: np.ndarray) -> None:
    if not name or "/" in name:
        raise ValueError(f"dataset name {name!r}")
    kind, size, order = a.dtype.kind, a.dtype.itemsize, a.dtype.byteorder
    if kind == "O" and not all(isinstance(x, (str, bytes)) for x in a.flat):
        raise ValueError(f"dataset {name}: an object array that is not all str or bytes")
    if kind not in "iufbUSO" or order == ">" or (kind == "f" and size not in (2, 4, 8)):
        raise ValueError(f"dataset {name}: {a.dtype} is not bool, text or a little-endian integer "
                         "or float")


def _utf8(x) -> bytes:
    return x if isinstance(x, bytes) else str(x).encode("utf-8")


def _global_heap(objects: list) -> bytes:
    """A global heap collection of `objects` (bytes each, object i + 1 the
    i-th), at least GCOL_MIN bytes, the rest one free-space object (index 0)."""
    body = b"".join(struct.pack("<HH4xQ", i + 1, 0, len(o)) + _pad8(o) for i, o in enumerate(objects))
    size = max(GCOL_MIN, 16 + len(body) + 16)
    free = size - 16 - len(body)
    return b"GCOL" + struct.pack("<B3xQ", 1, size) + body + struct.pack("<HH4xQ", 0, 0, free) + \
        b"\0" * (free - 16)


class H5Group:
    """A group being written: `create_group`, `create_dataset`, `in`."""

    def __init__(self, writer: "H5Writer", path: str):
        self.writer, self.path = writer, path
        self.members: dict = {}  # name -> ("dataset", header address) or ("group", H5Group)

    def __contains__(self, name) -> bool:
        node = self
        for part in str(name).split("/"):
            if not isinstance(node, H5Group) or part not in node.members:
                return False
            node = node.members[part][1]
        return True

    def create_group(self, name: str) -> "H5Group":
        """The group `name` below this one, and any missing group on its
        path (names separated by "/"); ValueError if it exists."""
        parts = [p for p in str(name).split("/") if p]
        if not parts:
            raise ValueError(f"group name {name!r}")
        node = self
        for i, part in enumerate(parts):
            member = node.members.get(part)
            if member is None:
                member = ("group", H5Group(self.writer, f"{node.path}/{part}"))
                node.members[part] = member
            elif member[0] != "group" or i == len(parts) - 1:
                raise ValueError(f"unable to create group {name!r}: {part!r} exists")
            node = member[1]
        return node

    def create_dataset(self, name: str, data) -> None:
        """Write `data` now as the contiguous dataset `name` of this group."""
        a = np.asarray(data, order="C")
        _check_array(name, a)
        if name in self.members:
            raise ValueError(f"unable to create dataset {name!r}: it exists")
        w = self.writer
        raw = w.vlen_elements(a) if _is_text(a.dtype) else a.tobytes()
        addr = w.append(raw) if raw else None
        self.members[name] = ("dataset", w.append(_dataset_header(a.shape, a.dtype, addr, len(raw))))


class H5Writer(H5Group):
    """A new HDF5 file at `path`, itself the root group; `close()` (or
    leaving a `with` block) writes the groups and the superblock."""

    def __init__(self, path):
        super().__init__(self, "")
        self.fh = open(Path(path), "wb")
        self.fh.write(b"\0" * SUPERBLOCK)  # the superblock, written at close
        self.eof = SUPERBLOCK

    def append(self, data: bytes) -> int:
        """Write `data` at the end of the file (8-byte aligned); its address."""
        addr = self.eof
        self.fh.write(_pad8(data))
        self.eof += len(_pad8(data))
        return addr

    def vlen_elements(self, a: np.ndarray) -> bytes:
        """The strings of `a` written into global heap collections; the
        dataset's elements: (length, collection address, object index)."""
        texts = [_utf8(x) for x in a.flat]
        out = []
        for i in range(0, len(texts), GCOL_OBJECTS):
            chunk = texts[i:i + GCOL_OBJECTS]
            heap = self.append(_global_heap(chunk))
            out += [struct.pack("<IQI", len(t), heap, j + 1) for j, t in enumerate(chunk)]
        return b"".join(out)

    def _write_group(self, group: H5Group) -> bytes:
        """The group's heap, symbol nodes, B-tree and object header, its
        member groups first; its 40-byte symbol entry's header address,
        cache type and scratch pad (the name offset is the parent's)."""
        names = sorted(group.members, key=str.encode)
        entries = {}
        for name in names:
            kind, value = group.members[name]
            if kind == "group":
                entries[name] = self._write_group(value)
            else:
                entries[name] = struct.pack("<QI4x16x", value, 0)
        # local heap data: "" at 0, the names, then one free block (next: none)
        heap_data, offsets = b"\0" * 8, {}
        for name in names:
            offsets[name] = len(heap_data)
            heap_data += _pad8(name.encode() + b"\0")
        free = len(heap_data)
        heap_data += struct.pack("<QQ", 1, 16)
        heap = self.eof
        self.append(b"HEAP" + struct.pack("<B3xQQQ", 0, len(heap_data), free, heap + 32) + heap_data)
        # symbol nodes, then the B-tree's levels: (left key, right key, address) of each child
        children = []
        for i in range(0, len(names), 2 * GROUP_LEAF_K):
            chunk = names[i:i + 2 * GROUP_LEAF_K]
            node = b"SNOD" + struct.pack("<BxH", 1, len(chunk))
            node += b"".join(struct.pack("<Q", offsets[n]) + entries[n] for n in chunk)
            left = offsets[names[i - 1]] if i else 0
            children.append((left, offsets[chunk[-1]], self.append(node + b"\0" * (SNOD - len(node)))))
        level = 0
        while True:
            nodes = [children[i:i + 2 * GROUP_INTERNAL_K]
                     for i in range(0, len(children), 2 * GROUP_INTERNAL_K)] or [[]]
            addrs = [self.eof + j * BTREE for j in range(len(nodes))]
            parents = []
            for j, kids in enumerate(nodes):
                left = struct.pack("<Q", addrs[j - 1]) if j else UNDEF
                right = struct.pack("<Q", addrs[j + 1]) if j + 1 < len(nodes) else UNDEF
                node = b"TREE" + struct.pack("<BBH", 0, level, len(kids)) + left + right
                node += struct.pack("<Q", kids[0][0] if kids else 0)
                node += b"".join(struct.pack("<QQ", addr, rkey) for _, rkey, addr in kids)
                self.append(node + b"\0" * (BTREE - len(node)))
                if kids:
                    parents.append((kids[0][0], kids[-1][1], addrs[j]))
            if len(nodes) == 1:
                btree = addrs[0]
                break
            children, level = parents, level + 1
        header = self.append(_object_header([_message(17, struct.pack("<QQ", btree, heap))]))
        return struct.pack("<QI4xQQ", header, 1, btree, heap)

    def close(self) -> None:
        if self.fh is None:
            return
        root = self._write_group(self)
        head = b"\x89HDF\r\n\x1a\n" + struct.pack("<BBBBBBBBHHI", 0, 0, 0, 0, 0, 8, 8, 0, GROUP_LEAF_K,
                                                 GROUP_INTERNAL_K, 0)
        head += struct.pack("<Q", 0) + UNDEF + struct.pack("<Q", self.eof) + UNDEF
        head += struct.pack("<Q", 0) + root  # the root's entry: name offset 0
        assert len(head) == SUPERBLOCK
        self.fh.seek(0)
        self.fh.write(head)
        self.fh.close()
        self.fh = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def write_datasets(path, arrays: dict) -> None:
    """Write `arrays` ({name: array}, names without "/") as datasets of the
    root group of a new HDF5 file at `path`."""
    if not arrays:
        raise ValueError("no datasets to write")
    with H5Writer(path) as f:
        for name, a in arrays.items():
            f.create_dataset(name, a)
