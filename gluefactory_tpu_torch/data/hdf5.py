"""A numpy reader for the part of HDF5 that h5py writes by default, in the
place of `h5py.File(path)` (MegaDepth's `depth_undistorted/*.h5`, the
posed-images datasets' `h5` depths, the feature caches of
`scripts/export_megadepth.py`). It imports numpy and zlib only.

    depth = read_dataset(path, "/depth")
    with H5File(path) as f:
        if "im0.jpg" in f:
            kpts = f["im0.jpg/keypoints"]      # a dataset: a numpy array
            names = f["im0.jpg"].keys()        # a group: an `H5Group`

`H5File` reads each group's name -> entry table once (a lookup is then a
dict hit) and each dataset's header once, and reads through `os.pread`: no
file offset is shared, so a file opened before a DataLoader forks serves
every worker, and after unpickling the handle opens again.

Read: superblock v0 and v1 (a user block before it too), version-1 object
headers with their continuation blocks, symbol-table groups (v1 B-tree of
symbol nodes, local heap for the names) at any depth of the path, and a
dataset's dataspace, datatype, fill value, layout (version 1-3: compact,
contiguous, or chunked through a v1 B-tree of chunks) and filter pipeline
(deflate, shuffle). Integers of 1-8 bytes and IEEE floats of 2, 4 or 8 bytes,
in either byte order, and h5py's `bool` (an enum of base int8 with members
FALSE = 0 and TRUE = 1) as `np.bool_`. Storage never allocated, and chunks
never written, read as the fill value.

Anything else raises `NotImplementedError` naming what it met (a superblock
v2 or v3, as `libver='latest'` writes, a version-2 object header, a
new-style group, a layout message v4, the szip, nbit, scale-offset or
fletcher32 filter, a string or compound type, any other enum, a shared
message): the reader
never returns an array it could not read whole. A file that is not HDF5
raises `ValueError`.
"""

from __future__ import annotations

import os
import struct
import zlib
from pathlib import Path

import numpy as np

SIGNATURE = b"\x89HDF\r\n\x1a\n"
UNDEFINED = 0xFFFFFFFFFFFFFFFF

# message types of a version-1 object header
NIL, DATASPACE, LINK_INFO, DATATYPE, FILL_OLD, FILL, LINK, LAYOUT, GROUP_INFO = 0, 1, 2, 3, 4, 5, 6, 8, 10
FILTERS, CONTINUATION, SYMBOL_TABLE = 11, 16, 17

FILTER_NAMES = {1: "deflate", 2: "shuffle", 3: "fletcher32", 4: "szip", 5: "nbit", 6: "scale-offset"}


class _File:
    """The superblock's sizes and positioned reads of one open file: `fh`
    is anything with a `fileno()` (a file opened "rb", an `H5File`)."""

    def __init__(self, fh):
        self.fh = fh
        self.base = self._find_superblock()
        head = self.read(self.base + 8, 16, relative=False)
        version = head[0]
        if version > 1:
            raise NotImplementedError(
                f"HDF5 superblock v{version} (libver='latest' or a later low bound): "
                "only superblock v0 and v1 are read")
        self.so, self.sl = head[5], head[6]
        if (self.so, self.sl) not in ((8, 8), (4, 4), (8, 4), (4, 8)):
            raise NotImplementedError(f"HDF5 offsets of {self.so} and lengths of {self.sl} bytes")
        self.group_leaf_k, self.group_internal_k = struct.unpack_from("<HH", head, 8)
        pos = self.base + 24 + (4 if version == 1 else 0)
        base_addr = self.offset(pos)
        if base_addr != 0 and base_addr != self.base:
            raise NotImplementedError(f"HDF5 base address {base_addr} apart from the superblock's")
        # base, free-space, end-of-file and driver addresses, then the root entry
        self.root = self.symbol_entry(pos + 4 * self.so)

    def _find_superblock(self) -> int:
        for pos in (0, 512, 1024, 2048, 4096, 8192, 16384, 32768, 65536):
            if os.pread(self.fh.fileno(), 8, pos) == SIGNATURE:
                return pos
        raise ValueError("not an HDF5 file (no superblock signature)")

    def read(self, addr: int, n: int, relative: bool = True) -> bytes:
        data = os.pread(self.fh.fileno(), n, addr + (self.base if relative else 0)) if n else b""
        if len(data) != n:
            raise ValueError(f"HDF5 file truncated: {n} bytes wanted at {addr}, {len(data)} read")
        return data

    def _uint(self, addr: int, size: int) -> int:
        return int.from_bytes(self.read(addr, size, relative=False), "little")

    def offset(self, pos: int) -> int:
        """An address stored at absolute position `pos`."""
        value = self._uint(pos, self.so)
        return UNDEFINED if value == (1 << (8 * self.so)) - 1 else value

    def symbol_entry(self, pos: int) -> dict:
        """A symbol-table entry at absolute position `pos`."""
        return self.parse_entry(self.read(pos, 2 * self.so + 24, relative=False), 0)

    def parse_entry(self, buf: bytes, pos: int) -> dict:
        """A symbol-table entry at `pos` of `buf`."""
        so = self.so
        undefined = (1 << (8 * so)) - 1
        header = _uint(buf, pos + so, so)
        cache = _uint(buf, pos + 2 * so, 4)
        entry = {"name_offset": _uint(buf, pos, so),
                 "header": UNDEFINED if header == undefined else header, "cache": cache}
        if cache == 1:
            entry["btree"] = _uint(buf, pos + 2 * so + 8, so)
            entry["heap"] = _uint(buf, pos + 3 * so + 8, so)
        return entry


def _uint(buf, pos: int, size: int) -> int:
    return int.from_bytes(buf[pos:pos + size], "little")


def _messages(f: _File, addr: int) -> list:
    """(type, data) of each message of the object header at `addr`,
    continuation blocks followed."""
    head = f.read(addr, 16)
    if head[:4] == b"OHDR":
        raise NotImplementedError("HDF5 version-2 object header (libver='latest'): "
                                  "only version-1 object headers are read")
    if head[0] != 1:
        raise NotImplementedError(f"HDF5 object header version {head[0]}")
    n_msgs, size = struct.unpack_from("<H", head, 2)[0], struct.unpack_from("<I", head, 8)[0]
    blocks = [(addr + 16, size)]
    out = []
    while blocks and len(out) < n_msgs:
        start, length = blocks.pop(0)
        buf = f.read(start, length)
        pos = 0
        while pos + 8 <= length and len(out) < n_msgs:
            mtype, msize, flags = struct.unpack_from("<HHB", buf, pos)
            data = buf[pos + 8:pos + 8 + msize]
            pos += 8 + msize
            if flags & 0x02:
                raise NotImplementedError(f"HDF5 shared message (type {mtype})")
            if mtype == CONTINUATION:
                blocks.append((_uint(data, 0, f.so), _uint(data, f.so, f.sl)))
            out.append((mtype, data))
    return out


def _local_heap(f: _File, addr: int) -> bytes:
    head = f.read(addr, 8 + 2 * f.sl + f.so)
    if head[:4] != b"HEAP":
        raise ValueError(f"HDF5 local heap expected at {addr}")
    size = _uint(head, 8, f.sl)
    data_addr = _uint(head, 8 + 2 * f.sl, f.so)
    return f.read(data_addr, size)


def _heap_name(heap: bytes, offset: int) -> str:
    end = heap.index(b"\0", offset)
    return heap[offset:end].decode("utf-8")


def _btree_children(f: _File, addr: int, node_type: int, key_size: int) -> list:
    """(key bytes left of the child, child address) of every leaf entry of
    the v1 B-tree at `addr`, in order."""
    head = f.read(addr, 8 + 2 * f.so)
    if head[:4] != b"TREE":
        raise ValueError(f"HDF5 v1 B-tree node expected at {addr}")
    if head[4] != node_type:
        raise ValueError(f"HDF5 B-tree node of type {head[4]}, expected {node_type}")
    level, used = head[5], struct.unpack_from("<H", head, 6)[0]
    body = f.read(addr + 8 + 2 * f.so, used * (key_size + f.so) + key_size)
    out = []
    for i in range(used):
        pos = i * (key_size + f.so)
        key = body[pos:pos + key_size]
        child = _uint(body, pos + key_size, f.so)
        if level > 0:
            out += _btree_children(f, child, node_type, key_size)
        else:
            out.append((key, child))
    return out


def _group_table(f: _File, btree: int, heap_addr: int) -> dict:
    """{name: symbol entry} of every member of a symbol-table group."""
    heap = _local_heap(f, heap_addr)
    entry_size = 2 * f.so + 24
    table = {}
    for _, snod in _btree_children(f, btree, 0, f.sl):
        head = f.read(snod, 8)
        if head[:4] != b"SNOD":
            raise ValueError(f"HDF5 symbol table node expected at {snod}")
        n = struct.unpack_from("<H", head, 6)[0]
        body = f.read(snod + 8, n * entry_size)
        for i in range(n):
            entry = f.parse_entry(body, i * entry_size)
            table[_heap_name(heap, entry["name_offset"])] = entry
    return table


def _group_lookup(f: _File, btree: int, heap_addr: int, name: str) -> dict:
    return _group_table(f, btree, heap_addr)[name]


def _datatype(data: bytes) -> np.dtype:
    cls, version = data[0] & 0x0F, data[0] >> 4
    bits = data[1] | (data[2] << 8) | (data[3] << 16)
    size = struct.unpack_from("<I", data, 4)[0]
    order = ">" if bits & 1 else "<"
    if cls == 0:  # fixed-point
        offset, precision = struct.unpack_from("<HH", data, 8)
        if size not in (1, 2, 4, 8) or offset != 0 or precision != 8 * size:
            raise NotImplementedError(f"HDF5 integer of {size} bytes, bit offset {offset}, "
                                      f"precision {precision}")
        return np.dtype(f"{order}{'i' if bits & 0x08 else 'u'}{size}")
    if cls == 1:  # IEEE floating point
        if bits & 0x40:
            raise NotImplementedError("HDF5 float in VAX byte order")
        offset, precision, e_loc, e_size, m_loc, m_size = struct.unpack_from("<HHBBBB", data, 8)
        bias = struct.unpack_from("<I", data, 16)[0]
        ieee = {2: (15, 10, 5, 0, 10, 15), 4: (31, 23, 8, 0, 23, 127), 8: (63, 52, 11, 0, 52, 1023)}
        sign = (bits >> 8) & 0xFF
        if size not in ieee or offset != 0 or precision != 8 * size or \
                (sign, e_loc, e_size, m_loc, m_size, bias) != ieee[size]:
            raise NotImplementedError(f"HDF5 float of {size} bytes that is not IEEE 754")
        return np.dtype(f"{order}f{size}")
    if cls == 8 and version in (1, 2) and _is_h5py_bool(data, size):
        return np.dtype(bool)
    names = {2: "time", 3: "string", 4: "bitfield", 5: "opaque", 6: "compound", 7: "reference",
             8: "enum", 9: "variable-length", 10: "array"}
    raise NotImplementedError(f"HDF5 {names.get(cls, f'class {cls}')} datatype (version {version})")


def _is_h5py_bool(data: bytes, size: int) -> bool:
    """Whether an enum datatype message (version 1 or 2) is h5py's `bool`:
    one byte, base int8, members FALSE = 0 and TRUE = 1 (in either order)."""
    n_members = data[1] | (data[2] << 8)
    base = data[8:20]  # an integer's message: 8 bytes of header, 4 of properties
    if size != 1 or n_members != 2 or base[0] != 0x10 or not base[1] & 0x08 or \
            struct.unpack_from("<I", base, 4)[0] != 1:
        return False
    names, pos = [], 20
    for _ in range(n_members):
        end = data.index(b"\0", pos)
        names.append(data[pos:end])
        pos += (end - pos + 8) // 8 * 8  # the name and its NUL, padded to 8 bytes
    return dict(zip(names, data[pos:pos + 2])) == {b"FALSE": 0, b"TRUE": 1}


def _dataspace(data: bytes, sl: int) -> tuple:
    version, rank = data[0], data[1]
    if version == 1:
        pos = 8
    elif version == 2:
        if data[3] == 2:
            raise NotImplementedError("HDF5 null dataspace")
        pos = 4
    else:
        raise NotImplementedError(f"HDF5 dataspace message version {version}")
    return tuple(_uint(data, pos + i * sl, sl) for i in range(rank))


def _fill_value(mtype: int, data: bytes):
    """The fill value's bytes, or None for the default (zeros)."""
    if mtype == FILL_OLD:
        size = struct.unpack_from("<I", data, 0)[0]
        return data[4:4 + size] if size else None
    version = data[0]
    if version in (1, 2):
        defined = data[3]
        if version == 1 or defined:
            size = struct.unpack_from("<I", data, 4)[0]
            return data[8:8 + size] if defined and size else None
        return None
    if version == 3:
        flags = data[1]
        if flags & 0x20:
            size = struct.unpack_from("<I", data, 2)[0]
            return data[6:6 + size] if size else None
        return None
    raise NotImplementedError(f"HDF5 fill value message version {version}")


def _filters(data: bytes) -> list:
    """(id, client data) of each filter of a filter pipeline message."""
    version, n = data[0], data[1]
    pos = 8 if version == 1 else 2
    out = []
    for _ in range(n):
        fid = struct.unpack_from("<H", data, pos)[0]
        if version == 1 or fid >= 256:
            name_len = struct.unpack_from("<H", data, pos + 2)[0]
            pos += 2
        else:
            name_len = 0
        n_vals = struct.unpack_from("<H", data, pos + 4)[0]
        pos += 6
        if version == 1:
            name_len = (name_len + 7) // 8 * 8
        pos += name_len
        values = struct.unpack_from(f"<{n_vals}I", data, pos)
        pos += 4 * n_vals + (4 if version == 1 and n_vals % 2 else 0)
        if fid not in (1, 2):
            raise NotImplementedError(f"HDF5 filter {FILTER_NAMES.get(fid, fid)}: "
                                      "only deflate and shuffle are read")
        out.append((fid, values))
    return out


def _unfilter(raw: bytes, filters: list, mask: int, itemsize: int) -> bytes:
    """The pipeline undone, last filter first; filter i is skipped where
    bit i of the chunk's mask is set."""
    for i in reversed(range(len(filters))):
        if mask & (1 << i):
            continue
        fid, values = filters[i]
        if fid == 1:
            raw = zlib.decompress(raw)
        else:
            size = values[0] if values else itemsize
            n = len(raw) // size
            planes = np.frombuffer(raw, np.uint8, n * size).reshape(size, n)
            raw = planes.T.tobytes() + raw[n * size:]
    return raw


def _layout(data: bytes, so: int, sl: int) -> dict:
    version = data[0]
    if version in (1, 2):
        rank, cls = data[1], data[2]
        pos = 8
        addr = UNDEFINED if cls == 0 else _uint(data, pos, so)
        pos += 0 if cls == 0 else so
        dims = struct.unpack_from(f"<{rank}I", data, pos)
        pos += 4 * rank
        if cls == 0:
            size = struct.unpack_from("<I", data, pos)[0]
            return {"class": 0, "raw": data[pos + 4:pos + 4 + size]}
        if cls == 1:
            return {"class": 1, "address": addr}
        return {"class": 2, "address": addr, "chunk": dims[:-1]}
    if version == 3:
        cls = data[1]
        if cls == 0:
            size = struct.unpack_from("<H", data, 2)[0]
            return {"class": 0, "raw": data[4:4 + size]}
        if cls == 1:
            addr = _uint(data, 2, so)
            return {"class": 1, "address": UNDEFINED if addr == (1 << 8 * so) - 1 else addr}
        if cls == 2:
            rank = data[2]
            addr = _uint(data, 3, so)
            dims = struct.unpack_from(f"<{rank}I", data, 3 + so)
            return {"class": 2, "address": UNDEFINED if addr == (1 << 8 * so) - 1 else addr,
                    "chunk": dims[:-1]}
        raise NotImplementedError(f"HDF5 layout class {cls}")
    raise NotImplementedError(f"HDF5 layout message version {version} (libver 'v110' or later "
                              "chunk indexes): only versions 1-3 are read")


def _read_chunked(f: _File, layout: dict, shape: tuple, dtype: np.dtype, filters: list,
                  out: np.ndarray) -> None:
    chunk = tuple(layout["chunk"])
    rank = len(shape)
    if len(chunk) != rank:
        raise ValueError(f"HDF5 chunk rank {len(chunk)} for a dataset of rank {rank}")
    if layout["address"] == UNDEFINED:
        return
    key_size = 8 + 8 * (rank + 1)
    n_chunk = int(np.prod(chunk)) * dtype.itemsize
    for key, addr in _btree_children(f, layout["address"], 1, key_size):
        size, mask = struct.unpack_from("<II", key, 0)
        offsets = struct.unpack_from(f"<{rank}Q", key, 8)
        raw = _unfilter(f.read(addr, size), filters, mask, dtype.itemsize)
        if len(raw) != n_chunk:
            raise ValueError(f"HDF5 chunk at {offsets} holds {len(raw)} bytes, not {n_chunk}")
        block = np.frombuffer(raw, dtype).reshape(chunk)
        # edge chunks are stored at the full chunk size
        sl = tuple(slice(o, min(o + c, s)) for o, c, s in zip(offsets, chunk, shape))
        out[sl] = block[tuple(slice(0, s.stop - s.start) for s in sl)]


def _dataset_meta(f: _File, messages: list) -> dict:
    """Shape, dtype, layout, fill value and filters of a dataset's header."""
    meta = {"shape": None, "dtype": None, "layout": None, "fill": None, "filters": []}
    for mtype, data in messages:
        if mtype == DATASPACE:
            meta["shape"] = _dataspace(data, f.sl)
        elif mtype == DATATYPE:
            meta["dtype"] = _datatype(data)
        elif mtype == LAYOUT:
            meta["layout"] = _layout(data, f.so, f.sl)
        elif mtype in (FILL_OLD, FILL):
            value = _fill_value(mtype, data)
            meta["fill"] = value if value is not None or mtype == FILL else meta["fill"]
        elif mtype == FILTERS:
            meta["filters"] = _filters(data)
        elif mtype == SYMBOL_TABLE:
            raise IsADirectoryError("an HDF5 group, not a dataset")
    if meta["shape"] is None or meta["dtype"] is None or meta["layout"] is None:
        raise ValueError("HDF5 object is not a dataset (no dataspace, datatype or layout)")
    if meta["fill"] is not None and len(meta["fill"]) != meta["dtype"].itemsize:
        raise ValueError(f"HDF5 fill value of {len(meta['fill'])} bytes for {meta['dtype']}")
    return meta


def _read_data(f: _File, meta: dict) -> np.ndarray:
    shape, dtype, layout, fill = meta["shape"], meta["dtype"], meta["layout"], meta["fill"]
    n = int(np.prod(shape))
    out = np.full(shape, np.frombuffer(fill, dtype)[0] if fill is not None else 0, dtype)
    if layout["class"] == 0:
        out[...] = np.frombuffer(layout["raw"], dtype, n).reshape(shape)
    elif layout["class"] == 1:
        if meta["filters"]:
            raise ValueError("HDF5 filters on a contiguous dataset")
        if layout["address"] != UNDEFINED and n:
            out[...] = np.frombuffer(f.read(layout["address"], n * dtype.itemsize), dtype).reshape(shape)
    else:
        _read_chunked(f, layout, shape, dtype, meta["filters"], out)
    return out.astype(dtype.newbyteorder("="), copy=False)


def _read_dataset(f: _File, header: int) -> np.ndarray:
    return _read_data(f, _dataset_meta(f, _messages(f, header)))


class H5Group:
    """A group of an open `H5File`: `in`, `keys()` (in HDF5's name order,
    as h5py lists them) and `[name]` for a member (a group or a dataset's
    array)."""

    def __init__(self, file: "H5File", path: str, table: dict):
        self.file, self.path, self._table = file, path, table

    def __contains__(self, name) -> bool:
        return f"{self.path}/{name}" in self.file

    def keys(self) -> list:
        return sorted(self._table, key=str.encode)

    def __getitem__(self, name):
        return self.file[f"{self.path}/{name}"]


class H5File:
    """An HDF5 file open for reading: `in`, `keys()`, `[path]` (a group as
    an `H5Group`, a dataset as a numpy array in the native byte order; a
    path of groups from the root, e.g. "a/b.jpg/keypoints"), `close()`,
    and use as a context manager. Group tables and dataset headers are
    read once; reads are positioned (`os.pread`), and the handle opens
    again in a process that did not open it (a spawned or unpickled copy)."""

    def __init__(self, path):
        self.path = Path(path)
        self._fh, self._pid = None, None
        self._f = _File(self)
        self._objects: dict = {}  # header address -> ("group", table) or ("dataset", meta)

    def fileno(self) -> int:
        if self._fh is None or self._pid != os.getpid():
            self._fh, self._pid = open(self.path, "rb"), os.getpid()
        return self._fh.fileno()

    def close(self) -> None:
        if self._fh is not None and self._pid == os.getpid():
            self._fh.close()
        self._fh = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __getstate__(self):
        return {**self.__dict__, "_fh": None, "_pid": None}

    def _object(self, entry: dict) -> tuple:
        header = entry["header"]
        if header not in self._objects:
            if entry.get("cache") == 1:
                obj = ("group", _group_table(self._f, entry["btree"], entry["heap"]))
            else:
                messages = _messages(self._f, header)
                kinds = {mtype for mtype, _ in messages}
                if SYMBOL_TABLE in kinds:
                    data = next(d for mtype, d in messages if mtype == SYMBOL_TABLE)
                    obj = ("group", _group_table(self._f, _uint(data, 0, self._f.so),
                                                 _uint(data, self._f.so, self._f.so)))
                elif kinds & {LINK_INFO, LINK}:
                    raise NotImplementedError("HDF5 new-style group (link messages, libver 'v18' or "
                                              "later): only symbol-table groups are read")
                else:
                    obj = ("dataset", _dataset_meta(self._f, messages))
            self._objects[header] = obj
        return self._objects[header]

    def _resolve(self, key: str) -> tuple:
        """(path, kind, table or meta) of `key`; KeyError where a name is
        missing or a dataset stands where a group is wanted."""
        names = [n for n in str(key).split("/") if n]
        kind, obj = self._object(self._f.root)
        for i, name in enumerate(names):
            if kind != "group" or name not in obj:
                raise KeyError(f"{'/'.join(names[:i + 1])} not found in {self.path}")
            kind, obj = self._object(obj[name])
        return "/".join(names), kind, obj

    def __contains__(self, key) -> bool:
        try:
            self._resolve(key)
        except KeyError:
            return False
        return True

    def keys(self) -> list:
        return self["/"].keys()

    def __getitem__(self, key):
        path, kind, obj = self._resolve(key)
        if kind == "group":
            return H5Group(self, path, obj)
        return _read_data(self._f, obj)


def read_dataset(path, key: str = "/depth") -> np.ndarray:
    """The dataset `key` (a path of groups from the root, e.g. "/depth" or
    "a/b/depth") of the HDF5 file at `path`, as a numpy array in the native
    byte order."""
    with H5File(path) as f:
        value = f[key]
    if isinstance(value, H5Group):
        raise IsADirectoryError(f"{key} in {path} is an HDF5 group, not a dataset")
    return value
