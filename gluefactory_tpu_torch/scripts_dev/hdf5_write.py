"""A minimal HDF5 writer for test and chip fixtures, where h5py is absent:
the subset that `data/hdf5.py` reads and h5py writes by default, laid out
as h5py lays out a small file.

    write_datasets(path, {"depth": depth})

Superblock v0 (8-byte addresses and lengths), a root symbol-table group
(one v1 B-tree leaf, one local heap, one symbol node of up to 8 entries,
names sorted as HDF5 searches them), and each dataset in a version-1 object
header (dataspace v1, datatype v1, fill value v2, layout v3 contiguous),
its data after the metadata. Little-endian integers of 1-8 bytes and
float16/32/64; C order. h5py reads the files it writes
(`tests/test_torch_hdf5.py`).
"""

from __future__ import annotations

import struct
from pathlib import Path

import numpy as np

UNDEF = b"\xff" * 8
GROUP_LEAF_K, GROUP_INTERNAL_K = 4, 16
ENTRY = 40  # symbol-table entry: name offset, header, cache type, reserved, scratch
BTREE = 24 + (2 * GROUP_INTERNAL_K + 1) * 8 + 2 * GROUP_INTERNAL_K * 8
SNOD = 8 + 2 * GROUP_LEAF_K * ENTRY


def _pad8(b: bytes) -> bytes:
    return b + b"\0" * (-len(b) % 8)


def _message(mtype: int, data: bytes, flags: int = 0) -> bytes:
    data = _pad8(data)
    return struct.pack("<HHB3x", mtype, len(data), flags) + data


def _object_header(messages: list) -> bytes:
    body = b"".join(messages)
    return struct.pack("<BxHII4x", 1, len(messages), 1, len(body)) + body


def _datatype(dtype: np.dtype) -> bytes:
    size = dtype.itemsize
    if dtype.kind == "f":
        ieee = {2: (15, 10, 5, 0, 10, 15), 4: (31, 23, 8, 0, 23, 127), 8: (63, 52, 11, 0, 52, 1023)}
        sign, e_loc, e_size, m_loc, m_size, bias = ieee[size]
        return struct.pack("<BBBBIHHBBBBI", 0x11, 0x20, sign, 0, size, 0, 8 * size, e_loc, e_size,
                           m_loc, m_size, bias)
    signed = 0x08 if dtype.kind == "i" else 0
    return struct.pack("<BBBBIHH", 0x10, signed, 0, 0, size, 0, 8 * size)


def _dataset_header(shape: tuple, dtype: np.dtype, addr: int, nbytes: int) -> bytes:
    dims = struct.pack(f"<{len(shape)}Q", *shape)
    return _object_header([
        _message(1, struct.pack("<BBB5x", 1, len(shape), 1) + dims + dims),  # dataspace, max dims
        _message(3, _datatype(dtype), flags=1),
        _message(5, struct.pack("<BBBBI", 2, 2, 2, 1, 0), flags=1),  # fill value: the default
        _message(8, struct.pack("<BBQQ", 3, 1, addr, nbytes)),  # contiguous layout
    ])


def write_datasets(path, arrays: dict) -> None:
    """Write `arrays` ({name: array}, names without "/") as datasets of the
    root group of a new HDF5 file at `path`."""
    arrays = {k: np.asarray(v, order="C") for k, v in sorted(arrays.items(), key=lambda kv: kv[0].encode())}
    if not 0 < len(arrays) <= 2 * GROUP_LEAF_K:
        raise ValueError(f"1 to {2 * GROUP_LEAF_K} datasets, not {len(arrays)}")
    for name, a in arrays.items():
        if not name or "/" in name:
            raise ValueError(f"dataset name {name!r}")
        if a.dtype.kind not in "iuf" or a.dtype.byteorder == ">" or \
                (a.dtype.kind == "f" and a.dtype.itemsize not in (2, 4, 8)):
            raise ValueError(f"dataset {name}: {a.dtype} is not a little-endian integer or float")

    # local heap data: "" at 0, the names, then one free block
    heap_data, offsets = b"\0" * 8, {}
    for name in arrays:
        offsets[name] = len(heap_data)
        heap_data += _pad8(name.encode() + b"\0")
    free = len(heap_data)
    heap_data += struct.pack("<QQ", 1, 16)  # the last free block (next: none), 16 bytes
    root_header = 96
    btree = root_header + 16 + 24
    heap = btree + BTREE
    heap_data_addr = heap + 32
    snod = heap_data_addr + len(heap_data)
    headers, pos = {}, snod + SNOD
    sizes = {name: len(_dataset_header(a.shape, a.dtype, 0, 0)) for name, a in arrays.items()}
    for name in arrays:
        headers[name] = pos
        pos += sizes[name]
    data_addr = {}
    for name, a in arrays.items():
        data_addr[name] = pos
        pos += len(_pad8(a.tobytes()))
    eof = pos

    root_entry = struct.pack("<QQI4xQQ", 0, root_header, 1, btree, heap)
    out = bytearray()
    out += b"\x89HDF\r\n\x1a\n" + struct.pack("<BBBBBBBBHHI", 0, 0, 0, 0, 0, 8, 8, 0, GROUP_LEAF_K,
                                               GROUP_INTERNAL_K, 0)
    out += struct.pack("<Q", 0) + UNDEF + struct.pack("<Q", eof) + UNDEF + root_entry
    out += _object_header([_message(17, struct.pack("<QQ", btree, heap))])
    node = b"TREE" + struct.pack("<BBH", 0, 0, 1) + UNDEF + UNDEF
    node += struct.pack("<QQQ", 0, snod, offsets[list(arrays)[-1]])
    out += node + b"\0" * (BTREE - len(node))
    out += b"HEAP" + struct.pack("<B3xQQQ", 0, len(heap_data), free, heap_data_addr) + heap_data
    node = b"SNOD" + struct.pack("<BxH", 1, len(arrays))
    node += b"".join(struct.pack("<QQI4x16x", offsets[n], headers[n], 0) for n in arrays)
    out += node + b"\0" * (SNOD - len(node))
    for name, a in arrays.items():
        out += _dataset_header(a.shape, a.dtype, data_addr[name], a.nbytes)
    for a in arrays.values():
        out += _pad8(a.tobytes())
    assert len(out) == eof
    Path(path).write_bytes(bytes(out))
