"""The port's HDF5 reader (`gluefactory_tpu_torch/data/hdf5.py`) against
h5py on files h5py writes by default: every dtype, layout, filter and group
depth it reads gives h5py's array exactly (bit for bit, dtype included,
in the native byte order); what it does not read raises
`NotImplementedError`. And h5py reads the package writer's files
(`utils/hdf5_write.py`) equal to what was written."""

import h5py
import numpy as np
import pytest

from gluefactory_tpu_torch.data import hdf5
from gluefactory_tpu_torch.data.hdf5 import H5File, H5Group, read_dataset
from gluefactory_tpu_torch.utils.hdf5_write import H5Writer, write_datasets

DTYPES = ["<f4", "<f8", "<u2", ">f4", ">f8", ">i4", "<i8", "<f2", "u1", "<i2"]
LAYOUTS = {
    "contiguous": {},
    "chunked": {"chunks": True},
    "gzip": {"compression": "gzip", "chunks": True},
    # chunks that leave edge chunks on every axis
    "gzip_shuffle_edges": {"compression": "gzip", "compression_opts": 9, "shuffle": True, "chunks": 4},
    "shuffle_edges": {"shuffle": True, "chunks": 5},
}
SHAPES = [(37, 53), (5, 7, 9)]


def _array(rng, dtype, shape):
    dtype = np.dtype(dtype)
    if dtype.kind == "f":
        return (rng.normal(size=shape) * 100).astype(dtype)
    info = np.iinfo(dtype)
    return rng.integers(info.min, info.max, shape, endpoint=True).astype(dtype)


def _h5py_read(path, key):
    with h5py.File(path, "r") as f:
        return f[key][...]


def _assert_same(got, want):
    assert got.dtype == want.dtype.newbyteorder("=")
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("dtype", DTYPES)
def test_reads_what_h5py_reads(tmp_path, dtype, layout):
    rng = np.random.default_rng(abs(hash((dtype, layout))) % 2**32)
    path = tmp_path / "f.h5"
    arrays = {}
    with h5py.File(path, "w") as f:
        for i, shape in enumerate(SHAPES):
            kw = dict(LAYOUTS[layout])
            if isinstance(kw.get("chunks"), int):
                kw["chunks"] = (kw["chunks"],) * len(shape)
            arrays[f"/d{i}"] = _array(rng, dtype, shape)
            f.create_dataset(f"d{i}", data=arrays[f"/d{i}"], **kw)
            key = f"/g{i}/inner/deeper/depth"
            arrays[key] = _array(rng, dtype, shape)
            f.create_dataset(key, data=arrays[key], **kw)
    for key, a in arrays.items():
        want = _h5py_read(path, key)
        np.testing.assert_array_equal(want, a)
        _assert_same(read_dataset(path, key), want)
        _assert_same(read_dataset(path, key.lstrip("/")), want)


def test_many_names_and_groups(tmp_path):
    """Enough entries that the group B-trees split into several symbol
    nodes and levels; names found through the local heaps."""
    path = tmp_path / "many.h5"
    with h5py.File(path, "w") as f:
        for i in range(300):
            f.create_dataset(f"g{i % 7}/x{i}", data=np.full((3,), i, np.int32))
        f.create_dataset("depth", data=np.arange(6.0).reshape(2, 3))
    for i in (0, 45, 178, 299):
        _assert_same(read_dataset(path, f"g{i % 7}/x{i}"), _h5py_read(path, f"g{i % 7}/x{i}"))
    _assert_same(read_dataset(path, "/depth"), _h5py_read(path, "/depth"))


def test_many_chunks(tmp_path):
    """A chunk B-tree of several levels (5000 one-element chunks)."""
    path = tmp_path / "chunks.h5"
    a = np.arange(5000, dtype=np.float32).reshape(50, 100)
    with h5py.File(path, "w") as f:
        f.create_dataset("d", data=a, chunks=(1, 1), compression="gzip")
    _assert_same(read_dataset(path, "d"), _h5py_read(path, "d"))


def test_fill_values_scalars_and_user_block(tmp_path):
    path = tmp_path / "fill.h5"
    with h5py.File(path, "w", userblock_size=512) as f:
        d = f.create_dataset("partial", shape=(10, 10), dtype="f4", fillvalue=3.5, chunks=(4, 4))
        d[:4, :4] = 1.0
        f.create_dataset("never", shape=(3, 2), dtype="<i2", fillvalue=-7)
        f.create_dataset("scalar", data=np.float64(2.25))
        f.create_dataset("empty", data=np.zeros((0, 4), np.float32))
    for key in ("partial", "never", "scalar", "empty"):
        _assert_same(read_dataset(path, key), _h5py_read(path, key))


def test_depth_map_as_megadepth_stores_it(tmp_path):
    """MegaDepth's `depth_undistorted/<scene>/<stem>.h5`: one float32
    `/depth` dataset, written by h5py with its defaults."""
    rng = np.random.default_rng(0)
    depth = rng.uniform(0, 50, (1200, 1600)).astype(np.float32)
    depth[rng.random(depth.shape) < 0.3] = 0
    with h5py.File(tmp_path / "im.h5", "w") as f:
        f.create_dataset("/depth", data=depth)
    _assert_same(read_dataset(tmp_path / "im.h5", "/depth"), depth)


def test_bool_is_read_and_other_enums_raise(tmp_path):
    """h5py's `bool` (an enum of base int8, FALSE = 0 and TRUE = 1) reads
    as `np.bool_`, empty too; an enum of other members or base raises."""
    path = tmp_path / "enum.h5"
    rng = np.random.default_rng(3)
    with h5py.File(path, "w") as f:
        f.create_dataset("flags", data=rng.random((17, 3)) > 0.5)
        f.create_dataset("none", data=np.zeros(0, bool))
        f.create_dataset("chunked", data=rng.random(100) > 0.2, chunks=(7,), compression="gzip")
        f.create_dataset("colour", data=np.array([0, 2, 1], np.int8),
                         dtype=h5py.enum_dtype({"RED": 0, "GREEN": 1, "BLUE": 2}, basetype="i1"))
        f.create_dataset("wide", data=np.array([0, 1], np.int32),
                         dtype=h5py.enum_dtype({"FALSE": 0, "TRUE": 1}, basetype="i4"))
    for key in ("flags", "none", "chunked"):
        _assert_same(read_dataset(path, key), _h5py_read(path, key))
        assert read_dataset(path, key).dtype == np.bool_
    for key in ("colour", "wide"):
        with pytest.raises(NotImplementedError, match="enum"):
            read_dataset(path, key)


def test_open_file_lists_and_reads_many_nested_groups(tmp_path):
    """`H5File` on an h5py file with 400 groups at the root (a B-tree of
    two levels), nested names and datasets beside groups: `keys()` in
    h5py's order, `in`, groups as `H5Group`, datasets as arrays."""
    path = tmp_path / "groups.h5"
    rng = np.random.default_rng(4)
    want = {}
    with h5py.File(path, "w") as f:
        for i in range(400):
            name = f"im{i:03d}.jpg" if i % 5 else f"dir{i % 3}/sub/im{i:03d}.jpg"
            want[name] = rng.normal(size=(i % 9, 2)).astype(np.float16)
            f.create_group(name).create_dataset("keypoints", data=want[name])
        f.create_dataset("top", data=np.arange(4))
        top_keys = list(f.keys())
        dir_keys = list(f["dir0/sub"].keys())
    with H5File(path) as f:
        assert f.keys() == top_keys and f["dir0/sub"].keys() == dir_keys
        assert isinstance(f["dir1"], H5Group) and "sub" in f["dir1"] and "im000.jpg" not in f["dir1"]
        assert "top" in f and "nope.jpg" not in f and "top/x" not in f
        _assert_same(f["top"], np.arange(4))
        for name, a in want.items():
            assert name in f and "keypoints" in f[name]
            _assert_same(f[name]["keypoints"], a)
            _assert_same(f[f"/{name}/keypoints"], a)
        with pytest.raises(KeyError):
            f["dir0/missing.jpg"]


@pytest.mark.parametrize("libver", ["latest", "v108", "v110"])
def test_later_formats_raise(tmp_path, libver):
    path = tmp_path / "late.h5"
    with h5py.File(path, "w", libver=libver) as f:
        f.create_dataset("depth", data=np.ones(3))
    with pytest.raises(NotImplementedError, match="superblock v[23]"):
        read_dataset(path, "depth")


def _patched_filter(tmp_path, filter_id):
    """A gzip-filtered file with the pipeline's filter id replaced."""
    path = tmp_path / "filt.h5"
    with h5py.File(path, "w") as f:
        f.create_dataset("d", data=np.ones((30, 30)), compression="gzip", chunks=(8, 8))
    with open(path, "rb") as fh:
        f = hdf5._File(fh)
        entry = hdf5._group_lookup(f, f.root["btree"], f.root["heap"], "d")
        pipeline = next(data for mtype, data in hdf5._messages(f, entry["header"])
                        if mtype == hdf5.FILTERS)
    raw = bytearray(path.read_bytes())
    at = raw.find(pipeline)
    assert at > 0 and raw[at + 8] == 1  # version 1: the first filter's id after 8 bytes
    raw[at + 8] = filter_id
    path.write_bytes(bytes(raw))
    return path


@pytest.mark.parametrize("filter_id,name", [(4, "szip"), (3, "fletcher32"), (5, "nbit")])
def test_unsupported_filters_raise(tmp_path, filter_id, name):
    with pytest.raises(NotImplementedError, match=name):
        read_dataset(_patched_filter(tmp_path, filter_id), "d")


def test_other_refusals(tmp_path):
    path = tmp_path / "f.h5"
    with h5py.File(path, "w") as f:
        f.create_dataset("lzf", data=np.ones((30, 30)), compression="lzf")
        f.create_dataset("fl32", data=np.ones((30, 30)), fletcher32=True)
        f.create_dataset("text", data="abc")
        f.create_dataset("pairs", data=np.zeros(3, [("a", "<f4"), ("b", "<i4")]))
        f.create_group("grp")
    with pytest.raises(NotImplementedError, match="32000"):
        read_dataset(path, "lzf")
    with pytest.raises(NotImplementedError, match="fletcher32"):
        read_dataset(path, "fl32")
    with pytest.raises(NotImplementedError, match="variable-length|string"):
        read_dataset(path, "text")
    with pytest.raises(NotImplementedError, match="compound"):
        read_dataset(path, "pairs")
    with pytest.raises(IsADirectoryError):
        read_dataset(path, "grp")
    with pytest.raises(KeyError, match="missing"):
        read_dataset(path, "grp/missing")
    (tmp_path / "not.h5").write_bytes(b"not an hdf5 file" * 8)
    with pytest.raises(ValueError, match="not an HDF5 file"):
        read_dataset(tmp_path / "not.h5", "depth")


def test_new_style_groups_raise(tmp_path):
    path = tmp_path / "new.h5"
    with h5py.File(path, "w", libver=("earliest", "latest")) as f:
        g = f.create_group("g", track_order=True)  # link messages, not a symbol table
        g.create_dataset("d", data=np.ones(2))
    with pytest.raises(NotImplementedError, match="new-style group|version-2 object header"):
        read_dataset(path, "g/d")


@pytest.mark.parametrize("dtype", ["<f4", "<f8", "<u2", "<i8", "<f2", "u1"])
def test_writer_output_reads_in_h5py(tmp_path, dtype):
    rng = np.random.default_rng(1)
    arrays = {"depth": _array(rng, dtype, (120, 160)), "b": _array(rng, dtype, (3, 4, 5)),
              "a": _array(rng, dtype, (7,)), "scalar": _array(rng, dtype, ())}
    path = tmp_path / "w.h5"
    write_datasets(path, arrays)
    with h5py.File(path, "r") as f:
        assert sorted(f) == sorted(arrays)
        for k, a in arrays.items():
            assert f[k].dtype == a.dtype and f[k].shape == a.shape
            np.testing.assert_array_equal(f[k][...], a)
    for k, a in arrays.items():
        _assert_same(read_dataset(path, "/" + k), a)


def test_writer_refuses_what_it_does_not_write(tmp_path):
    with pytest.raises(ValueError):
        write_datasets(tmp_path / "x.h5", {"a/b": np.ones(2)})
    with pytest.raises(ValueError):
        write_datasets(tmp_path / "x.h5", {"a": np.ones(2, ">f4")})
    with pytest.raises(ValueError):
        write_datasets(tmp_path / "x.h5", {"a": np.array(["text"])})
    with pytest.raises(ValueError):
        write_datasets(tmp_path / "x.h5", {})
    with H5Writer(tmp_path / "y.h5") as f:
        g = f.create_group("g")
        g.create_dataset("d", data=np.ones(2))
        with pytest.raises(ValueError):  # a group twice
            f.create_group("g")
        with pytest.raises(ValueError):  # a group where a dataset is
            f.create_group("g/d")
        with pytest.raises(ValueError):  # a dataset twice
            g.create_dataset("d", data=np.ones(2))
