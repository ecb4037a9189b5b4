"""tps_torch's HDF5 subset reader and writer (io/h5lite.py) against h5py.

h5py reads what h5lite writes (the same attributes and dtypes, datasets
bit for bit); h5lite reads what h5py writes with the earliest file format,
and every .h5 file in the repo, bit for bit; files outside the subset
(chunked, compressed, compact, the newer superblock and group formats,
other dtypes) raise a ValueError that names what was found.
"""

import os

import numpy as np
import pytest

h5py = pytest.importorskip("h5py")

from tps_torch.io import h5lite  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO_FILES = ["tests/ref_solns/argon_minimal.4iters.h5",
              "tests/ref_solns/vortex2d.5iters.h5",
              "examples/cases/lte_table.h5", "examples/cases/nec_table.h5"]


def _tree(seed):
    """A checkpoint-like tree: root attributes, /solution with more names
    than one symbol-table node holds, a 2-D table, an int64 dataset, an
    empty group, names that sort differently as bytes and as text."""
    rng = np.random.default_rng(seed)
    sol = {f"field_{k:02d}": rng.standard_normal(37) for k in range(11)}
    sol.update({"density": rng.standard_normal(324), "rho-Y_Ar.+1":
                rng.standard_normal(324), "Z-last": np.arange(5.0)})
    tree = h5lite.Group({"solution": sol,
                         "table": rng.standard_normal((60, 6)),
                         "ids": np.arange(-3, 9, dtype=np.int64),
                         "empty": {}},
                        attrs={"iteration": 4, "time": 9.955e-07,
                               "dt": np.float64(2.4887e-07), "order": 2,
                               "vec": np.array([1.5, -2.0])})
    return tree


def _same(lite, h5, path="/"):
    """lite (an h5lite Group, or a dict written as one) holds exactly what
    h5 (an h5py group) holds."""
    attrs = getattr(lite, "attrs", {})
    assert set(attrs) == set(h5.attrs), path
    for k in h5.attrs:
        a, b = np.asarray(attrs[k]), np.asarray(h5.attrs[k])
        assert a.dtype == b.dtype and np.array_equal(a, b), (path, k)
    assert set(lite) == set(h5), path
    for k in h5:
        if isinstance(h5[k], h5py.Group):
            _same(lite[k], h5[k], f"{path}{k}/")
        else:
            b = h5[k][()]
            a = lite[k]
            assert a.dtype == b.dtype and a.shape == b.shape, (path, k)
            assert np.array_equal(a, b), (path, k)


def _h5py_write(path, tree, attrs):
    with h5py.File(path, "w", libver="earliest") as f:
        for k, v in attrs.items():
            f.attrs[k] = v

        def fill(g, t):
            for k, v in t.items():
                if isinstance(v, dict):
                    fill(g.create_group(k), v)
                else:
                    g.create_dataset(k, data=v)
        fill(f, tree)


@pytest.mark.parametrize("seed", [0, 1])
def test_h5py_reads_h5lite_files(tmp_path, seed):
    tree = _tree(seed)
    path = tmp_path / "lite.h5"
    h5lite.write(path, tree)
    with h5py.File(path, "r") as f:
        _same(tree, f)
        assert f["solution/density"].dtype == np.float64
        assert f.attrs["iteration"].dtype == np.int64


def test_h5lite_reads_h5py_files(tmp_path):
    tree = _tree(2)
    path = tmp_path / "h5py.h5"
    _h5py_write(path, tree, tree.attrs)
    got = h5lite.read(path)
    with h5py.File(path, "r") as f:
        _same(got, f)


@pytest.mark.parametrize("name", REPO_FILES)
def test_reads_the_repo_files(name):
    path = os.path.join(REPO, name)
    got = h5lite.read(path)
    with h5py.File(path, "r") as f:
        _same(got, f)


def test_round_trip_keeps_every_bit(tmp_path):
    """NaN, inf, -0.0 and subnormals survive a write and a read."""
    vals = np.array([np.nan, np.inf, -np.inf, -0.0, 5e-324, 1.0 / 3.0])
    h5lite.write(tmp_path / "b.h5", {"v": vals}, {"t": -0.0})
    got = h5lite.read(tmp_path / "b.h5")
    assert got["v"].tobytes() == vals.tobytes()
    assert np.signbit(got.attrs["t"])


def _chunked(f):
    f.create_dataset("x", data=np.arange(100.0), chunks=(10,))


def _gzip(f):
    f.create_dataset("x", data=np.arange(100.0), compression="gzip")


def _compact(f):
    space = h5py.h5s.create_simple((4,))
    plist = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
    plist.set_layout(h5py.h5d.COMPACT)
    h5py.h5d.create(f.id, b"x", h5py.h5t.IEEE_F64LE, space, plist)


def _float32(f):
    f.create_dataset("x", data=np.arange(4, dtype=np.float32))


def _string_attr(f):
    f.attrs["name"] = "cylinder"


@pytest.mark.parametrize("make,libver,match", [
    (_chunked, "earliest", "chunked data layout"),
    (_gzip, "earliest", "filter pipeline|chunked"),
    (_compact, "earliest", "compact data layout"),
    (_float32, "earliest", "4-byte floating-point"),
    (_string_attr, "earliest", "variable-length datatype"),
    (_float32, "latest", "superblock version"),
])
def test_outside_the_subset_raises(tmp_path, make, libver, match):
    path = tmp_path / "out.h5"
    with h5py.File(path, "w", libver=libver) as f:
        make(f)
    with pytest.raises(ValueError, match=match):
        h5lite.read(path)


def test_writer_refuses_other_dtypes(tmp_path):
    with pytest.raises(ValueError, match="float64 and int64"):
        h5lite.write(tmp_path / "c.h5", {"x": np.arange(3, dtype=np.complex128)})
