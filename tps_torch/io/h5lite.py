"""A numpy reader and writer for the subset of HDF5 that the repo's files use.

The card's machine has no h5py, so checkpoints (io/restart.py) and, later,
the tables of the plasma stack go through this module.  The subset is the
one the HDF5 library writes with its earliest file format, which is what
every `.h5` in the repo holds (restart files, `tests/ref_solns/*.h5`,
`examples/cases/*_table.h5`):

- superblock version 0, 8-byte offsets and lengths, no user block;
- version-1 object headers (with continuation blocks);
- groups as symbol tables: a version-1 B-tree of symbol-table nodes and a
  local heap of names;
- datasets of little-endian float64 or int64 with contiguous storage (no
  chunking, no filters, no compact layout);
- attributes of the same two types (scalars or arrays).

Anything outside it raises a ValueError that names what was found; nothing
is guessed.  `read` returns a `Group`: a dict of names to numpy arrays and
sub-Groups, with the attributes in `.attrs`.  `write` takes the same
(nested dicts of arrays; attributes from a Group's `.attrs`) and writes a
file that h5py (and so the JAX package's restart reader) reads.

Format reference: the HDF5 File Format Specification, version 3.0
(superblock v0, object header v1, v1 B-trees, local heaps, symbol table
nodes, the dataspace/datatype/fill value/layout/attribute messages).
"""

from __future__ import annotations

import os

import numpy as np

SIGNATURE = b"\x89HDF\r\n\x1a\n"
UNDEF = 0xFFFFFFFFFFFFFFFF
_HEAP_FREE_NULL = 1  # end of a local heap's free list on disk
_LEAF_K = 4  # symbol-table node capacity is 2K entries
_NODE_K = 16  # B-tree node capacity is 2K children
_SNOD_SIZE = 8 + 2 * _LEAF_K * 40
_BTREE_SIZE = 24 + (2 * _NODE_K + 1) * 8 + 2 * _NODE_K * 8

# message types
_NIL, _DATASPACE, _LINK_INFO, _DATATYPE = 0x0, 0x1, 0x2, 0x3
_FILL_OLD, _FILL, _LINK, _LAYOUT = 0x4, 0x5, 0x6, 0x8
_GROUP_INFO, _FILTERS, _ATTRIBUTE = 0xA, 0xB, 0xC
_MTIME_OLD, _CONTINUATION, _SYMBOL_TABLE = 0xE, 0x10, 0x11
_MTIME, _ATTR_INFO = 0x12, 0x15
_SKIPPED = (_NIL, _FILL_OLD, _FILL, _MTIME_OLD, _MTIME)
_NEW_STYLE = {_LINK_INFO: "a link info message", _LINK: "a link message",
              _GROUP_INFO: "a group info message",
              _ATTR_INFO: "an attribute info message"}

_F8 = np.dtype("<f8")
_I8 = np.dtype("<i8")


class Group(dict):
    """Names to numpy arrays and sub-Groups; the attributes in `.attrs`."""

    def __init__(self, items=(), attrs=None):
        super().__init__(items)
        self.attrs = dict(attrs or {})


# ---------------------------------------------------------------- reading


class _Reader:
    def __init__(self, buf, path):
        self.buf = buf
        self.path = path

    def fail(self, what):
        return ValueError(f"{self.path}: {what} is outside the HDF5 subset "
                          "tps_torch reads (io/h5lite.py)")

    def u(self, off, n):
        if off + n > len(self.buf):
            raise ValueError(f"{self.path}: truncated at byte {off}")
        return int.from_bytes(self.buf[off:off + n], "little")

    def sig(self, off, expect, what):
        got = bytes(self.buf[off:off + 4])
        if got != expect:
            raise ValueError(f"{self.path}: expected a {what} ({expect!r}) at "
                             f"byte {off}, found {got!r}")

    # -------------------------------------------------------- superblock
    def root(self):
        if bytes(self.buf[:8]) != SIGNATURE:
            raise ValueError(f"{self.path}: no HDF5 signature at byte 0 (a "
                             "user block, or not an HDF5 file)")
        version = self.buf[8]
        if version != 0:
            raise self.fail(f"superblock version {version}")
        if self.buf[13] != 8 or self.buf[14] != 8:
            raise self.fail(f"{self.buf[13]}-byte offsets and "
                            f"{self.buf[14]}-byte lengths")
        if self.u(24, 8) != 0:
            raise self.fail("a non-zero base address")
        return self.object(self.u(56 + 8, 8), "/")

    # ----------------------------------------------------- object headers
    def messages(self, addr):
        """(type, data offset, size) of every message of the object header
        at addr, continuation blocks followed."""
        version = self.buf[addr]
        if bytes(self.buf[addr:addr + 4]) == b"OHDR":
            raise self.fail("a version-2 object header")
        if version != 1:
            raise self.fail(f"object header version {version}")
        chunks = [(addr + 16, self.u(addr + 8, 4))]
        out = []
        while chunks:
            start, size = chunks.pop(0)
            p, end = start, start + size
            while p + 8 <= end:
                mtype, msize = self.u(p, 2), self.u(p + 2, 2)
                flags = self.buf[p + 4]
                if flags & 0x2:
                    raise self.fail(f"a shared message (type {mtype:#x})")
                data = p + 8
                if mtype == _CONTINUATION:
                    chunks.append((self.u(data, 8), self.u(data + 8, 8)))
                elif mtype not in _SKIPPED:
                    out.append((mtype, data, msize))
                p = data + msize
        return out

    def object(self, addr, name):
        msgs = self.messages(addr)
        types = {m[0] for m in msgs}
        for t, what in _NEW_STYLE.items():
            if t in types:
                raise self.fail(f"{what} in {name} (new-style group or "
                                "attribute storage)")
        for t in types:
            if t not in (_DATASPACE, _DATATYPE, _LAYOUT, _ATTRIBUTE,
                         _SYMBOL_TABLE, _FILTERS):
                raise self.fail(f"object header message type {t:#x} in {name}")
        if _FILTERS in types:
            raise self.fail(f"a filter pipeline (compression) on {name}")
        attrs = {}
        for mtype, off, size in msgs:
            if mtype == _ATTRIBUTE:
                key, val = self.attribute(off, name)
                attrs[key] = val
        if _SYMBOL_TABLE in types:
            off = next(m[1] for m in msgs if m[0] == _SYMBOL_TABLE)
            return self.group(self.u(off, 8), self.u(off + 8, 8), name, attrs)
        if _LAYOUT not in types:
            raise self.fail(f"an object with neither a symbol table nor a "
                            f"data layout ({name})")
        shape = dtype = None
        for mtype, off, size in msgs:
            if mtype == _DATASPACE:
                shape = self.dataspace(off, name)
            elif mtype == _DATATYPE:
                dtype = self.datatype(off, name)
        off = next(m[1] for m in msgs if m[0] == _LAYOUT)
        if shape is None or dtype is None:
            raise ValueError(f"{self.path}: dataset {name} lacks a dataspace "
                             "or a datatype message")
        return self.dataset(off, shape, dtype, name)

    def group(self, btree, heap, name, attrs):
        self.sig(heap, b"HEAP", "local heap")
        if self.buf[heap + 4] != 0:
            raise self.fail(f"local heap version {self.buf[heap + 4]}")
        names_at = self.u(heap + 24, 8)
        out = Group(attrs=attrs)
        for name_off, child in self.btree_entries(btree):
            key = self.cstring(names_at + name_off)
            full = name.rstrip("/") + "/" + key
            out[key] = self.object(child, full)
        return out

    def btree_entries(self, addr):
        self.sig(addr, b"TREE", "v1 B-tree node")
        if self.buf[addr + 4] != 0:
            raise self.fail(f"B-tree node type {self.buf[addr + 4]} where a "
                            "group node (0) belongs")
        level, used = self.buf[addr + 5], self.u(addr + 6, 2)
        for i in range(used):
            child = self.u(addr + 24 + 8 + 16 * i, 8)
            if level > 0:
                yield from self.btree_entries(child)
                continue
            self.sig(child, b"SNOD", "symbol table node")
            if self.buf[child + 4] != 1:
                raise self.fail(f"symbol table node version "
                                f"{self.buf[child + 4]}")
            for j in range(self.u(child + 6, 2)):
                e = child + 8 + 40 * j
                yield self.u(e, 8), self.u(e + 8, 8)

    def cstring(self, off):
        end = self.buf.find(b"\0", off)
        if end < 0:
            raise ValueError(f"{self.path}: unterminated name at byte {off}")
        return bytes(self.buf[off:end]).decode("utf-8")

    # ----------------------------------------------------------- messages
    def dataspace(self, off, name):
        version, rank, flags = self.buf[off], self.buf[off + 1], self.buf[off + 2]
        if version == 1:
            dims_at = off + 8
        elif version == 2:
            kind = self.buf[off + 3]
            if kind == 2:
                raise self.fail(f"a null dataspace ({name})")
            dims_at = off + 4
        else:
            raise self.fail(f"dataspace version {version} ({name})")
        if flags & 0x2:
            raise self.fail(f"a permuted dataspace ({name})")
        return tuple(self.u(dims_at + 8 * i, 8) for i in range(rank))

    def datatype(self, off, name):
        b0 = self.buf[off]
        cls, version = b0 & 0x0F, b0 >> 4
        bits = self.u(off + 1, 3)
        size = self.u(off + 4, 4)
        kinds = {0: "fixed-point", 1: "floating-point", 2: "time",
                 3: "string", 4: "bitfield", 5: "opaque", 6: "compound",
                 7: "reference", 8: "enumerated", 9: "variable-length",
                 10: "array"}
        kind = kinds.get(cls, f"class-{cls}")
        if version not in (1, 2, 3):
            raise self.fail(f"datatype version {version} ({name})")
        if cls not in (0, 1) or size != 8:
            raise self.fail(f"a {size}-byte {kind} datatype ({name})")
        if bits & 0x1:
            raise self.fail(f"a big-endian {kind} datatype ({name})")
        if cls == 0:
            if not bits & 0x8:
                raise self.fail(f"an unsigned 8-byte integer datatype ({name})")
            return _I8
        # IEEE double: implied mantissa bit, sign at 63, 52-bit mantissa,
        # 11-bit exponent at 52, bias 1023
        prop = off + 8
        ieee = ((bits >> 4) & 0x3 == 2 and (bits >> 8) & 0xFF == 63
                and self.u(prop, 2) == 0 and self.u(prop + 2, 2) == 64
                and self.buf[prop + 4] == 52 and self.buf[prop + 5] == 11
                and self.buf[prop + 6] == 0 and self.buf[prop + 7] == 52
                and self.u(prop + 8, 4) == 1023)
        if not ieee:
            raise self.fail(f"a non-IEEE 8-byte float datatype ({name})")
        return _F8

    def dataset(self, off, shape, dtype, name):
        version, cls = self.buf[off], self.buf[off + 1]
        if version != 3:
            raise self.fail(f"data layout version {version} ({name})")
        if cls != 1:
            layout = {0: "compact", 2: "chunked", 3: "virtual"}.get(cls, cls)
            raise self.fail(f"a {layout} data layout ({name})")
        addr, size = self.u(off + 2, 8), self.u(off + 10, 8)
        count = int(np.prod(shape, dtype=np.int64))
        if addr == UNDEF:  # never written: the default fill, zeros
            return np.zeros(shape, dtype.newbyteorder("="))
        if size != count * dtype.itemsize:
            raise ValueError(f"{self.path}: dataset {name} stores {size} "
                             f"bytes for shape {shape} of {dtype}")
        return self.array(addr, shape, dtype, name)

    def array(self, addr, shape, dtype, name):
        count = int(np.prod(shape, dtype=np.int64))
        if addr + count * dtype.itemsize > len(self.buf):
            raise ValueError(f"{self.path}: {name} runs past the end of the "
                             "file")
        arr = np.frombuffer(self.buf, dtype, count, addr)
        return arr.astype(dtype.newbyteorder("=")).reshape(shape)

    def attribute(self, off, owner):
        version = self.buf[off]
        nlen, tlen, slen = (self.u(off + 2, 2), self.u(off + 4, 2),
                            self.u(off + 6, 2))
        if version == 1:
            def pad(n):
                return (n + 7) & ~7
            p = off + 8
        elif version in (2, 3):
            def pad(n):
                return n
            p = off + 8 + (version == 3)
        else:
            raise self.fail(f"attribute message version {version} ({owner})")
        name = bytes(self.buf[p:p + nlen]).split(b"\0")[0].decode("utf-8")
        p += pad(nlen)
        where = f"{owner} attribute {name}"
        dtype = self.datatype(p, where)
        p += pad(tlen)
        shape = self.dataspace(p, where)
        p += pad(slen)
        val = self.array(p, shape, dtype, where)
        return name, (val[()] if shape == () else val)


def read(path) -> Group:
    """The file's root group: names to arrays and Groups, attrs in .attrs."""
    with open(path, "rb") as f:
        buf = f.read()
    return _Reader(buf, os.fspath(path)).root()


# ---------------------------------------------------------------- writing


def _u(v, n):
    return int(v).to_bytes(n, "little")


def _pad8(b):
    return b + b"\0" * (-len(b) % 8)


def _dtype_of(arr, where):
    kind = arr.dtype.kind
    if kind == "f" and arr.dtype.itemsize <= 8:
        return _F8
    if kind in "iu" and (kind == "i" or arr.dtype.itemsize < 8):
        return _I8
    raise ValueError(f"{where}: dtype {arr.dtype} is outside the HDF5 subset "
                     "tps_torch writes (float64 and int64)")


def _datatype_msg(dtype):
    if dtype == _F8:
        return (bytes([0x11, 0x20, 0x3F, 0x00]) + _u(8, 4) + _u(0, 2)
                + _u(64, 2) + bytes([52, 11, 0, 52]) + _u(1023, 4))
    return bytes([0x10, 0x08, 0x00, 0x00]) + _u(8, 4) + _u(0, 2) + _u(64, 2)


def _dataspace_msg(shape):
    out = bytes([1, len(shape), 1 if shape else 0, 0]) + b"\0" * 4
    dims = b"".join(_u(d, 8) for d in shape)
    return out + dims + dims


def _message(mtype, data, flags=0):
    data = _pad8(data)
    return _u(mtype, 2) + _u(len(data), 2) + bytes([flags]) + b"\0" * 3 + data


def _object_header(msgs):
    body = b"".join(msgs)
    return (bytes([1, 0]) + _u(len(msgs), 2) + _u(1, 4) + _u(len(body), 4)
            + b"\0" * 4 + body)


def _attribute_msg(name, value):
    arr = np.asarray(value)
    dtype = _dtype_of(arr, f"attribute {name}")
    nm = name.encode("utf-8") + b"\0"
    dt, ds = _datatype_msg(dtype), _dataspace_msg(arr.shape)
    data = (bytes([1, 0]) + _u(len(nm), 2) + _u(len(dt), 2) + _u(len(ds), 2)
            + _pad8(nm) + _pad8(dt) + _pad8(ds)
            + np.ascontiguousarray(arr, dtype).tobytes())
    return _message(_ATTRIBUTE, data)


class _Writer:
    """Lays the objects out in one pass (every size is known up front),
    then fills in their bytes."""

    def __init__(self):
        self.size = 96  # the superblock
        self.parts = []  # (address, bytes)

    def alloc(self, n):
        addr = self.size
        self.size += (n + 7) & ~7
        return addr

    def group(self, tree, attrs, path):
        """Lay out a group; returns its object header's address."""
        names = sorted(tree, key=lambda s: s.encode("utf-8"))
        for key in names:
            if not key or "/" in key or key == ".":
                raise ValueError(f"{path}: invalid member name {key!r}")
        attr_msgs = [_attribute_msg(k, v) for k, v in attrs.items()]
        header_len = 16 + 24 + sum(len(m) for m in attr_msgs)
        header = self.alloc(header_len)
        btree = self.alloc(_BTREE_SIZE)
        heap_data = bytearray(8)  # offset 0: the empty name
        offsets = []
        for key in names:
            offsets.append(len(heap_data))
            heap_data += _pad8(key.encode("utf-8") + b"\0")
        heap = self.alloc(32 + len(heap_data))
        nodes = [names[i:i + 2 * _LEAF_K]
                 for i in range(0, len(names), 2 * _LEAF_K)]
        if len(nodes) > 2 * _NODE_K:
            raise ValueError(f"{path}: {len(names)} members need a multi-level "
                             "B-tree, which h5lite does not write")
        snods = [self.alloc(_SNOD_SIZE) for _ in nodes]
        children = {}
        for key in names:
            val = tree[key]
            sub = f"{path.rstrip('/')}/{key}"
            if isinstance(val, dict):
                children[key] = self.group(val, getattr(val, "attrs", {}), sub)
            else:
                children[key] = self.dataset(np.asarray(val), sub)

        symtab = _message(_SYMBOL_TABLE, _u(btree, 8) + _u(heap, 8))
        self.parts.append((header, _object_header([symtab] + attr_msgs)))
        keys = [0] + [offsets[names.index(n[-1])] for n in nodes]
        tree_b = (b"TREE" + bytes([0, 0]) + _u(len(nodes), 2) + _u(UNDEF, 8)
                  + _u(UNDEF, 8) + _u(keys[0], 8))
        for i, addr in enumerate(snods):
            tree_b += _u(addr, 8) + _u(keys[i + 1], 8)
        self.parts.append((btree, tree_b))
        self.parts.append((heap, b"HEAP" + bytes(4) + _u(len(heap_data), 8)
                           + _u(_HEAP_FREE_NULL, 8) + _u(heap + 32, 8)
                           + bytes(heap_data)))
        i = 0
        for addr, node in zip(snods, nodes):
            b = b"SNOD" + bytes([1, 0]) + _u(len(node), 2)
            for key in node:
                b += (_u(offsets[i], 8) + _u(children[key], 8) + _u(0, 4)
                      + bytes(4) + bytes(16))
                i += 1
            self.parts.append((addr, b))
        return header

    def dataset(self, arr, path):
        dtype = _dtype_of(arr, path)
        data = np.ascontiguousarray(arr, dtype).tobytes()
        ds = _message(_DATASPACE, _dataspace_msg(arr.shape))
        dt = _message(_DATATYPE, _datatype_msg(dtype), flags=1)
        # fill value v2: allocated late, written if set, the default value
        fill = _message(_FILL, bytes([2, 2, 2, 1]) + _u(0, 4), flags=1)
        layout_len = 8 + 24  # v3 contiguous: address and size, padded
        header = self.alloc(16 + len(ds) + len(dt) + len(fill) + layout_len)
        addr = self.alloc(len(data)) if data else UNDEF
        layout = _message(_LAYOUT, bytes([3, 1]) + _u(addr, 8)
                          + _u(len(data), 8))
        self.parts.append((header, _object_header([ds, dt, fill, layout])))
        if data:
            self.parts.append((addr, data))
        return header


def write(path, tree, attrs=None):
    """Write `tree` (names to arrays and nested dicts; a Group's .attrs, or
    `attrs`, become the root attributes) to path, through a temporary file
    that replaces path only when complete."""
    w = _Writer()
    if attrs is None:
        attrs = getattr(tree, "attrs", {})
    root = w.group(tree, attrs, "/")
    root_entry = _u(0, 8) + _u(root, 8) + _u(0, 4) + bytes(4) + bytes(16)
    superblock = (SIGNATURE + bytes([0, 0, 0, 0, 0, 8, 8, 0]) + _u(_LEAF_K, 2)
                  + _u(_NODE_K, 2) + _u(0, 4) + _u(0, 8) + _u(UNDEF, 8)
                  + _u(w.size, 8) + _u(UNDEF, 8) + root_entry)
    buf = bytearray(w.size)
    buf[:96] = superblock
    for addr, b in w.parts:
        buf[addr:addr + len(b)] = b
    path = os.fspath(path)
    tmp = f"{path}.tmp{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(buf)
    os.replace(tmp, path)
