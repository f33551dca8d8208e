"""Minimal pure-Python HDF5 reader/writer (counterpart of
``spatial_audio_framework_tpu/utils/hdf5.py``, ported as it is: host code,
numpy + struct + zlib).

Counterpart of the reference's vendored libmysofa HDF5 parser
(framework/modules/saf_sofa_reader/libmysofa/internal/hdf_reader.c): SOFA
files are HDF5, and the package depends on neither h5py nor netCDF4, so —
like the reference — it ships its own implementation of the HDF5 subset
that SOFA files use:

* superblock v0/v2, version-1 object headers (+ continuations)
* old-style groups (v1 B-trees + symbol tables + local heaps)
* contiguous / chunked / compact dataset layouts
* deflate (zlib) + shuffle filters
* attributes (v1/v2/v3 messages), fixed/float/string datatypes

The writer emits superblock v0, symbol-table groups and contiguous datasets
with attributes — sufficient for fixtures and for exporting SOFA sets.
"""
from __future__ import annotations

import struct
import zlib
from dataclasses import dataclass, field
from typing import Dict, Optional

import numpy as np

_SIG = b"\x89HDF\r\n\x1a\n"
UNDEF = 0xFFFFFFFFFFFFFFFF


# ===========================================================================
# Reader
# ===========================================================================

@dataclass
class Dataset:
    name: str
    data: np.ndarray
    attrs: Dict[str, object] = field(default_factory=dict)


@dataclass
class Group:
    name: str
    attrs: Dict[str, object] = field(default_factory=dict)
    datasets: Dict[str, Dataset] = field(default_factory=dict)
    groups: Dict[str, "Group"] = field(default_factory=dict)


class HDF5Reader:
    def __init__(self, buf: bytes):
        self.buf = buf
        if buf[:8] != _SIG:
            raise ValueError("not an HDF5 file")
        ver = buf[8]
        if ver == 0:
            # superblock v0 (spec III.A.1)
            self.off_size = buf[13]
            self.len_size = buf[14]
            assert self.off_size == 8 and self.len_size == 8, "only 8-byte offsets supported"
            root_ste = 24 + 8 * 4
            self.root_addr = struct.unpack_from("<Q", buf, root_ste + 8)[0]
        elif ver in (2, 3):
            self.off_size = buf[9]
            self.len_size = buf[10]
            self.root_addr = struct.unpack_from("<Q", buf, 12 + 3 * 8)[0]
        else:
            raise ValueError(f"unsupported superblock version {ver}")
        self.root = self._read_object(self.root_addr, "/")

    # -- primitives ----------------------------------------------------------
    def _u(self, fmt, off):
        return struct.unpack_from("<" + fmt, self.buf, off)

    # -- object headers ------------------------------------------------------
    def _read_object(self, addr: int, name: str) -> Group:
        """Parse an object header into a Group/Dataset tree node."""
        msgs = self._messages(addr)
        grp = Group(name=name)
        datatype = dataspace = layout = None
        filters = []
        for mtype, body in msgs:
            if mtype == 0x0001:
                dataspace = self._parse_dataspace(body)
            elif mtype == 0x0003:
                datatype = self._parse_datatype(body)
            elif mtype == 0x0008:
                layout = self._parse_layout(body)
            elif mtype == 0x000B:
                filters = self._parse_filters(body)
            elif mtype == 0x000C:
                k, v = self._parse_attribute(body)
                grp.attrs[k] = v
            elif mtype == 0x0011:
                btree, heap = struct.unpack_from("<QQ", body, 0)
                self._read_symbol_table(btree, heap, grp)
            elif mtype == 0x0002:  # Link info (new-style group)
                self._read_link_info(body, grp)
            elif mtype == 0x0006:  # Link message (new-style compact group)
                self._read_link_message(body, grp)
        if datatype is not None and dataspace is not None and layout is not None:
            data = self._read_data(datatype, dataspace, layout, filters)
            ds = Dataset(name=name, data=data, attrs=grp.attrs)
            g = Group(name=name, attrs=grp.attrs)
            g.datasets["__self__"] = ds
            return g
        return grp

    def _messages(self, addr: int):
        buf = self.buf
        out = []
        if buf[addr:addr + 4] == b"OHDR":
            # version 2 object header
            p = addr + 4
            ver = buf[p]; p += 1
            flags = buf[p]; p += 1
            if flags & 0x20:
                p += 16  # four 4-byte timestamps (access/mod/change/birth)
            if flags & 0x10:
                p += 4  # max compact/dense
            size_bytes = 1 << (flags & 0x3)
            chunk0 = int.from_bytes(buf[p:p + size_bytes], "little")
            p += size_bytes
            end = p + chunk0
            track_order = bool(flags & 0x04)
            conts = []
            while p < end:
                mtype = buf[p]
                msize = struct.unpack_from("<H", buf, p + 1)[0]
                mflags = buf[p + 3]
                p += 4
                if track_order:
                    p += 2
                body = buf[p:p + msize]
                p += msize
                if mtype == 0x10:
                    o, l = struct.unpack_from("<QQ", body, 0)
                    conts.append((o, l))
                else:
                    out.append((mtype, body))
                del mflags
            for o, l in conts:
                # continuation block: OCHK signature
                q = o + 4
                qend = o + l - 4
                while q < qend:
                    mtype = buf[q]
                    msize = struct.unpack_from("<H", buf, q + 1)[0]
                    q += 4
                    if track_order:
                        q += 2
                    out.append((mtype, buf[q:q + msize]))
                    q += msize
            return out
        # version 1 object header
        ver, _, nmsg, _refs, hsize = struct.unpack_from("<BBHII", buf, addr)
        assert ver == 1, f"object header version {ver}"
        blocks = [(addr + 16, hsize)]
        remaining = nmsg
        while blocks and remaining > 0:
            p, size = blocks.pop(0)
            end = p + size
            while p + 8 <= end and remaining > 0:
                mtype, msize, _mflags = struct.unpack_from("<HHB", buf, p)
                p += 8
                body = buf[p:p + msize]
                p += msize
                remaining -= 1
                if mtype == 0x10:
                    o, l = struct.unpack_from("<QQ", body, 0)
                    blocks.append((o, l))
                else:
                    out.append((mtype, body))
        return out

    # -- message parsers ------------------------------------------------------
    @staticmethod
    def _parse_dataspace(b: bytes):
        ver = b[0]
        rank = b[1]
        flags = b[2]
        if ver == 1:
            p = 8
        else:
            p = 4
        dims = struct.unpack_from(f"<{rank}Q", b, p) if rank else ()
        del flags
        return tuple(dims)

    @staticmethod
    def _parse_datatype(b: bytes):
        cls = b[0] & 0x0F
        size = struct.unpack_from("<I", b, 4)[0]
        bits0 = b[1]
        if cls == 0:   # fixed-point
            signed = bool(bits0 & 0x08)
            return ("int" if signed else "uint", size)
        if cls == 1:   # floating point
            return ("float", size)
        if cls == 3:   # string
            return ("string", size)
        if cls == 9:   # vlen (e.g. vlen string attrs) — not supported as data
            return ("vlen", size)
        return ("raw", size)

    @staticmethod
    def _np_dtype(dt):
        kind, size = dt
        if kind == "float":
            return np.dtype(f"<f{size}")
        if kind == "int":
            return np.dtype(f"<i{size}")
        if kind == "uint":
            return np.dtype(f"<u{size}")
        if kind == "string":
            return np.dtype(f"S{size}")
        raise ValueError(dt)

    @staticmethod
    def _parse_layout(b: bytes):
        ver = b[0]
        assert ver == 3, f"layout version {ver}"
        cls = b[1]
        if cls == 0:   # compact
            size = struct.unpack_from("<H", b, 2)[0]
            return ("compact", b[4:4 + size])
        if cls == 1:   # contiguous
            addr, size = struct.unpack_from("<QQ", b, 2)
            return ("contiguous", addr, size)
        if cls == 2:   # chunked
            dim = b[2]
            btree = struct.unpack_from("<Q", b, 3)[0]
            cdims = struct.unpack_from(f"<{dim}I", b, 11)
            return ("chunked", btree, cdims)
        raise ValueError(f"layout class {cls}")

    @staticmethod
    def _parse_filters(b: bytes):
        ver = b[0]
        n = b[1]
        out = []
        p = 8 if ver == 1 else 2
        for _ in range(n):
            fid = struct.unpack_from("<H", b, p)[0]
            p += 2
            # v2 omits the Name Length field entirely for ids < 256
            if ver == 1 or fid >= 256:
                namelen = struct.unpack_from("<H", b, p)[0]
                p += 2
            else:
                namelen = 0
            ncli = struct.unpack_from("<H", b, p + 2)[0]  # skip flags
            p += 4
            if namelen:
                p += (namelen + 7) // 8 * 8 if ver == 1 else namelen
            p += 4 * ncli
            if ver == 1 and ncli % 2:
                p += 4
            out.append(fid)
        return out

    def _parse_attribute(self, b: bytes):
        ver = b[0]
        if ver == 1:
            name_size, dt_size, ds_size = struct.unpack_from("<HHH", b, 2)
            p = 8
            name = b[p:p + name_size].split(b"\0")[0].decode()
            p += (name_size + 7) // 8 * 8
            dt = self._parse_datatype(b[p:p + dt_size])
            p += (dt_size + 7) // 8 * 8
            shape = self._parse_dataspace(b[p:p + ds_size])
            p += (ds_size + 7) // 8 * 8
        elif ver in (2, 3):
            name_size, dt_size, ds_size = struct.unpack_from("<HHH", b, 2)
            p = 8 + (1 if ver == 3 else 0)
            name = b[p:p + name_size].split(b"\0")[0].decode()
            p += name_size
            dt = self._parse_datatype(b[p:p + dt_size])
            p += dt_size
            shape = self._parse_dataspace(b[p:p + ds_size])
            p += ds_size
        else:
            return (f"__unsupported_attr_v{ver}__", None)
        n = int(np.prod(shape)) if shape else 1
        if dt[0] == "string":
            return name, b[p:p + dt[1] * n].split(b"\0")[0].decode(errors="replace")
        if dt[0] == "vlen":
            return name, None  # vlen attr values live in a global heap; skip
        arr = np.frombuffer(b, dtype=self._np_dtype(dt), count=n, offset=p)
        return name, (arr.reshape(shape) if shape else arr[0])

    # -- groups ----------------------------------------------------------------
    def _read_symbol_table(self, btree_addr: int, heap_addr: int, grp: Group):
        names = self._heap_strings(heap_addr)
        for name_off, obj_addr in self._btree_v1_group(btree_addr):
            name = names(name_off)
            child = self._read_object(obj_addr, name)
            if "__self__" in child.datasets:
                ds = child.datasets["__self__"]
                ds.name = name
                grp.datasets[name] = ds
            else:
                grp.groups[name] = child

    def _heap_strings(self, heap_addr: int):
        assert self.buf[heap_addr:heap_addr + 4] == b"HEAP"
        data_addr = struct.unpack_from("<Q", self.buf, heap_addr + 24)[0]

        def get(off):
            end = self.buf.index(b"\0", data_addr + off)
            return self.buf[data_addr + off:end].decode()

        return get

    def _btree_v1_group(self, addr: int):
        """Yield (heap_name_offset, object_header_addr) leaf entries."""
        out = []
        buf = self.buf
        assert buf[addr:addr + 4] == b"TREE", "expected v1 B-tree"
        level = buf[5 + addr]
        n = struct.unpack_from("<H", buf, addr + 6)[0]
        p = addr + 8 + 16  # skip siblings
        # keys and children interleaved: key(L) child(O) ... key(L)
        children = []
        p += 8  # key 0
        for _ in range(n):
            child = struct.unpack_from("<Q", buf, p)[0]
            children.append(child)
            p += 16  # child + next key
        for child in children:
            if level > 0:
                out.extend(self._btree_v1_group(child))
            else:
                # SNOD
                assert buf[child:child + 4] == b"SNOD"
                nsym = struct.unpack_from("<H", buf, child + 6)[0]
                q = child + 8
                for _ in range(nsym):
                    name_off, obj_addr = struct.unpack_from("<QQ", buf, q)
                    out.append((name_off, obj_addr))
                    q += 40
        return out

    def _read_link_info(self, b: bytes, grp: Group):
        # Dense/new-style groups (fractal heap + v2 btree) unsupported;
        # netCDF4/MATLAB SOFA writers use old-style groups.
        fheap = struct.unpack_from("<Q", b, 2 + (8 if b[1] & 1 else 0))[0]
        if fheap != UNDEF:
            raise NotImplementedError("dense (fractal-heap) groups not supported")

    def _read_link_message(self, b: bytes, grp: Group):
        ver = b[0]
        flags = b[1]
        p = 2
        ltype = 0
        if flags & 0x08:
            ltype = b[p]; p += 1
        if flags & 0x04:
            p += 8
        if flags & 0x10:
            p += 1
        len_size = 1 << (flags & 0x3)
        nlen = int.from_bytes(b[p:p + len_size], "little")
        p += len_size
        name = b[p:p + nlen].decode()
        p += nlen
        if ltype == 0:  # hard link
            addr = struct.unpack_from("<Q", b, p)[0]
            child = self._read_object(addr, name)
            if "__self__" in child.datasets:
                ds = child.datasets["__self__"]
                ds.name = name
                grp.datasets[name] = ds
            else:
                grp.groups[name] = child
        del ver

    # -- data -------------------------------------------------------------------
    def _read_data(self, dt, shape, layout, filters) -> np.ndarray:
        np_dt = self._np_dtype(dt)
        n = int(np.prod(shape)) if shape else 1
        if layout[0] == "compact":
            return np.frombuffer(layout[1], np_dt, count=n).reshape(shape)
        if layout[0] == "contiguous":
            addr, size = layout[1], layout[2]
            if addr == UNDEF:
                return np.zeros(shape, np_dt)
            return np.frombuffer(self.buf, np_dt, count=n, offset=addr
                                 ).reshape(shape).copy()
        # chunked
        _, btree, cdims = layout
        cdims = cdims[:-1]  # last entry is element size
        out = np.zeros(shape, np_dt)
        for offsets, csize, fmask, caddr in self._btree_v1_chunks(btree, len(cdims)):
            raw = self.buf[caddr:caddr + csize]
            if 1 in filters and not (fmask & (1 << filters.index(1))):
                raw = zlib.decompress(raw)
            if 2 in filters and not (fmask & (1 << filters.index(2))):
                raw = self._unshuffle(raw, np_dt.itemsize)
            chunk = np.frombuffer(raw, np_dt,
                                  count=int(np.prod(cdims))).reshape(cdims)
            sl = tuple(slice(o, min(o + c, s))
                       for o, c, s in zip(offsets, cdims, shape))
            csel = tuple(slice(0, s.stop - s.start) for s in sl)
            out[sl] = chunk[csel]
        return out

    @staticmethod
    def _unshuffle(raw: bytes, itemsize: int) -> bytes:
        arr = np.frombuffer(raw, np.uint8)
        n = arr.size // itemsize
        return arr[: n * itemsize].reshape(itemsize, n).T.tobytes()

    def _btree_v1_chunks(self, addr: int, ndims: int):
        buf = self.buf
        out = []
        assert buf[addr:addr + 4] == b"TREE"
        level = buf[addr + 5]
        n = struct.unpack_from("<H", buf, addr + 6)[0]
        key_size = 8 + 8 * (ndims + 1)
        p = addr + 24
        for i in range(n):
            csize, fmask = struct.unpack_from("<II", buf, p)
            offsets = struct.unpack_from(f"<{ndims}Q", buf, p + 8)
            child = struct.unpack_from("<Q", buf, p + key_size)[0]
            if level > 0:
                out.extend(self._btree_v1_chunks(child, ndims))
            else:
                out.append((offsets, csize, fmask, child))
            p += key_size + 8
        return out


def read_hdf5(path: str) -> Group:
    with open(path, "rb") as f:
        return HDF5Reader(f.read()).root


# ===========================================================================
# Writer (superblock v0, symbol-table root group, contiguous datasets)
# ===========================================================================

class HDF5Writer:
    """Just enough HDF5 to round-trip SOFA-style content through our reader
    and other HDF5 tools: root group with ≤ one SNOD of datasets, v1 object
    headers, contiguous layout, v1 attributes."""

    def __init__(self):
        self.datasets = []
        self.root_attrs = {}

    def add_dataset(self, name: str, data: np.ndarray, attrs=None):
        self.datasets.append((name, np.ascontiguousarray(data), attrs or {}))

    def add_root_attr(self, name: str, value):
        self.root_attrs[name] = value

    # -- low-level encoders ---------------------------------------------------
    @staticmethod
    def _pad8(b: bytes) -> bytes:
        return b + b"\0" * ((8 - len(b) % 8) % 8)

    @staticmethod
    def _datatype_msg(dtype: np.dtype) -> bytes:
        if dtype.kind == "f":
            # IEEE little-endian float: class 1
            b0 = (1 << 4) | 1
            bits = dtype.itemsize * 8
            if dtype.itemsize == 8:
                # IEEE binary64: 52-bit mantissa, 11-bit exponent, bias 1023
                props = struct.pack("<HHBBBBII", 0, bits, 52, 11, 0, 52, 1023, 0)
            else:
                props = struct.pack("<HHBBBBII", 0, bits, 23, 8, 0, 23, 127, 0)
            head = struct.pack("<BBBBI", b0, 0x20, 0x3F if dtype.itemsize == 8 else 0x1F,
                               0, dtype.itemsize)
            return head + props
        if dtype.kind in "iu":
            b0 = (1 << 4) | 0
            signed = 0x08 if dtype.kind == "i" else 0
            head = struct.pack("<BBBBI", b0, signed, 0, 0, dtype.itemsize)
            return head + struct.pack("<HH", 0, dtype.itemsize * 8)
        if dtype.kind == "S":
            b0 = (1 << 4) | 3
            return struct.pack("<BBBBI", b0, 0, 0, 0, dtype.itemsize)
        raise ValueError(dtype)

    @staticmethod
    def _dataspace_msg(shape) -> bytes:
        rank = len(shape)
        head = struct.pack("<BBBBI", 1, rank, 0, 0, 0)
        return head + b"".join(struct.pack("<Q", d) for d in shape)

    def _attr_msg(self, name: str, value) -> bytes:
        if isinstance(value, str):
            data = value.encode() + b"\0"
            dt = np.dtype(f"S{len(data)}")
            arr = np.frombuffer(data, dt)
            shape = ()
        else:
            arr = np.atleast_1d(np.asarray(value))
            dt = arr.dtype
            shape = arr.shape
        dt_msg = self._datatype_msg(dt)
        ds_msg = self._dataspace_msg(shape)
        name_b = name.encode() + b"\0"
        body = struct.pack("<BBHHH", 1, 0, len(name_b), len(dt_msg), len(ds_msg))
        body += self._pad8(name_b) + self._pad8(dt_msg) + self._pad8(ds_msg)
        body += arr.tobytes()
        return body

    def _object_header(self, msgs) -> bytes:
        parts = []
        for mtype, body in msgs:
            body_p = self._pad8(body)
            parts.append(struct.pack("<HHBBBB", mtype, len(body_p), 0, 0, 0, 0)
                         + body_p)
        payload = b"".join(parts)
        hdr = struct.pack("<BBHII", 1, 0, len(msgs), 1, len(payload))
        return hdr + b"\0\0\0\0" + payload

    def tobytes(self) -> bytes:
        # layout plan: [superblock+root STE][root header][heap][btree][snod]
        # [dataset headers][raw data]
        out = bytearray()
        out += _SIG
        out += struct.pack("<BBBBB", 0, 0, 0, 0, 0)  # versions
        out += struct.pack("<BBB", 8, 8, 0)          # sizes
        out += struct.pack("<HH", 4, 16)             # leaf/internal k
        out += struct.pack("<I", 0)                  # consistency flags
        # addresses: base, free space, end of file (patched later),
        # file-access info block (undefined)
        eof_pos = len(out) + 16
        out += struct.pack("<QQQQ", 0, UNDEF, 0, UNDEF)
        root_ste_pos = len(out)
        out += b"\0" * 40  # root symbol table entry (patched)

        # name heap
        names = sorted(n for n, _, _ in self.datasets)
        heap_data = bytearray(b"\0" * 8)
        name_offs = {}
        for n in names:
            name_offs[n] = len(heap_data)
            nb = n.encode() + b"\0"
            heap_data += nb + b"\0" * ((8 - len(nb) % 8) % 8)
        heap_addr = None
        btree_addr = None
        snod_addr = None

        def reserve(size):
            pos = len(out)
            out.extend(b"\0" * size)
            return pos

        # root object header (symbol table msg + root attrs)
        root_msgs = [(0x0011, struct.pack("<QQ", 0, 0))]  # patched
        for k, v in self.root_attrs.items():
            root_msgs.append((0x000C, self._attr_msg(k, v)))
        root_hdr = self._object_header(root_msgs)
        root_hdr_addr = reserve(len(root_hdr))

        heap_hdr_addr = reserve(32)
        heap_data_addr = reserve(len(heap_data))
        btree_addr = reserve(24 + 8 + len(names) * 16)
        snod_addr = reserve(8 + len(names) * 40)

        # dataset object headers + data
        ds_addrs = {}
        data_blobs = []
        for name, data, attrs in self.datasets:
            msgs = [(0x0001, self._dataspace_msg(data.shape)),
                    (0x0003, self._datatype_msg(data.dtype))]
            for k, v in attrs.items():
                msgs.append((0x000C, self._attr_msg(k, v)))
            # layout placeholder (patched): v3 contiguous
            msgs.append((0x0008, struct.pack("<BBQQ", 3, 1, 0, data.nbytes)
                         + b"\0\0\0\0\0\0"))
            hdr = self._object_header(msgs)
            ds_addrs[name] = reserve(len(hdr))
            data_blobs.append((name, data))
        data_addrs = {}
        for name, data in data_blobs:
            data_addrs[name] = reserve(max(data.nbytes, 1))

        buf = out

        def patch(pos, b):
            buf[pos:pos + len(b)] = b

        # superblock: eof + root STE (eof_pos already points at the
        # end-of-file-address field, superblock offset 40)
        patch(eof_pos, struct.pack("<Q", len(buf)))
        patch(root_ste_pos, struct.pack("<QQII", 0, root_hdr_addr, 1, 0)
              + struct.pack("<QQ", btree_addr, heap_hdr_addr))
        # root header with real symbol-table addresses
        root_msgs[0] = (0x0011, struct.pack("<QQ", btree_addr, heap_hdr_addr))
        patch(root_hdr_addr, self._object_header(root_msgs))
        # heap
        # free-list head = 1 (H5HL_FREE_NULL): libhdf5's "no free block"
        # marker — an address ≥ the segment size (e.g. UNDEF) is rejected
        # as "bad heap free list"
        patch(heap_hdr_addr, b"HEAP" + struct.pack("<BBBBQQQ", 0, 0, 0, 0,
                                                   len(heap_data), 1,
                                                   heap_data_addr))
        patch(heap_data_addr, bytes(heap_data))
        # btree (single leaf pointing at one SNOD)
        bt = b"TREE" + struct.pack("<BBHQQ", 0, 0, 1, UNDEF, UNDEF)
        bt += struct.pack("<Q", 0)           # key 0
        bt += struct.pack("<Q", snod_addr)   # child 0
        bt += struct.pack("<Q", name_offs[names[-1]] if names else 0)  # key 1
        patch(btree_addr, bt)
        # snod
        sn = bytearray(b"SNOD" + struct.pack("<BBH", 1, 0, len(names)))
        for n in names:
            sn += struct.pack("<QQII", name_offs[n], ds_addrs[n], 0, 0) + b"\0" * 16
        patch(snod_addr, bytes(sn))
        # dataset headers with patched layout + data
        for name, data, attrs in self.datasets:
            msgs = [(0x0001, self._dataspace_msg(data.shape)),
                    (0x0003, self._datatype_msg(data.dtype))]
            for k, v in attrs.items():
                msgs.append((0x000C, self._attr_msg(k, v)))
            msgs.append((0x0008, struct.pack("<BBQQ", 3, 1, data_addrs[name],
                                             data.nbytes) + b"\0\0\0\0\0\0"))
            patch(ds_addrs[name], self._object_header(msgs))
            patch(data_addrs[name], data.tobytes())
        return bytes(buf)

    def save(self, path: str):
        with open(path, "wb") as f:
            f.write(self.tobytes())
