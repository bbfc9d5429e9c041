"""Minimal pure-Python HDF4 Scientific-Dataset reader, a copy of ``tsadar_tpu.utils.data_handling.hdf4``.

Upstream tsadar loads OMEGA CCD/streak frames with ``pyhdf.SD``, which is not
a dependency.  This module reads the subset of HDF4 needed for those files
from scratch: DD-block parsing, linked-block special elements, deflate-compressed
special elements, and chunked scientific datasets, returning numpy arrays.

Verified against the shipped OMEGA shot files (uint16 chunked+deflate SDs).
"""

import struct
import zlib

import numpy as np

_MAGIC = bytes.fromhex("0e031301")

# tags
_DFTAG_LINKED = 20
_DFTAG_COMPRESSED = 40
_DFTAG_CHUNK = 61
_DFTAG_NT = 106
_DFTAG_SDD = 701
_DFTAG_SD = 702
_DFTAG_NDG = 720
_DFTAG_VH = 1962
_DFTAG_VS = 1963
_DFTAG_VG = 1965
_SPECIAL_MASK = 0x4000

# special element codes
_SPECIAL_LINKED = 1
_SPECIAL_EXT = 2
_SPECIAL_COMP = 4
_SPECIAL_CHUNK_COMP = 3  # per-chunk compressed element header
_SPECIAL_CHUNKED = 5

# DFNT number types -> numpy dtype (big endian; HDF4 default)
_DFNT = {
    3: ">u1", 4: "S1", 5: ">f4", 6: ">f8",
    20: ">i1", 21: ">u1", 22: ">i2", 23: ">u2", 24: ">i4", 25: ">u4",
    26: ">i8", 27: ">u8",
}


class HDF4File:
    def __init__(self, path):
        with open(path, "rb") as f:
            self.raw = f.read()
        if self.raw[:4] != _MAGIC:
            raise ValueError(f"{path} is not an HDF4 file")
        self.dd = {}
        off = 4
        while off:
            ndds, nextoff = struct.unpack(">HI", self.raw[off : off + 6])
            p = off + 6
            for _ in range(ndds):
                tag, ref, o, ln = struct.unpack(">HHII", self.raw[p : p + 12])
                p += 12
                if tag:
                    self.dd[(tag, ref)] = (o, ln)
            off = nextoff

    # -------------------------------------------------------------- elements

    def read_element(self, tag, ref):
        """Element bytes, resolving special (linked/compressed/chunked) storage."""
        if (tag, ref) in self.dd:
            o, ln = self.dd[(tag, ref)]
            return self.raw[o : o + ln]
        key = (tag | _SPECIAL_MASK, ref)
        if key not in self.dd:
            raise KeyError(f"no element tag={tag} ref={ref}")
        o, ln = self.dd[key]
        (code,) = struct.unpack(">H", self.raw[o : o + 2])
        if code == _SPECIAL_LINKED:
            return self._read_linked(o)
        if code in (_SPECIAL_COMP, _SPECIAL_CHUNK_COMP):
            return self._read_compressed(o)
        if code == _SPECIAL_CHUNKED:
            return self._read_chunked(o)
        raise NotImplementedError(f"special element code {code}")

    def _read_linked(self, o):
        # HDF4 linked-block header field order: total length, block length,
        # blocks per table, first link-table ref (all validated against the
        # 11 shipped OMEGA shot files, which exercise this path)
        length, blk_len, num_blk, link_ref = struct.unpack(">IIIH", self.raw[o + 2 : o + 16])
        out = bytearray()
        ref = link_ref
        while ref and len(out) < length:
            to, tl = self.dd[(_DFTAG_LINKED, ref)]
            tbl = self.raw[to : to + tl]
            (next_ref,) = struct.unpack(">H", tbl[:2])
            blk_refs = struct.unpack(f">{num_blk}H", tbl[2 : 2 + 2 * num_blk])
            for br in blk_refs:
                if br == 0:
                    break
                bo, bl = self.dd[(_DFTAG_LINKED, br)]
                out += self.raw[bo : bo + bl]
                if len(out) >= length:
                    break
            ref = next_ref
        return bytes(out[:length])

    def _read_compressed(self, o):
        ver, ulen, cref, model, ctype = struct.unpack(">HIHHH", self.raw[o + 2 : o + 14])
        do, dl = self.dd[(_DFTAG_COMPRESSED, cref)]
        payload = self.raw[do : do + dl]
        if ctype == 4:  # deflate
            return zlib.decompress(payload)[:ulen]
        if ctype == 0:  # none
            return payload[:ulen]
        raise NotImplementedError(f"compression type {ctype}")

    def _read_chunked(self, o):
        d = self.raw
        p = o
        (code,) = struct.unpack_from(">H", d, p); p += 2
        (hlen,) = struct.unpack_from(">I", d, p); p += 4
        p += 1  # version
        (flag,) = struct.unpack_from(">I", d, p); p += 4
        (tot,) = struct.unpack_from(">I", d, p); p += 4
        (csize,) = struct.unpack_from(">I", d, p); p += 4
        (ntsize,) = struct.unpack_from(">I", d, p); p += 4
        ttag, tref = struct.unpack_from(">HH", d, p); p += 4
        p += 4  # sp_tag/sp_ref
        (nd,) = struct.unpack_from(">I", d, p); p += 4
        dims = []
        for _ in range(nd):
            dflag, dlen, clen = struct.unpack_from(">III", d, p); p += 12
            dims.append((dlen, clen))

        # chunk table is a Vdata of records (origin[nd] int32, chk_tag u16, chk_ref u16)
        tbl = self.read_element(_DFTAG_VS, tref)
        rec_size = 4 * nd + 4
        out = bytearray(tot)
        chunk_dims = [c for (_, c) in dims]
        n_chunks_per_dim = [-(-dl // cl) for (dl, cl) in dims]
        full_dims = [dl for (dl, _) in dims]
        chunk_bytes = int(np.prod(chunk_dims)) * ntsize

        arr = np.zeros(full_dims, dtype=np.uint8)  # placeholder; assembled below
        chunks = {}
        for i in range(len(tbl) // rec_size):
            rec = tbl[i * rec_size : (i + 1) * rec_size]
            origin = struct.unpack(f">{nd}i", rec[: 4 * nd])
            ctag, cref = struct.unpack(">HH", rec[4 * nd :])
            if ctag == 0 or (ctag, cref) == (0, 0):
                continue
            chunks[origin] = self.read_element(ctag, cref)
        return chunks, dims, ntsize, tot

    # ------------------------------------------------------------------- SDS

    def _nt_dtype(self, nt_ref):
        o, ln = self.dd[(_DFTAG_NT, nt_ref)]
        version, typ, width, cls = struct.unpack(">BBBB", self.raw[o : o + 4])
        code = typ & ~0x40  # strip DFNT_LITEND flag
        dt = np.dtype(_DFNT[code])
        if typ & 0x40:
            dt = dt.newbyteorder("<")
        return dt

    def sds_list(self):
        """(ref, dims, dtype) for every NDG-described scientific dataset."""
        out = []
        for (tag, ref), (o, ln) in self.dd.items():
            if tag != _DFTAG_NDG:
                continue
            members = struct.unpack(f">{ln // 4 * 2}H", self.raw[o : o + (ln // 4) * 4])
            pairs = list(zip(members[::2], members[1::2]))
            sdd = next((r for t, r in pairs if t == _DFTAG_SDD), None)
            sd = next((r for t, r in pairs if t == _DFTAG_SD), None)
            if sdd is None or sd is None:
                continue
            so, sl = self.dd[(_DFTAG_SDD, sdd)]
            (rank,) = struct.unpack(">H", self.raw[so : so + 2])
            dims = struct.unpack(f">{rank}I", self.raw[so + 2 : so + 2 + 4 * rank])
            # NT refs follow: one for data + one per dim
            nt_tag, nt_ref = struct.unpack(
                ">HH", self.raw[so + 2 + 4 * rank : so + 6 + 4 * rank]
            )
            out.append((sd, dims, self._nt_dtype(nt_ref)))
        return out

    def get_sds(self, index=0):
        """Read scientific dataset ``index`` as a numpy array."""
        sd_ref, dims, dtype = self.sds_list()[index]
        itemsize = dtype.itemsize
        try:
            data = self.read_element(_DFTAG_SD, sd_ref)
        except KeyError:
            raise KeyError("SD data element not found")
        if isinstance(data, tuple):  # chunked
            chunks, cdims, ntsize, tot = data
            full_dims = [dl for (dl, _) in cdims]
            chunk_dims = [cl for (_, cl) in cdims]
            arr = np.zeros(full_dims, dtype=dtype)
            for origin, cbytes in chunks.items():
                chunk = np.frombuffer(cbytes, dtype=dtype)[: int(np.prod(chunk_dims))]
                chunk = chunk.reshape(chunk_dims)
                sl = tuple(
                    slice(o * c, min((o + 1) * c, d))
                    for o, c, d in zip(origin, chunk_dims, full_dims)
                )
                view_shape = tuple(s.stop - s.start for s in sl)
                arr[sl] = chunk[tuple(slice(0, n) for n in view_shape)]
            return arr
        return np.frombuffer(data, dtype=dtype)[: int(np.prod(dims))].reshape(dims)


def read_sds(path, name_or_index=0):
    """Convenience: read the (first) scientific dataset from an HDF4 file.

    The OMEGA shot files contain a single SDS ("Streak_array"), so selection by
    index is sufficient (the reference selects by that fixed name,
    load_ts_data.py:80).
    """
    f = HDF4File(path)
    index = name_or_index if isinstance(name_or_index, int) else 0
    return f.get_sds(index)
