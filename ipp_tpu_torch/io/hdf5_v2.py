"""The structures of newer HDF5 files that io/hdf5.py reads (HDF5 File
Format Specification version 3.0), in numpy-free Python and ``struct``.

What h5py writes with ``libver='v108'`` or later, with ``track_order=True``
or for groups and attribute sets past their compact limits:

- Jenkins' lookup3 hash, the checksum of every structure below (and of
  superblocks 2 and 3 and version 2 object headers); a mismatch raises
  ``FormatError`` naming the structure and its address;
- fractal heaps (III.G: ``FRHP`` header, ``FHDB`` direct and ``FHIB``
  indirect blocks through the doubling table; managed, tiny and huge
  objects), which hold the link and attribute messages of dense storage
  and the messages of the shared-message table;
- version 2 B-trees (III.A.2: ``BTHD``, ``BTIN``, ``BTLF``), read as an
  ordered walk of raw records or searched by a key;
- the shared-message table (III.C: ``SMTB`` and its indexes, ``SMLI``
  lists or version 2 B-trees of type 7), which resolves a shared
  message's heap ID to the message;
- fixed arrays (III.H: ``FAHD``, ``FADB`` with its pages) and extensible
  arrays (III.I: ``EAHD``, ``EAIB``, ``EASB``, ``EADB`` and their pages),
  two of the chunk indexes of a version 4 layout;
- global heap collections (III.E, ``GCOL``), which hold variable-length
  strings.

Each reader takes an object with ``read(address, nbytes) -> bytes`` and
caches the blocks it has checked.  Filtered heaps raise ``FormatError``.
"""

from __future__ import annotations

import bisect
import struct
from typing import Callable, Dict, Iterator, List, Optional, Tuple

UNDEF = 0xFFFFFFFFFFFFFFFF
M32 = 0xFFFFFFFF


class FormatError(OSError):
    """A structure this reader does not decode (or a damaged file)."""


def lookup3(data: bytes, init: int = 0) -> int:
    """Bob Jenkins' lookup3 ``hashlittle`` of data (H5_checksum_lookup3).
    A rotation's two parts share no bit, so each ``x ^= rot(y, k)`` is
    ``x ^ y << k ^ y >> (32 - k)`` masked once."""
    n, m = len(data), M32
    a = b = c = (0xDEADBEEF + n + init) & m
    if n == 0:
        return c
    full = (n - 1) // 12          # blocks before the last (1 to 12 bytes)
    words = struct.unpack_from(f"<{3 * full}I", data)
    for i in range(0, 3 * full, 3):
        a += words[i]
        b += words[i + 1]
        c = (c + words[i + 2]) & m
        a = (a - c ^ c << 4 ^ c >> 28) & m
        c = (c + b) & m
        b = (b - a ^ a << 6 ^ a >> 26) & m
        a = (a + c) & m
        c = (c - b ^ b << 8 ^ b >> 24) & m
        b = (b + a) & m
        a = (a - c ^ c << 16 ^ c >> 16) & m
        c = (c + b) & m
        b = (b - a ^ a << 19 ^ a >> 13) & m
        a = (a + c) & m
        c = (c - b ^ b << 4 ^ b >> 28) & m
        b = (b + a) & m
    x, y, z = struct.unpack("<3I", data[12 * full:].ljust(12, b"\0"))
    a, b, c = (a + x) & m, (b + y) & m, (c + z) & m
    c = ((c ^ b) - (b << 14 & m | b >> 18)) & m
    a = ((a ^ c) - (c << 11 & m | c >> 21)) & m
    b = ((b ^ a) - (a << 25 & m | a >> 7)) & m
    c = ((c ^ b) - (b << 16 & m | b >> 16)) & m
    a = ((a ^ c) - (c << 4 & m | c >> 28)) & m
    b = ((b ^ a) - (a << 14 & m | a >> 18)) & m
    c = ((c ^ b) - (b << 24 & m | b >> 8)) & m
    return c


def checked(buf: bytes, what: str, addr: int) -> bytes:
    """buf, whose last 4 bytes are the lookup3 checksum of the rest."""
    if lookup3(buf[:-4]) != struct.unpack_from("<I", buf, len(buf) - 4)[0]:
        raise FormatError(f"{what} checksum mismatch at {addr}")
    return buf


def header(reader, addr: int, sig: bytes, n: int) -> bytes:
    """The first n bytes of a structure at addr, its signature and version
    0 checked."""
    buf = reader.read(addr, n)
    if buf[:4] != sig:
        raise FormatError(f"no {sig.decode()} at {addr}")
    if buf[4] != 0:
        raise FormatError(f"{sig.decode()} version {buf[4]} at {addr}")
    return buf


def uint(buf: bytes, at: int, n: int) -> int:
    return int.from_bytes(buf[at:at + n], "little")


def enc_size(n: int) -> int:
    """Bytes the library takes to store counts up to n
    (H5VM_limit_enc_size)."""
    return (max(n, 1).bit_length() - 1) // 8 + 1


def log2(n: int) -> int:
    return n.bit_length() - 1


# -- version 2 B-trees -------------------------------------------------------

class BTree2:
    """A version 2 B-tree of records of one type; records are raw bytes.
    key maps a record to what the tree orders it by (for ``find``)."""

    def __init__(self, reader, addr: int, kind: int,
                 key: Optional[Callable[[bytes], object]] = None):
        head = checked(header(reader, addr, b"BTHD", 38), "BTHD", addr)
        if head[5] != kind:
            raise FormatError(f"version 2 B-tree of type {head[5]} at "
                              f"{addr} (type {kind} expected)")
        self.reader, self.key = reader, key
        self.node_size, self.rec_size, self.depth = struct.unpack_from(
            "<IHH", head, 6)
        self.root, self.nroot = struct.unpack_from("<QH", head, 16)
        # the width of the record counts in internal nodes (H5B2__hdr_init)
        leaf_max = (self.node_size - 10) // self.rec_size
        self.nrec_size = enc_size(leaf_max)
        cum, self.cum_size = [leaf_max], [0]
        for d in range(1, self.depth + 1):
            ptr = self._ptr_size(d)
            most = (self.node_size - 10 - ptr) // (self.rec_size + ptr)
            cum.append((most + 1) * cum[d - 1] + most)
            self.cum_size.append(enc_size(cum[d]))
        self._nodes: Dict[int, tuple] = {}

    def _ptr_size(self, depth: int) -> int:
        return 8 + self.nrec_size + (self.cum_size[depth - 1]
                                     if depth > 1 else 0)

    def _node(self, addr: int, nrec: int, depth: int):
        """(records, keys, children (address, records)) of a node."""
        node = self._nodes.get(addr)
        if node is not None:
            return node
        sig = b"BTLF" if depth == 0 else b"BTIN"
        ptr = self._ptr_size(depth) if depth else 0
        size = 6 + nrec * self.rec_size + (nrec + 1) * ptr if depth else \
            6 + nrec * self.rec_size
        buf = checked(header(self.reader, addr, sig, size + 4),
                      sig.decode(), addr)
        recs = [buf[6 + i * self.rec_size:6 + (i + 1) * self.rec_size]
                for i in range(nrec)]
        kids = []
        at = 6 + nrec * self.rec_size
        for _ in range(nrec + 1 if depth else 0):
            kids.append((uint(buf, at, 8), uint(buf, at + 8,
                                                self.nrec_size)))
            at += ptr
        keys = [self.key(r) for r in recs] if self.key else None
        node = self._nodes[addr] = (recs, keys, kids)
        return node

    def records(self) -> Iterator[bytes]:
        """Every record, in the tree's order."""
        def walk(addr, nrec, depth):
            recs, _, kids = self._node(addr, nrec, depth)
            for i in range(nrec + 1):
                if depth:
                    yield from walk(*kids[i], depth - 1)
                if i < nrec:
                    yield recs[i]

        if self.root != UNDEF and self.nroot:
            yield from walk(self.root, self.nroot, self.depth)

    def find(self, key) -> Optional[bytes]:
        """The record whose key equals key, or None: one path down."""
        addr, nrec, depth = self.root, self.nroot, self.depth
        if addr == UNDEF:
            return None
        while nrec:
            recs, keys, kids = self._node(addr, nrec, depth)
            i = bisect.bisect_left(keys, key)
            if i < nrec and keys[i] == key:
                return recs[i]
            if depth == 0:
                return None
            (addr, nrec), depth = kids[i], depth - 1
        return None


# -- fractal heaps -----------------------------------------------------------

class FractalHeap:
    """The objects of a fractal heap, found by their heap IDs."""

    def __init__(self, reader, addr: int):
        head = header(reader, addr, b"FRHP", 146)
        self.reader, self.addr = reader, addr
        self.id_len, filters, self.flags, self.max_man = struct.unpack_from(
            "<HHBI", head, 5)
        if filters:
            raise FormatError(f"fractal heap with I/O filters at {addr}")
        checked(head, "FRHP", addr)
        self.width, self.start, self.max_direct, max_bits, _, self.root, \
            self.root_rows = struct.unpack_from("<HQQHHQH", head, 110)
        self.off_size = (max_bits + 7) // 8
        self.len_size = min((log2(self.max_direct) + 7) // 8,
                            enc_size(self.max_man))
        self.direct_rows = log2(self.max_direct) - log2(self.start) + 2
        self.first_row_bits = log2(self.start) + log2(self.width)
        self.tiny_ext = self.id_len - 1 > 16
        # huge objects: an ID wide enough for an address and a length holds
        # them (the direct form, whose B-tree is of type 3); a narrower ID
        # holds a key of the huge-object B-tree of type 1 (H5HF__huge_init)
        (self.huge_tree,) = struct.unpack_from("<Q", head, 22)
        self.huge_direct = self.id_len - 1 >= 16
        self.huge_key_size = min(self.id_len - 1, 8)
        self._huge: Optional[BTree2] = None
        self._blocks: Dict[int, bytes] = {}

    def get(self, hid: bytes) -> bytes:
        """The object a heap ID names."""
        if hid[0] >> 6:
            raise FormatError(f"fractal heap ID version {hid[0] >> 6}")
        kind = hid[0] >> 4 & 3
        if kind == 0:
            off = uint(hid, 1, self.off_size)
            n = uint(hid, 1 + self.off_size, self.len_size)
            addr, base, size = self._locate(off)
            block = self._direct(addr, base, size)
            return block[off - base:off - base + n]
        if kind == 2:
            if self.tiny_ext:
                n = ((hid[0] & 0x0F) << 8 | hid[1]) + 1
                return hid[2:2 + n]
            return hid[1:2 + (hid[0] & 0x0F)]
        if kind == 1:
            return self._huge_object(hid)
        raise FormatError(f"fractal heap ID of type {kind} in the heap at "
                          f"{self.addr}")

    def _huge_object(self, hid: bytes) -> bytes:
        """An object over the heap's managed limit, read from the file at
        its own address."""
        if self.huge_direct:
            addr, n = struct.unpack_from("<QQ", hid, 1)
            return self.reader.read(addr, n)
        if self.huge_tree == UNDEF:
            raise FormatError(f"huge fractal-heap object ID in the heap at "
                              f"{self.addr}, which has no huge-object "
                              f"B-tree")
        if self._huge is None:
            # records: address, length, ID; the widths from the record size
            self._huge = BTree2(self.reader, self.huge_tree, 1,
                                key=lambda r: uint(r, (len(r) + 8) // 2,
                                                   (len(r) - 8) // 2))
        key = uint(hid, 1, self.huge_key_size)
        rec = self._huge.find(key)
        if rec is None:
            raise FormatError(f"huge object {key} is not in the B-tree of "
                              f"the heap at {self.addr}")
        width = (len(rec) - 8) // 2
        return self.reader.read(uint(rec, 0, 8), uint(rec, 8, width))

    def _row(self, local: int) -> Tuple[int, int, int]:
        """(row, row's first offset, block size) of a block table offset."""
        span = self.width * self.start
        if local < span:
            return 0, 0, self.start
        row = (local // span).bit_length()
        return row, span << (row - 1), self.start << (row - 1)

    def _locate(self, off: int) -> Tuple[int, int, int]:
        """(address, heap offset, size) of the direct block holding off."""
        if self.root == UNDEF:
            raise FormatError(f"empty fractal heap at {self.addr}")
        if self.root_rows == 0:
            return self.root, 0, self.start
        addr, base, nrows = self.root, 0, self.root_rows
        while True:
            kids = self._indirect(addr, base, nrows)
            row, first, size = self._row(off - base)
            col = (off - base - first) // size
            if row >= nrows:
                raise FormatError(f"heap offset {off} outside the fractal "
                                  f"heap at {self.addr}")
            child, base = kids[row * self.width + col], base + first + \
                col * size
            if child == UNDEF:
                raise FormatError(f"heap offset {off} in an unallocated "
                                  f"block of the fractal heap at {self.addr}")
            if row < self.direct_rows:
                return child, base, size
            addr, nrows = child, log2(size) - self.first_row_bits + 1

    def _indirect(self, addr: int, base: int, nrows: int) -> List[int]:
        kids = self._blocks.get(addr)
        if kids is None:
            n = nrows * self.width
            at = 13 + self.off_size
            buf = checked(header(self.reader, addr, b"FHIB", at + 8 * n + 4),
                          "FHIB", addr)
            if uint(buf, 13, self.off_size) != base:
                raise FormatError(f"FHIB at {addr} is not the block at heap "
                                  f"offset {base}")
            kids = self._blocks[addr] = list(struct.unpack_from(f"<{n}Q",
                                                                buf, at))
        return kids

    def _direct(self, addr: int, base: int, size: int) -> bytes:
        block = self._blocks.get(addr)
        if block is None:
            block = header(self.reader, addr, b"FHDB", size)
            if uint(block, 13, self.off_size) != base:
                raise FormatError(f"FHDB at {addr} is not the block at heap "
                                  f"offset {base}")
            if self.flags & 2:
                at = 13 + self.off_size
                zeroed = block[:at] + bytes(4) + block[at + 4:]
                if lookup3(zeroed) != struct.unpack_from("<I", block, at)[0]:
                    raise FormatError(f"FHDB checksum mismatch at {addr}")
            self._blocks[addr] = block
        return block


# -- fixed and extensible arrays ---------------------------------------------

class FixedArray:
    """The elements (raw bytes, or None where the page is unset) of a
    fixed array."""

    def __init__(self, reader, addr: int):
        head = checked(header(reader, addr, b"FAHD", 28), "FAHD", addr)
        self.reader = reader
        self.esize, page_bits = head[6], head[7]
        self.n, self.dblock = struct.unpack_from("<QQ", head, 8)
        self.page = 1 << page_bits
        self._pages: Dict[int, Optional[bytes]] = {}

    def get(self, i: int) -> Optional[bytes]:
        if not 0 <= i < self.n:
            raise FormatError(f"fixed array index {i} outside 0..{self.n}")
        if self.dblock == UNDEF:
            return None
        p = i // self.page if self.n > self.page else 0
        if p not in self._pages:
            self._pages[p] = self._load(p)
        buf = self._pages[p]
        if buf is None:
            return None
        at = (i - p * self.page) * self.esize
        return buf[at:at + self.esize]

    def _load(self, p: int) -> Optional[bytes]:
        """Page p's elements (the whole data block's when unpaged)."""
        if self.n <= self.page:
            buf = checked(header(self.reader, self.dblock, b"FADB",
                                 18 + self.n * self.esize), "FADB",
                          self.dblock)
            return buf[14:-4]
        npages = -(-self.n // self.page)
        prefix = 18 + (npages + 7) // 8
        head = checked(header(self.reader, self.dblock, b"FADB", prefix),
                       "FADB", self.dblock)
        if not head[14 + p // 8] & (0x80 >> p % 8):
            return None
        count = min(self.page, self.n - p * self.page)
        at = self.dblock + prefix + p * (self.page * self.esize + 4)
        return checked(self.reader.read(at, count * self.esize + 4),
                       "fixed array page", at)[:-4]


class ExtensibleArray:
    """The elements (raw bytes, or None where unset) of an extensible
    array: the index block's own, then super blocks of data blocks whose
    sizes double (H5EA__hdr_init)."""

    def __init__(self, reader, addr: int):
        head = checked(header(reader, addr, b"EAHD", 72), "EAHD", addr)
        self.reader = reader
        (self.esize, max_bits, self.iblk_n, self.dblk_min, sblk_ptrs,
         page_bits) = head[6:12]
        (self.iblock,) = struct.unpack_from("<Q", head, 60)
        self.off_size = (max_bits + 7) // 8
        self.page = 1 << page_bits
        nsblks = 1 + max_bits - log2(self.dblk_min)
        # (data blocks, elements per data block, first element, first
        # data block) of each super block
        self.sblk = []
        first = dfirst = 0
        for u in range(nsblks):
            nd, ne = 1 << u // 2, (1 << (u + 1) // 2) * self.dblk_min
            self.sblk.append((nd, ne, first, dfirst))
            first, dfirst = first + nd * ne, dfirst + nd
        self.iblk_sblks = 2 * log2(sblk_ptrs)
        self.iblk_dblks = 2 * (sblk_ptrs - 1)
        self.iblk_sblk_addrs = nsblks - self.iblk_sblks
        self._index: Optional[Tuple[bytes, tuple, tuple]] = None
        self._blocks: Dict[Tuple[int, int], Optional[bytes]] = {}
        self._supers: Dict[int, Tuple[tuple, bytes]] = {}

    def _index_block(self):
        if self._index is None:
            a = 14 + self.iblk_n * self.esize
            n = a + 8 * (self.iblk_dblks + self.iblk_sblk_addrs) + 4
            buf = checked(header(self.reader, self.iblock, b"EAIB", n),
                          "EAIB", self.iblock)
            self._index = (
                buf[14:a],
                struct.unpack_from(f"<{self.iblk_dblks}Q", buf, a),
                struct.unpack_from(f"<{self.iblk_sblk_addrs}Q", buf,
                                   a + 8 * self.iblk_dblks))
        return self._index

    def get(self, i: int) -> Optional[bytes]:
        if self.iblock == UNDEF:
            return None
        elems, dblks, sblks = self._index_block()
        if i < self.iblk_n:
            return elems[i * self.esize:(i + 1) * self.esize]
        j = i - self.iblk_n
        s = log2(j // self.dblk_min + 1)
        if s >= len(self.sblk):
            raise FormatError(f"extensible array index {i} beyond its "
                              f"super blocks")
        nd, ne, first, dfirst = self.sblk[s]
        e = j - first
        if s < self.iblk_sblks:
            addr, init = dblks[dfirst + e // ne], None
        else:
            saddr = sblks[s - self.iblk_sblks]
            if saddr == UNDEF:
                return None
            addrs, init = self._super(saddr, s)
            addr = addrs[e // ne]
            if init is not None:
                npages = ne // self.page
                bit = e // ne * npages + e % ne // self.page
                if not init[bit // 8] & (0x80 >> bit % 8):
                    return None
        if addr == UNDEF:
            return None
        e %= ne
        paged = ne > self.page
        p = e // self.page if paged else 0
        buf = self._data(addr, ne, p, paged)
        at = (e - p * self.page if paged else e) * self.esize
        return buf[at:at + self.esize]

    def _super(self, addr: int, s: int):
        """(data block addresses, page-init bitmap or None) of super
        block s."""
        sb = self._supers.get(addr)
        if sb is None:
            nd, ne, _, _ = self.sblk[s]
            init = nd * ((ne // self.page + 7) // 8) if ne > self.page else 0
            at = 14 + self.off_size
            buf = checked(header(self.reader, addr, b"EASB",
                                 at + init + 8 * nd + 4), "EASB", addr)
            sb = self._supers[addr] = (
                struct.unpack_from(f"<{nd}Q", buf, at + init),
                buf[at:at + init] if init else None)
        return sb

    def _data(self, addr: int, ne: int, p: int, paged: bool) -> bytes:
        """The elements of data block addr (of page p when paged)."""
        buf = self._blocks.get((addr, p))
        if buf is None:
            prefix = 14 + self.off_size
            if not paged:
                buf = checked(header(self.reader, addr, b"EADB",
                                     prefix + ne * self.esize + 4), "EADB",
                              addr)[prefix:-4]
            else:
                checked(header(self.reader, addr, b"EADB", prefix + 4),
                        "EADB", addr)
                at = addr + prefix + 4 + p * (self.page * self.esize + 4)
                buf = checked(self.reader.read(at, self.page * self.esize
                                               + 4),
                              "extensible array page", at)[:-4]
            self._blocks[(addr, p)] = buf
        return buf


# -- the shared-message table ------------------------------------------------

SOHM_HEAP = 0      # a record's message is in the heap (1: in a header)


class SharedMessageTable:
    """The shared object header message table (``SMTB``, superblock
    extension message 15): indexes each of some message types, holding
    the messages in a fractal heap and their heap IDs in a list
    (``SMLI``) or, past the list's limit, a version 2 B-tree of type 7.
    ``message`` returns the message a shared message's heap ID names,
    after checking that the index lists the ID."""

    def __init__(self, reader, addr: int, nindexes: int):
        size = 4 + 30 * nindexes + 4
        buf = reader.read(addr, size)
        if buf[:4] != b"SMTB":
            raise FormatError(f"no shared-message table (SMTB) at {addr}")
        checked(buf, "SMTB", addr)
        self.reader, self.indexes = reader, []
        for i in range(nindexes):
            at = 4 + 30 * i
            if buf[at] != 0:
                raise FormatError(f"shared-message index version {buf[at]} "
                                  f"at {addr}")
            kind, flags, _, _, _, nmsgs, index, heap = struct.unpack_from(
                "<BHIHHHQQ", buf, at + 1)
            self.indexes.append(dict(kind=kind, flags=flags, nmsgs=nmsgs,
                                     index=index, heap=heap, ids=None,
                                     fheap=None))

    def message(self, mtype: int, hid: bytes) -> bytes:
        idx = [x for x in self.indexes if x["flags"] >> mtype & 1]
        if not idx:
            raise FormatError(f"a shared message of type {mtype}, which no "
                              f"index of the shared-message table holds")
        x = idx[0]
        if x["ids"] is None:
            x["ids"] = self._ids(x)
            x["fheap"] = FractalHeap(self.reader, x["heap"])
        if bytes(hid) not in x["ids"]:
            raise FormatError(f"heap ID {bytes(hid).hex()} is not in the "
                              f"shared-message index of type {mtype}")
        return x["fheap"].get(hid)

    def _ids(self, x) -> set:
        """The heap IDs an index lists (its records of messages in the
        heap)."""
        if x["kind"] == 0:
            n = x["nmsgs"]
            buf = self.reader.read(x["index"], 4 + 17 * n + 4)
            if buf[:4] != b"SMLI":
                raise FormatError(f"no shared-message list (SMLI) at "
                                  f"{x['index']}")
            checked(buf, "SMLI", x["index"])
            recs = [buf[4 + 17 * i:4 + 17 * (i + 1)] for i in range(n)]
        elif x["kind"] == 1:
            recs = list(BTree2(self.reader, x["index"], 7).records())
        else:
            raise FormatError(f"shared-message index of type {x['kind']}")
        return {r[9:17] for r in recs if r[0] == SOHM_HEAP}


# -- global heaps ------------------------------------------------------------

def global_heap_objects(reader, addr: int) -> Dict[int, bytes]:
    """index -> data of every object in the global heap collection at
    addr."""
    head = reader.read(addr, 16)
    if head[:4] != b"GCOL" or head[4] != 1:
        raise FormatError(f"no global heap collection (GCOL) at {addr}")
    (size,) = struct.unpack_from("<Q", head, 8)
    buf, at, out = reader.read(addr, size), 16, {}
    while at + 16 <= size:
        idx, _, n = struct.unpack_from("<HH4xQ", buf, at)
        if idx == 0:            # the free space runs to the end
            break
        out[idx] = buf[at + 16:at + 16 + n]
        at += 16 + n + -n % 8
    return out
