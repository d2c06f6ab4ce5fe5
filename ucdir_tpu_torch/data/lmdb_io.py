"""Pure-Python LMDB file reader/writer (no `lmdb` package needed).
Counterpart of `ucdir_tpu/data/lmdb_io.py` (the port keeps its own copy).

The reference stores SR3-style datasets in LMDB environments and reads them
with `lmdb.open(root, readonly=True)` / `txn.get(key)`
(data/LRHR_dataset.py:144-201); the `lmdb` C binding is
absent from this image, so this module implements the on-disk format
directly from the LMDB spec (openldap mdb.c, 64-bit layout):

- a data.mdb file is an array of `psize`-byte pages; pages 0 and 1 are meta
  pages, the newer one (higher txnid) points at the main B+tree root;
- branch/leaf pages hold sorted even-aligned nodes addressed by a uint16
  offset array after the 16-byte page header; values too big for a leaf go
  to contiguous overflow pages (F_BIGDATA nodes store the start pgno);
- the page size rides in the FREE db's md_pad field (mm_psize in mdb.c).

`LmdbReader` implements read-only `get`/`__len__`/`items` over this format
and memory-maps the file (matching the C library's zero-copy reads).
`write_lmdb` produces a valid single-txn environment — used by
`prepare_data.py --lmdb` and the test fixtures. The writer packs leaves
bottom-up and builds branch levels until a single root, exactly the shape
`mdb_put` would produce for sorted bulk inserts.
"""
from __future__ import annotations

import mmap
import os
import struct
from typing import Dict, Iterator, List, Optional, Tuple

MAGIC = 0xBEEFC0DE
VERSION = 1
PAGEHDRSZ = 16
P_INVALID = 0xFFFFFFFFFFFFFFFF
# page flags (mdb.c)
P_BRANCH, P_LEAF, P_OVERFLOW, P_META = 0x01, 0x02, 0x04, 0x08
# node flags
F_BIGDATA = 0x01

_META = struct.Struct('<II Q Q')          # magic, version, address, mapsize
_DB = struct.Struct('<I H H Q Q Q Q Q')   # pad, flags, depth, branch, leaf,
                                          # overflow, entries, root
_PGHDR = struct.Struct('<Q H H H H')      # pgno, pad, flags, lower, upper
_NODE = struct.Struct('<H H H H')         # lo, hi, flags, ksize


def _even(n: int) -> int:
    return (n + 1) & ~1


class LmdbReader:
    """Read-only accessor for an LMDB environment (a dir containing
    data.mdb, or a direct path to the .mdb file)."""

    def __init__(self, path: str):
        if os.path.isdir(path):
            path = os.path.join(path, 'data.mdb')
        self._f = open(path, 'rb')
        self._mm = mmap.mmap(self._f.fileno(), 0, access=mmap.ACCESS_READ)
        main0, txn0, ps0 = self._parse_meta(0)
        # meta page 1 lives at psize, which meta 0 already tells us
        main1, txn1, _ = self._parse_meta(ps0)
        self.psize = ps0
        self._main = main1 if txn1 > txn0 else main0
        self.entries = self._main[6]

    def _parse_meta(self, base: int):
        magic, version, _, _ = _META.unpack_from(self._mm, base + PAGEHDRSZ)
        if magic != MAGIC:
            raise ValueError('not an LMDB file (bad magic 0x%X)' % magic)
        if version != VERSION:
            raise ValueError('unsupported LMDB data version %d' % version)
        o = base + PAGEHDRSZ + _META.size
        free_db = _DB.unpack_from(self._mm, o)
        main_db = _DB.unpack_from(self._mm, o + _DB.size)
        txnid = struct.unpack_from('<Q', self._mm, o + 2 * _DB.size + 8)[0]
        psize = free_db[0] or 4096       # mm_psize == mm_dbs[0].md_pad
        return main_db, txnid, psize

    # -- page / node accessors -----------------------------------------------
    def _page(self, pgno: int) -> int:
        return pgno * self.psize

    def _nodes(self, base: int) -> Tuple[int, int, List[int]]:
        _, _, flags, lower, _ = _PGHDR.unpack_from(self._mm, base)
        n = (lower - PAGEHDRSZ) >> 1
        ptrs = struct.unpack_from('<%dH' % n, self._mm, base + PAGEHDRSZ)
        return flags, n, list(ptrs)

    def _node_key(self, base: int, off: int) -> bytes:
        _, _, _, ksize = _NODE.unpack_from(self._mm, base + off)
        s = base + off + _NODE.size
        return self._mm[s:s + ksize]

    def _leaf_data(self, base: int, off: int) -> bytes:
        lo, hi, flags, ksize = _NODE.unpack_from(self._mm, base + off)
        dsize = lo | (hi << 16)
        s = base + off + _NODE.size + ksize
        if flags & F_BIGDATA:
            ovf = struct.unpack_from('<Q', self._mm, s)[0]
            d = self._page(ovf) + PAGEHDRSZ
            return self._mm[d:d + dsize]
        return self._mm[s:s + dsize]

    def _branch_pgno(self, base: int, off: int) -> int:
        lo, hi, flags, _ = _NODE.unpack_from(self._mm, base + off)
        return lo | (hi << 16) | (flags << 32)

    # -- lookups --------------------------------------------------------------
    def get(self, key: bytes) -> Optional[bytes]:
        if isinstance(key, str):
            key = key.encode('utf-8')
        root = self._main[7]
        if root == P_INVALID:
            return None
        base = self._page(root)
        depth = self._main[2]
        for _ in range(max(depth - 1, 0)):
            flags, n, ptrs = self._nodes(base)
            if not flags & P_BRANCH:
                break
            # rightmost child whose separator key <= target (node 0 = -inf)
            child = self._branch_pgno(base, ptrs[0])
            for off in ptrs[1:]:
                if self._node_key(base, off) <= key:
                    child = self._branch_pgno(base, off)
                else:
                    break
            base = self._page(child)
        flags, n, ptrs = self._nodes(base)
        if not flags & P_LEAF:
            raise ValueError('corrupt tree: expected leaf page')
        lo_i, hi_i = 0, n - 1                  # binary search, memcmp order
        while lo_i <= hi_i:
            mid = (lo_i + hi_i) >> 1
            k = self._node_key(base, ptrs[mid])
            if k == key:
                return self._leaf_data(base, ptrs[mid])
            if k < key:
                lo_i = mid + 1
            else:
                hi_i = mid - 1
        return None

    def items(self) -> Iterator[Tuple[bytes, bytes]]:
        """In-order (key, value) scan of the whole main DB."""
        root = self._main[7]
        if root == P_INVALID:
            return
        stack = [root]
        while stack:
            base = self._page(stack.pop())
            flags, n, ptrs = self._nodes(base)
            if flags & P_BRANCH:
                stack.extend(self._branch_pgno(base, off)
                             for off in reversed(ptrs))
            else:
                for off in ptrs:
                    yield self._node_key(base, off), self._leaf_data(base, off)

    def __len__(self) -> int:
        return self.entries

    def close(self):
        self._mm.close()
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


# -- writer -------------------------------------------------------------------

def write_lmdb(path: str, items, psize: int = 4096, inline_max: int = 1024):
    """Create an LMDB environment at `path` (a directory; data.mdb inside)
    holding `items` (dict or (key, value) iterable) in one committed
    transaction. Values larger than `inline_max` go to contiguous overflow
    pages (the C library's F_BIGDATA rule). Returns the data.mdb path."""
    os.makedirs(path, exist_ok=True)
    kv = sorted((k.encode('utf-8') if isinstance(k, str) else bytes(k),
                 v.encode('utf-8') if isinstance(v, str) else bytes(v))
                for k, v in (items.items() if isinstance(items, dict)
                             else items))
    for k, _ in kv:
        if not k or len(k) > 511:
            raise ValueError('invalid lmdb key length %d' % len(k))
    avail = psize - PAGEHDRSZ
    by_pgno: Dict[int, bytes] = {}
    next_pg = [2]

    def alloc(npg: int) -> int:
        pg = next_pg[0]
        next_pg[0] += npg
        return pg

    def page(pgno: int, flags: int, nodes: List[bytes]):
        """Assemble a branch/leaf page: ptr array ascending from the header,
        node bodies packed downward from the page end (mdb_node_add)."""
        buf = bytearray(psize)
        ptrs, upper = [], psize
        for nd in nodes:
            upper -= _even(len(nd))
            buf[upper:upper + len(nd)] = nd
            ptrs.append(upper)
        lower = PAGEHDRSZ + 2 * len(nodes)
        assert lower <= upper, 'node overflow in page assembly'
        _PGHDR.pack_into(buf, 0, pgno, 0, flags, lower, upper)
        struct.pack_into('<%dH' % len(ptrs), buf, PAGEHDRSZ, *ptrs)
        by_pgno[pgno] = bytes(buf)

    # pass 1: overflow pages (allocated in key order, like sequential puts)
    # and the final leaf-node byte strings
    n_overflow = 0
    leaf_nodes: List[Tuple[bytes, bytes]] = []   # (key, node bytes)
    for k, v in kv:
        if len(v) > inline_max:
            npg = -(-(PAGEHDRSZ + len(v)) // psize)
            pg = alloc(npg)
            buf = bytearray(npg * psize)
            struct.pack_into('<QHHI', buf, 0, pg, 0, P_OVERFLOW, npg)
            buf[PAGEHDRSZ:PAGEHDRSZ + len(v)] = v
            by_pgno[pg] = bytes(buf)
            n_overflow += npg
            nd = (_NODE.pack(len(v) & 0xFFFF, len(v) >> 16, F_BIGDATA,
                             len(k)) + k + struct.pack('<Q', pg))
        else:
            nd = (_NODE.pack(len(v) & 0xFFFF, len(v) >> 16, 0, len(k))
                  + k + v)
        leaf_nodes.append((k, nd))

    def pack_level(entries, flags):
        """Greedy-pack (key, node) pairs into pages; returns
        [(first_key, pgno)] of the packed pages."""
        groups, used = [[]], 0
        for k, nd in entries:
            c = 2 + _even(len(nd))
            if used + c > avail and groups[-1]:
                groups.append([])
                used = 0
            groups[-1].append((k, nd))
            used += c
        out = []
        for g in groups:
            pg = alloc(1)
            page(pg, flags, [nd for _, nd in g])
            out.append((g[0][0], pg))
        return out

    # pass 2: leaves; pass 3: branch levels until a single root
    n_leaf = n_branch = 0
    depth = 0
    if kv:
        level = pack_level(leaf_nodes, P_LEAF)
        n_leaf, depth = len(level), 1
        while len(level) > 1:
            depth += 1
            bn = [(k, _NODE.pack(pg & 0xFFFF, (pg >> 16) & 0xFFFF,
                                 (pg >> 32) & 0xFFFF, len(k)) + k)
                  for k, pg in level]
            level = pack_level(bn, P_BRANCH)
            n_branch += len(level)
        root = level[0][1]
    else:
        root = P_INVALID

    last_pg = next_pg[0] - 1
    mapsize = max(next_pg[0] * psize, 1 << 20)

    def meta(pgno: int) -> bytes:
        buf = bytearray(psize)
        _PGHDR.pack_into(buf, 0, pgno, 0, P_META, 0, 0)
        _META.pack_into(buf, PAGEHDRSZ, MAGIC, VERSION, 0, mapsize)
        o = PAGEHDRSZ + _META.size
        _DB.pack_into(buf, o, psize, 0, 0, 0, 0, 0, 0, P_INVALID)  # FREE db
        _DB.pack_into(buf, o + _DB.size, 0, 0, depth, n_branch, n_leaf,
                      n_overflow, len(kv), root)                   # MAIN db
        struct.pack_into('<QQ', buf, o + 2 * _DB.size, last_pg, 1)
        return bytes(buf)

    out_path = os.path.join(path, 'data.mdb')
    with open(out_path, 'wb') as f:
        f.write(meta(0))
        f.write(meta(1))
        for pg in sorted(by_pgno):
            f.seek(pg * psize)
            f.write(by_pgno[pg])
    return out_path
