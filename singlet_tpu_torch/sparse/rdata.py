"""Reader for R's serialization format (RData / RDS, version 2/3).

Covers the grammar needed for the reference's input surface: the bundled
pbmc3k dataset (reference:data/pbmc3k.RData; a named list with dgCMatrix
slots i/p/Dim/Dimnames, an rle-compressed x, and a cell_type factor,
reference:R/get_pbmc3k_data.R:14-20) and Seurat RDS objects — S4 objects
with attribute pairlists — as consumed by ``cellxgene_pipeline``
(reference:R/cellxgene_pipeline.R:19-21): ``seurat_to_parts`` extracts the
active assay's counts dgCMatrix (classic Assay slots or Assay5 layers) and
the meta.data data.frame. No R installation or third-party reader is
available in this environment, so this is implemented from the public
serialization grammar: big-endian XDR, 4-byte flag words (sexptype |
levels<<12 | attr/tag bits), typed vector payloads, pairlist attributes,
reference table for symbols/environments, and the ALTREP compact-intseq
wrapper R >= 3.5 uses for 1:n sequences.

A copy of ``singlet_tpu/sparse/rdata.py`` (numpy, scipy and the standard
library; host code, no kernel): the port imports nothing of the JAX
package, whose ``__init__`` imports jax.
"""

from __future__ import annotations

import gzip
import struct
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np

# SEXP type codes
NILSXP = 0
SYMSXP = 1
LISTSXP = 2
CLOSXP = 3
ENVSXP = 4
PROMSXP = 5
LANGSXP = 6
CHARSXP = 9
LGLSXP = 10
INTSXP = 13
REALSXP = 14
CPLXSXP = 15
STRSXP = 16
VECSXP = 19
EXPRSXP = 20
RAWSXP = 24
S4SXP = 25

# special pseudo-types
REFSXP = 255
NILVALUE_SXP = 254
GLOBALENV_SXP = 253
UNBOUNDVALUE_SXP = 252
MISSINGARG_SXP = 251
BASENAMESPACE_SXP = 250
NAMESPACESXP = 249
PACKAGESXP = 248
PERSISTSXP = 247
EMPTYENV_SXP = 242
BASEENV_SXP = 241
ALTREP_SXP = 238
ATTRLISTSXP = 240  # not a real code; placeholder


@dataclass
class RObj:
    """Parsed R object: data + attributes."""

    type: str
    value: Any
    attrs: Dict[str, Any] = field(default_factory=dict)

    @property
    def names(self) -> Optional[List[str]]:
        n = self.attrs.get("names")
        return None if n is None else list(n.value)

    def __getitem__(self, key):
        if isinstance(key, str):
            return self.value[self.names.index(key)]
        return self.value[key]


class _Reader:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0
        self.refs: List[Any] = []

    def _take(self, n: int) -> bytes:
        b = self.data[self.pos:self.pos + n]
        if len(b) != n:
            raise EOFError("truncated R serialization stream")
        self.pos += n
        return b

    def u8(self) -> int:
        return self._take(1)[0]

    def i32(self) -> int:
        return struct.unpack(">i", self._take(4))[0]

    def f64(self) -> float:
        return struct.unpack(">d", self._take(8))[0]

    def length(self) -> int:
        n = self.i32()
        if n == -1:  # long vector: two 32-bit words
            hi = self.i32()
            lo = self.i32()
            return (hi << 32) | (lo & 0xFFFFFFFF)
        return n

    # ---------------------------------------------------------------- items
    def read_item(self) -> Any:
        flags = self.i32()
        sexptype = flags & 0xFF
        has_attr = bool(flags & 0x200)
        has_tag = bool(flags & 0x400)

        if sexptype == NILVALUE_SXP or sexptype == NILSXP:
            return None
        if sexptype == REFSXP:
            idx = flags >> 8
            if idx == 0:
                idx = self.i32()
            return self.refs[idx - 1]
        if sexptype in (GLOBALENV_SXP, EMPTYENV_SXP, BASEENV_SXP,
                        UNBOUNDVALUE_SXP, MISSINGARG_SXP, BASENAMESPACE_SXP):
            return RObj("env", None)
        if sexptype == SYMSXP:
            name = self.read_item()  # CHARSXP
            sym = RObj("symbol", name)
            self.refs.append(sym)
            return sym
        if sexptype in (PACKAGESXP, NAMESPACESXP, PERSISTSXP):
            strs = self._read_stringvec_raw()
            obj = RObj("namespace", strs)
            self.refs.append(obj)
            return obj
        if sexptype == ENVSXP:
            self.i32()  # locked
            enclos = self.read_item()
            frame = self.read_item()
            hashtab = self.read_item()
            attr = self.read_item()
            obj = RObj("env", (enclos, frame, hashtab, attr))
            self.refs.append(obj)
            return obj
        if sexptype in (LISTSXP, LANGSXP, CLOSXP, PROMSXP):
            attrs = self.read_item() if has_attr else None
            tag = self.read_item() if has_tag else None
            car = self.read_item()
            cdr = self.read_item()
            return RObj("pairlist", (tag, car, cdr),
                        attrs=_pairlist_to_dict(attrs) if attrs else {})
        if sexptype == CHARSXP:
            n = self.i32()
            if n == -1:
                return None  # NA_character_
            return self._take(n).decode("utf-8", errors="replace")
        if sexptype == LGLSXP:
            n = self.length()
            v = np.frombuffer(self._take(4 * n), dtype=">i4").astype(np.int32)
            out = RObj("logical", v)
        elif sexptype == INTSXP:
            n = self.length()
            v = np.frombuffer(self._take(4 * n), dtype=">i4").astype(np.int32)
            out = RObj("integer", v)
        elif sexptype == REALSXP:
            n = self.length()
            v = np.frombuffer(self._take(8 * n), dtype=">f8").astype(np.float64)
            out = RObj("double", v)
        elif sexptype == STRSXP:
            n = self.length()
            out = RObj("character", [self.read_item() for _ in range(n)])
        elif sexptype == VECSXP or sexptype == EXPRSXP:
            n = self.length()
            out = RObj("list", [self.read_item() for _ in range(n)])
        elif sexptype == RAWSXP:
            n = self.length()
            out = RObj("raw", np.frombuffer(self._take(n), dtype=np.uint8))
        elif sexptype == CPLXSXP:
            n = self.length()
            v = np.frombuffer(self._take(16 * n), dtype=">c16")
            out = RObj("complex", v.astype(np.complex128))
        elif sexptype == S4SXP:
            attrs = self.read_item() if has_attr else None
            return RObj("s4", None,
                        attrs=_pairlist_to_dict(attrs) if attrs else {})
        elif sexptype == ALTREP_SXP:
            info = self.read_item()     # list(class symbol, package, type)
            state = self.read_item()
            self.read_item()            # attributes (usually NULL)
            return _expand_altrep(info, state)
        else:
            raise NotImplementedError(
                f"R serialization SEXP type {sexptype} not supported")

        if has_attr:
            attrs = self.read_item()
            out.attrs = _pairlist_to_dict(attrs)
        return out

    def _read_stringvec_raw(self):
        # PERSISTSXP/PACKAGESXP/NAMESPACESXP carry a raw string vector
        self.i32()  # version/flags int (0)
        n = self.i32()
        return [self.read_item() for _ in range(n)]


def _pairlist_to_dict(pl) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    node = pl
    while isinstance(node, RObj) and node.type == "pairlist":
        tag, car, cdr = node.value
        if isinstance(tag, RObj) and tag.type == "symbol":
            out[tag.value] = car
        node = cdr
    return out


def _expand_altrep(info, state):
    """Materialize the ALTREP wrappers R commonly serializes."""
    cls = info.value[0]
    cls_name = cls.value if isinstance(cls, RObj) else str(cls)
    if cls_name == "compact_intseq":
        n, start, step = state.value
        return RObj("integer",
                    (np.arange(n) * int(step) + int(start)).astype(np.int32))
    if cls_name == "compact_realseq":
        n, start, step = state.value
        return RObj("double", np.arange(n) * float(step) + float(start))
    if cls_name in ("wrap_integer", "wrap_real", "wrap_string",
                    "wrap_logical", "deferred_string"):
        payload = state.value[0] if isinstance(state, RObj) else state
        return payload
    raise NotImplementedError(f"ALTREP class {cls_name!r} not supported")


def _parse_stream(data: bytes):
    r = _Reader(data)
    magic = r._take(2)
    if magic == b"X\n":
        pass
    elif magic == b"A\n":
        raise NotImplementedError("ASCII R serialization not supported")
    elif magic == b"B\n":
        raise NotImplementedError("native-binary R serialization not supported")
    else:
        raise ValueError(f"unrecognized R serialization header {magic!r}")
    version = r.i32()
    r.i32()  # writer R version
    r.i32()  # min reader version
    if version >= 3:
        enc_len = r.i32()
        r._take(enc_len)  # native encoding string
    return r


def _decompress(raw: bytes) -> bytes:
    if raw[:2] == b"\x1f\x8b":
        return gzip.decompress(raw)
    if raw[:3] == b"BZh":
        import bz2
        return bz2.decompress(raw)
    if raw[:6] == b"\xfd7zXZ\x00":
        import lzma
        return lzma.decompress(raw)
    return raw


def read_rds(path: str):
    """Read a single-object .rds file."""
    data = _decompress(open(path, "rb").read())
    return _parse_stream(data).read_item()


def read_rdata(path: str) -> Dict[str, Any]:
    """Read a workspace .RData file -> {name: RObj}."""
    data = _decompress(open(path, "rb").read())
    if not data.startswith(b"RD"):
        raise ValueError("not an RData workspace file")
    # header line like 'RDX3\n'
    nl = data.index(b"\n")
    r = _parse_stream(data[nl + 1:])
    # the workspace is a pairlist of (symbol, value)
    out: Dict[str, Any] = {}
    node = r.read_item()
    while isinstance(node, RObj) and node.type == "pairlist":
        tag, car, cdr = node.value
        name = tag.value if isinstance(tag, RObj) else str(tag)
        out[name] = car
        node = cdr
    return out


def r_class(obj) -> List[str]:
    """The R class attribute as a list of strings ([] if absent)."""
    if not isinstance(obj, RObj):
        return []
    c = obj.attrs.get("class")
    if c is None:
        return []
    vals = c.value if isinstance(c, RObj) else c
    return [str(v) for v in vals]


def dgcmatrix_to_csc(obj):
    """Matrix-package dgCMatrix S4 -> (scipy CSC, rownames, colnames)."""
    import scipy.sparse as sp

    a = obj.attrs
    i = np.asarray(a["i"].value, np.int32)
    p = np.asarray(a["p"].value, np.int64)
    dim = tuple(int(v) for v in a["Dim"].value)
    x = np.asarray(a["x"].value, np.float64)
    M = sp.csc_matrix((x, i, p), shape=dim)
    rownames = colnames = None
    dn = a.get("Dimnames")
    if isinstance(dn, RObj) and dn.type == "list":
        rn, cn = dn.value
        if isinstance(rn, RObj):
            rownames = [str(s) for s in rn.value]
        if isinstance(cn, RObj):
            colnames = [str(s) for s in cn.value]
    return M, rownames, colnames


def _named_get(robj, name):
    """Element of a named R list by name (None if absent)."""
    names = robj.names if isinstance(robj, RObj) else None
    if names is None or name not in names:
        return None
    return robj.value[names.index(name)]


def _assay_counts(assay):
    """The counts (falling back to data) dgCMatrix of a Seurat Assay.

    Handles the classic ``Assay`` (counts/data slots,
    reference:R/cellxgene_pipeline.R:19-21 reads these via
    ``CreateSeuratObject``-produced objects) and the v5 ``Assay5`` whose
    matrices live in a named ``layers`` list."""
    aa = assay.attrs
    for slot in ("counts", "data"):
        m = aa.get(slot)
        if isinstance(m, RObj) and "dgCMatrix" in r_class(m) \
                and m.attrs.get("x") is not None and len(m.attrs["x"].value):
            return m
    layers = aa.get("layers")
    if isinstance(layers, RObj):
        for slot in ("counts", "data"):
            m = _named_get(layers, slot)
            if isinstance(m, RObj) and "dgCMatrix" in r_class(m):
                return m
    raise ValueError("Seurat assay has no non-empty counts/data dgCMatrix")


def seurat_to_parts(obj):
    """Seurat S4 object -> (counts CSC, gene_names, cell_names, meta dict).

    Reads the active assay's counts (the input surface of the reference's
    ``cellxgene_pipeline``, reference:R/cellxgene_pipeline.R:19-21: RDS ->
    keep RNA assay -> preprocess) and the ``meta.data`` data.frame.
    """
    if "Seurat" not in r_class(obj):
        raise ValueError(f"not a Seurat object (class {r_class(obj)})")
    a = obj.attrs
    assays = a["assays"]
    active = a.get("active.assay")
    name = None
    if isinstance(active, RObj) and active.value:
        name = str(active.value[0])
    assay = _named_get(assays, name) if name else None
    if assay is None:
        assay = _named_get(assays, "RNA") or assays.value[0]
    M, genes, cells = dgcmatrix_to_csc(_assay_counts(assay))

    meta = {}
    md = a.get("meta.data")
    if isinstance(md, RObj) and md.type == "list":
        conv = r_to_python(md)
        if isinstance(conv, dict):
            meta = {k: np.asarray(v) for k, v in conv.items()}
        if cells is None:
            rn = md.attrs.get("row.names")
            if isinstance(rn, RObj) and rn.type == "character":
                cells = [str(s) for s in rn.value]
    return M, genes, cells, meta


def _any_matrix_to_csc(m):
    """dgCMatrix S4 or dense R matrix -> (scipy CSC, rownames, colnames)."""
    import scipy.sparse as sp

    if isinstance(m, RObj) and "dgCMatrix" in r_class(m):
        return dgcmatrix_to_csc(m)
    if isinstance(m, RObj) and m.type in ("double", "integer"):
        dim = m.attrs.get("dim")
        if dim is None:
            raise ValueError("assay matrix has no dim attribute")
        nr, nc = (int(v) for v in dim.value[:2])
        arr = np.asarray(m.value, np.float64).reshape(nc, nr).T  # col-major
        genes = cells = None
        dn = m.attrs.get("dimnames")
        if isinstance(dn, RObj) and dn.type == "list" and len(dn.value) == 2:
            rn, cn = dn.value
            if isinstance(rn, RObj) and rn.type == "character":
                genes = [str(s) for s in rn.value]
            if isinstance(cn, RObj) and cn.type == "character":
                cells = [str(s) for s in cn.value]
        return sp.csc_matrix(arr), genes, cells
    raise ValueError(f"unsupported assay matrix (class {r_class(m)})")


def sce_to_parts(obj):
    """SingleCellExperiment / SummarizedExperiment S4 ->
    (counts CSC, gene_names, cell_names, meta dict).

    The reference's other ecosystem class (``RunNMF.SingleCellExperiment``,
    reference:R/RunNMF.R:222-324, reads ``assay(object)``). Slot layout:
    ``assays`` is a SimpleAssays/Assays wrapper whose ``data`` slot is an
    S4Vectors SimpleList with the matrices in ``listData`` (counts
    preferred, then logcounts, then the first); ``colData`` is a DFrame
    (columns in ``listData``, cell names in ``rownames``). Gene/cell names
    fall back to the assay matrix's Dimnames.
    """
    cls = r_class(obj)
    if not any(c in cls for c in
               ("SingleCellExperiment", "SummarizedExperiment",
                "RangedSummarizedExperiment")):
        raise ValueError(
            f"not a SingleCellExperiment object (class {cls})")
    a = obj.attrs

    # unwrap assays -> ... -> listData (SimpleAssays holds a SimpleList)
    node = a.get("assays")
    listdata = None
    for _ in range(4):
        if not isinstance(node, RObj):
            break
        at = node.attrs
        if "listData" in at:
            listdata = at["listData"]
            break
        node = at.get("data")
    if listdata is None:
        raise ValueError("SingleCellExperiment has no assays listData")
    assay = "counts"
    m = _named_get(listdata, "counts")
    if m is None:
        # the reference's SCE method consumes logcounts directly without
        # renormalizing (reference:R/RunNMF.R:222-324); callers must know
        # which assay was taken so they can skip LogNormalize
        assay = "logcounts"
        m = _named_get(listdata, "logcounts")
    if m is None:
        assay = "first"
        m = listdata.value[0] if listdata.value else None
    if m is None:
        raise ValueError("SingleCellExperiment assays are empty")
    M, genes, cells = _any_matrix_to_csc(m)

    meta = {}
    cd = a.get("colData")
    if isinstance(cd, RObj):
        ld = cd.attrs.get("listData")
        if isinstance(ld, RObj) and ld.type == "list":
            conv = r_to_python(ld)
            if isinstance(conv, dict):
                meta = {k: np.asarray(v) for k, v in conv.items()}
        rn = cd.attrs.get("rownames")
        if cells is None and isinstance(rn, RObj) and rn.type == "character":
            cells = [str(s) for s in rn.value]
    return M, genes, cells, meta, assay


def r_to_python(obj):
    """Best-effort conversion of an RObj tree to plain Python/numpy."""
    if obj is None:
        return None
    if not isinstance(obj, RObj):
        return obj
    if obj.type in ("integer", "double", "logical", "raw", "complex"):
        # factor: integer codes + levels attribute
        levels = obj.attrs.get("levels")
        cls = obj.attrs.get("class")
        if levels is not None and cls is not None and "factor" in list(cls.value):
            lv = [r_to_python(s) for s in levels.value]
            return np.array([lv[i - 1] if i >= 1 else None for i in obj.value])
        return obj.value
    if obj.type == "character":
        return list(obj.value)
    if obj.type == "list":
        vals = [r_to_python(v) for v in obj.value]
        names = obj.names
        if names is not None:
            return dict(zip(names, vals))
        return vals
    return obj
