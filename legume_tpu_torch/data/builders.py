"""Backend builders/exporters (the port's copy of the JAX package's
`data/builders.py`; data-beans CLI handlers equivalent,
`data-beans/src/main.rs:205+`, `handlers/builders/`).

- from_h5ad: CELLxGENE-style AnnData .h5ad (h5py; CSR/CSC X groups)
- from_10x_h5: CellRanger filtered_feature_bc_matrix.h5
- from_mtx: MatrixMarket triple (mtx + features + barcodes)
- to_mtx: MEX export (scanpy-readable)
- to_h5ad: minimal AnnData export
- subset / merge helpers

AnnData convention: X is [obs=cells, var=genes]; the backend stores
[genes, cells] (reference orientation), so X transposes on the way in.
"""

from __future__ import annotations

import gzip
import logging
from pathlib import Path

import numpy as np
import scipy.sparse as sp

from .sparse_io import SparseBackend, create_sparse_from_csc, open_sparse_matrix

log = logging.getLogger(__name__)


def _h5py():
    """h5py, or an ImportError that says which commands need it."""
    try:
        import h5py
    except ImportError as e:
        raise ImportError("the .h5ad / 10x .h5 builders and exporters need h5py, which is not "
                          "installed (.mtx, .zarr, fragments and triplet tables do not)") from e
    return h5py


def _h5_strings(ds) -> list[str]:
    out = []
    for v in np.asarray(ds):
        out.append(v.decode() if isinstance(v, bytes) else str(v))
    return out


def _read_h5ad_x(f):
    """X as scipy sparse [obs, var]."""
    x = f["X"]
    h5py = _h5py()

    if isinstance(x, h5py.Dataset):  # dense
        return sp.csr_matrix(np.asarray(x))
    enc = x.attrs.get("encoding-type", b"")
    enc = enc.decode() if isinstance(enc, bytes) else str(enc)
    shape = tuple(int(v) for v in x.attrs["shape"])
    data = np.asarray(x["data"])
    indices = np.asarray(x["indices"])
    indptr = np.asarray(x["indptr"])
    if "csc" in enc:
        return sp.csc_matrix((data, indices, indptr), shape=shape)
    return sp.csr_matrix((data, indices, indptr), shape=shape)


def _read_index(f, key):
    grp = f[key]
    idx_key = grp.attrs.get("_index", b"_index")
    idx_key = idx_key.decode() if isinstance(idx_key, bytes) else str(idx_key)
    if idx_key in grp:
        node = grp[idx_key]
        h5py = _h5py()

        if isinstance(node, h5py.Group):  # categorical
            cats = _h5_strings(node["categories"])
            codes = np.asarray(node["codes"])
            return [cats[c] for c in codes]
        return _h5_strings(node)
    raise KeyError(f"no index in {key}")


def from_h5ad(
    h5ad_path: str, output: str, *, streaming: bool | None = None
) -> SparseBackend:
    """Build a backend from .h5ad (`data-beans from-h5ad`). CSR-encoded
    X (the CELLxGENE default) streams cell slabs directly into CSC
    appends — a cell row IS a backend column — so large files never
    materialize in RAM."""
    h5py = _h5py()

    if streaming is None:
        streaming = Path(h5ad_path).stat().st_size > _STREAM_BYTES
    with h5py.File(h5ad_path, "r") as f:
        cells = _read_index(f, "obs")
        genes = _read_index(f, "var")
        x = f["X"]
        enc = x.attrs.get("encoding-type", b"") if not isinstance(x, h5py.Dataset) else ""
        enc = enc.decode() if isinstance(enc, bytes) else str(enc)
        if streaming and "csr" in enc:
            from .sparse_io import StreamingCscWriter

            indptr = np.asarray(x["indptr"], np.int64)
            n_cells, d = (int(v) for v in x.attrs["shape"])
            writer = StreamingCscWriter(str(output), d, row_names=genes)
            slab = 8192
            for lb in range(0, n_cells, slab):
                ub = min(lb + slab, n_cells)
                a, b = indptr[lb], indptr[ub]
                csr = sp.csr_matrix(
                    (
                        np.asarray(x["data"][a:b], np.float32),
                        np.asarray(x["indices"][a:b], np.int64),
                        indptr[lb : ub + 1] - a,
                    ),
                    shape=(ub - lb, d),
                )
                writer.append(csr.T.tocsc())
            backend = writer.finalize(column_names=cells)
            log.info(
                "from-h5ad (streaming): %d genes x %d cells", d, n_cells
            )
            return backend
        xm = _read_h5ad_x(f)  # [cells, genes]
    csc = xm.T.tocsc()  # -> [genes, cells]
    log.info("from-h5ad: %d genes x %d cells, nnz=%d", csc.shape[0], csc.shape[1], csc.nnz)
    return create_sparse_from_csc(csc, output, genes, cells)


def from_10x_h5(h5_path: str, output: str, *, genome: str | None = None) -> SparseBackend:
    """CellRanger .h5 (matrix group: data/indices/indptr/shape CSC
    [genes, cells]) (`data-beans from-10x-matrix`)."""
    h5py = _h5py()

    with h5py.File(h5_path, "r") as f:
        grp = f["matrix"] if "matrix" in f else f[genome or list(f.keys())[0]]
        shape = tuple(np.asarray(grp["shape"]))
        csc = sp.csc_matrix(
            (np.asarray(grp["data"]), np.asarray(grp["indices"]), np.asarray(grp["indptr"])),
            shape=shape,
        )
        feats = grp["features/name"] if "features" in grp else grp["gene_names"]
        genes = _h5_strings(feats)
        cells = _h5_strings(grp["barcodes"])
    return create_sparse_from_csc(csc, output, genes, cells)


def from_multiome_h5(
    h5_path: str, out_prefix: str, *, fragments: str | None = None
) -> tuple[SparseBackend, SparseBackend]:
    """10x Multiome filtered_feature_bc_matrix.h5 -> paired
    `{out}.rna.zarr` + `{out}.atac.zarr` split on the feature_type
    column ("Gene Expression" vs "Peaks"); optional fragments file
    filtered to the matrix's barcodes as `{out}.fragments.tsv.gz`
    (`chickpea from-multiome`, chickpea/src/from_multiome/mod.rs)."""
    h5py = _h5py()

    with h5py.File(h5_path, "r") as f:
        grp = f["matrix"] if "matrix" in f else f[list(f.keys())[0]]
        shape = tuple(np.asarray(grp["shape"]))
        csc = sp.csc_matrix(
            (np.asarray(grp["data"]), np.asarray(grp["indices"]), np.asarray(grp["indptr"])),
            shape=shape,
        )
        names = _h5_strings(grp["features/name"])
        ftypes = np.asarray(_h5_strings(grp["features/feature_type"]))
        cells = _h5_strings(grp["barcodes"])

    csr = csc.tocsr()
    rna_rows = np.nonzero(ftypes == "Gene Expression")[0]
    atac_rows = np.nonzero(ftypes == "Peaks")[0]
    if len(rna_rows) == 0 or len(atac_rows) == 0:
        raise ValueError(
            f"from-multiome: need both feature types, got "
            f"{dict(zip(*np.unique(ftypes, return_counts=True)))}"
        )
    rna = create_sparse_from_csc(
        csr[rna_rows].tocsc(), f"{out_prefix}.rna.zarr",
        [names[i] for i in rna_rows], cells,
    )
    atac = create_sparse_from_csc(
        csr[atac_rows].tocsc(), f"{out_prefix}.atac.zarr",
        [names[i] for i in atac_rows], cells,
    )
    log.info(
        "from-multiome: RNA %d x %d, ATAC %d x %d",
        rna.num_rows, rna.num_columns, atac.num_rows, atac.num_columns,
    )

    if fragments:
        keep = set(cells)
        n_in = n_out = 0
        opener = gzip.open if fragments.endswith(".gz") else open
        with opener(fragments, "rt") as fin, gzip.open(
            f"{out_prefix}.fragments.tsv.gz", "wt"
        ) as fout:
            for line in fin:
                if line.startswith("#"):
                    fout.write(line)
                    continue
                n_in += 1
                parts = line.split("\t")
                if len(parts) > 3 and parts[3] in keep:
                    fout.write(line)
                    n_out += 1
        log.info(
            "from-multiome: fragments filtered %d -> %d (matched barcodes)",
            n_in, n_out,
        )
    return rna, atac


def from_10x_molecule(
    h5_path: str,
    output: str,
    *,
    min_umi: int = 1,
) -> SparseBackend:
    """CellRanger molecule_info.h5 -> cell x gene counts
    (`data-beans from-10x-molecule`, `data-beans/src/main.rs:205+`).

    Each record is one deduplicated molecule: `barcode_idx`,
    `feature_idx`, `count` (reads supporting the UMI), `umi`. A
    molecule contributes 1 to (cell, gene) when its read support is
    >= ``min_umi`` reads."""
    h5py = _h5py()

    with h5py.File(h5_path, "r") as f:
        bc_idx = np.asarray(f["barcode_idx"], np.int64)
        ft_idx = np.asarray(f["feature_idx"], np.int64)
        support = (
            np.asarray(f["count"], np.int64)
            if "count" in f
            else np.ones_like(bc_idx)
        )
        barcodes = _h5_strings(f["barcodes"])
        feat_grp = f["features/name"] if "features" in f else f["gene_names"]
        genes = _h5_strings(feat_grp)

    keep = support >= min_umi
    bc_idx, ft_idx = bc_idx[keep], ft_idx[keep]
    # only barcodes that carry molecules become columns (the molecule
    # file lists the full whitelist)
    used = np.unique(bc_idx)
    remap = np.full(len(barcodes), -1, np.int64)
    remap[used] = np.arange(len(used))
    counts = sp.coo_matrix(
        (np.ones(len(bc_idx), np.float32), (ft_idx, remap[bc_idx])),
        shape=(len(genes), len(used)),
    ).tocsc()
    cells = [barcodes[i] for i in used]
    log.info(
        "from-10x-molecule: %d molecules -> %d genes x %d cells",
        len(bc_idx), counts.shape[0], counts.shape[1],
    )
    return create_sparse_from_csc(counts, output, genes, cells)


def from_triplets_table(
    path: str,
    output: str,
    *,
    feature_col: str = "feature_name",
    cell_col: str = "cell_id",
    value_col: str | None = None,
) -> SparseBackend:
    """Xenium/transcript-table triplets (parquet/csv of one row per
    transcript) -> feature x cell counts (`data-beans from-zarr`
    equivalent; the reference reads Xenium zarr triplet stores)."""
    import pandas as pd

    if path.endswith(".parquet"):
        df = pd.read_parquet(path)
    else:
        df = pd.read_csv(path)
    feats, f_codes = np.unique(df[feature_col].astype(str), return_inverse=True)
    cells, c_codes = np.unique(df[cell_col].astype(str), return_inverse=True)
    vals = (
        df[value_col].to_numpy(np.float32)
        if value_col is not None
        else np.ones(len(df), np.float32)
    )
    counts = sp.coo_matrix(
        (vals, (f_codes, c_codes)), shape=(len(feats), len(cells))
    ).tocsc()
    log.info(
        "from-triplets: %d rows -> %d features x %d cells",
        len(df), counts.shape[0], counts.shape[1],
    )
    return create_sparse_from_csc(counts, output, list(feats), list(cells))


# in-memory build below this compressed-file size; larger inputs stream
# through the external column sort (traits.rs:680-843 contract)
_STREAM_BYTES = 256 << 20


def from_zarr_store(
    zarr_file: str,
    output: str,
    *,
    data_field: str = "/cell_features/data",
    indices_field: str = "/cell_features/indices",
    indptr_field: str = "/cell_features/indptr",
    pointer_type: str = "row",
    row_id_field: str = "/cell_features/feature_ids",
    row_name_field: str = "/cell_features/feature_keys",
    row_type_field: str = "/cell_features/feature_types",
    select_row_type: str = "gene,peak",
    remove_row_type: str = "aggregate",
    column_name_field: str = "/cell_features/cell_id",
    do_squeeze: bool = False,
    row_nnz_cutoff: int = 1,
    column_nnz_cutoff: int = 1,
) -> SparseBackend:
    """Build a backend from a raw CSC/CSR zarr store, e.g. 10x Xenium's
    ``cell_feature_matrix.zarr.zip`` (`data-beans from-zarr`,
    handlers/builders/from_zarr.rs:129-260). `pointer_type` says what
    the indptr runs over: "row" = CSR pointers (row-major), "column" =
    CSC. Row-type select/remove patterns are case-insensitive
    substrings; a row is kept if its type contains ANY select pattern
    and NO remove pattern."""
    from .zarr_raw import read_zarr_numeric, read_zarr_strings

    values = np.asarray(read_zarr_numeric(zarr_file, data_field), np.float32)
    indices = np.asarray(read_zarr_numeric(zarr_file, indices_field), np.int64)
    indptr = np.asarray(read_zarr_numeric(zarr_file, indptr_field), np.int64)
    minor_dim = int(indices.max()) + 1 if len(indices) else 0
    major_dim = len(indptr) - 1
    if pointer_type == "row":  # CSR: rows major, columns minor
        mat = sp.csr_matrix(
            (values, indices, indptr), shape=(major_dim, minor_dim)
        ).tocsc()
    else:  # CSC: columns major, rows minor
        mat = sp.csc_matrix(
            (values, indices, indptr), shape=(minor_dim, major_dim)
        )
    n_rows, n_cols = mat.shape

    def _names(field, n, label):
        got = read_zarr_strings(zarr_file, field) if field else None
        if got is not None and len(got) >= n:
            return [str(x) for x in got[:n]]
        if got is not None:
            log.warning("%s: %d names for %d %s; using positions",
                        field, len(got), n, label)
        return [str(i) for i in range(n)]

    row_names = _names(row_name_field, n_rows, "rows")
    row_ids = _names(row_id_field, n_rows, "rows")
    if row_names == [str(i) for i in range(n_rows)] and row_ids != row_names:
        row_names = row_ids
    col_names = _names(column_name_field, n_cols, "columns")

    # row-type filter (from_zarr.rs select_row_type / remove_row_type)
    from .zarr_raw import read_zarr_strings as _rs

    row_types = _rs(zarr_file, row_type_field) if row_type_field else None
    if row_types is not None and len(row_types) >= n_rows:
        sel = [p.strip().lower() for p in select_row_type.split(",") if p.strip()]
        rem = [p.strip().lower() for p in remove_row_type.split(",") if p.strip()]
        keep = np.asarray([
            any(p in t.lower() for p in sel) and not any(p in t.lower() for p in rem)
            for t in row_types[:n_rows]
        ])
        if not keep.all():
            log.info("row-type filter keeps %d/%d rows", int(keep.sum()), n_rows)
            mat = mat[keep]
            row_names = [n for n, k in zip(row_names, keep) if k]

    if do_squeeze:
        rk = np.asarray((mat != 0).sum(1)).ravel() >= row_nnz_cutoff
        ck = np.asarray((mat != 0).sum(0)).ravel() >= column_nnz_cutoff
        mat = mat[rk][:, ck]
        row_names = [n for n, k in zip(row_names, rk) if k]
        col_names = [n for n, k in zip(col_names, ck) if k]
        log.info("squeeze: %s -> %s", (len(rk), len(ck)), mat.shape)

    return create_sparse_from_csc(mat.tocsc(), output, row_names, col_names)


def from_mtx(
    mtx: str,
    output: str,
    *,
    rows_file: str | None = None,
    cols_file: str | None = None,
    streaming: bool | None = None,
) -> SparseBackend:
    row_names = _read_name_file(rows_file) if rows_file else None
    col_names = _read_name_file(cols_file) if cols_file else None
    if streaming is None:
        streaming = Path(mtx).stat().st_size > _STREAM_BYTES
    if not streaming:
        from .ioaccel import available, mtx_triplet_chunks

        if available():
            it = mtx_triplet_chunks(mtx)
            (d_mtx, n_mtx, _nnz), _ = next(it)
            parts = list(it)
            rows = np.concatenate([p[0] for p in parts]) if parts else np.zeros(0, np.int64)
            cols = np.concatenate([p[1] for p in parts]) if parts else np.zeros(0, np.int64)
            vals = np.concatenate([p[2] for p in parts]) if parts else np.zeros(0, np.float32)
            m = sp.coo_matrix((vals, (rows, cols)), shape=(d_mtx, n_mtx)).tocsc()
        else:
            import scipy.io as sio

            m = sio.mmread(mtx).tocsc()
        return create_sparse_from_csc(m, output, row_names, col_names)
    return from_mtx_streaming(mtx, output, row_names=row_names, col_names=col_names)


def from_mtx_streaming(
    mtx: str,
    output: str,
    *,
    row_names=None,
    col_names=None,
    chunk_nnz: int = 1 << 22,
    slab_cols: int = 16384,
) -> SparseBackend:
    """Bounded-memory MTX ingestion: triplet chunks -> external column
    sort -> CSC slab appends + gene-chunked CSR rebuild (the streaming
    path of `sparse_io/traits.rs:680-843`)."""
    import pandas as pd

    from .spill import build_streaming_from_triplet_chunks

    from .ioaccel import available as _accel_ok
    from .ioaccel import mtx_triplet_chunks

    if _accel_ok():
        it = mtx_triplet_chunks(mtx, chunk=chunk_nnz)
        (d, n, nnz), _ = next(it)
        backend, sorter = build_streaming_from_triplet_chunks(
            it, output,
            n_rows=d, n_cols=n,
            row_names=row_names, column_names=col_names,
            chunk_nnz=chunk_nnz, slab_cols=slab_cols,
        )
        log.info(
            "from-mtx (streaming, native): %d x %d nnz=%d, peak resident nnz=%d",
            d, n, sorter.total_nnz, sorter.peak_resident_nnz,
        )
        return backend

    opener = gzip.open if str(mtx).endswith(".gz") else open
    with opener(mtx, "rt") as f:
        line = "%"
        while line.startswith("%"):
            line = f.readline()
        d, n, nnz = (int(x) for x in line.split()[:3])

        def chunks():
            reader = pd.read_csv(
                f, sep=r"\s+", header=None, chunksize=chunk_nnz,
                names=["i", "j", "v"], engine="c",
            )
            for df in reader:
                yield (
                    df["i"].to_numpy(np.int64) - 1,
                    df["j"].to_numpy(np.int64) - 1,
                    df["v"].to_numpy(np.float32)
                    if "v" in df and df["v"].notna().any()
                    else np.ones(len(df), np.float32),
                )

        backend, sorter = build_streaming_from_triplet_chunks(
            chunks(), output,
            n_rows=d, n_cols=n,
            row_names=row_names, column_names=col_names,
            chunk_nnz=chunk_nnz, slab_cols=slab_cols,
        )
    log.info(
        "from-mtx (streaming): %d x %d nnz=%d, peak resident nnz=%d",
        d, n, sorter.total_nnz, sorter.peak_resident_nnz,
    )
    return backend


def _read_name_file(path: str) -> list[str]:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        return [line.split("\t")[0].split()[0] for line in f if line.strip()]


def from_fragments(
    fragments_path: str,
    output: str,
    *,
    tile_size: int = 5000,
    peaks_bed: str | None = None,
    min_count: int = 1,
) -> SparseBackend:
    """ATAC fragments file -> per-cell tile (or peak) counts
    (`data-beans from-fragments`; coitrees interval overlap role).

    Fragments TSV(.gz): chrom, start, end, barcode[, count]. With
    `peaks_bed`, counts land in peak intervals (sorted-array overlap);
    otherwise fixed-size genome tiles.
    """
    opener = gzip.open if str(fragments_path).endswith(".gz") else open

    # pass 1: collect barcodes + chrom extents (or peaks)
    peaks: dict[str, np.ndarray] | None = None
    peak_names: list[str] = []
    if peaks_bed:
        by_chrom: dict[str, list] = {}
        with (gzip.open if peaks_bed.endswith(".gz") else open)(peaks_bed, "rt") as f:
            for line in f:
                p = line.split()
                if len(p) >= 3:
                    by_chrom.setdefault(p[0], []).append((int(p[1]), int(p[2])))
        peaks = {}
        for c in sorted(by_chrom):
            iv = np.asarray(sorted(by_chrom[c]))
            base = len(peak_names)
            peaks[c] = np.column_stack(
                [iv[:, 0], iv[:, 1], base + np.arange(len(iv))]
            )
            peak_names.extend(f"{c}:{s}-{e}" for s, e in iv)

    # single pass with bounded memory: triplet chunks spill to the
    # external column sorter, registries (barcodes/tiles) stay in RAM
    # (`traits.rs:680-843` streaming-CSC contract)
    from .spill import TripletSpillSorter

    sorter = TripletSpillSorter(str(output).rstrip("/") + ".sortspill")

    # native tokenizer path: vectorized per-chunk processing (the
    # Python line loop below is the fallback when g++ is absent)
    from .ioaccel import available as _accel_ok
    from .ioaccel import fragment_chunks

    if _accel_ok():
        tiles: dict[tuple, int] = {}
        tile_names: list[str] = []
        peak_pos: dict[str, np.ndarray] | None = None
        if peaks is not None:
            peak_pos = peaks  # chrom -> [n, 3] (start, end, rid)
        names_final = None
        for out in fragment_chunks(fragments_path):
            if isinstance(out, dict):
                names_final = out
                break
            cid, start, end, bid, cnt, chroms_now = out
            mid = (start + end) // 2
            if peak_pos is not None:
                rid = np.full(len(cid), -1, np.int64)
                for ci in np.unique(cid):
                    cname = chroms_now[ci]
                    iv = peak_pos.get(cname)
                    if iv is None:
                        continue
                    m = cid == ci
                    j = np.searchsorted(iv[:, 0], mid[m], side="right") - 1
                    ok = (j >= 0) & (mid[m] < iv[np.clip(j, 0, len(iv) - 1), 1])
                    rr = np.where(ok, iv[np.clip(j, 0, len(iv) - 1), 2], -1)
                    rid[m] = rr
                keep = rid >= 0
                sorter.add(rid[keep], bid[keep], cnt[keep].astype(np.float32))
            else:
                tile_idx = mid // tile_size
                rid = np.empty(len(cid), np.int64)
                # registry update via per-chunk unique pairs
                pairs = np.stack([cid, tile_idx], 1)
                uniq, inv = np.unique(pairs, axis=0, return_inverse=True)
                lut = np.empty(len(uniq), np.int64)
                for u, (ci, tj) in enumerate(uniq):
                    key = (chroms_now[ci], int(tj))
                    if key not in tiles:
                        tiles[key] = len(tiles)
                        tile_names.append(
                            f"{key[0]}:{key[1] * tile_size}-{(key[1] + 1) * tile_size}"
                        )
                    lut[u] = tiles[key]
                rid = lut[inv]
                sorter.add(rid, bid, cnt.astype(np.float32))
        names = peak_names if peaks is not None else tile_names
        barcodes_list = names_final["barcodes"]
        from .sparse_io import StreamingCscWriter

        sorter.n_rows = len(names)
        writer = StreamingCscWriter(str(output), len(names), row_names=names)
        for _lb, slab in sorter.iter_column_slabs(16384, n_cols=len(barcodes_list)):
            if min_count > 1:
                slab.data[slab.data < min_count] = 0
                slab.eliminate_zeros()
            writer.append(slab)
        backend = writer.finalize(column_names=barcodes_list)
        sorter.cleanup()
        log.info(
            "from-fragments (native): %d %s x %d cells, nnz=%d",
            len(names), "peaks" if peaks is not None else "tiles",
            len(barcodes_list), backend.num_nonzeros,
        )
        return backend
    barcodes: dict[str, int] = {}
    tiles: dict[tuple, int] = {}
    rows, cols, vals = [], [], []
    tile_names: list[str] = []
    flush_every = 1 << 20

    def flush():
        if rows:
            sorter.add(
                np.asarray(rows, np.int64),
                np.asarray(cols, np.int64),
                np.asarray(vals, np.float32),
            )
            rows.clear()
            cols.clear()
            vals.clear()

    with opener(fragments_path, "rt") as f:
        for line in f:
            if line.startswith("#"):
                continue
            p = line.split()
            if len(p) < 4:
                continue
            chrom, start, end, bc = p[0], int(p[1]), int(p[2]), p[3]
            cnt = int(p[4]) if len(p) > 4 else 1
            cb = barcodes.setdefault(bc, len(barcodes))
            mid = (start + end) // 2
            if peaks is not None:
                iv = peaks.get(chrom)
                if iv is None:
                    continue
                j = np.searchsorted(iv[:, 0], mid, side="right") - 1
                if j < 0 or mid >= iv[j, 1]:
                    continue
                rid = int(iv[j, 2])
            else:
                key = (chrom, mid // tile_size)
                if key not in tiles:
                    tiles[key] = len(tiles)
                    tile_names.append(
                        f"{chrom}:{key[1] * tile_size}-{(key[1] + 1) * tile_size}"
                    )
                rid = tiles[key]
            rows.append(rid)
            cols.append(cb)
            vals.append(cnt)
            if len(rows) >= flush_every:
                flush()
    flush()

    names = peak_names if peaks is not None else tile_names
    from .sparse_io import StreamingCscWriter

    sorter.n_rows = len(names)
    writer = StreamingCscWriter(str(output), len(names), row_names=names)
    for _lb, slab in sorter.iter_column_slabs(16384, n_cols=len(barcodes)):
        if min_count > 1:
            slab.data[slab.data < min_count] = 0
            slab.eliminate_zeros()
        writer.append(slab)
    cell_names = [None] * len(barcodes)
    for bc, i in barcodes.items():
        cell_names[i] = bc
    backend = writer.finalize(column_names=cell_names)
    sorter.cleanup()
    log.info(
        "from-fragments: %d %s x %d cells, nnz=%d (peak resident nnz %d)",
        len(names), "peaks" if peaks is not None else "tiles",
        len(barcodes), backend.num_nonzeros, sorter.peak_resident_nnz,
    )
    return backend


def to_mtx(backend_path: str, out_prefix: str):
    """MEX export: matrix.mtx.gz + features.tsv.gz + barcodes.tsv.gz
    (`data-beans to-mtx`), gzipped at `gzip.open`'s default level as the
    JAX package's is."""
    import scipy.io as sio

    be = open_sparse_matrix(backend_path)
    csc = be.read_columns_csc(np.arange(be.num_columns))
    Path(out_prefix).parent.mkdir(parents=True, exist_ok=True)
    with gzip.open(f"{out_prefix}.matrix.mtx.gz", "wb") as f:
        sio.mmwrite(f, csc)
    with gzip.open(f"{out_prefix}.features.tsv.gz", "wt") as f:
        for g in be.row_names():
            f.write(f"{g}\t{g}\tGene Expression\n")
    with gzip.open(f"{out_prefix}.barcodes.tsv.gz", "wt") as f:
        f.write("\n".join(be.column_names()) + "\n")


def to_h5ad(
    backend_path: str, out_path: str,
    *, obs_file: str | None = None, var_file: str | None = None,
):
    """Minimal scanpy-readable AnnData export (`data-beans to-h5ad`;
    ToH5adArgs obs/var: optional TSV/parquet tables joined onto the
    cell/gene index as extra columns)."""
    h5py = _h5py()

    be = open_sparse_matrix(backend_path)
    csr = be.read_columns_csc(np.arange(be.num_columns)).T.tocsr()  # [cells, genes]

    def _extra_table(path, index_names):
        if path is None:
            return None
        import pandas as pd

        df = (
            pd.read_parquet(path)
            if str(path).endswith(".parquet")
            else pd.read_csv(path, sep="\t")
        )
        df = df.set_index(df.columns[0])
        return df.reindex([str(x) for x in index_names])

    obs_extra = _extra_table(obs_file, be.column_names())
    var_extra = _extra_table(var_file, be.row_names())
    with h5py.File(out_path, "w") as f:
        x = f.create_group("X")
        x.attrs["encoding-type"] = "csr_matrix"
        x.attrs["encoding-version"] = "0.1.0"
        x.attrs["shape"] = np.asarray(csr.shape, np.int64)
        x.create_dataset("data", data=csr.data.astype(np.float32))
        x.create_dataset("indices", data=csr.indices.astype(np.int32))
        x.create_dataset("indptr", data=csr.indptr.astype(np.int32))
        for key, names, extra in (
            ("obs", be.column_names(), obs_extra),
            ("var", be.row_names(), var_extra),
        ):
            g = f.create_group(key)
            g.attrs["_index"] = "_index"
            g.attrs["encoding-type"] = "dataframe"
            g.attrs["encoding-version"] = "0.2.0"
            cols = [] if extra is None else [str(c) for c in extra.columns]
            g.attrs["column-order"] = np.asarray(cols, dtype=h5py.string_dtype())
            g.create_dataset("_index", data=np.asarray(names, dtype=h5py.string_dtype()))
            if extra is not None:
                for c in extra.columns:
                    vals = extra[c].to_numpy()
                    if vals.dtype.kind in "OUS":
                        g.create_dataset(
                            str(c),
                            data=np.asarray(
                                [str(v) for v in vals], dtype=h5py.string_dtype()
                            ),
                        )
                    else:
                        g.create_dataset(str(c), data=vals.astype(np.float64))


def subset_backend(
    backend_path: str,
    output: str,
    *,
    columns: np.ndarray | None = None,
    rows: np.ndarray | None = None,
) -> SparseBackend:
    """Subset cells/genes into a fresh backend (`data-beans subset`)."""
    be = open_sparse_matrix(backend_path)
    cols = np.arange(be.num_columns) if columns is None else np.asarray(columns)
    csc = be.read_columns_csc(cols)
    names = be.column_names()  # read once: each call decodes the store's name array
    col_names = [names[int(j)] for j in cols]
    row_names = be.row_names()
    if rows is not None:
        rows = np.asarray(rows)
        csc = csc[rows, :]
        row_names = [row_names[int(i)] for i in rows]
    return create_sparse_from_csc(csc.tocsc(), output, row_names, col_names)


def merge_backends(paths: list[str], output: str) -> SparseBackend:
    """Horizontally merge backends sharing the same feature rows
    (`data-beans merge-backend`)."""
    bes = [open_sparse_matrix(p) for p in paths]
    rows0 = bes[0].row_names()
    pieces, names = [], []
    for i, be in enumerate(bes):
        if be.row_names() != rows0:
            raise ValueError(f"backend {paths[i]} rows disagree; align first")
        pieces.append(be.read_columns_csc(np.arange(be.num_columns)))
        names.extend(f"{n}@{i}" if len(bes) > 1 else n for n in be.column_names())
    merged = sp.hstack(pieces, format="csc")
    return create_sparse_from_csc(merged, output, rows0, names)


def align_backends(paths: list[str], outputs: list[str]) -> list[SparseBackend]:
    """Rewrite each backend onto the SHARED row (feature) union, in a
    canonical sorted order, so they can be merged/stacked
    (`data-beans align`). Missing features become explicit zero rows."""
    bes = [open_sparse_matrix(p) for p in paths]
    union = sorted(set().union(*[set(be.row_names()) for be in bes]))
    idx = {n: i for i, n in enumerate(union)}
    out = []
    for be, dest in zip(bes, outputs):
        csc = be.read_columns_csc(np.arange(be.num_columns)).tocoo()
        rmap = np.asarray([idx[n] for n in be.row_names()], np.int64)
        aligned = sp.coo_matrix(
            (csc.data, (rmap[csc.row], csc.col)),
            shape=(len(union), be.num_columns),
        ).tocsc()
        out.append(
            create_sparse_from_csc(aligned, dest, union, be.column_names())
        )
    return out


def reorder_backend(
    backend_path: str, output: str, column_order: list[str]
) -> SparseBackend:
    """Reorder columns by an explicit name list (`data-beans reorder`)."""
    be = open_sparse_matrix(backend_path)
    pos = {n: i for i, n in enumerate(be.column_names())}
    missing = [n for n in column_order if n not in pos]
    if missing:
        raise ValueError(f"{len(missing)} requested columns absent, e.g. {missing[:3]}")
    cols = np.asarray([pos[n] for n in column_order], np.int64)
    return subset_backend(backend_path, output, columns=cols)


def squeeze_backend(
    backend_path: str, output: str, *, min_row_total: float = 1.0,
    row_nnz_cutoff: int = 0, column_nnz_cutoff: int = 0,
) -> SparseBackend:
    """Drop near-zero rows and (optionally) columns (`data-beans
    squeeze`; RunSqueezeArgs row/column_nnz_cutoff)."""
    be = open_sparse_matrix(backend_path)
    csc = be.read_columns_csc(np.arange(be.num_columns))
    totals = np.asarray(csc.sum(axis=1)).ravel()
    row_nnz = np.asarray((csc != 0).sum(axis=1)).ravel()
    keep_rows = np.nonzero(
        (totals >= min_row_total) & (row_nnz >= row_nnz_cutoff)
    )[0]
    keep_cols = None
    if column_nnz_cutoff > 0:
        col_nnz = np.asarray((csc != 0).sum(axis=0)).ravel()
        keep_cols = np.nonzero(col_nnz >= column_nnz_cutoff)[0]
    return subset_backend(
        backend_path, output, rows=keep_rows, columns=keep_cols
    )


def apply_build_squeeze(
    backend: SparseBackend, output: str,
    *, row_nnz_cutoff: int, column_nnz_cutoff: int,
) -> SparseBackend:
    """Post-build squeeze shared by every from-* builder (the
    reference's do_squeeze + nnz cutoffs trio on FromMtx/FromH5ad/
    From10x/FromFragments args): rewrites `output` in place with rows/
    columns below the nnz cutoffs dropped."""
    import shutil
    import tempfile

    src_path = output
    ext = ".h5" if str(output).endswith(".h5") else ".zarr"
    tmp = tempfile.mkdtemp(prefix="squeeze_") + "/t" + ext
    out_be = squeeze_backend(
        src_path, tmp, min_row_total=0.0,
        row_nnz_cutoff=row_nnz_cutoff, column_nnz_cutoff=column_nnz_cutoff,
    )
    shutil.rmtree(src_path, ignore_errors=True)
    if Path(src_path).exists():
        Path(src_path).unlink()
    shutil.move(tmp, src_path)
    log.info(
        "build squeeze: %d rows x %d cols kept",
        out_be.num_rows, out_be.num_columns,
    )
    return open_sparse_matrix(src_path)


def subsample_backend(
    backend_path: str, output: str, n_columns: "int | None" = None, *,
    cell_frac: "float | None" = None,
    n_genes: "int | None" = None,
    gene_frac: "float | None" = None,
    seed: int = 0,
) -> SparseBackend:
    """Uniform cell and/or gene subsample (`data-beans subsample`:
    SubsampleArgs cells/cell_frac/genes/gene_frac)."""
    be = open_sparse_matrix(backend_path)
    rng = np.random.default_rng(seed)
    cols = rows = None
    n_target = n_columns
    if n_target is None and cell_frac is not None:
        n_target = int(round(cell_frac * be.num_columns))
    if n_target is not None:
        n = min(max(n_target, 1), be.num_columns)
        cols = np.sort(rng.choice(be.num_columns, n, replace=False))
    g_target = n_genes
    if g_target is None and gene_frac is not None:
        g_target = int(round(gene_frac * be.num_rows))
    if g_target is not None:
        g = min(max(g_target, 1), be.num_rows)
        rows = np.sort(rng.choice(be.num_rows, g, replace=False))
    return subset_backend(backend_path, output, columns=cols, rows=rows)


def backend_stat(backend_path: str) -> dict:
    """Row/column summary statistics (`data-beans stat`)."""
    be = open_sparse_matrix(backend_path)
    csc = be.read_columns_csc(np.arange(be.num_columns))
    col_tot = np.asarray(csc.sum(axis=0)).ravel()
    row_tot = np.asarray(csc.sum(axis=1)).ravel()
    row_nnz = np.diff(sp.csr_matrix(csc).indptr)
    col_nnz = np.diff(csc.indptr)
    return {
        "nrow": be.num_rows,
        "ncol": be.num_columns,
        "nnz": int(csc.nnz),
        "total": float(csc.sum()),
        "col_total_mean": float(col_tot.mean()),
        "col_total_median": float(np.median(col_tot)),
        "col_nnz_median": float(np.median(col_nnz)),
        "row_total_mean": float(row_tot.mean()),
        "row_nnz_median": float(np.median(row_nnz)),
        "zero_rows": int((row_tot == 0).sum()),
    }


def merge_mtx(
    mtx_files: list[str],
    output: str,
    *,
    rows_file: str | None = None,
    cols_files: list[str] | None = None,
) -> SparseBackend:
    """Column-wise merge of MatrixMarket files sharing the feature axis
    (`data-beans merge-mtx`, handlers/merge_mtx.rs role): cells
    concatenate; column names get a per-file @i suffix when they
    collide across files."""
    import scipy.io as sio
    import scipy.sparse as sp

    mats = [sio.mmread(f).tocsc() for f in mtx_files]
    d = mats[0].shape[0]
    for f, m in zip(mtx_files, mats):
        if m.shape[0] != d:
            raise ValueError(f"{f}: {m.shape[0]} rows != {d}")
    merged = sp.hstack(mats, format="csc")
    row_names = _read_name_file(rows_file) if rows_file else None
    col_names = None
    if cols_files:
        col_names = []
        seen: set = set()
        for i, cf in enumerate(cols_files):
            for nm in _read_name_file(cf):
                col_names.append(f"{nm}@{i}" if nm in seen else nm)
                seen.add(nm)
    return create_sparse_from_csc(merged, output, row_names, col_names)


def sort_rows_backend(
    backend_path: str, output: str, row_order: list[str]
) -> SparseBackend:
    """Reorder feature rows by an explicit name list (`data-beans
    sort-rows`; reference main.rs "Sort rows by name order"). Names
    absent from the backend are skipped with a warning; backend rows
    absent from the list are dropped (the reference semantics: the
    name file defines the output universe)."""
    be = open_sparse_matrix(backend_path)
    pos = {n: i for i, n in enumerate(be.row_names())}
    missing = [n for n in row_order if n not in pos]
    if missing:
        log.warning(
            "sort-rows: %d requested rows absent (e.g. %s)",
            len(missing), missing[:3],
        )
    rows = np.asarray([pos[n] for n in row_order if n in pos], np.int64)
    if rows.size == 0:
        raise ValueError("sort-rows: no requested row names found in backend")
    return subset_backend(backend_path, output, rows=rows)


def convert_backend(
    backend_path: str, output: str, *, block_size: int = 8192
) -> SparseBackend:
    """Convert a backend between on-disk formats (`data-beans convert`,
    zarr <-> h5): format picked from the output extension. Zarr targets
    stream column slabs through StreamingCscWriter (bounded memory);
    h5 targets assemble in memory."""
    from .sparse_io import StreamingCscWriter, _backend_kind, finalize_zarr_zip

    be = open_sparse_matrix(backend_path)
    output = str(output)
    if _backend_kind(output) == "h5":
        csc = be.read_columns_csc(np.arange(be.num_columns))
        return create_sparse_from_csc(
            csc, output, be.row_names(), be.column_names()
        )
    # `.zarr.zip` targets stream into a working directory and archive
    # it afterwards (zarr_io.rs prepare_output/finalize_output)
    is_zip = output.endswith(".zarr.zip")
    work = output + ".working" if is_zip else output
    w = StreamingCscWriter(work, be.num_rows, row_names=be.row_names())
    for lb, ub in be.column_block_sizes(block_size):
        w.append(be.read_column_range_csc(lb, ub))
    out_be = w.finalize(column_names=be.column_names())
    if is_zip:
        del out_be
        finalize_zarr_zip(work, output)
        return open_sparse_matrix(output)
    return out_be
