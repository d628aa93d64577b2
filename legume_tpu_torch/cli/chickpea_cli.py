"""`chickpea` binary of the port: peak-to-gene cis-regulatory linkage CLI
(the JAX package's `cli/chickpea_cli.py` tree, every flag and default;
`p2g` takes `--device`, default `cuda`).

Pipeline: paired RNA + ATAC pseudobulk backends (shared columns =
pseudobulk samples) -> per-gene marginal z + eigenspace LD from the
rSVD ATAC embedding -> SuSiE-RSS fine-mapping per gene over its cis
window -> optional GhostKnockoff FDR filter -> parquet + bgzip-style
BED output. `--loco` residualizes both sides on leave-one-chromosome-
out low-rank factors before mapping (the `--tmle` double-ML path).
`--pseudobulk` partitions the cells with the port's `senna topic`
projection and sort (K1) and sums both sides on that partition (K3).
`from-multiome` needs h5py (an `ImportError` says so where it is
missing)."""

from __future__ import annotations

import argparse
import gzip
import re

import numpy as np

_PEAK_RE = re.compile(r"^([^:_]+)[:_](\d+)[-_](\d+)$")


def parse_peak_coords(names: list[str]):
    """(chrom, start, end) per peak from 'chr:start-end' style names;
    unparseable peaks get chrom=None and never enter a cis window."""
    out = []
    for n in names:
        m = _PEAK_RE.match(str(n))
        out.append((m.group(1), int(m.group(2)), int(m.group(3))) if m else (None, 0, 0))
    return out


def build_cis_windows(
    gene_names: list[str], gene_model, peak_coords, *, window: int
) -> dict[int, np.ndarray]:
    """gene index -> candidate peak indices within +-window of the TSS
    (p2g/run.rs cis-window assembly)."""
    tss = {}
    for gi, nm in enumerate(gene_model.names):
        s = gene_model.start[gi] if gene_model.strand[gi] > 0 else gene_model.end[gi]
        tss[nm] = (gene_model.chrom_names[gene_model.chrom[gi]], int(s))
    # peaks grouped by chromosome, sorted by midpoint
    by_chrom: dict[str, list[tuple[int, int]]] = {}
    for pi, (c, s, e) in enumerate(peak_coords):
        if c is not None:
            by_chrom.setdefault(c, []).append(((s + e) // 2, pi))
    for c in by_chrom:
        by_chrom[c].sort()
    cis = {}
    for gi, nm in enumerate(gene_names):
        if nm not in tss:
            continue
        c, pos = tss[nm]
        cands = by_chrom.get(c, [])
        if not cands:
            continue
        mids = np.asarray([m for m, _ in cands])
        ids = np.asarray([p for _, p in cands])
        lo = np.searchsorted(mids, pos - window)
        hi = np.searchsorted(mids, pos + window)
        if hi > lo:
            cis[gi] = ids[lo:hi]
    return cis


def loco_residualize(ys: np.ndarray, xs: np.ndarray, gene_chrom: list,
                     peak_chrom: list, *, rank: int, seed: int = 0, device="cuda"):
    """Leave-one-chromosome-out low-rank residualization (double-ML /
    --tmle path, `p2g/tmle.rs`): per chromosome, factors fit on the
    OTHER chromosomes' peaks residualize both RNA and ATAC columns of
    this chromosome, breaking trans-acting confounding without leaking
    the cis signal being tested."""
    import torch

    from ..ops.rsvd import rsvd
    from ..utils.prng import key_from_seed

    ys_r, xs_r = ys.copy(), xs.copy()
    chroms = sorted({c for c in peak_chrom if c is not None})
    for c in chroms:
        other = np.asarray([pc is not None and pc != c for pc in peak_chrom])
        if other.sum() < rank + 1:
            continue
        u, _, _ = rsvd(
            torch.from_numpy(np.asarray(xs[:, other] / np.sqrt(len(xs)), np.float32)).to(device),
            min(rank, other.sum() - 1, len(xs) - 1),
            key=key_from_seed(seed, 7),
        )
        u = np.asarray(u)  # [n, r] sample factors from other chromosomes
        q, _ = np.linalg.qr(u)
        proj = q @ q.T
        g_here = np.asarray([gc == c for gc in gene_chrom])
        p_here = np.asarray([pc == c for pc in peak_chrom])
        if g_here.any():
            ys_r[:, g_here] = ys[:, g_here] - proj @ ys[:, g_here]
        if p_here.any():
            xs_r[:, p_here] = xs[:, p_here] - proj @ xs[:, p_here]
    return ys_r, xs_r


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="chickpea", description="peak-to-gene cis-regulatory linkage"
    )
    sub = ap.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("p2g", help="SuSiE-RSS fine-mapping of genes on cis peaks")
    p.add_argument("--rna", required=True, help="RNA backend: genes x pb samples")
    p.add_argument("--atac", required=True,
                   help="ATAC backend: peaks x pb samples, names chr:start-end")
    p.add_argument("--gff", required=True, help="gene annotation (TSS)")
    p.add_argument("--out", required=True)
    p.add_argument("--cis-window", type=int, default=500_000)
    p.add_argument("--rank", "--tmle-rank", dest="rank", type=int, default=20,
                   help="LD eigenspace / LOCO factor rank")
    p.add_argument("-L", "--num-components", dest="L", type=int, default=3)
    p.add_argument("--steps", type=int, default=600)
    p.add_argument("--prior-var", type=float, default=5.0,
                   help="SuSiE effect prior variance (finemap.rs)")
    p.add_argument("--no-pve-adjust", action="store_true",
                   help="skip the winner's-curse z shrinkage")
    p.add_argument("--knockoff-fdr", "--fdr", dest="knockoff_fdr",
                   type=float, default=None,
                   help="GhostKnockoff FDR filter level (off by default)")
    p.add_argument("--ko-ridge", type=float, default=1e-4,
                   help="knockoff correlation ridge")
    p.add_argument("--ko-s", choices=["equi", "me", "mvr"], default="equi",
                   help="knockoff diag(s) construction")
    p.add_argument("--loco", "--tmle", action="store_true", dest="loco",
                   help="leave-one-chromosome-out double-ML residualization")
    p.add_argument("--tmle-atac-only", action="store_true",
                   help="LOCO-residualize the ATAC side only")
    p.add_argument("--min-pip", "--pip-threshold", dest="min_pip",
                   type=float, default=0.0, help="output PIP floor")
    p.add_argument("--pseudobulk", action="store_true",
                   help="inputs are CELL-level backends sharing barcodes; "
                        "collapse both to shared pseudobulks first "
                        "(run.rs pipeline)")
    p.add_argument("--batch-files", nargs="+", default=None,
                   help="pseudobulk mode: per-cell batch labels (RNA order)")
    p.add_argument("--use-adjusted", action="store_true",
                   help="pseudobulk mode: use the batch-ADJUSTED RNA plane")
    p.add_argument("--qc", action="store_true",
                   help="pseudobulk mode: cell QC keep mask (both sides)")
    p.add_argument("--qc-min-total", type=float, default=0.0)
    p.add_argument("--proj-dim", type=int, default=50)
    p.add_argument("--sort-dim", type=int, default=8)
    p.add_argument("--iter-opt", type=int, default=30)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda", help="torch device (cuda, or cpu)")

    p = sub.add_parser(
        "from-multiome",
        help="split a 10x Multiome h5 into paired {out}.rna.zarr + "
             "{out}.atac.zarr (+ barcode-filtered fragments)",
    )
    p.add_argument("h5_file")
    p.add_argument("--out", "-o", required=True)
    p.add_argument("--fragments", default=None,
                   help="atac_fragments.tsv.gz to filter to matched barcodes")
    return ap


def run_chickpea(argv):
    args = build_parser().parse_args(argv)

    if args.cmd == "from-multiome":
        from ..data.builders import from_multiome_h5

        rna, atac = from_multiome_h5(
            args.h5_file, args.out, fragments=args.fragments
        )
        print(f"RNA backend: {rna.num_rows} rows x {rna.num_columns} cols")
        print(f"ATAC backend: {atac.num_rows} rows x {atac.num_columns} cols")
        return

    import pandas as pd

    from ..chickpea.p2g import peak_to_gene
    from ..data.sparse_io import open_sparse_matrix
    from ..faba.genes import parse_gff_genes
    from ..utils.manifest import RunManifest

    rna = open_sparse_matrix(args.rna)
    atac = open_sparse_matrix(args.atac)
    if rna.num_columns != atac.num_columns:
        raise SystemExit(
            f"rna has {rna.num_columns} samples but atac has {atac.num_columns}"
        )
    if args.pseudobulk:
        # cell-level mode (run.rs pipeline): QC on the RNA side applies
        # to BOTH backends, the RNA projection partitions cells into
        # pseudobulk groups, and both sides collapse on that partition
        # (the RNA side batch-adjusted under --use-adjusted)
        from ..data import SparseIoVec
        from ..ops import collapse as _clp
        from ..senna.topic import TopicArgs, load_and_collapse

        rvec = SparseIoVec()
        rvec.push(rna)
        avec = SparseIoVec()
        avec.push(atac)
        if args.batch_files:
            labels = []
            for bf in args.batch_files:
                with open(bf) as f:
                    labels.extend(x.strip() for x in f if x.strip())
            rvec.register_batches(labels)
        if args.qc:
            from ..data.qc import compute_cell_qc

            qs = compute_cell_qc(rvec, device=args.device)
            keep = qs.keep_mask(min_total=args.qc_min_total)
            rvec = rvec.subset_columns(keep)
            avec = avec.subset_columns(keep)
            print(f"qc: keeping {int(keep.sum())} cells")
        targs = TopicArgs(
            proj_dim=args.proj_dim, sort_dim=args.sort_dim, num_levels=1,
            iter_opt=args.iter_opt, seed=args.seed,
        )
        levels = load_and_collapse(rvec, targs, device=args.device)
        finest = levels.collapsed[0]
        groups = levels.groups_per_level[0]
        plane = (
            finest.mu_adjusted
            if args.use_adjusted and finest.mu_adjusted is not None
            else finest.mu_observed
        )
        rna_pg = np.log1p(plane.mean().cpu().numpy().T)  # [P, G]
        n_pb = rna_pg.shape[0]
        astat = _clp.collect_basic_stats(avec, groups, n_pb, device=args.device)
        aout = _clp.optimize(astat, num_iter=args.iter_opt, device=args.device)
        atac_pp = np.log1p(aout.mu_observed.mean().cpu().numpy().T)  # [P, K]
        print(f"pseudobulk mode: {n_pb} pb samples from "
              f"{rvec.num_columns} cells")
    else:
        rna_pg = np.log1p(
            np.asarray(rna.read_columns_csc(np.arange(rna.num_columns)).todense()).T
        )  # [n, G]
        atac_pp = np.log1p(
            np.asarray(atac.read_columns_csc(np.arange(atac.num_columns)).todense()).T
        )
    gene_names = [str(g) for g in rna.row_names()]
    peak_names = [str(p) for p in atac.row_names()]
    peak_coords = parse_peak_coords(peak_names)
    model = parse_gff_genes(args.gff)
    cis = build_cis_windows(gene_names, model, peak_coords, window=args.cis_window)
    if not cis:
        raise SystemExit("no gene has candidate cis peaks (check names/GFF/window)")
    print(f"p2g: {len(cis)} genes with cis peaks "
          f"(median {int(np.median([len(v) for v in cis.values()]))} peaks/gene)")

    if args.loco:
        tssmap = {nm: model.chrom_names[model.chrom[i]] for i, nm in enumerate(model.names)}
        gene_chrom = [tssmap.get(nm) for nm in gene_names]
        peak_chrom = [c for c, _, _ in peak_coords]
        rna_res, atac_res = loco_residualize(
            rna_pg, atac_pp, gene_chrom, peak_chrom, rank=args.rank, seed=args.seed,
            device=args.device,
        )
        if args.tmle_atac_only:
            atac_pp = atac_res  # run.rs tmle_atac_only: RNA stays raw
        else:
            rna_pg, atac_pp = rna_res, atac_res

    links = peak_to_gene(
        rna_pg, atac_pp, cis,
        rank=args.rank, L=args.L, num_steps=args.steps,
        knockoff_fdr=args.knockoff_fdr,
        prior_var=args.prior_var, pve_adjust=not args.no_pve_adjust,
        ko_ridge=args.ko_ridge, ko_s=args.ko_s, seed=args.seed, device=args.device,
    )

    df = pd.DataFrame(
        {
            "gene": [gene_names[g] for g in links.gene],
            "peak": [peak_names[p] for p in links.peak],
            "pip": links.pip,
            "effect": links.effect,
        }
    )
    if links.knockoff_selected is not None:
        df["selected"] = links.knockoff_selected
    if args.min_pip > 0:
        df = df[df["pip"] >= args.min_pip]
    df.to_parquet(f"{args.out}.p2g.parquet")

    # BED output (p2g/run.rs BGZF BED): chrom start end gene pip effect
    coord_of = {peak_names[i]: peak_coords[i] for i in range(len(peak_names))}
    with gzip.open(f"{args.out}.p2g.bed.gz", "wt") as f:
        for _, row in df.iterrows():
            c, s, e = coord_of[row["peak"]]
            if c is None:
                continue
            f.write(f"{c}\t{s}\t{e}\t{row['gene']}\t{row['pip']:.4f}\t{row['effect']:.4f}\n")
    RunManifest(
        command="p2g",
        inputs={"rna": args.rna, "atac": args.atac, "gff": args.gff},
        outputs={"links": f"{args.out}.p2g.parquet", "bed": f"{args.out}.p2g.bed.gz"},
    ).save(args.out, "chickpea.json")
    print(f"wrote {args.out}.p2g.parquet and {args.out}.p2g.bed.gz ({len(df)} links)")
