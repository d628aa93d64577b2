"""`fagioli` binary of the port: genetics fine-mapping CLI (the JAX
package's `cli/fagioli_cli.py` tree, every subcommand, flag and default).
`map-sumstat`, `fit-sumstat-sgvb`, `fit-prs-susie`, `fit-sumstat-mcmc`,
`map-qtl`, `fit-qtl-sgvb`, `fit-regression` and `pseudobulk` take
`--device` (default `cuda`); the simulators run on the host. The
count-store commands keep the store's CSC: the pseudobulk sums are K3
launches on the device, where the JAX package densifies the store."""

from __future__ import annotations

import argparse
import numpy as np


def _add_panel_args(p):
    """Shared LD-reference-panel input + individual filtering
    (summary_stats/common.rs:110-151: --keep/--remove/--max-individuals,
    like plink --keep)."""
    p.add_argument("--geno", default=None, help="reference genotype .npy [n, p]")
    p.add_argument("--plink", default=None,
                   help="PLINK prefix for the LD reference panel "
                        "(alternative to --geno; enables ID filters)")
    p.add_argument("--keep", default=None,
                   help="keep only these individuals: file (one per line, "
                        "'FID IID' or 'IID', # skipped, .gz ok) or "
                        "comma-separated IIDs")
    p.add_argument("--remove", default=None,
                   help="remove these individuals (same formats as --keep)")
    p.add_argument("--max-individuals", type=int, default=None,
                   help="subsample the panel to at most N individuals")
    p.add_argument("--chromosome", default=None,
                   help="restrict PLINK panel variants to this chromosome")
    p.add_argument("--left-bound", type=int, default=None)
    p.add_argument("--right-bound", type=int, default=None)


def _parse_individual_ids(val):
    """File path (one individual per line, last column is the IID,
    # comments, .gz supported) or comma-separated IID list."""
    import gzip
    import os

    ids = set()
    if os.path.exists(val):
        op = gzip.open if val.endswith(".gz") else open
        with op(val, "rt") as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                ids.add(line.split()[-1])
    else:
        ids.update(x for x in val.split(",") if x)
    return ids


def _load_panel(args):
    """Back-compat: the dosage matrix alone."""
    return _load_panel_full(args)[0]


def _load_panel_full(args):
    """Load the LD reference panel from --geno or --plink, apply
    --keep/--remove/--max-individuals and the --chromosome/--left-bound
    /--right-bound variant filters, mean-impute missing dosages.
    Returns (geno, var_pos | None, var_names | None)."""
    var_pos = var_names = None
    if getattr(args, "plink", None):
        from ..fagioli.plink import read_plink

        pk = read_plink(args.plink)
        geno, samples = pk.genotypes, pk.sample_ids
        var_pos, var_names = pk.pos, list(pk.variant_ids)
        vkeep = np.ones(geno.shape[1], bool)
        if getattr(args, "chromosome", None) is not None \
                and pk.chrom is not None:
            vkeep &= np.asarray(
                [str(cc) == args.chromosome for cc in pk.chrom])
        if getattr(args, "left_bound", None) is not None:
            vkeep &= var_pos >= args.left_bound
        if getattr(args, "right_bound", None) is not None:
            vkeep &= var_pos <= args.right_bound
        if not vkeep.all():
            geno = geno[:, vkeep]
            var_pos = var_pos[vkeep]
            var_names = [n for n, k in zip(var_names, vkeep) if k]
            print(f"panel: {int(vkeep.sum())}/{len(vkeep)} variants in "
                  "the chromosome/bound window")
    elif getattr(args, "geno", None):
        geno = np.load(args.geno)
        samples = [str(i) for i in range(geno.shape[0])]
    else:
        raise SystemExit(f"{args.cmd}: provide --geno or --plink")
    if args.keep and args.remove:
        raise SystemExit("--keep conflicts with --remove")
    n0 = geno.shape[0]
    if args.keep:
        ids = _parse_individual_ids(args.keep)
        idx = [i for i, s in enumerate(samples) if s in ids]
        geno = geno[idx]
        print(f"kept {len(idx)}/{n0} individuals (--keep)")
    elif args.remove:
        ids = _parse_individual_ids(args.remove)
        idx = [i for i, s in enumerate(samples) if s not in ids]
        geno = geno[idx]
        print(f"removed {n0 - len(idx)}/{n0} individuals (--remove)")
    if args.max_individuals and geno.shape[0] > args.max_individuals:
        rng = np.random.default_rng(0)
        idx = np.sort(rng.choice(geno.shape[0], args.max_individuals,
                                 replace=False))
        geno = geno[idx]
        print(f"subsampled panel to {geno.shape[0]} individuals")
    if geno.shape[0] < 2:
        raise SystemExit("reference panel has fewer than 2 individuals")
    if np.isnan(geno).any():
        col_mean = np.nanmean(geno, axis=0)
        ii, jj = np.nonzero(np.isnan(geno))
        geno = geno.copy()
        geno[ii, jj] = col_mean[jj]
    return np.asarray(geno, np.float32), var_pos, var_names


def _read_zscores(args, var_names):
    """Summary statistics as a DataFrame with `variant` + `z` columns
    (CommonSumstatArgs sumstats): plain TSV (variant, z) or the
    reference's BED-like `.sumstats.bed[.gz]` (chr, start, end,
    variant, z — header optional). With a PLINK panel, rows align to
    the panel's variant ids (order-independent; missing = error)."""
    import pandas as pd

    path = args.zscores
    if ".bed" in path:
        df = pd.read_csv(path, sep="\t", comment="#", header=None)
        if str(df.iloc[0, 1]).lstrip("-").isdigit() is False:
            df = df.iloc[1:].reset_index(drop=True)  # header row
        df = df.rename(columns={
            0: "chr", 1: "start", 2: "end", 3: "variant",
            len(df.columns) - 1: "z",
        })
        df["z"] = df["z"].astype(float)
    else:
        df = pd.read_csv(path, sep="\t")
        if "variant" not in df.columns:
            df = df.rename(columns={df.columns[0]: "variant"})
    if var_names is not None:
        where = {str(v): i for i, v in enumerate(df["variant"])}
        missing = [v for v in var_names if str(v) not in where]
        if not missing:
            df = df.iloc[[where[str(v)] for v in var_names]].reset_index(
                drop=True)
        elif len(missing) == len(var_names) and len(df) == len(var_names):
            # disjoint id vocabularies but matching lengths: keep the
            # positional contract (pre-alignment behavior), loudly
            print(
                f"{args.cmd}: summary-stat variant ids share nothing "
                "with the panel's; aligning by POSITION"
            )
        else:
            raise SystemExit(
                f"{args.cmd}: {len(missing)} panel variants absent "
                f"from the summary stats (e.g. {missing[0]})"
            )
    return df


DEVICE_COMMANDS = ("map-sumstat", "fit-sumstat-sgvb", "fit-prs-susie", "fit-sumstat-mcmc",
                   "map-qtl", "fit-qtl-sgvb", "fit-regression", "pseudobulk")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="fagioli", description="genetics fine-mapping")
    sub = ap.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("map-sumstat", help="SuSiE-RSS fine-mapping from z-scores")
    p.add_argument("--zscores", required=True, help="TSV: variant z")
    _add_panel_args(p)
    p.add_argument("--out", required=True)
    p.add_argument("-L", type=int, default=5)
    p.add_argument("--steps", type=int, default=1500)
    p.add_argument("--max-rank", dest="max_rank", type=int, default=None,
                   help="LD eigenspace rank cap")
    p.add_argument("--lambda", dest="lam", type=float, default=0.1,
                   help="LD ridge")
    p.add_argument("--no-ldsc-intercept", action="store_true",
                   help="disable per-block LDSC intercept z correction")
    p.add_argument("--no-pve-adjust", action="store_true",
                   help="disable the winner's-curse z shrinkage")
    p.add_argument("--ld-block-file", default=None,
                   help="TSV variant<TAB>block_id: user LD blocks for "
                        "--multilevel (default: contiguous auto-blocks)")
    p.add_argument(
        "--multilevel", action="store_true",
        help="hierarchical block/within-block selection (LD-blocked)",
    )
    p = sub.add_parser(
        "fit-sumstat-sgvb",
        help="SGVB fine-mapping: model family + prior grid/ash",
    )
    p.add_argument("--zscores", required=True, help="TSV: variant z")
    _add_panel_args(p)
    p.add_argument("--out", required=True)
    p.add_argument("--model", default="susie",
                   choices=["susie", "bisusie", "spike-slab", "ml-susie"])
    p.add_argument("--prior-type", default="single", choices=["single", "ash"])
    p.add_argument("--prior-var", type=float, nargs="+",
                   default=[0.01, 0.1, 1.0],
                   help="variance grid (single: ELBO-selected; ash: components)")
    p.add_argument("-L", type=int, default=5)
    p.add_argument("--steps", type=int, default=1000)
    p = sub.add_parser("fit-prs-susie", help="sparse PRS weights via SuSiE")
    p.add_argument("--zscores", required=True, help="TSV: variant z")
    _add_panel_args(p)
    p.add_argument("--out", required=True)
    p.add_argument("-L", type=int, default=10)
    p.add_argument("--score-geno", default=None, help=".npy panel to score")
    p.add_argument("--steps", type=int, default=1500)
    p = sub.add_parser("fit-sumstat-mcmc", help="ESS posterior over RSS effects")
    p.add_argument("--zscores", required=True)
    _add_panel_args(p)
    p.add_argument("--out", required=True)
    p.add_argument("--samples", type=int, default=1000)
    p.add_argument("--burn-in", type=int, default=200)
    p.add_argument("--prior-sd", type=float, default=0.3)
    p = sub.add_parser(
        "sim-sumstat",
        help="multi-trait GWAS summary stats (sim_sumstat.rs "
             "SimSumstatArgs)",
    )
    p.add_argument("--out", required=True)
    p.add_argument("--plink", "--bed-prefix", dest="plink", default=None,
                   help="simulate from a REAL genotype panel")
    p.add_argument("--chromosome", default=None)
    p.add_argument("--left-bound", type=int, default=None)
    p.add_argument("--right-bound", type=int, default=None)
    p.add_argument("--max-individuals", type=int, default=None)
    p.add_argument("--n", type=int, default=500,
                   help="synthetic panel size (ignored with --plink)")
    p.add_argument("--p", type=int, default=200)
    p.add_argument("--num-traits", type=int, default=1)
    p.add_argument("--num-shared-causal", type=int, default=1,
                   help="shared causal SNPs per causal block")
    p.add_argument("--num-independent-causal", type=int, default=1,
                   help="per-trait private causal SNPs per causal block")
    p.add_argument("--num-causal-blocks", type=int, default=3)
    p.add_argument("--h2", "--h2-sparse", dest="h2", type=float,
                   default=0.3)
    p.add_argument("--h2-polygenic", type=float, default=0.0,
                   help="dense infinitesimal heritability on all SNPs")
    p.add_argument("--num-confounders", type=int, default=0)
    p.add_argument("--num-hidden-factors", type=int, default=2)
    p.add_argument("--pve-confounders", type=float, default=0.1)
    p.add_argument("--n-causal", type=int, default=3,
                   help="[--legacy] causal SNPs")
    p.add_argument("--legacy", action="store_true",
                   help="round-2 single-trait flat generator")
    p.add_argument("--seed", type=int, default=0)
    p = sub.add_parser("sim-geno", help="LD-blocked genotype panel")
    p.add_argument("--out", required=True)
    p.add_argument("--n", type=int, default=500)
    p.add_argument("--p", type=int, default=200)
    p.add_argument("--block-size", type=int, default=25)
    p.add_argument("--seed", type=int, default=0)

    p = sub.add_parser(
        "sim-qtl",
        help="single-cell eQTL generative model (sim_qtl.rs SimQtlArgs)",
    )
    p.add_argument("--out", required=True,
                   help="prefix: counts backend + annotations + truth")
    p.add_argument("--plink", "--bed-prefix", dest="plink", default=None,
                   help="simulate from a REAL genotype panel")
    p.add_argument("--chromosome", default=None)
    p.add_argument("--left-bound", type=int, default=None)
    p.add_argument("--right-bound", type=int, default=None)
    p.add_argument("--max-individuals", type=int, default=None)
    p.add_argument("--gff", default=None,
                   help="gene coords: cis-window causal placement "
                        "(overrides --genes)")
    p.add_argument("--cis-window", type=int, default=1000000)
    p.add_argument("--genes", "--num-genes", dest="genes",
                   type=int, default=40)
    p.add_argument("--indv", type=int, default=60,
                   help="synthetic panel size (ignored with --plink)")
    p.add_argument("--variants", type=int, default=50,
                   help="synthetic panel variants (ignored with --plink)")
    p.add_argument("--num-cell-types", type=int, default=5)
    p.add_argument("--num-factors", type=int, default=5)
    p.add_argument("--gene-loading-std", type=float, default=0.5)
    p.add_argument("--factor-score-std", type=float, default=0.5)
    p.add_argument("--frac-egenes", "--eqtl-gene-proportion",
                   dest="frac_egenes", type=float, default=0.5)
    p.add_argument("--shared-eqtl-proportion", type=float, default=0.5)
    p.add_argument("--independent-eqtl-proportion", type=float,
                   default=0.5)
    p.add_argument("--num-shared-causal-per-gene", type=int, default=1)
    p.add_argument("--num-independent-causal-per-gene", type=int,
                   default=1)
    p.add_argument("--genetic-variance", type=float, default=0.3)
    p.add_argument("--pve-cell-type", type=float, default=0.3)
    p.add_argument("--mean-cells-per-individual", "--cells-per-indv",
                   dest="cells_per_indv", type=float, default=25)
    p.add_argument("--depth-per-cell", type=float, default=2000.0)
    p.add_argument("--dirichlet-alpha", default=None,
                   help="comma-separated cell-type fractions prior")
    p.add_argument("--backend", choices=["zarr", "hdf5"], default="zarr")
    p.add_argument("--legacy", action="store_true",
                   help="round-2 single-celltype generator "
                        "(.npz truth outputs)")
    p.add_argument("--effect-sd", type=float, default=0.5,
                   help="[--legacy] effect size sd")
    p.add_argument("--seed", type=int, default=0)

    p = sub.add_parser("map-qtl", help="per-gene SuSiE eQTL fine-mapping")
    p.add_argument("--backend", required=True, help="gene x cell counts backend")
    p.add_argument("--indv", required=True, help="cell -> individual labels, one per line")
    p.add_argument("--geno", required=True, help=".npy [n_indv, p] dosages")
    p.add_argument("--out", required=True)
    p.add_argument("-L", type=int, default=3)
    p.add_argument("--steps", type=int, default=800)
    p.add_argument("--seed", type=int, default=0)

    p = sub.add_parser(
        "fit-qtl-sgvb",
        help="cell-type-resolved SGVB eQTL (soft membership, cis windows)",
    )
    p.add_argument("--backend", required=True, help="gene x cell counts backend")
    p.add_argument("--indv", default=None,
                   help="cell -> individual labels, one per line")
    p.add_argument("--annot", default=None,
                   help="cell annotations TSV[.gz]: cell, individual"
                        "[, celltype] (FitQtlSgvbArgs annotations)")
    p.add_argument("--geno", default=None, help=".npy [n_indv, p] dosages")
    p.add_argument("--plink", default=None, help="PLINK prefix (.bed/.bim/.fam)")
    p.add_argument("--chromosome", default=None,
                   help="restrict PLINK variants to this chromosome")
    p.add_argument("--left-bound", type=int, default=None)
    p.add_argument("--right-bound", type=int, default=None)
    p.add_argument("--max-individuals", type=int, default=None,
                   help="subsample individuals from the genotype panel")
    p.add_argument("--celltypes", default=None,
                   help="per-cell labels TSV (hard) or membership parquet (soft)")
    p.add_argument("--gff", default=None, help="gene coordinates: cis-window mode")
    p.add_argument("--gene-bed", default=None,
                   help="BED gene coords (chr start end gene[, name[, strand]])")
    p.add_argument("--cis-window", type=int, default=1000000)
    p.add_argument("--model", default="susie",
                   choices=["susie", "bisusie", "spike-slab", "ml-susie"])
    p.add_argument("--prior-type", default="single", choices=["single", "ash"])
    p.add_argument("--prior-var", type=float, nargs="+", default=[0.01, 0.1, 1.0])
    p.add_argument("--min-weight", type=float, default=2.0,
                   help="min effective cells per (indv, celltype) pair")
    p.add_argument("--a0", type=float, default=1.0,
                   help="Gamma prior shape for the Poisson-Gamma pb")
    p.add_argument("--b0", type=float, default=1.0)
    p.add_argument("-L", type=int, default=3)
    p.add_argument("--steps", "--num-iterations", dest="steps",
                   type=int, default=600)
    p.add_argument("--mc-samples", type=int, default=8,
                   help="Monte Carlo samples per SGVB gradient step")
    p.add_argument("--learning-rate", type=float, default=0.02)
    p.add_argument("--empirical-bayes", action="store_true",
                   help="pool the prior-variance grid ELBOs across "
                        "genes and pick one variance (single prior only)")
    p.add_argument("--composition-covariates", action="store_true",
                   help="residualize cell-type composition fractions "
                        "out of the pseudobulk log-rates")
    p.add_argument("--covariates", default=None,
                   help="TSV/CSV covariate file(s), comma-separated: "
                        "individual_id + numeric columns")
    p.add_argument("--out", required=True,
                   help="prefix: {out}.qtl.parquet + "
                        "{out}.results.bed.gz + {out}.parameters.json")
    p.add_argument("--seed", type=int, default=0)

    p = sub.add_parser(
        "sim-mediation",
        help="SNP -> expression -> outcome mediation simulator "
             "(sim_mediation.rs SimMediationArgs)",
    )
    p.add_argument("--out", required=True)
    p.add_argument("--plink", "--bed-prefix", dest="plink", default=None,
                   help="simulate from a REAL genotype panel")
    p.add_argument("--chromosome", default=None)
    p.add_argument("--left-bound", type=int, default=None)
    p.add_argument("--right-bound", type=int, default=None)
    p.add_argument("--max-individuals", type=int, default=None)
    p.add_argument("--n", type=int, default=800,
                   help="synthetic panel size (ignored with --plink)")
    p.add_argument("--p", type=int, default=100,
                   help="synthetic panel variants")
    p.add_argument("--gff", default=None,
                   help="gene coords for cis eQTL placement "
                        "(overrides --num-genes)")
    p.add_argument("--num-genes", type=int, default=20)
    p.add_argument("--cis-window", type=int, default=1000000)
    p.add_argument("--n-eqtl-per-gene", type=int, default=3)
    p.add_argument("--mediators", "--num-mediator-genes",
                   dest="mediators", type=int, default=5)
    p.add_argument("--num-observed-mediators", type=int, default=None)
    p.add_argument("--expression-heritability", type=float, default=0.3)
    p.add_argument("--pve-mediated", type=float, default=0.2)
    p.add_argument("--pve-direct", type=float, default=0.05)
    p.add_argument("--pve-confounder-expr", type=float, default=0.1)
    p.add_argument("--pve-confounder-y", type=float, default=0.1)
    p.add_argument("--num-confounders", type=int, default=3)
    p.add_argument("--num-hidden-factors", type=int, default=2)
    p.add_argument("--num-collider-genes", type=int, default=0)
    p.add_argument("--collider-confounder-correlation", type=float,
                   default=0.5)
    p.add_argument("--induce-collider-bias", action="store_true")
    p.add_argument("--num-conditioned-colliders", type=int, default=1)
    p.add_argument("--collider-selection-quantile", type=float,
                   default=0.5)
    p.add_argument("--n-eqtl-discovery", type=int, default=None,
                   help="discovery-cohort size: enables the "
                        "discovery/replication split with instrument "
                        "selection at --eqtl-pvalue-threshold")
    p.add_argument("--eqtl-pvalue-threshold", type=float, default=1e-3)
    p.add_argument("--legacy", action="store_true",
                   help="round-2 flat X->M->Y fixture")
    p.add_argument("--seed", type=int, default=0)

    p = sub.add_parser("fit-regression", help="SGVB regression on a table")
    p.add_argument("--table", required=True, help="TSV/parquet: response + covariates")
    p.add_argument("--response", required=True, help="response column name")
    p.add_argument("--out", required=True)
    p.add_argument("--family", choices=["susie", "spike-slab", "gaussian"], default="susie")
    p.add_argument("-L", type=int, default=5)
    p.add_argument("--steps", type=int, default=1500)

    p = sub.add_parser(
        "pseudobulk", help="per-(individual) Gamma pseudobulk log-rates"
    )
    p.add_argument("--backend", required=True, help="gene x cell counts backend")
    p.add_argument("--indv", required=True, help="cell -> individual labels, one per line")
    p.add_argument("--out", required=True)
    for name in DEVICE_COMMANDS:
        sub.choices[name].add_argument("--device", default="cuda",
                                       help="torch device (cuda, or cpu)")
    return ap


def run_fagioli(argv):
    args = build_parser().parse_args(argv)
    dev = getattr(args, "device", "cpu")

    import pandas as pd

    if args.cmd == "sim-geno":
        from ..fagioli.sim import simulate_genotypes

        gs = simulate_genotypes(
            n=args.n, p=args.p, block_size=args.block_size, seed=args.seed
        )
        np.save(args.out + ".geno.npy", gs.genotypes)
        pd.DataFrame(
            {"variant": [f"v{i}" for i in range(args.p)], "maf": gs.maf,
             "block": gs.block}
        ).to_csv(args.out + ".variants.tsv", sep="\t", index=False)
        print(f"wrote {args.out}.geno.npy and .variants.tsv")
        return
    if args.cmd == "sim-qtl":
        import scipy.sparse as sp

        from ..data.sparse_io import create_sparse_from_csc

        if args.legacy:
            from ..fagioli.qtl import simulate_qtl

            sim = simulate_qtl(
                n_genes=args.genes, n_indv=args.indv,
                cells_per_indv=int(args.cells_per_indv),
                n_variants=args.variants,
                frac_egenes=args.frac_egenes, effect_sd=args.effect_sd,
                seed=args.seed,
            )
            create_sparse_from_csc(
                sp.csc_matrix(sim.counts), f"{args.out}.zarr",
                [f"g{i}" for i in range(args.genes)],
                [f"cell{j}" for j in range(sim.counts.shape[1])],
            )
            np.save(args.out + ".geno.npy", sim.genotypes)
            with open(f"{args.out}.indv.txt", "w") as f:
                f.write("\n".join(f"i{v:04d}" for v in sim.cell_indv) + "\n")
            pd.DataFrame(
                {"gene": [f"g{i}" for i in range(args.genes)],
                 "causal_variant": sim.causal_variant, "beta": sim.beta}
            ).to_parquet(f"{args.out}.truth.parquet")
            print(f"wrote {args.out}.zarr + .geno.npy + .indv.txt + "
                  ".truth.parquet")
            return

        from ..fagioli.qtl import simulate_qtl_full

        rng = np.random.default_rng(args.seed)
        gene_names = [f"g{i}" for i in range(args.genes)]
        gene_tss = None
        var_pos = None
        if args.plink:
            from ..fagioli.plink import read_plink

            pk = read_plink(args.plink)
            geno, var_pos = pk.genotypes, pk.pos
            vkeep = np.ones(geno.shape[1], bool)
            if args.chromosome is not None and pk.chrom is not None:
                vkeep &= np.asarray(
                    [str(cc) == args.chromosome for cc in pk.chrom])
            if args.left_bound is not None:
                vkeep &= var_pos >= args.left_bound
            if args.right_bound is not None:
                vkeep &= var_pos <= args.right_bound
            geno, var_pos = geno[:, vkeep], var_pos[vkeep]
            indv_ids = list(pk.sample_ids)
        else:
            maf = rng.uniform(0.1, 0.5, args.variants)
            geno = rng.binomial(
                2, maf[None, :], size=(args.indv, args.variants)
            ).astype(np.float64)
            indv_ids = [f"i{v:04d}" for v in range(args.indv)]
            np.save(args.out + ".geno.npy", geno)
        if args.max_individuals and geno.shape[0] > args.max_individuals:
            keep_i = np.sort(rng.choice(
                geno.shape[0], args.max_individuals, replace=False))
            geno = geno[keep_i]
            indv_ids = [indv_ids[int(i)] for i in keep_i]
        if args.gff and var_pos is not None:
            from ..faba.genes import parse_gff_genes

            model_g = parse_gff_genes(args.gff)
            gene_names = list(model_g.names)
            gene_tss = np.where(
                model_g.strand > 0, model_g.start, model_g.end
            ).astype(np.int64)
        out = simulate_qtl_full(
            geno, var_pos,
            n_genes=len(gene_names), gene_tss=gene_tss,
            n_cell_types=args.num_cell_types,
            n_factors=args.num_factors,
            gene_loading_std=args.gene_loading_std,
            factor_score_std=args.factor_score_std,
            eqtl_gene_proportion=args.frac_egenes,
            shared_eqtl_proportion=args.shared_eqtl_proportion,
            independent_eqtl_proportion=args.independent_eqtl_proportion,
            n_shared_causal=args.num_shared_causal_per_gene,
            n_independent_causal=args.num_independent_causal_per_gene,
            genetic_variance=args.genetic_variance,
            cis_window=args.cis_window,
            pve_cell_type=args.pve_cell_type,
            mean_cells_per_individual=args.cells_per_indv,
            depth_per_cell=args.depth_per_cell,
            dirichlet_alpha=(
                [float(x) for x in args.dirichlet_alpha.split(",")]
                if args.dirichlet_alpha else None
            ),
            seed=args.seed,
        )
        n_cells = out["counts"].shape[1]
        cells = [f"cell{j}" for j in range(n_cells)]
        sfx = ".h5" if args.backend == "hdf5" else ".zarr"
        create_sparse_from_csc(
            sp.csc_matrix(out["counts"]), f"{args.out}{sfx}",
            gene_names, cells,
        )
        # reference-shape cell annotations (cell, individual, celltype)
        pd.DataFrame({
            "cell": cells,
            "individual": [indv_ids[int(i)] for i in out["cell_indv"]],
            "celltype": [f"ct{int(t)}" for t in out["cell_type"]],
        }).to_csv(f"{args.out}.annotations.tsv.gz", sep="\t",
                  index=False, header=False)
        pd.DataFrame(
            out["truth"],
            columns=["gene", "celltype", "variant", "beta", "kind"],
        ).assign(gene=lambda d: [gene_names[int(i)] for i in d["gene"]]
                 ).to_parquet(f"{args.out}.truth.parquet")
        print(
            f"wrote {args.out}{sfx} ({len(gene_names)} genes x "
            f"{n_cells} cells, {len(out['truth'])} causal entries) + "
            ".annotations.tsv.gz + .truth.parquet"
        )
        return
    if args.cmd == "map-qtl":
        from ..data.sparse_io import open_sparse_matrix
        from ..fagioli.qtl import map_qtl

        be = open_sparse_matrix(args.backend)
        counts = be.read_columns_csc(np.arange(be.num_columns))  # [G, N] CSC, kept sparse
        with open(args.indv) as f:
            labels = np.asarray([line.strip() for line in f if line.strip()])
        names, cell_indv = np.unique(labels, return_inverse=True)
        geno = np.load(args.geno)
        if geno.shape[0] != len(names):
            raise SystemExit(
                f"genotypes have {geno.shape[0]} rows but {len(names)} individuals found"
            )
        out = map_qtl(
            counts, cell_indv, geno, L=args.L, num_steps=args.steps, seed=args.seed,
            device=dev,
        )
        g, p_var = out["pip"].shape
        pd.DataFrame(
            {
                "gene": np.repeat([str(x) for x in be.row_names()], p_var),
                "variant": np.tile([f"v{j}" for j in range(p_var)], g),
                "pip": out["pip"].ravel(),
                "effect": out["effect"].ravel(),
            }
        ).to_parquet(f"{args.out}.qtl.parquet")
        print(f"wrote {args.out}.qtl.parquet ({g} genes x {p_var} variants)")
        return
    if args.cmd == "sim-mediation":
        if args.legacy:
            from ..fagioli.sim import simulate_mediation

            sim = simulate_mediation(
                n=args.n, p=args.p, n_mediators=args.mediators,
                seed=args.seed,
            )
            np.save(args.out + ".geno.npy", sim.genotypes)
            m = sim.z_med.shape[1]
            med_cols = {f"z_med{j}": sim.z_med[:, j] for j in range(m)}
            pd.DataFrame(
                {"variant": [f"v{i}" for i in range(args.p)],
                 "z": sim.z_out, **med_cols}
            ).to_csv(args.out + ".sumstat.tsv", sep="\t", index=False)
            pd.DataFrame(
                {"mediator": [f"m{j}" for j in range(m)],
                 "beta_med": sim.beta_med}
            ).to_parquet(args.out + ".truth.parquet")
            np.save(args.out + ".alpha.npy", sim.alpha)
            print(f"wrote {args.out}.geno.npy + .sumstat.tsv + "
                  ".truth.parquet")
            return

        from ..fagioli.sim import simulate_genotypes, simulate_mediation_full

        rng = np.random.default_rng(args.seed)
        gene_names = [f"g{i}" for i in range(args.num_genes)]
        gene_tss = var_pos = None
        if args.plink:
            from ..fagioli.plink import read_plink

            pk = read_plink(args.plink)
            geno, var_pos = pk.genotypes, pk.pos
            vkeep = np.ones(geno.shape[1], bool)
            if args.chromosome is not None and pk.chrom is not None:
                vkeep &= np.asarray(
                    [str(cc) == args.chromosome for cc in pk.chrom])
            if args.left_bound is not None:
                vkeep &= var_pos >= args.left_bound
            if args.right_bound is not None:
                vkeep &= var_pos <= args.right_bound
            geno, var_pos = geno[:, vkeep], var_pos[vkeep]
            var_names = [n for n, k in zip(pk.variant_ids, vkeep) if k]
        else:
            geno = simulate_genotypes(
                n=args.n, p=args.p, seed=args.seed).genotypes
            var_names = [f"v{j}" for j in range(args.p)]
        if args.max_individuals and geno.shape[0] > args.max_individuals:
            keep_i = np.sort(rng.choice(
                geno.shape[0], args.max_individuals, replace=False))
            geno = geno[keep_i]
        if args.gff and var_pos is not None:
            from ..faba.genes import parse_gff_genes

            model_g = parse_gff_genes(args.gff)
            gene_names = list(model_g.names)
            gene_tss = np.where(
                model_g.strand > 0, model_g.start, model_g.end
            ).astype(np.int64)
        out = simulate_mediation_full(
            geno, var_pos,
            n_genes=len(gene_names), gene_tss=gene_tss,
            cis_window=args.cis_window,
            n_eqtl_per_gene=args.n_eqtl_per_gene,
            num_mediator_genes=args.mediators,
            num_observed_mediators=args.num_observed_mediators,
            expression_heritability=args.expression_heritability,
            pve_mediated=args.pve_mediated,
            pve_direct=args.pve_direct,
            pve_confounder_expr=args.pve_confounder_expr,
            pve_confounder_y=args.pve_confounder_y,
            num_confounders=args.num_confounders,
            num_hidden_factors=args.num_hidden_factors,
            num_collider_genes=args.num_collider_genes,
            collider_confounder_correlation=(
                args.collider_confounder_correlation),
            induce_collider_bias=args.induce_collider_bias,
            num_conditioned_colliders=args.num_conditioned_colliders,
            collider_selection_quantile=(
                args.collider_selection_quantile),
            n_eqtl_discovery=args.n_eqtl_discovery,
            eqtl_pvalue_threshold=args.eqtl_pvalue_threshold,
            seed=args.seed,
        )
        np.save(args.out + ".geno.npy", geno)
        pd.DataFrame(
            out["expression"], columns=gene_names,
        ).assign(outcome=out["outcome"], kept=out["keep"]).to_parquet(
            args.out + ".phenotypes.parquet")
        z_cols = {f"z_{g}": out["z_med"][:, gi]
                  for gi, g in enumerate(gene_names)}
        pd.DataFrame(
            {"variant": var_names, "z": out["z_out"], **z_cols}
        ).to_csv(args.out + ".sumstat.tsv", sep="\t", index=False)
        truth = {
            "gene": gene_names,
            "beta_med": out["beta_med"],
            "is_mediator": [gi in set(out["mediator_ids"])
                            for gi in range(len(gene_names))],
            "is_observed": [gi in set(out["observed_ids"])
                            for gi in range(len(gene_names))],
            "is_collider": [gi in set(out["collider_ids"])
                            for gi in range(len(gene_names))],
        }
        pd.DataFrame(truth).to_parquet(args.out + ".truth.parquet")
        np.save(args.out + ".alpha.npy", out["alpha"])
        extra = ""
        if out["instruments"] is not None:
            np.save(args.out + ".instruments.npy", out["instruments"])
            extra = " + .instruments.npy"
        print(
            f"wrote {args.out}.geno.npy + .phenotypes.parquet + "
            f".sumstat.tsv + .truth.parquet{extra} "
            f"(replication n = {out['n_replication']})"
        )
        return
    if args.cmd == "fit-qtl-sgvb":
        from ..data import open_sparse_matrix
        from ..fagioli.qtl import fit_qtl_sgvb

        be = open_sparse_matrix(args.backend)
        counts = be.read_columns_csc(np.arange(be.num_columns))  # [G, N] CSC, kept sparse
        annot_ct = None
        if args.annot:
            # cell annotations table (cell, individual[, celltype]) —
            # the reference's input shape; rows align by cell name
            import gzip as _gzip

            opener = _gzip.open if args.annot.endswith(".gz") else open
            lut, lut_ct = {}, {}
            with opener(args.annot, "rt") as f:
                for ln in f:
                    parts = ln.split()
                    if len(parts) >= 2 and parts[0] != "cell":
                        lut[parts[0]] = parts[1]
                        if len(parts) >= 3:
                            lut_ct[parts[0]] = parts[2]
            cells_ax = [str(x) for x in be.column_names()]
            missing = [x for x in cells_ax if x not in lut]
            if missing:
                raise SystemExit(
                    f"fit-qtl-sgvb: {len(missing)} cells absent from "
                    f"--annot (e.g. {missing[0]})"
                )
            labels = np.asarray([lut[x] for x in cells_ax])
            if lut_ct:
                annot_ct = np.asarray(
                    [lut_ct.get(x, "NA") for x in cells_ax]
                )
        elif args.indv:
            with open(args.indv) as f:
                labels = np.asarray([ln.strip() for ln in f if ln.strip()])
        else:
            raise SystemExit("fit-qtl-sgvb: provide --annot or --indv")
        indv_names, cell_indv = np.unique(labels, return_inverse=True)
        if args.plink:
            from ..fagioli.plink import read_plink

            pk = read_plink(args.plink)
            geno = pk.genotypes
            var_pos = pk.pos
            var_names = pk.variant_ids
            # align the panel's sample rows with the (sorted-unique)
            # individual labels — PLINK .fam order is arbitrary, and
            # np.unique's lexicographic order is NOT it (I10 < I2)
            sample_of = {str(s): r for r, s in enumerate(pk.sample_ids)}
            missing = [n for n in indv_names if str(n) not in sample_of]
            if missing:
                raise SystemExit(
                    f"fit-qtl-sgvb: {len(missing)} individuals absent "
                    f"from the PLINK panel (e.g. {missing[0]})"
                )
            geno = geno[[sample_of[str(n)] for n in indv_names]]
            vkeep = np.ones(geno.shape[1], bool)
            if args.chromosome is not None and pk.chrom is not None:
                vkeep &= np.asarray(
                    [str(cc) == args.chromosome for cc in pk.chrom]
                )
            if args.left_bound is not None:
                vkeep &= var_pos >= args.left_bound
            if args.right_bound is not None:
                vkeep &= var_pos <= args.right_bound
            if not vkeep.all():
                geno = geno[:, vkeep]
                var_pos = var_pos[vkeep]
                var_names = [n for n, k in zip(var_names, vkeep) if k]
        elif args.geno:
            geno = np.load(args.geno)
            var_pos = None
            var_names = [f"v{j}" for j in range(geno.shape[1])]
        else:
            raise SystemExit("fit-qtl-sgvb: provide --geno or --plink")
        if args.max_individuals and geno.shape[0] > args.max_individuals:
            rng_sub = np.random.default_rng(args.seed)
            keep_i = np.sort(rng_sub.choice(
                geno.shape[0], args.max_individuals, replace=False))
            geno = geno[keep_i]
            kept = {int(i) for i in keep_i}
            cell_keep = np.asarray([int(i) in kept for i in cell_indv])
            remap = {int(i): r for r, i in enumerate(keep_i)}
            counts = counts[:, cell_keep]
            cell_indv = np.asarray(
                [remap[int(i)] for i in cell_indv[cell_keep]])
            indv_names = [indv_names[int(i)] for i in keep_i]
            if annot_ct is not None:
                annot_ct = annot_ct[cell_keep]
        membership = ct_names = None
        if annot_ct is not None and not args.celltypes:
            uniq, inv = np.unique(annot_ct, return_inverse=True)
            ct_names = [str(u) for u in uniq]
            membership = np.eye(len(uniq), dtype=np.float32)[inv]
        if args.celltypes:
            if args.celltypes.endswith(".parquet"):
                mdf = pd.read_parquet(args.celltypes)
                ct_names = [c for c in mdf.columns if c != "cell"]
                membership = mdf[ct_names].to_numpy(np.float32)
            else:
                with open(args.celltypes) as f:
                    ct = np.asarray([ln.strip() for ln in f if ln.strip()])
                uniq, inv = np.unique(ct, return_inverse=True)
                ct_names = [str(u) for u in uniq]
                membership = np.eye(len(uniq), dtype=np.float32)[inv]
        tss = None
        if args.gff and var_pos is not None:
            from ..faba.genes import parse_gff_genes

            model_g = parse_gff_genes(args.gff)
            where = {n: j for j, n in enumerate(model_g.names)}
            tss = np.full(be.num_rows, -10**12, np.int64)
            for gi, gname in enumerate(be.row_names()):
                j = where.get(gname)
                if j is not None:
                    tss[gi] = (
                        model_g.start[j] if model_g.strand[j] > 0 else model_g.end[j]
                    )
        elif args.gene_bed and var_pos is not None:
            # BED gene coords (FitQtlSgvbArgs gene_bed): chr start end
            # gene [name [strand]]; TSS = start (+) / end (-)
            where_bed = {}
            with open(args.gene_bed) as f:
                for ln in f:
                    parts = ln.split()
                    if len(parts) >= 4:
                        strand = parts[5] if len(parts) >= 6 else "+"
                        where_bed[parts[3]] = (
                            int(parts[1]) if strand != "-" else int(parts[2])
                        )
            tss = np.full(be.num_rows, -10**12, np.int64)
            for gi, gname in enumerate(be.row_names()):
                if str(gname) in where_bed:
                    tss[gi] = where_bed[str(gname)]
        cov_i = None
        if args.covariates:
            mats = []
            for path in args.covariates.split(","):
                cdf = (
                    pd.read_parquet(path) if path.endswith(".parquet")
                    else pd.read_csv(
                        path, sep="," if path.endswith(".csv") else "\t")
                )
                cdf = cdf.set_index(cdf.columns[0]).reindex(
                    [str(x) for x in indv_names])
                mats.append(cdf.select_dtypes("number").to_numpy(
                    np.float64))
            cov_i = np.nan_to_num(np.concatenate(mats, axis=1))
        rows = fit_qtl_sgvb(
            counts, cell_indv, geno,
            membership_nc=membership, celltype_names=ct_names,
            model=args.model, prior_type=args.prior_type,
            prior_vars=args.prior_var, L=args.L, num_steps=args.steps,
            min_weight=args.min_weight, a0=args.a0, b0=args.b0,
            learning_rate=args.learning_rate, mc_samples=args.mc_samples,
            covariates_i=cov_i,
            composition_covariates=args.composition_covariates,
            empirical_bayes=args.empirical_bayes,
            gene_tss=tss, var_pos=var_pos, cis_window=args.cis_window,
            seed=args.seed, device=dev,
        )
        genes = be.row_names()
        df = pd.DataFrame(rows)
        df["gene"] = [genes[int(i)] for i in df["gene"]]
        vpos_of = (
            {j: int(p) for j, p in enumerate(var_pos)}
            if var_pos is not None else {}
        )
        df["pos"] = [vpos_of.get(int(j), -1) for j in df["variant"]]
        df["variant"] = [var_names[int(j)] for j in df["variant"]]
        df.to_parquet(args.out + ".qtl.parquet")
        # reference artifacts (fit_qtl_sgvb.rs output contract):
        # {out}.results.bed.gz + {out}.parameters.json
        import gzip as _gzip
        import json as _json

        with _gzip.open(args.out + ".results.bed.gz", "wt") as f:
            f.write("#chr\tstart\tend\tgene\tcelltype\tvariant\tpip"
                    "\teffect\n")
            for r in df.itertuples(index=False):
                pos = int(r.pos) if r.pos >= 0 else 0
                f.write(
                    f"{args.chromosome or '.'}\t{pos}\t{pos + 1}\t"
                    f"{r.gene}\t{r.celltype}\t{r.variant}\t"
                    f"{r.pip:.6g}\t{r.effect:.6g}\n"
                )
        with open(args.out + ".parameters.json", "w") as f:
            _json.dump(
                {"model": args.model, "prior_type": args.prior_type,
                 "prior_variances": args.prior_var, "L": args.L,
                 "num_iterations": args.steps,
                 "mc_samples": args.mc_samples,
                 "learning_rate": args.learning_rate,
                 "empirical_bayes": args.empirical_bayes,
                 "cis_window": args.cis_window, "a0": args.a0,
                 "b0": args.b0, "min_weight": args.min_weight,
                 "seed": args.seed}, f, indent=1,
            )
        print(
            f"wrote {args.out}.qtl.parquet + .results.bed.gz + "
            f".parameters.json ({len(df)} tests)"
        )
        return

    if args.cmd == "fit-regression":
        from ..models.sgvb import SgvbConfig, fit_regression

        df = (
            pd.read_parquet(args.table)
            if args.table.endswith(".parquet")
            else pd.read_csv(args.table, sep="\t")
        )
        y = df[args.response].to_numpy(np.float64)[:, None]
        xcols = [c for c in df.columns if c != args.response and np.issubdtype(df[c].dtype, np.number)]
        x = df[xcols].to_numpy(np.float64)
        x = (x - x.mean(0)) / np.maximum(x.std(0), 1e-8)
        y = (y - y.mean()) / max(y.std(), 1e-8)
        out = fit_regression(
            x, y, family=args.family, L=args.L,
            config=SgvbConfig(num_steps=args.steps), device=dev,
        )
        res = {"covariate": xcols, "effect": out["theta_mean"][:, 0]}
        if "pip" in out:
            res["pip"] = out["pip"][:, 0]
        pd.DataFrame(res).to_parquet(f"{args.out}.regression.parquet")
        print(f"wrote {args.out}.regression.parquet ({len(xcols)} covariates)")
        return
    if args.cmd == "pseudobulk":
        from ..data.sparse_io import open_sparse_matrix
        from ..fagioli.qtl import pseudobulk_log_rates

        be = open_sparse_matrix(args.backend)
        counts = be.read_columns_csc(np.arange(be.num_columns))  # [G, N] CSC, kept sparse
        with open(args.indv) as f:
            labels = np.asarray([line.strip() for line in f if line.strip()])
        names, cell_indv = np.unique(labels, return_inverse=True)
        log_mu, w = pseudobulk_log_rates(counts, cell_indv, len(names), device=dev)
        genes = [str(g) for g in be.row_names()]
        pd.DataFrame(
            log_mu, index=genes, columns=[str(n) for n in names]
        ).reset_index(names="gene").to_parquet(f"{args.out}.pseudobulk.parquet")
        pd.DataFrame(
            w, index=genes, columns=[str(n) for n in names]
        ).reset_index(names="gene").to_parquet(f"{args.out}.weights.parquet")
        print(f"wrote {args.out}.pseudobulk.parquet + .weights.parquet")
        return

    if args.cmd == "sim-sumstat":
        if args.legacy:
            from ..fagioli.sumstat import simulate_sumstat

            sim = simulate_sumstat(
                n=args.n, p=args.p, n_causal=args.n_causal, h2=args.h2,
                seed=args.seed,
            )
            np.save(args.out + ".geno.npy", sim.genotypes)
            pd.DataFrame(
                {"variant": [f"v{i}" for i in range(args.p)], "z": sim.z,
                 "beta_true": sim.beta, "causal": sim.causal}
            ).to_csv(args.out + ".sumstat.tsv", sep="\t", index=False)
            print(f"wrote {args.out}.sumstat.tsv and {args.out}.geno.npy")
            return
        from ..fagioli.sim import simulate_genotypes, simulate_sumstat_full

        blk = None
        if args.plink:
            from ..fagioli.plink import read_plink

            pk = read_plink(args.plink)
            geno, var_pos = pk.genotypes, pk.pos
            vkeep = np.ones(geno.shape[1], bool)
            if args.chromosome is not None and pk.chrom is not None:
                vkeep &= np.asarray(
                    [str(cc) == args.chromosome for cc in pk.chrom])
            if args.left_bound is not None:
                vkeep &= var_pos >= args.left_bound
            if args.right_bound is not None:
                vkeep &= var_pos <= args.right_bound
            geno = geno[:, vkeep]
            var_names = [n for n, k in zip(pk.variant_ids, vkeep) if k]
            if args.max_individuals \
                    and geno.shape[0] > args.max_individuals:
                rng_s = np.random.default_rng(args.seed)
                geno = geno[np.sort(rng_s.choice(
                    geno.shape[0], args.max_individuals, replace=False))]
        else:
            gsim = simulate_genotypes(n=args.n, p=args.p, seed=args.seed)
            geno, blk = gsim.genotypes, gsim.block
            var_names = [f"v{j}" for j in range(args.p)]
        out = simulate_sumstat_full(
            geno, blk,
            num_traits=args.num_traits,
            num_shared_causal=args.num_shared_causal,
            num_independent_causal=args.num_independent_causal,
            h2_sparse=args.h2, h2_polygenic=args.h2_polygenic,
            num_causal_blocks=args.num_causal_blocks,
            num_confounders=args.num_confounders,
            num_hidden_factors=args.num_hidden_factors,
            pve_confounders=args.pve_confounders,
            seed=args.seed,
        )
        np.save(args.out + ".geno.npy", geno)
        cols = {"variant": var_names}
        if args.num_traits == 1:
            cols["z"] = out["z"][:, 0]
            cols["beta_true"] = out["beta"][:, 0]
        else:
            for t in range(args.num_traits):
                cols[f"z_t{t}"] = out["z"][:, t]
            cols["z"] = out["z"][:, 0]  # first trait stays the z column
        pd.DataFrame(cols).to_csv(
            args.out + ".sumstat.tsv", sep="\t", index=False)
        pd.DataFrame(
            out["truth"], columns=["variant_idx", "trait", "kind"],
        ).assign(variant=lambda d: [var_names[int(i)]
                                    for i in d["variant_idx"]]
                 ).to_parquet(args.out + ".truth.parquet")
        print(
            f"wrote {args.out}.sumstat.tsv (+ .truth.parquet, "
            f"{args.num_traits} traits, {len(out['truth'])} causal "
            "entries)"
        )
    elif args.cmd == "fit-prs-susie":
        from ..fagioli.sumstat import fit_prs
        from ..models.sgvb import SgvbConfig

        geno, _var_pos, _var_names = _load_panel_full(args)
        df = _read_zscores(args, _var_names)
        score = np.load(args.score_geno) if args.score_geno else None
        out = fit_prs(
            df["z"].to_numpy(), geno, L=args.L, score_genotypes=score,
            config=SgvbConfig(num_steps=args.steps), device=dev,
        )
        pd.DataFrame(
            {"variant": df.iloc[:, 0], "weight": out["weights"], "pip": out["pip"]}
        ).to_parquet(args.out + ".prs_weights.parquet")
        msg = f"wrote {args.out}.prs_weights.parquet"
        if "prs" in out:
            pd.DataFrame(
                {"sample": np.arange(len(out["prs"])), "prs": out["prs"]}
            ).to_parquet(args.out + ".prs.parquet")
            msg += f" and {args.out}.prs.parquet"
        print(msg)
    elif args.cmd == "fit-sumstat-mcmc":
        from ..fagioli.sumstat import fit_sumstat_mcmc

        geno, _var_pos, _var_names = _load_panel_full(args)
        df = _read_zscores(args, _var_names)
        out = fit_sumstat_mcmc(
            df["z"].to_numpy(), geno,
            num_samples=args.samples, burn_in=args.burn_in,
            prior_sd=args.prior_sd, device=dev,
        )
        pd.DataFrame(
            {"variant": df.iloc[:, 0], "beta_mean": out["beta_mean"],
             "beta_sd": out["beta_sd"], "rhat": out["rhat"], "ess": out["ess"]}
        ).to_parquet(args.out + ".mcmc.parquet")
        print(
            f"wrote {args.out}.mcmc.parquet "
            f"(max rhat {out['rhat'].max():.3f}, min ess {out['ess'].min():.0f})"
        )
    elif args.cmd == "fit-sumstat-sgvb":
        from ..fagioli.sumstat import fit_sumstat_sgvb
        from ..models.sgvb import SgvbConfig

        geno, _var_pos, _var_names = _load_panel_full(args)
        df = _read_zscores(args, _var_names)
        out = fit_sumstat_sgvb(
            df["z"].to_numpy(), geno,
            model=args.model, prior_type=args.prior_type,
            prior_vars=args.prior_var, L=args.L,
            config=SgvbConfig(num_steps=args.steps), device=dev,
        )
        tbl = {"variant": df.iloc[:, 0], "pip": out["pip"],
               "effect": out["theta_mean"][:, 0]}
        pd.DataFrame(tbl).to_parquet(args.out + ".finemap.parquet")
        extra = (
            f"prior_var={out['prior_var']}" if "prior_var" in out
            else f"mix_weights={np.round(out['mix_weights'], 3)}"
        )
        print(f"wrote {args.out}.finemap.parquet ({args.model}, {extra})")
    else:
        from ..fagioli.sumstat import map_sumstat
        from ..models.sgvb import SgvbConfig

        geno, _var_pos, _var_names = _load_panel_full(args)
        df = _read_zscores(args, _var_names)
        ld_blocks = None
        if args.ld_block_file:
            bdf = pd.read_csv(args.ld_block_file, sep="\t", header=None,
                              names=["variant", "block"], dtype=str)
            lut = dict(zip(bdf.variant, bdf.block))
            labs = [lut.get(str(v), "?") for v in df.iloc[:, 0]]
            _, ld_blocks = np.unique(np.asarray(labs), return_inverse=True)
        out = map_sumstat(
            df["z"].to_numpy(), geno, L=args.L,
            config=SgvbConfig(num_steps=args.steps),
            multilevel=args.multilevel,
            ld_blocks=ld_blocks,
            rank=args.max_rank, lam=args.lam,
            ldsc_intercept=not args.no_ldsc_intercept,
            pve_adjust=not args.no_pve_adjust, device=dev,
        )
        pd.DataFrame(
            {"variant": df.iloc[:, 0], "pip": out["pip"],
             "effect": out["theta_mean"][:, 0]}
        ).to_parquet(args.out + ".finemap.parquet")
        print(f"wrote {args.out}.finemap.parquet")
