"""faba `pwm, metagene`: parsers + handlers (the port's copy of the JAX
package's `cli/faba_cmds/motif_cmds.py`, flags and defaults unchanged).
Host only: `faba/context.py` and `faba/metagene.py` are numpy."""

from __future__ import annotations

import os

import numpy as np


def add_parsers(sub):
    p = sub.add_parser(
        "pwm",
        help="sequence-context PWM around called sites "
             "(site_analysis/scan_pwm.rs ScanPwmArgs)",
    )
    p.add_argument("-s", "--sites", required=True,
                   help="parquet with chrom,pos[,strand]")
    p.add_argument("-f", "--fasta", "--genome", dest="fasta",
                   required=True)
    p.add_argument("-o", "--output", required=True,
                   help="output prefix; also accepts a .tsv/.tsv.gz "
                        "path for the reference TSV layout")
    p.add_argument("--flank", "--window", dest="flank", type=int,
                   default=5, help="+/- bp collected around each site")
    p.add_argument("--source", choices=["reference", "reads"],
                   default="reference",
                   help="base frequencies from the FASTA context or "
                        "from the reads covering each position")
    p.add_argument("--bam", default=None,
                   help="BAM(s), comma-separated (required for "
                        "--source reads)")
    p = sub.add_parser(
        "metagene",
        help="MetaPlotR tripartite 5'UTR/CDS/3'UTR metagene "
             "(site_analysis/metagene.rs MetageneArgs)",
    )
    p.add_argument("-s", "--sites", required=True,
                   help="site parquet (from dartseq/atoi/apa output)")
    p.add_argument("-g", "--gff", required=True)
    p.add_argument("-o", "--output", required=True,
                   help="TSV path (a .parquet twin is written too)")
    p.add_argument("--bins", type=int, default=200,
                   help="total bins across 5'UTR+CDS+3'UTR, split in "
                        "proportion to the site-weighted medians")
    p.add_argument("--isoform", choices=["longest", "all"],
                   default="longest",
                   help="longest spliced coding isoform per gene "
                        "(MetaPlotR) or every coding transcript")
    p.add_argument("--ncrna", action="store_true",
                   help="also profile non-coding genes (own [0,1] track)")
    p.add_argument("--distances", default=None,
                   help="also write MetaPlotR's per-site distance "
                        "table (TSV) here")
    p.add_argument("--print", dest="print_hist", action="store_true",
                   help="print the ASCII histogram to stderr")
    p.add_argument("--max-width", type=int, default=60)
    p.add_argument("--gene-type", default=None,
                   help="GFF biotype filter")
    p.add_argument("--body", action="store_true",
                   help="legacy round-2 mode: uniform gene-body bins "
                        "(writes {out}.metagene.parquet only)")


def _cmd_pwm(args):
    import json as _json

    import pandas as pd

    from ...faba.context import pwm_at_sites, pwm_from_reads, read_fasta

    df = pd.read_parquet(args.sites)
    strand = df["strand"].to_numpy() if "strand" in df else None
    strand = (
        np.where(np.asarray(strand).astype(str) == "-", -1, 1)
        if strand is not None and strand.dtype == object else strand
    )
    fasta = read_fasta(args.fasta)
    if args.source == "reads":
        if not args.bam:
            raise SystemExit("--source reads needs --bam")
        pwm = pwm_from_reads(
            args.bam.split(","), fasta,
            df["chrom"].astype(str).to_numpy(object),
            df["pos"].to_numpy(np.int64),
            flank=args.flank, strand=strand,
        )
    else:
        pwm = pwm_at_sites(
            fasta, df["chrom"].tolist(),
            df["pos"].to_numpy(), flank=args.flank, strand=strand,
        )
    out = pd.DataFrame(pwm.freqs, columns=list("ACGT"))
    out["offset"] = np.arange(-args.flank, args.flank + 1)
    out["info_bits"] = pwm.info_bits
    if args.output.endswith((".tsv", ".tsv.gz")):
        out.to_csv(args.output, sep="\t", index=False)
        out_path = args.output
    else:
        out_path = f"{args.output}.pwm.parquet"
        out.to_parquet(out_path)
    print(
        _json.dumps(
            {"consensus": pwm.consensus, "n_sites": pwm.n_sites,
             "source": args.source, "out": out_path}
        )
    )


def _cmd_metagene(args):
    import pandas as pd

    df = pd.read_parquet(args.sites)
    if args.body:
        from ...faba.context import metagene_profile
        from ...faba.genes import parse_gff_genes

        model = parse_gff_genes(args.gff, gene_type=args.gene_type)
        chroms = sorted(set(df["chrom"].astype(str)))
        cidx = {c: i for i, c in enumerate(chroms)}
        prof = metagene_profile(
            model, chroms,
            df["chrom"].map(cidx).to_numpy(), df["pos"].to_numpy(),
            bins=args.bins,
        )
        pd.DataFrame(
            {"bin": prof["bin_centers"], "density": prof["density"],
             "count": prof["counts"]}
        ).to_parquet(f"{args.output}.metagene.parquet")
        print(
            f"wrote {args.output}.metagene.parquet "
            f"({prof['n_assigned']}/{len(df)} sites in genes)"
        )
        return
    import sys

    from ...faba.metagene import (
        ascii_histogram,
        metagene_metaplotr,
        parse_gff_transcripts,
    )

    models, ncrna = parse_gff_transcripts(
        args.gff, gene_type=args.gene_type
    )
    res = metagene_metaplotr(
        models, ncrna,
        df["chrom"].astype(str).to_numpy(object),
        df["pos"].to_numpy(np.int64),
        bins=args.bins, isoform=args.isoform,
        include_ncrna=args.ncrna,
    )
    out_df = pd.DataFrame(res["rows"]).rename(
        columns={"feature": "#feature"})
    out_df.to_csv(args.output, sep="\t", index=False)
    base = args.output.removesuffix(".tsv").removesuffix(".gz")
    out_df.to_parquet(f"{base}.metagene.parquet")
    if args.distances:
        pd.DataFrame(res["distances"]).to_csv(
            args.distances, sep="\t", index=False)
    if args.print_hist:
        print(ascii_histogram(res["rows"],
                              max_width=args.max_width),
              file=sys.stderr)
    m5, mc, m3 = res["median_sizes"]
    print(
        f"wrote {args.output} ({res['n_sites_placed']}/{len(df)} "
        f"sites placed; median 5'UTR/CDS/3'UTR = "
        f"{m5:.0f}/{mc:.0f}/{m3:.0f} nt; bins {res['region_bins']})"
    )

