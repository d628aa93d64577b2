"""`data-beans-sim` binary: synthetic generators CLI (the port of the JAX
package's `cli/sim_cli.py`: the same subcommands, flags, defaults and
numpy draws). Everything runs on the host."""

from __future__ import annotations

import argparse
import numpy as np


def run_sim(argv):
    ap = argparse.ArgumentParser(prog="data-beans-sim", description="synthetic generators")
    sub = ap.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("topic", help="factored count matrix with topic + batch structure")
    p.add_argument("--rows", type=int, default=2000)
    p.add_argument("--cols", type=int, default=1000)
    p.add_argument("--factors", type=int, default=8)
    p.add_argument("--batches", type=int, default=1)
    p.add_argument("--pve-topic", type=float, default=0.7)
    p.add_argument("--pve-batch", type=float, default=0.3)
    p.add_argument("--beta-scale", type=float, default=1.0)
    p.add_argument("--depth", type=float, default=1000.0)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--pve-noise", type=float, default=0.0,
                   help="per-cell residual log-mean noise magnitude")
    p.add_argument("--hierarchical-depth", type=int, default=None,
                   help="binary stick-breaking tree dictionary with "
                        "2^depth leaf topics (overrides --factors)")
    p.add_argument("--n-housekeeping", type=int, default=0)
    p.add_argument("--housekeeping-fold", type=float, default=10.0)
    p.add_argument("--batch-rank", type=int, default=0,
                   help="rank of the batch-program subspace "
                        "(0 = iid per-gene shifts)")
    p.add_argument("--holdout-topics", type=int, nargs="+", default=None,
                   help="cells whose argmax topic is in this set go to a "
                        "second {out}.holdout backend")
    p.add_argument("--output", required=True)
    p.add_argument(
        "--reference", default=None,
        help="real backend: sample via NB + Gaussian copula conditioned on it",
    )
    p.add_argument("--copula-rank", type=int, default=10)
    p = sub.add_parser("faba", help="m6A/A-to-I/APA site tracks (faba naming)")
    p.add_argument("--genes", type=int, default=50)
    p.add_argument("--cols", type=int, default=500)
    p.add_argument("--states", type=int, default=3)
    p.add_argument("--depth", type=float, default=30.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--output", required=True)
    p = sub.add_parser(
        "multimodal", help="shared-theta counts across modalities (sim/main.rs:30)"
    )
    p.add_argument("--rows", type=int, nargs="+", default=[500, 300],
                   help="features per modality")
    p.add_argument("--cols", type=int, default=600)
    p.add_argument("--factors", type=int, default=5)
    p.add_argument("--depth", type=float, default=1500.0)
    p.add_argument("--seed", type=int, default=13)
    p.add_argument("--output", required=True)
    p = sub.add_parser(
        "multiome", help="paired RNA+ATAC with peak-gene ground truth"
    )
    p.add_argument("--genes", type=int, default=300)
    p.add_argument("--peaks", type=int, default=600)
    p.add_argument("--cols", type=int, default=600)
    p.add_argument("--factors", type=int, default=5)
    p.add_argument("--depth", type=float, default=1500.0)
    p.add_argument("--seed", type=int, default=13)
    p.add_argument("--n-causal-per-gene", type=int, default=1)
    p.add_argument("--linked-gene-fraction", type=float, default=1.0,
                   help="fraction of genes WITH a cis driver")
    p.add_argument("--pve-cis", type=float, default=1.0,
                   help="cis share of a linked gene's rate profile")
    p.add_argument("--output", required=True)
    p = sub.add_parser("bulk", help="Dirichlet-mixed bulk samples from single cells")
    p.add_argument("--backend", required=True, help="single-cell backend to mix")
    p.add_argument("--labels", required=True, help="parquet/TSV: cell, label")
    p.add_argument("--samples", type=int, default=20)
    p.add_argument("--reads", type=float, default=100_000)
    p.add_argument("--alpha", type=float, default=1.0)
    p.add_argument("--seed", type=int, default=17)
    p.add_argument("--output", required=True)
    args = ap.parse_args(argv)

    if args.cmd == "multimodal":
        from ..data.sim import simulate_multimodal
        from ..data.sparse_io import create_sparse_from_csc
        import pandas as pd

        mm = simulate_multimodal(
            rows_per_modality=tuple(args.rows), cols=args.cols,
            factors=args.factors, depth=args.depth, seed=args.seed,
        )
        outs = []
        for m, counts in enumerate(mm.counts):
            path = f"{args.output}.mod{m}.zarr"
            create_sparse_from_csc(
                counts, path,
                [f"m{m}_f{i}" for i in range(counts.shape[0])],
                [f"cell{j}" for j in range(counts.shape[1])],
            )
            outs.append(path)
        pd.DataFrame(
            mm.theta, columns=[f"k{i}" for i in range(mm.theta.shape[1])]
        ).reset_index(names="cell").to_parquet(f"{args.output}.prop.parquet")
        print(f"wrote backends: {' '.join(outs)}")
        return
    if args.cmd == "multiome":
        import pandas as pd

        from ..data.sim import simulate_multiome
        from ..data.sparse_io import create_sparse_from_csc

        sim = simulate_multiome(
            genes=args.genes, peaks=args.peaks, cols=args.cols,
            factors=args.factors, depth=args.depth, seed=args.seed,
            n_causal_per_gene=args.n_causal_per_gene,
            linked_gene_fraction=args.linked_gene_fraction,
            pve_cis=args.pve_cis,
        )
        # synthetic genome: peaks tile one chromosome at 2 kb spacing;
        # gene g's TSS sits inside its driving peak so the cis window
        # contains the truth (chickpea fixtures, sim README outputs)
        spacing = 2000
        peak_names = [
            f"chrS:{1 + i * spacing}-{1 + i * spacing + 500}" for i in range(args.peaks)
        ]
        gene_names = [f"gene{g}" for g in range(args.genes)]
        create_sparse_from_csc(
            sim.rna, f"{args.output}.rna.zarr", gene_names,
            [f"cell{j}" for j in range(sim.rna.shape[1])],
        )
        create_sparse_from_csc(
            sim.atac, f"{args.output}.atac.zarr", peak_names,
            [f"cell{j}" for j in range(sim.atac.shape[1])],
        )
        with open(f"{args.output}.genes.gff", "w") as f:
            for g in range(args.genes):
                # linked genes sit inside their FIRST driving peak's
                # window; unlinked genes land at a random position
                anchor = (
                    int(sim.peak_to_gene[g, 0])
                    if sim.linked[g]
                    else int(np.random.default_rng(args.seed + g).integers(args.peaks))
                )
                tss = 1 + anchor * spacing + 250
                f.write(
                    f"chrS\tsim\tgene\t{tss}\t{tss + 1000}\t.\t+\t.\t"
                    f"ID=gene:{gene_names[g]};Name={gene_names[g]}\n"
                )
        rows = []
        for g in range(args.genes):
            for p in sim.peak_to_gene[g]:
                if p >= 0:
                    rows.append({"gene": gene_names[g], "peak": peak_names[int(p)]})
        pd.DataFrame(rows, columns=["gene", "peak"]).to_parquet(
            f"{args.output}.truth.parquet"
        )
        print(
            f"wrote {args.output}.rna.zarr / .atac.zarr / .genes.gff / .truth.parquet"
        )
        return
    if args.cmd == "bulk":
        import pandas as pd

        from ..data.sim import simulate_bulk
        from ..data.sparse_io import open_sparse_matrix

        be = open_sparse_matrix(args.backend)
        lab_df = (
            pd.read_parquet(args.labels)
            if args.labels.endswith(".parquet")
            else pd.read_csv(args.labels, sep="\t")
        )
        labels = lab_df.iloc[:, 1].to_numpy()
        counts = be.read_columns_csc(np.arange(be.num_columns))
        bulk, fracs = simulate_bulk(
            counts, labels, n_samples=args.samples,
            reads_per_sample=args.reads, alpha=args.alpha, seed=args.seed,
        )
        types = [str(t) for t in np.unique(labels)]
        pd.DataFrame(
            bulk, columns=[str(g) for g in be.row_names()],
            index=[f"s{i}" for i in range(args.samples)],
        ).reset_index(names="sample").to_parquet(f"{args.output}.bulk.parquet")
        pd.DataFrame(
            fracs, columns=types, index=[f"s{i}" for i in range(args.samples)]
        ).reset_index(names="sample").to_parquet(f"{args.output}.fractions.parquet")
        print(f"wrote {args.output}.bulk.parquet and .fractions.parquet")
        return

    if args.cmd == "faba":
        import pandas as pd

        from ..data.sim import simulate_faba
        from ..data.sparse_io import create_sparse_from_csc

        sim = simulate_faba(
            n_genes=args.genes, n_cells=args.cols, n_states=args.states,
            depth=args.depth, seed=args.seed,
        )
        path = args.output if args.output.endswith((".zarr", ".h5")) else args.output + ".zarr"
        create_sparse_from_csc(sim.counts, path, sim.site_names, sim.col_names)
        pd.DataFrame(
            {"cell": sim.col_names, "state": sim.state}
        ).to_parquet(args.output + ".state.parquet")
        pd.DataFrame(
            sim.true_rates, index=sim.site_names,
            columns=[f"state{k}" for k in range(args.states)],
        ).reset_index(names="site").to_parquet(args.output + ".rates.parquet")
        print(f"wrote backend: {path} ({len(sim.site_names)} sites)")
        return

    if args.cmd == "topic" and args.reference:

        from ..data.sim import simulate_from_reference
        from ..data.sparse_io import create_sparse_from_csc, open_sparse_matrix

        ref = open_sparse_matrix(args.reference)
        counts, params = simulate_from_reference(
            ref.read_columns_csc(np.arange(ref.num_columns)),
            n_cells=args.cols, rank=args.copula_rank, seed=args.seed,
        )
        path = args.output if args.output.endswith((".zarr", ".h5")) else args.output + ".zarr"
        create_sparse_from_csc(
            counts, path, ref.row_names(),
            [f"sim{i}" for i in range(counts.shape[1])],
        )
        print(f"wrote backend: {path} (copula rank {args.copula_rank})")
        return

    if args.cmd == "topic":
        from ..data.sim import simulate_topic, write_topic_sim

        sim = simulate_topic(
            rows=args.rows,
            cols=args.cols,
            factors=args.factors,
            batches=args.batches,
            pve_topic=args.pve_topic,
            pve_batch=args.pve_batch,
            beta_scale=args.beta_scale,
            depth=args.depth,
            seed=args.seed,
            pve_noise=args.pve_noise,
            hierarchical_depth=args.hierarchical_depth,
            n_housekeeping=args.n_housekeeping,
            housekeeping_fold=args.housekeeping_fold,
            batch_rank=args.batch_rank,
        )
        if args.holdout_topics:
            # route argmax-theta cells to {out}.holdout (handlers.rs
            # holdout_topics): ground-truth parquets stay FULL
            from ..data.sparse_io import create_sparse_from_csc

            held = np.isin(sim.theta.argmax(1), args.holdout_topics)
            full_counts = sim.counts.tocsc()
            hold_cols = np.nonzero(held)[0]
            keep_cols = np.nonzero(~held)[0]
            hold_path = args.output + ".holdout.zarr"
            create_sparse_from_csc(
                full_counts[:, hold_cols], hold_path,
                sim.row_names, [sim.col_names[j] for j in hold_cols],
            )
            full_names = list(sim.col_names)
            full_theta = sim.theta
            sim.counts = full_counts[:, keep_cols]
            sim.col_names = [full_names[j] for j in keep_cols]
            sim.theta = full_theta[keep_cols]
            sim.batch = sim.batch[keep_cols]  # keep batch.gz aligned
            path = write_topic_sim(sim, args.output)
            # ground-truth prop parquet stays FULL (both backends'
            # column names cross-reference it)
            import pandas as pd

            k = sim.beta.shape[1]
            pd.DataFrame(
                full_theta, index=full_names,
                columns=[f"k{i}" for i in range(k)],
            ).reset_index(names="cell").to_parquet(args.output + ".prop.parquet")
            print(f"wrote backend: {path} ({len(keep_cols)} cells) + "
                  f"{hold_path} ({len(hold_cols)} held-out cells)")
            return
        path = write_topic_sim(sim, args.output)
        print(f"wrote backend: {path}")
