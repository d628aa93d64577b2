"""`faba all` — chained feature extraction pipeline
(`faba/src/pipeline/{args,run,steps}.rs` equivalent).

Stage order matches `run.rs run_pipeline`:
  0. SNP genotyping (de novo + optional known sites); the VAF-gated
     mask feeds the editing stages so germline variants never read as
     editing, while true RNA-editing sites (low/variable VAF) stay out
     of the mask.
  1. gene counting (+ optional expression/mito QC, freezing a cell
     set per batch)
  2. per-cell read depth — opt-in via `depth_resolution_kb`,
     independent of every other stage
  3. A-to-I detection (WT-vs-control contrast, as `faba atoi`)
  4. m6A (DART) detection — skipped without a control arm
  5. APA — the heavy stage, LAST so it never blocks the others

Every sample in `bam_files ∪ control_bams` is QUANTIFIED in every
modality (`run.rs all_quant_bam_files`): the WT-vs-MUT split is used
only for the editing contrast. Declared divergences (MIGRATION.md):
outputs are prefix-keyed (`{out}[.{batch}].{stage}.*`), not a
directory; our editing stages need a control arm (the reference's
A-to-I can run control-free against the genome error model); with
multiple control BAMs the contrast uses the first (logged).

The port's copy of the JAX package's `faba/pipeline.py` (numpy and scipy
on the host, as there). Beyond it, the result and the manifest carry each
stage's seconds (`timings`), and `mixture_weight="posterior"` hands the
mixture each (site, cell)'s coverage, as `faba dartseq` does (the JAX
package's `run_all` passes none, and its mixture raises).
"""

from __future__ import annotations

import logging
import os
import time
from dataclasses import dataclass, field

from ..data.sparse_io import create_sparse_from_csc
from ..utils.manifest import RunManifest

log = logging.getLogger(__name__)


@dataclass
class FabaAllResult:
    outputs: dict = field(default_factory=dict)
    timings: dict = field(default_factory=dict)  # seconds per stage


def run_all(
    bam: "str | list[str]",
    gff: str,
    out: str,
    *,
    control_bam: "str | list[str] | None" = None,
    genome: str | None = None,
    gene_type: str | None = None,
    cell_barcode_tag: str = "CB",
    umi_tag: str = "UB",
    gene_barcode_tag: str | None = None,
    no_umi_dedup: bool = False,
    backend: str = "zarr",
    zip_output: bool = False,
    min_mapq: int = 20,
    min_base_quality: int = 20,
    # stage skips (PipelineArgs skip_*)
    skip_snp: bool = False,
    skip_genes: bool = False,
    skip_atoi: bool = False,
    skip_apa: bool = False,
    # step 2: opt-in per-cell depth tracks
    depth_resolution_kb: float | None = None,
    # SNP knobs (snp_* fields)
    known_snps: str | None = None,
    snp_min_depth: int = 5,
    snp_min_gq: float = 20.0,
    snp_min_coverage: int = 8,
    snp_min_alt_count: int = 2,
    snp_min_alt_freq: float = 0.1,
    snp_mask_min_vaf: float | None = 0.2,
    # editing knobs (atoi_* / edit_*)
    atoi_min_coverage: int = 0,
    atoi_min_conversion: int = 3,
    atoi_pvalue_cutoff: float = 0.05,
    edit_error_rate: float = 0.01,
    edit_overdispersion: float = 0.05,
    # APA knobs (apa_* / polya_*)
    apa_min_coverage: int = 5,
    apa_max_sites: int = 0,
    polya_min_tail_length: int = 0,
    no_apa_pdui: bool = False,
    # per-gene site mixture (MixtureWeightMode + priors)
    mixture: bool = True,
    mixture_weight: str = "converted",
    mixture_prior_alpha: float = 1.0,
    mixture_prior_beta: float = 1.0,
    drop_single_component: bool = False,
    # gene/cell expression QC (gene_* / cell_min_genes; opt-in like the
    # standalone commands — tiny fixtures would otherwise empty)
    gene_qc: bool = False,
    gene_min_cells: int = 10,
    gene_min_counts: int = 10,
    cell_min_genes: int = 10,
) -> FabaAllResult:
    from .apa import run_apa
    from .dartseq import run_atoi, run_dartseq
    from .genes import count_genes
    from .snp import GenotypeParams, run_snp

    bam_files = [bam] if isinstance(bam, str) else list(bam)
    ctrl_files = (
        [] if control_bam is None
        else ([control_bam] if isinstance(control_bam, str)
              else list(control_bam))
    )
    # every sample quantifies in every modality; dedupe BAMs listed in
    # both roles (run.rs all_quant_bam_files)
    quant = list(dict.fromkeys(bam_files + ctrl_files))
    if len(quant) < len(bam_files) + len(ctrl_files):
        log.warning(
            "BAM(s) listed both positionally and in --control-bam; "
            "quantifying each once to avoid double counting"
        )
    suffix = ".h5" if backend == "hdf5" else (
        ".zarr.zip" if zip_output else ".zarr")

    def batch_tag(path: str) -> str:
        # a single positional (WT) sample keeps the round-2 unsuffixed
        # layout; everything else (second batches, quantified control
        # arms) is batch-suffixed
        if len(bam_files) == 1 and path == bam_files[0]:
            return ""
        return "." + os.path.splitext(os.path.basename(path))[0]

    outputs: dict = {}
    timings: dict = {}

    def lap(stage: str, t0: float) -> None:
        timings[f"{stage}_s"] = timings.get(f"{stage}_s", 0.0) + time.time() - t0

    # ---- step 0: SNP genotyping -> editing mask --------------------
    snp_mask = None
    t0 = time.time()
    if not skip_snp:
        snp_dir = f"{out}.snp"
        sites = run_snp(
            quant, snp_dir, gff=gff, genome=genome, bulk=True,
            known_snps=known_snps,
            params=GenotypeParams(
                min_depth=snp_min_depth, min_gq=snp_min_gq,
                min_coverage=snp_min_coverage,
                min_alt_count=snp_min_alt_count,
                min_alt_freq=snp_min_alt_freq,
            ),
            cell_barcode_tag=cell_barcode_tag, umi_tag=umi_tag,
            no_umi_dedup=no_umi_dedup,
            min_mapping_quality=min_mapq,
            min_base_quality=min_base_quality,
            min_vaf=snp_mask_min_vaf, gene_type=gene_type,
        )
        if len(sites):
            outputs["snp"] = f"{snp_dir}/snp_sites.parquet"
            from .snp import build_snp_mask

            snp_mask = set(
                build_snp_mask(sites, snp_min_gq, snp_mask_min_vaf)
            ) or None
        lap("snp", t0)
    else:
        log.info("step 0 SKIPPED (--skip-snp)")

    # ---- step 1: gene counting (per quantified sample) -------------
    if not skip_genes:
        t0 = time.time()
        for b in quant:
            tag = batch_tag(b)
            counts, genes, barcodes = count_genes(
                b, gff, min_mapq=min_mapq, dedup_umi=not no_umi_dedup,
                cb_tag=cell_barcode_tag, umi_tag=umi_tag,
                gene_barcode_tag=gene_barcode_tag,
            )
            if gene_qc:
                from .cell_calling import gene_qc_masks

                gmask, cmask = gene_qc_masks(
                    counts, gene_min_cells=gene_min_cells,
                    gene_min_counts=gene_min_counts,
                    cell_min_genes=cell_min_genes,
                )
                counts = counts[gmask][:, cmask]
                genes = [g for g, k in zip(genes, gmask) if k]
                barcodes = [c for c, k in zip(barcodes, cmask) if k]
                log.info("gene QC: %d genes x %d cells kept",
                         counts.shape[0], counts.shape[1])
            path = f"{out}{tag}.genes{suffix}"
            create_sparse_from_csc(counts, path, genes, barcodes)
            outputs[f"genes{tag}"] = path
        lap("genes", t0)
    else:
        log.info("step 1 SKIPPED (--skip-genes)")

    # ---- step 2: per-cell read depth (opt-in) ----------------------
    if depth_resolution_kb:
        from .depth import depth_matrix_uniform

        t0 = time.time()
        for b in quant:
            tag = batch_tag(b)
            mat, names, barcodes = depth_matrix_uniform(
                b, resolution_bp=int(depth_resolution_kb * 1000),
                min_mapq=min_mapq, cb_tag=cell_barcode_tag,
            )
            path = f"{out}{tag}.depth{suffix}"
            create_sparse_from_csc(mat, path, names, barcodes)
            outputs[f"depth{tag}"] = path
        lap("depth", t0)

    # ---- steps 3+4: editing contrasts (need a control arm) ---------
    if ctrl_files:
        from .bam import read_bam_ref_names
        from .genes import parse_gff_exons, parse_gff_genes
        from .mixture import run_mixture

        ctrl = ctrl_files[0]
        if len(ctrl_files) > 1:
            log.warning(
                "multiple --control-bam files: the editing contrast "
                "uses %s (merged control arms not yet supported)", ctrl,
            )
        model = parse_gff_genes(gff, gene_type=gene_type)
        exons = parse_gff_exons(gff, model)
        stages = []
        if not skip_atoi:
            stages.append(("atoi", run_atoi))
        stages.append(("m6a", run_dartseq))
        for b in bam_files:
            tag = batch_tag(b)
            # header-only contig read (a full read_bam here would
            # re-parse all records once per modality)
            bam_ref_names = read_bam_ref_names(b)
            for name, runner in stages:
                t0 = time.time()
                res = runner(
                    b, ctrl, snp_mask=snp_mask,
                    eps=edit_error_rate, rho=edit_overdispersion,
                    max_p=atoi_pvalue_cutoff,
                    min_alt=atoi_min_conversion,
                    min_coverage=atoi_min_coverage,
                    min_mapq=min_mapq, min_baseq=min_base_quality,
                    cb_tag=cell_barcode_tag, umi_tag=umi_tag,
                    # read-level gene-consistency filter, like the
                    # reference's ConversionParams.gene_barcode_tag
                    gene_barcode_tag=gene_barcode_tag, gff=gff,
                )
                if not res.cell_counts.shape[0]:
                    lap(name, t0)
                    continue
                path = f"{out}{tag}.{name}{suffix}"
                create_sparse_from_csc(
                    res.cell_counts, path, res.site_names, res.barcodes
                )
                outputs[f"{name}{tag}"] = path
                if mixture:
                    # per-gene site mixture rides the pipeline's gene
                    # model (mixture_pipeline.rs runs inside run_m6a)
                    from .mixture import MixtureParams

                    cov = None
                    if mixture_weight == "posterior":
                        # the Beta-posterior weights need each (site, cell)'s
                        # coverage, as `faba dartseq` passes it (the JAX
                        # package's run_all passes none and raises)
                        from .bam import read_bam
                        from .dartseq import per_cell_coverage_at_sites

                        cov = per_cell_coverage_at_sites(
                            read_bam(b, cb_tag=cell_barcode_tag, umi_tag=umi_tag),
                            res.sites[:, 0], res.sites[:, 1], len(res.barcodes),
                            min_mapq=min_mapq,
                        )
                    mat, names_mix, components, _bw = run_mixture(
                        res.cell_counts, res.sites[:, 0],
                        res.sites[:, 1], res.strand, bam_ref_names,
                        model, exons, modality=name,
                        weight_mode=mixture_weight,
                        prior_alpha=mixture_prior_alpha,
                        prior_beta=mixture_prior_beta,
                        params=MixtureParams(
                            drop_single_component=drop_single_component
                        ),
                        cell_coverage=cov,
                    )
                    if mat is not None:
                        mpath = f"{out}{tag}.{name}_mixture{suffix}"
                        create_sparse_from_csc(
                            mat, mpath, names_mix, res.barcodes
                        )
                        components.to_parquet(
                            f"{out}{tag}.{name}_components.parquet"
                        )
                        outputs[f"{name}_mixture{tag}"] = mpath
                lap(name, t0)
    elif not skip_atoi:
        log.info(
            "steps 3+4 SKIPPED (editing contrasts need --control-bam; "
            "declared divergence: the reference's A-to-I can run "
            "control-free)"
        )

    # ---- step 5: APA (the heavy stage, last) -----------------------
    if not skip_apa:
        t0 = time.time()
        for b in quant:
            tag = batch_tag(b)
            apa = run_apa(
                b, gff, min_mapq=min_mapq, min_reads=apa_min_coverage,
                polya_min_tail_length=polya_min_tail_length,
                max_sites=apa_max_sites,
            )
            if apa.counts.shape[0]:
                path = f"{out}{tag}.apa{suffix}"
                create_sparse_from_csc(
                    apa.counts, path, apa.site_names, apa.barcodes
                )
                outputs[f"apa{tag}"] = path
                if not no_apa_pdui:
                    import pandas as pd

                    from .apa import compute_pdui

                    gg, cc, vv = compute_pdui(apa)
                    pd.DataFrame(
                        {"gene": gg, "cell": cc, "pdui": vv}
                    ).to_parquet(f"{out}{tag}.apa_pdui.parquet")
                    outputs[f"apa_pdui{tag}"] = (
                        f"{out}{tag}.apa_pdui.parquet"
                    )
        lap("apa", t0)
    else:
        log.info("step 5 SKIPPED (--skip-apa)")

    RunManifest(
        command="faba-all",
        inputs={
            "bam": bam_files, "gff": gff, "control_bam": ctrl_files,
            "genome": genome,
        },
        outputs=outputs,
        timings=timings,
    ).save(out, "gem.json")
    log.info("faba all: wrote %s", sorted(outputs))
    return FabaAllResult(outputs=outputs, timings=timings)
