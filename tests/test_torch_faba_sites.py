"""`faba`'s site modules in the port (`faba/{site_tests,context,dartseq,
cell_activity,mixture}.py`) against the JAX package's, on the CPU.

Both packages run numpy and scipy on the host here, so every output is
held equal exactly: p-values, log odds, site tables, masks, per-cell
count and coverage matrices, PWMs, pileups, the cell-scan call and the
mixtures' EM fits. The BAMs are the port's planted wild-type / control
pair (`faba/bam_sim.py::simulate_edit_pair`: A-to-G and RAC C-to-T sites
on both strands, germline SNPs, sequencing errors, PCR duplicates),
read by each package's own BAM reader.
"""

import numpy as np
import pytest

from legume_tpu.faba import bam as jbam
from legume_tpu.faba import cell_activity as jca
from legume_tpu.faba import context as jctx
from legume_tpu.faba import dartseq as jds
from legume_tpu.faba import genes as jgenes
from legume_tpu.faba import mixture as jmix
from legume_tpu.faba import site_tests as jst
from legume_tpu_torch.faba import bam as tbam
from legume_tpu_torch.faba import cell_activity as tca
from legume_tpu_torch.faba import context as tctx
from legume_tpu_torch.faba import dartseq as tds
from legume_tpu_torch.faba import genes as tgenes
from legume_tpu_torch.faba import mixture as tmix
from legume_tpu_torch.faba import site_tests as tst

from faba_parity import planted_pair, same


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    return planted_pair(tmp_path_factory.mktemp("edit_pair"))


@pytest.fixture(scope="module")
def recs(pair):
    paths, _ = pair
    return {k: (jbam.read_bam(paths[k]), tbam.read_bam(paths[k])) for k in ("wt", "ct")}


# ---- site_tests --------------------------------------------------------------

def _counts(seed, n=400):
    rng = np.random.default_rng(seed)
    cov = rng.integers(0, 300, n)
    alt = rng.binomial(cov, rng.uniform(0.0, 0.4, n))
    cov_c = rng.integers(0, 300, n)
    alt_c = rng.binomial(cov_c, 0.01)
    return alt, cov - alt, alt_c, cov_c - alt_c


@pytest.mark.parametrize("rho", [0.0, 0.05, 0.3])
def test_betabinom_tail_equal(rho):
    alt, ref, _, _ = _counts(1)
    same(jst.betabinom_pvalue_greater(alt, alt + ref, 0.01, rho),
         tst.betabinom_pvalue_greater(alt, alt + ref, 0.01, rho))


@pytest.mark.parametrize("fn", ["fisher_exact_greater", "log_odds_ratio", "log_odds_ratio_woolf"])
def test_fisher_and_log_odds_equal(fn):
    args = _counts(2, 200)
    same(getattr(jst, fn)(*args), getattr(tst, fn)(*args))


@pytest.mark.parametrize("eps,rho", [(0.01, 0.05), (0.005, 0.1)])
def test_contrast_sites_equal(eps, rho):
    args = _counts(3, 300)
    same(jst.contrast_sites(*args, eps=eps, rho=rho), tst.contrast_sites(*args, eps=eps, rho=rho))


# ---- context -------------------------------------------------------------------

def test_read_fasta_equal(pair):
    paths, _ = pair
    assert jctx.read_fasta(paths["fa"]) == tctx.read_fasta(paths["fa"])


@pytest.mark.parametrize("flank", [0, 3])
def test_pileup_at_sites_equal(pair, recs, flank):
    paths, truth = pair
    fasta = tctx.read_fasta(paths["fa"])
    names = recs["wt"][1].ref_names
    rid = np.asarray([names.index(c) for c, *_ in truth["atoi"] + truth["m6a"]])
    pos = np.asarray([p for _, p, *_ in truth["atoi"] + truth["m6a"]])
    for fa in (None, fasta):
        same(jctx.pileup_at_sites(recs["wt"][0], rid, pos, flank=flank, fasta=fa),
             tctx.pileup_at_sites(recs["wt"][1], rid, pos, flank=flank, fasta=fa))


def test_pwm_and_metagene_equal(pair):
    paths, truth = pair
    fasta = tctx.read_fasta(paths["fa"])
    chrom = [c for c, *_ in truth["m6a"]]
    pos = np.asarray([p for _, p, *_ in truth["m6a"]])
    strand = np.asarray([1 if s == "+" else -1 for *_, s, _ in truth["m6a"]])
    same(jctx.pwm_at_sites(fasta, chrom, pos, flank=2, strand=strand),
         tctx.pwm_at_sites(fasta, chrom, pos, flank=2, strand=strand))
    same(jctx.pwm_from_reads([paths["wt"]], fasta, chrom, pos, flank=3, strand=strand),
         tctx.pwm_from_reads([paths["wt"]], fasta, chrom, pos, flank=3, strand=strand))
    jm, tm = jgenes.parse_gff_genes(paths["gff"]), tgenes.parse_gff_genes(paths["gff"])
    ref_names = sorted({c for c, *_ in truth["m6a"]} | set(tm.chrom_names))
    rid = np.asarray([ref_names.index(c) for c in chrom])
    same(jctx.metagene_profile(jm, ref_names, rid, pos, value=pos * 1.0, bins=20),
         tctx.metagene_profile(tm, ref_names, rid, pos, value=pos * 1.0, bins=20))


# ---- dartseq -------------------------------------------------------------------

@pytest.mark.parametrize("bases,min_baseq", [("CT", 20), ("AG", 0), ("GA", 20), ("TC", 35)])
def test_conversion_counts_equal(recs, bases, min_baseq):
    ref, alt = (ord(x) for x in bases)
    for arm in ("wt", "ct"):
        j, t = recs[arm]
        same(jds.conversion_counts(j, ref_base=ref, alt_base=alt, min_baseq=min_baseq),
             tds.conversion_counts(t, ref_base=ref, alt_base=alt, min_baseq=min_baseq))


def test_coverage_at_sites_equal(pair, recs):
    _, truth = pair
    names = recs["wt"][1].ref_names
    sites = truth["atoi"] + truth["m6a"] + truth["snps"]
    rid = np.asarray([names.index(c) for c, *_ in sites])
    pos = np.asarray([s[1] for s in sites])
    for arm in ("wt", "ct"):
        j, t = recs[arm]
        same(jds.coverage_at_sites(j, rid, pos), tds.coverage_at_sites(t, rid, pos))
        same(jds.per_cell_coverage_at_sites(j, rid, pos, len(j.barcodes)),
             tds.per_cell_coverage_at_sites(t, rid, pos, len(t.barcodes)))


@pytest.mark.parametrize("runner,kw", [
    ("run_dartseq", {}),
    ("run_atoi", {}),
    ("run_dartseq", {"max_p": 0.2, "min_alt": 2, "min_coverage": 10, "min_baseq": 0}),
    ("run_atoi", {"snp_mask": "planted"}),
    ("run_dartseq", {"valid_cells": "half"}),
    ("run_atoi", {"wt_cells": "half", "eps": 0.02, "rho": 0.1}),
], ids=["m6a", "atoi", "m6a_loose", "atoi_snp_mask", "m6a_valid_cells", "atoi_wt_cells"])
def test_run_dartseq_and_atoi_equal(pair, runner, kw):
    paths, truth = pair
    kw = dict(kw)
    if kw.get("snp_mask") == "planted":
        kw["snp_mask"] = {(c, p) for c, p, *_ in truth["snps"] + truth["atoi"][:4]}
    if kw.get("wt_cells") == "half":
        kw["wt_cells"] = set(truth["wt"]["barcodes"][::2])
    if kw.get("valid_cells") == "half":  # an allow-list over both arms
        kw["valid_cells"] = set(truth["wt"]["barcodes"][::2] + truth["control"]["barcodes"][::2])
    j = getattr(jds, runner)(paths["wt"], paths["ct"], **kw)
    t = getattr(tds, runner)(paths["wt"], paths["ct"], **kw)
    same(j, t)
    assert len(t.site_names) > 0


def test_motif_and_confounder_masks_equal(pair):
    paths, truth = pair
    res = tds.run_dartseq(paths["wt"], paths["ct"], max_p=0.5, min_alt=1)
    names = tbam.read_bam_ref_names(paths["wt"])
    fasta = tctx.read_fasta(paths["fa"])
    for check_r in (True, False):
        a = jds.m6a_motif_mask(fasta, names, res.sites[:, 0], res.sites[:, 1], res.strand,
                               check_r_site=check_r)
        b = tds.m6a_motif_mask(fasta, names, res.sites[:, 0], res.sites[:, 1], res.strand,
                               check_r_site=check_r)
        same(a, b)
    atoi = {(c, p) for c, p, *_ in truth["atoi"]} | {(names[int(r)], int(p) - 1)
                                                      for r, p in res.sites[::3]}
    same(jds.atoi_confounder_mask(res.sites[:, 0], res.sites[:, 1], res.strand, names, atoi),
         tds.atoi_confounder_mask(res.sites[:, 0], res.sites[:, 1], res.strand, names, atoi))
    keep = tds.m6a_motif_mask(fasta, names, res.sites[:, 0], res.sites[:, 1], res.strand)
    same(jds.filter_sites(jds.run_dartseq(paths["wt"], paths["ct"], max_p=0.5, min_alt=1), keep),
         tds.filter_sites(res, keep))


# ---- cell_activity -------------------------------------------------------------

@pytest.mark.parametrize("bases", ["CT", "AG"])
def test_editing_tallies_and_cell_scan_equal(recs, bases):
    ref, alt = (ord(x) for x in bases)
    j = jds.editing_activity_tallies(recs["wt"][0], recs["ct"][0], ref_base=ref, alt_base=alt)
    t = tds.editing_activity_tallies(recs["wt"][1], recs["ct"][1], ref_base=ref, alt_base=alt)
    same(j, t)
    for kw in ({"min_coverage": 5, "min_per_stratum": 10},
               {"min_coverage": 5, "min_per_stratum": 10, "control_tail": 0.05}):
        same(jca.call_competent_cells(*j, **kw), tca.call_competent_cells(*t, **kw))


def test_betabinom_mom_and_strata_equal():
    rng = np.random.default_rng(0)
    n = rng.integers(50, 500, 400)
    y = rng.binomial(n, rng.beta(4.9, 44.1, 400))
    same(jca.fit_betabinom_mom(y, n), tca.fit_betabinom_mom(y, n))
    v = rng.gamma(2.0, 100.0, 500)
    for n_strata, min_per in ((4, 10), (12, 50), (12, 30)):
        same(jca.quantile_strata(v, n_strata, min_per), tca.quantile_strata(v, n_strata, min_per))


# ---- mixture -------------------------------------------------------------------

def test_mixture_primitives_equal():
    rng = np.random.default_rng(1)
    groups = [(np.sort(rng.integers(0, 3000, rng.integers(3, 40))).astype(np.float64),
               rng.gamma(2.0, 1.0, 40)) for _ in range(12)]
    groups = [(p, w[: len(p)]) for p, w in groups]
    for preset in ("m6a", "atoi"):
        kw = jmix.BANDWIDTH_PRESETS[preset]
        same(jmix.estimate_bandwidth(groups, **kw), tmix.estimate_bandwidth(groups, **kw))
    x = np.sort(rng.uniform(0, 1000, 300))
    y = rng.gamma(1.0, 1.0, 300)
    grid = np.arange(0.0, 1000.0, 5.0)
    for bw in (7.5, 40.0):
        sj, st = jmix.gaussian_kernel_smooth(x, y, grid, bw), tmix.gaussian_kernel_smooth(x, y, grid, bw)
        same(sj, st)
        same(jmix.find_modes(sj), tmix.find_modes(st))
    cll = np.log(rng.dirichlet(np.ones(4), 200))
    w = rng.gamma(2.0, 1.0, 200)
    for weights in (None, w):
        same(jmix.fixed_em_weighted(cll, weights, n_free_params=3),
             tmix.fixed_em_weighted(cll, weights, n_free_params=3))


@pytest.mark.parametrize("bandwidth", [0.0, 25.0])
def test_fit_gene_mixture_equal(bandwidth):
    rng = np.random.default_rng(2)
    pos = np.concatenate([rng.normal(300, 20, 60), rng.normal(900, 30, 40)]).round()
    cells = rng.integers(0, 50, len(pos))
    w = rng.gamma(2.0, 1.0, len(pos))
    p = jmix.MixtureParams(bandwidth=bandwidth)
    same(jmix.fit_gene_mixture(cells, pos, w, 1200.0, p),
         tmix.fit_gene_mixture(cells, pos, w, 1200.0, tmix.MixtureParams(bandwidth=bandwidth)))


@pytest.mark.parametrize("modality,weight_mode", [("m6a", "converted"), ("atoi", "posterior"),
                                                  ("m6a", "posterior")])
def test_run_mixture_equal(pair, modality, weight_mode):
    paths, _ = pair
    runner = tds.run_atoi if modality == "atoi" else tds.run_dartseq
    res = runner(paths["wt"], paths["ct"], max_p=0.5, min_alt=1)
    names = tbam.read_bam_ref_names(paths["wt"])
    cov = None
    if weight_mode == "posterior":
        cov = tds.per_cell_coverage_at_sites(tbam.read_bam(paths["wt"]), res.sites[:, 0],
                                             res.sites[:, 1], len(res.barcodes))
    out = []
    for genes, mix in ((jgenes, jmix), (tgenes, tmix)):
        model = genes.parse_gff_genes(paths["gff"])
        exons = genes.parse_gff_exons(paths["gff"], model)
        out.append(mix.run_mixture(res.cell_counts, res.sites[:, 0], res.sites[:, 1], res.strand,
                                   names, model, exons, modality=modality,
                                   weight_mode=weight_mode, cell_coverage=cov,
                                   params=mix.MixtureParams(min_sites=2)))
    (jm, jn, jc, jb), (tm, tn, tc, tb) = out
    same(jm, tm)
    same(jn, tn)
    assert jc.equals(tc)
    same(jb, tb)
    assert tm is not None and tm.shape[0] > 0
