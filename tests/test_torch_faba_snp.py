"""`faba snp` and `faba depth` in the port (`faba/snp.py`, `faba/depth.py`)
against the JAX package's, on the CPU.

The genotyper's likelihoods, MAP calls and GQs, the site tables, the VCF,
parquet and mask files, the per-cell BAF stores and the depth matrices
are held equal exactly (both packages run the same float64 numpy). The
BAMs are the port's planted wild-type / control pair
(`faba/bam_sim.py::simulate_edit_pair`), whose heterozygous germline SNPs
both arms carry.
"""

import numpy as np
import pandas as pd
import pytest

from legume_tpu.faba import depth as jdepth
from legume_tpu.faba import snp as jsnp
from legume_tpu_torch.faba import depth as tdepth
from legume_tpu_torch.faba import snp as tsnp

from faba_parity import planted_pair, same, same_outputs


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    return planted_pair(tmp_path_factory.mktemp("snp_pair"))


def _known_vcf(path, truth, names):
    """A VCF of half the planted SNPs, an indel and a contig the BAMs lack."""
    rows = [f"{c}\t{p + 1}\trs{i}\t{r}\t{a}\t.\t.\t." for i, (c, p, r, a) in
            enumerate(truth["snps"][::2])]
    rows += [f"{names[0]}\t{truth['snps'][1][1] + 1}\trsIndel\tCT\tC\t.\t.\t.",
             "chrM\t101\trsM\tA\tC\t.\t.\t."]
    path.write_text("##fileformat=VCFv4.2\n#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\n"
                    + "\n".join(rows) + "\n")
    return str(path)


def test_genotype_likelihoods_and_calls_equal():
    rng = np.random.default_rng(0)
    depth = rng.integers(0, 200, 500)
    n_alt = rng.binomial(depth, rng.choice([0.0, 0.02, 0.5, 0.98], 500))
    params = jsnp.GenotypeParams()
    for e in (0.001, 0.01):
        lj = jsnp.genotype_log_likelihoods(depth - n_alt, n_alt, e)
        lt = tsnp.genotype_log_likelihoods(depth - n_alt, n_alt, e)
        same(lj, lt)
        same(jsnp.call_genotypes(lj, params), tsnp.call_genotypes(lt, tsnp.GenotypeParams()))
    s = [rng.normal(-k, 1.0, 500) for k in (1, 2, 3)]
    same(jsnp.genotype_log_likelihoods_qual(depth - n_alt, *s, 0.01),
         tsnp.genotype_log_likelihoods_qual(depth - n_alt, *s, 0.01))


@pytest.mark.parametrize("case", ["bulk", "per_cell", "gff_genome", "known", "known_only",
                                  "no_dedup_no_qual", "min_vaf"])
def test_run_snp_outputs_equal(pair, tmp_path, case):
    paths, truth = pair
    bams = [paths["wt"], paths["ct"]]
    kw = {
        "bulk": dict(bulk=True),
        "per_cell": dict(bulk=False, gff=paths["gff"]),
        "gff_genome": dict(bulk=True, gff=paths["gff"], genome=paths["fa"]),
        "known": dict(bulk=False, gff=paths["gff"], known_snps="vcf"),
        "known_only": dict(bulk=True, known_snps="vcf", skip_discovery=True),
        "no_dedup_no_qual": dict(bulk=True, no_umi_dedup=True, use_base_quality=False,
                                 params="loose"),
        "min_vaf": dict(bulk=True, min_vaf=0.2),
    }[case]
    if kw.get("known_snps") == "vcf":
        kw["known_snps"] = _known_vcf(tmp_path / "known.vcf", truth, ["chr1"])
    out = {}
    for side, mod in (("jax", jsnp), ("port", tsnp)):
        k = dict(kw)
        if k.get("params") == "loose":
            k["params"] = mod.GenotypeParams(min_coverage=4, min_alt_count=1, min_alt_freq=0.05)
        out[side] = mod.run_snp(bams, str(tmp_path / side), **k)
    same(out["jax"], out["port"])
    files = same_outputs(tmp_path / "jax", tmp_path / "port", "", "")
    assert "snp_sites.parquet" in files and len(out["port"]) > 0
    if not kw.get("bulk"):  # the per-cell allele counts, one store a BAM
        assert {"wt_baf.zarr", "ct_baf.zarr"} <= set(files), files


def test_snp_mask_and_call_snps_equal(pair, tmp_path):
    paths, _ = pair
    sites = tsnp.run_snp([paths["wt"], paths["ct"]], str(tmp_path / "o"), bulk=True)
    jsites = jsnp.run_snp([paths["wt"], paths["ct"]], str(tmp_path / "j"), bulk=True)
    for gq, vaf in ((20.0, None), (20.0, 0.2), (60.0, 0.3)):
        same(jsnp.build_snp_mask(jsites, gq, vaf), tsnp.build_snp_mask(sites, gq, vaf))
    same(jsnp.call_snps(paths["wt"]), tsnp.call_snps(paths["wt"]))
    known = tmp_path / "k.parquet"
    pd.DataFrame({"chr": sites.chrom, "pos": sites.pos, "ref": sites.ref_allele,
                  "alt": sites.alt_allele}).to_parquet(known)
    same(jsnp.load_known_snps(str(known)), tsnp.load_known_snps(str(known)))


def test_read_bed_and_depth_per_region_equal(pair, tmp_path):
    paths, truth = pair
    bed = tmp_path / "r.bed"
    bed.write_text("".join(f"{c}\t{max(p - 300, 0)}\t{p + 200}\tpas_{g}\n"
                           for g, (c, p) in enumerate(
                               (s[0], s[1]) for s in truth["atoi"] + truth["snps"]))
                   + "chrX\t0\t100\n")
    jb, tb = jdepth.read_bed(str(bed)), tdepth.read_bed(str(bed))
    same(jb, tb)
    for arm in ("wt", "ct"):
        for use_index in (False, True):
            same(jdepth.depth_per_region(paths[arm], jb, use_index=use_index),
                 tdepth.depth_per_region(paths[arm], tb, use_index=use_index))


@pytest.mark.parametrize("resolution_bp,min_mapq", [(1000, 20), (5000, 0), (250, 30)])
def test_depth_matrix_uniform_equal(pair, resolution_bp, min_mapq):
    paths, _ = pair
    for arm in ("wt", "ct"):
        same(jdepth.depth_matrix_uniform(paths[arm], resolution_bp=resolution_bp,
                                         min_mapq=min_mapq),
             tdepth.depth_matrix_uniform(paths[arm], resolution_bp=resolution_bp,
                                         min_mapq=min_mapq))
