"""`faba all` (`faba/pipeline.py::run_all`) and the six command handlers
of this slice (`faba dartseq`, `atoi`, `snp`, `depth`, `apa`, `all`;
`cli/faba_cmds/{editing,variant,apa,pipeline}_cmds.py`) in the port
against the JAX package's, on the CPU.

Each run takes the same arguments on the same planted pair
(`faba/bam_sim.py::simulate_edit_pair`); every file the JAX run writes
has its counterpart in the port's run with the same content (stores
decoded equal with equal names, parquet tables, VCF and BED text, the
manifest but for its timings), and no more files. The port's run also
gives the planted gene counts and depth tiles exactly.
"""

import numpy as np
import pytest
import scipy.sparse as sp

from legume_tpu.cli.main import run_faba as j_faba
from legume_tpu.faba import pipeline as jpipe
from legume_tpu_torch.cli.main import run_faba as t_faba
from legume_tpu_torch.data.sparse_io import open_sparse_matrix
from legume_tpu_torch.faba import pipeline as tpipe

from faba_parity import planted_pair, same_outputs


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("all_pair")
    paths, truth = planted_pair(tmp)
    # a second wild-type batch (another seed over the same contigs)
    second, _ = planted_pair(tmp_path_factory.mktemp("all_pair2"), n_cells=60, seed=6)
    paths["wt2"] = str(tmp / "wt2.bam")
    with open(second["wt"], "rb") as f, open(paths["wt2"], "wb") as g:
        g.write(f.read())
    paths["bed"] = str(tmp / "r.bed")
    with open(paths["bed"], "w") as f:
        for c, p, *_ in truth["snps"]:
            f.write(f"{c}\t{max(p - 400, 0)}\t{p + 100}\n")
    paths["mask"] = str(tmp / "mask.txt")
    with open(paths["mask"], "w") as f:
        f.write("".join(f"{c}\t{p}\n" for c, p, *_ in truth["snps"] + truth["atoi"][:3]))
    return paths, truth


def _both(tmp_path, run_j, run_t):
    """Run each package into a directory of its own; compare the outputs."""
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    run_j(str(tmp_path / "j" / "o"))
    run_t(str(tmp_path / "t" / "o"))
    return same_outputs(tmp_path / "j", tmp_path / "t", "o", "o")


@pytest.mark.parametrize("case", ["default", "multi_sample_qc", "zip_loose_no_pdui"])
def test_run_all_outputs_equal(pair, tmp_path, case):
    paths, truth = pair
    bam, kw = paths["wt"], dict(control_bam=paths["ct"], genome=paths["fa"],
                                depth_resolution_kb=1.0)
    if case == "multi_sample_qc":
        bam = [paths["wt"], paths["wt2"]]
        kw.update(gene_qc=True, gene_min_cells=5, gene_min_counts=0, cell_min_genes=2,
                  skip_snp=True, depth_resolution_kb=None)
    elif case == "zip_loose_no_pdui":
        kw.update(zip_output=True, no_apa_pdui=True, snp_mask_min_vaf=None,
                  atoi_pvalue_cutoff=0.2, drop_single_component=True)
    files = _both(tmp_path, lambda o: jpipe.run_all(bam, paths["gff"], o, **kw),
                  lambda o: tpipe.run_all(bam, paths["gff"], o, **kw))
    assert ".gem.json" in files
    if case == "default":
        assert {".genes.zarr", ".ct.genes.zarr", ".depth.zarr", ".ct.depth.zarr", ".atoi.zarr",
                ".m6a.zarr", ".apa.zarr", ".snp/snp_sites.parquet"} <= set(files), files
        for arm, tag in (("wt", ""), ("control", ".ct")):
            t = truth[arm]
            g = open_sparse_matrix(str(tmp_path / "t" / f"o{tag}.genes.zarr"))
            assert (g.read_columns_csc(np.arange(g.num_columns)) != t["genes"]).nnz == 0
            d = open_sparse_matrix(str(tmp_path / "t" / f"o{tag}.depth.zarr"))
            tile = t["mol_ref"] * (d.num_rows // 4) + t["mol_start"] // 1000
            want = sp.coo_matrix((np.ones(len(tile), np.float32), (tile, t["mol_cell"])),
                                 shape=(d.num_rows, d.num_columns)).tocsc()
            assert (d.read_columns_csc(np.arange(d.num_columns)) != want).nnz == 0


def test_run_all_posterior_mixture_weights_take_the_coverage(pair, tmp_path):
    """`--mixture-weight posterior` needs each (site, cell)'s coverage: the
    JAX package's run_all passes none and raises; the port's passes it, as
    the `faba dartseq` handler does, and its mixture equals `run_mixture`'s
    with that coverage."""
    from legume_tpu_torch.faba import bam as tbam
    from legume_tpu_torch.faba import dartseq as tds
    from legume_tpu_torch.faba import genes as tgenes
    from legume_tpu_torch.faba import mixture as tmix

    paths, _ = pair
    kw = dict(control_bam=paths["ct"], skip_snp=True, skip_apa=True, skip_atoi=True,
              mixture_weight="posterior", atoi_pvalue_cutoff=0.5, atoi_min_conversion=1)
    with pytest.raises(ValueError, match="per-cell coverage"):
        jpipe.run_all(paths["wt"], paths["gff"], str(tmp_path / "j"), **kw)
    res = tpipe.run_all(paths["wt"], paths["gff"], str(tmp_path / "t"), **kw)
    m6a = tds.run_dartseq(paths["wt"], paths["ct"], gff=paths["gff"], max_p=0.5, min_alt=1)
    model = tgenes.parse_gff_genes(paths["gff"])
    cov = tds.per_cell_coverage_at_sites(tbam.read_bam(paths["wt"]), m6a.sites[:, 0],
                                         m6a.sites[:, 1], len(m6a.barcodes))
    mat, names, _, _ = tmix.run_mixture(
        m6a.cell_counts, m6a.sites[:, 0], m6a.sites[:, 1], m6a.strand,
        tbam.read_bam_ref_names(paths["wt"]), model, tgenes.parse_gff_exons(paths["gff"], model),
        modality="m6a", weight_mode="posterior", cell_coverage=cov)
    b = open_sparse_matrix(res.outputs["m6a_mixture"])
    assert b.row_names() == names
    assert (b.read_columns_csc(np.arange(b.num_columns)) != mat).nnz == 0


CLI = {
    "dartseq": ["dartseq", "--bam", "{wt}", "--control-bam", "{ct}", "--gff", "{gff}"],
    "dartseq_motif_bed_atoi": ["dartseq", "--bam", "{wt}", "--control-bam", "{ct}", "--gff",
                               "{gff}", "--genome", "{fa}", "--output-bed-file", "--detect-atoi",
                               "--mixture-weight", "posterior", "--site-min-cells", "2"],
    "dartseq_cell_scan": ["dartseq", "--bam", "{wt}", "--control-bam", "{ct}", "--no-mixture",
                          "--cell-scan", "--cell-scan-min-coverage", "5", "--max-p", "0.1"],
    "atoi": ["atoi", "--bam", "{wt}", "--control-bam", "{ct}", "--gff", "{gff}",
             "--snp-mask-file", "{mask}"],
    "atoi_gene_qc": ["atoi", "--bam", "{wt}", "--control-bam", "{ct}", "--gff", "{gff}",
                     "--gene-qc", "--gene-min-cells", "5", "--cell-min-genes", "2",
                     "--no-mixture"],
    "snp": ["snp", "--bam", "{wt},{ct}", "--gff", "{gff}"],
    "snp_bulk_zip": ["snp", "--bam", "{wt}", "--bulk", "--genome", "{fa}", "--zip",
                     "--min-vaf", "0.2"],
    "depth_bed": ["depth", "--bam", "{wt}", "--bed", "{bed}"],
    "depth_tiles": ["depth", "--bam", "{wt}", "--resolution-kb", "2", "--row-nnz-cutoff", "2"],
    "apa_simple": ["apa", "--bam", "{wt}", "--gff", "{gff}", "--method", "simple"],
    "apa_mixture": ["apa", "--bam", "{wt},{ct}", "--gff", "{gff}", "--mixture",
                    "--polya-min-tail-length", "0", "--min-fragments", "20", "--skip-gene-qc"],
    "all": ["all", "--bam", "{wt}", "--control-bam", "{ct}", "--gff", "{gff}", "--genome",
            "{fa}", "--depth-resolution-kb", "1"],
    "all_zip_skips": ["all", "--bam", "{wt},{wt2}", "--control-bam", "{ct}", "--gff", "{gff}",
                      "--zip", "--skip-atoi", "--no-apa-pdui", "--apa-max-sites", "1",
                      "--mixture-weight", "converted", "--drop-single-component"],
}


@pytest.mark.parametrize("name", list(CLI))
def test_cli_handlers_write_what_jax_writes(pair, tmp_path, name):
    paths, _ = pair
    argv = [a.format(**paths) for a in CLI[name]]
    files = _both(tmp_path, lambda o: j_faba(argv + ["--output", o]),
                  lambda o: t_faba(argv + ["--output", o]))
    assert files, name
