"""faba's GFF reader and the commands that take it, through both packages,
the port on the CPU: `parse_gff_genes` equal on GFF3 and GTF lines,
gzipped, with a biotype filter; `genome_order_from_gff` equal; `cocoa
diff --gff` gives JAX's gene order and CNV outputs, the same as a
`--cnv-ground-truth` run on the same positions; `senna plot-strand`
writes JAX's images where matplotlib imports. With them, the masked
model's gathers by gene id: the backward through K3's group sum (its
plain version here) equals plain indexing's."""

import gzip
import os

import numpy as np
import pandas as pd
import pytest
import scipy.sparse as sp
import torch

from legume_tpu.cli import main as jcli
from legume_tpu.cocoa import cnv_call as jcnv
from legume_tpu.cocoa.diff import CocoaDiffArgs, run_cocoa_diff
from legume_tpu.data.sparse_io import create_sparse_from_csc
from legume_tpu.faba.genes import parse_gff_genes as j_parse
from legume_tpu_torch.cli.main import main as port_cli
from legume_tpu_torch.cocoa import cnv_call as tcnv
from legume_tpu_torch.faba.genes import parse_gff_genes as t_parse
from legume_tpu_torch.models import indexed as tidx

GFF3 = """##gff-version 3
chr2\tens\tgene\t5001\t7000\t.\t-\t.\tID=gene:ENSG2;Name=BETA;biotype=protein_coding
chr1\tens\tgene\t101\t900\t.\t+\t.\tID=gene:ENSG1;Name=ALPHA;biotype=protein_coding
chr1\tens\tmRNA\t101\t900\t.\t+\t.\tID=transcript:T1;Parent=gene:ENSG1
chr1\tens\tgene\t3001\t3500\t.\t-\t.\tID=gene:ENSG3;biotype=lncRNA
chrX\tens\tgene\t10\t20\t.\t+\t.\tNote=no-name-or-id
"""
GTF = """#!genome-build test
chr1\thav\tgene\t11\t500\t.\t+\t.\tgene_id "G1.1"; gene_type "protein_coding"; gene_name "A1";
chr1\thav\texon\t11\t200\t.\t+\t.\tgene_id "G1.1"; gene_name "A1";
chr3\thav\tgene\t900\t1200\t.\t-\t.\tgene_id "G2.4"; gene_type "miRNA";
chr10\thav\tgene\t50\t80\t.\t+\t.\tgene_id "G3"; gene_biotype "protein_coding"; gene_name "A-3";
"""


def _same_model(t, j):
    assert t.names == j.names and t.chrom_names == j.chrom_names
    for f in ("chrom", "start", "end", "strand"):
        np.testing.assert_array_equal(getattr(t, f), getattr(j, f), err_msg=f)
        assert getattr(t, f).dtype == getattr(j, f).dtype, f


@pytest.mark.parametrize("kind", ["gff3", "gtf"])
@pytest.mark.parametrize("gz", [False, True])
@pytest.mark.parametrize("gene_type", [None, "protein_coding", "miRNA"])
def test_parse_gff_genes_equals_jax(tmp_path, kind, gz, gene_type):
    text = GFF3 if kind == "gff3" else GTF
    path = tmp_path / f"g.{kind}{'.gz' if gz else ''}"
    path.write_bytes(gzip.compress(text.encode()) if gz else text.encode())
    t, j = t_parse(str(path), gene_type=gene_type), j_parse(str(path), gene_type=gene_type)
    _same_model(t, j)
    assert len(t.names) > 0 or gene_type == "miRNA" and kind == "gff3"


def test_genome_order_from_gff_equals_jax(tmp_path):
    path = tmp_path / "g.gff3"
    path.write_text(GFF3)
    names = ["BETA", "nope", "ENSG3", "ALPHA"]
    t, j = tcnv.genome_order_from_gff(names, str(path)), jcnv.genome_order_from_gff(names, str(path))
    for f in ("ordered", "chrom", "pos"):
        np.testing.assert_array_equal(getattr(t, f), getattr(j, f), err_msg=f)
    assert t.chrom_names == j.chrom_names and list(t.ordered) == [3, 2, 0]
    with pytest.raises(ValueError, match="matched"):
        tcnv.genome_order_from_gff(["x"], str(path))


def _amplified(tmp_path):
    """`tests/test_cocoa_e2e.py::test_cocoa_cnv_side_channel_recovers_amplified_block`'s
    data, with its gene positions both as a ground-truth table and as a GFF
    (TSS on the + strand at the same position)."""
    rng = np.random.default_rng(11)
    g, n_indv, cpi = 60, 8, 40
    n = n_indv * cpi
    base = rng.gamma(2.0, 1.0, size=g)
    cell_indv = np.repeat(np.arange(n_indv), cpi)
    rate = np.tile(base[:, None], (1, n))
    for i in range(2):
        rate[20:36, cell_indv == i] *= 2.2
    counts = rng.poisson(rate * 5.0).astype(np.float32)
    path = str(tmp_path / "cnv_counts.zarr")
    create_sparse_from_csc(sp.csc_matrix(counts), path, [f"g{i}" for i in range(g)],
                           [f"c{j}" for j in range(n)])
    (tmp_path / "indv.txt").write_text("\n".join(f"i{v}" for v in cell_indv) + "\n")
    (tmp_path / "exp.tsv").write_text(
        "".join(f"i{i}\t{x}\n" for i, x in enumerate(np.tile([0, 1], n_indv // 2))))
    truth = tmp_path / "truth.tsv.gz"
    gff = tmp_path / "genes.gff3.gz"
    with gzip.open(truth, "wt") as f, gzip.open(gff, "wt") as h:
        f.write("gene_idx\tchr\tpos\n")
        for i in rng.permutation(g):  # the GFF lists the genes in another order
            chrom, pos = ("chr1" if i < 45 else "chr2"), i * 1000 + 500
            h.write(f"{chrom}\tsim\tgene\t{pos + 1}\t{pos + 800}\t.\t+\t.\tID=gene:g{i};Name=g{i}\n")
        for i in range(g):
            f.write(f"{i}\t{'chr1' if i < 45 else 'chr2'}\t{i * 1000 + 500}\n")
    return path, str(truth), str(gff)


def _cnv_outputs(prefix):
    out = {n: pd.read_parquet(f"{prefix}.cnv.{n}.parquet") for n in ("states", "cn_score")}
    for n in ("normal_samples.tsv.gz", "segments.bed.gz"):
        with gzip.open(f"{prefix}.cnv.{n}", "rt") as f:
            out[n] = f.read()
    out["effect"] = pd.read_parquet(f"{prefix}.effect.parquet")
    return out


def test_cocoa_diff_gff_matches_jax_and_the_truth_table(tmp_path):
    path, truth, gff = _amplified(tmp_path)
    common = ["--data-files", path, "--indv", str(tmp_path / "indv.txt"), "--exposure",
              str(tmp_path / "exp.tsv"), "--n-pb-samples", "4", "--knn", "5", "--iter-opt", "40",
              "--no-match-cache", "--permutations", "2", "--device", "cpu"]
    run_cocoa_diff(CocoaDiffArgs(
        data_files=[path], out=str(tmp_path / "j"), indv_file=str(tmp_path / "indv.txt"),
        exposure_file=str(tmp_path / "exp.tsv"), n_pb_samples=4, knn=5, n_opt_iter=40,
        gff=gff, cnv_ground_truth=truth, match_cache=False, n_permutations=2))
    # --gff takes precedence over --cnv-ground-truth, as in the JAX package
    assert port_cli(["cocoa", "diff", *common, "--gff", gff, "--cnv-ground-truth", truth,
                     "--out", str(tmp_path / "t")]) == 0
    assert port_cli(["cocoa", "diff", *common, "--cnv-ground-truth", truth,
                     "--out", str(tmp_path / "truth")]) == 0
    t, j, by_truth = (_cnv_outputs(str(tmp_path / x)) for x in ("t", "j", "truth"))
    for other in (j, by_truth):
        for name in ("states", "cn_score"):
            a, b = t[name], other[name]
            assert list(a.columns) == list(b.columns) and (a.gene == b.gene).all()
            if name == "states":
                np.testing.assert_array_equal(a.iloc[:, 1:].to_numpy(), b.iloc[:, 1:].to_numpy())
            else:
                np.testing.assert_allclose(a.iloc[:, 1:].to_numpy(), b.iloc[:, 1:].to_numpy(),
                                           rtol=0, atol=1e-4)
        assert t["normal_samples.tsv.gz"] == other["normal_samples.tsv.gz"]
        assert t["segments.bed.gz"] == other["segments.bed.gz"]
        np.testing.assert_array_equal(t["effect"].cnv_state, other["effect"].cnv_state)
        np.testing.assert_allclose(t["effect"].cnv_concordance_r, other["effect"].cnv_concordance_r,
                                   rtol=0, atol=1e-4)
    assert t["states"].gene.tolist() == [f"g{i}" for i in range(60)]


def test_plot_strand_writes_jax_images(tmp_path):
    pytest.importorskip("matplotlib")
    (tmp_path / "g.gff3").write_text(GFF3)
    pd.DataFrame({"gene": ["ALPHA", "BETA", "ENSG3", "absent"], "t0": [1.0, 2.0, 0.5, 9.0],
                  "t1": [0.0, 1.5, 3.0, 1.0]}).to_parquet(tmp_path / "act.parquet")
    flags = ["--activity", str(tmp_path / "act.parquet"), "--gff", str(tmp_path / "g.gff3"),
             "--bins", "20"]
    assert port_cli(["senna", "plot-strand", *flags, "--out", str(tmp_path / "t")]) == 0
    jcli.main(["senna", "plot-strand", *flags, "--out", str(tmp_path / "j")])
    for col in ("t0", "t1"):
        t, j = tmp_path / f"t.{col}.png", tmp_path / f"j.{col}.png"
        assert os.path.getsize(t) > 0 and os.path.getsize(j) > 0
    assert sorted(p.name[2:] for p in tmp_path.glob("t.*.png")) == sorted(
        p.name[2:] for p in tmp_path.glob("j.*.png"))


@pytest.mark.parametrize("shape", [(6, 5, 4), (6, 5)])
def test_masked_gather_backward_through_group_sum_equals_indexing(shape):
    """`_RowGather` (the card's path: K3's group sum, here its plain
    version) against plain indexing, for rho-like [rows, H] and
    log-phi-like [rows] tables, with repeated ids."""
    g = torch.Generator().manual_seed(0)
    table = torch.randn(shape[0] + 3, *shape[2:], generator=g, dtype=torch.float32)
    ids = torch.randint(0, shape[0] + 3, shape[:2], generator=g, dtype=torch.int32)
    ids[0, :] = 2  # one id many times
    w = torch.randn(*shape, generator=g)
    a = table.clone().requires_grad_(True)
    b = table.clone().requires_grad_(True)
    (tidx._RowGather.apply(a, ids) * w).sum().backward()
    (b[ids.long()] * w).sum().backward()
    assert torch.equal(tidx._RowGather.apply(table, ids), table[ids.long()])
    torch.testing.assert_close(a.grad, b.grad, rtol=1e-6, atol=1e-6)
    # on the CPU the model keeps plain indexing: its values are unchanged
    c = table.clone().requires_grad_(True)
    (tidx.gather_rows(c, ids) * w).sum().backward()
    assert torch.equal(c.grad, b.grad)
