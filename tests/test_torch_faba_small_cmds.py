"""`faba docs`, `pwm`, `metagene`, `pileup` / `inspect` in the port against
the JAX package (`legume_tpu/faba/{docs,metagene,context}.py`,
`cli/faba_cli.py`, `cli/faba_cmds/{motif,pileup}_cmds.py`), on the
inputs of `tests/test_faba_small_cmds.py`. All host numpy: every table,
count and printed line is held exact. The Miami figure needs matplotlib;
its files and summary line are held, not its pixels.
"""

import os

import numpy as np
import pandas as pd
import pytest
import scipy.sparse as sp

from faba_parity import same
from legume_tpu.cli.main import run_faba as j_faba
from legume_tpu.faba import docs as jdocs
from legume_tpu.faba import metagene as jmg
from legume_tpu_torch.cli.main import run_faba as t_faba
from legume_tpu_torch.data.sparse_io import create_sparse_from_csc
from legume_tpu_torch.faba import docs as tdocs
from legume_tpu_torch.faba import metagene as tmg
from legume_tpu_torch.faba.bam import write_bam

TRIPARTITE_GFF = """chr1\tx\tgene\t1\t1000\t.\t+\t.\tID=gene:G1
chr1\tx\tmRNA\t1\t1000\t.\t+\t.\tID=transcript:T1;Parent=gene:G1
chr1\tx\texon\t1\t1000\t.\t+\t.\tParent=transcript:T1
chr1\tx\tfive_prime_UTR\t1\t100\t.\t+\t.\tParent=transcript:T1
chr1\tx\tCDS\t101\t800\t.\t+\t.\tParent=transcript:T1
chr1\tx\tthree_prime_UTR\t801\t1000\t.\t+\t.\tParent=transcript:T1
chr1\tx\tmRNA\t2001\t3000\t.\t-\t.\tID=transcript:T2;Parent=gene:G2
chr1\tx\texon\t2001\t3000\t.\t-\t.\tParent=transcript:T2
chr1\tx\tCDS\t2101\t2800\t.\t-\t.\tParent=transcript:T2
chr1\tx\tmRNA\t2001\t2600\t.\t-\t.\tID=transcript:T3;Parent=gene:G2
chr1\tx\texon\t2001\t2600\t.\t-\t.\tParent=transcript:T3
chr1\tx\tCDS\t2101\t2500\t.\t-\t.\tParent=transcript:T3
chr1\tx\ttranscript\t5001\t5500\t.\t+\t.\tID=transcript:NC1;Parent=gene:NC
chr1\tx\texon\t5001\t5500\t.\t+\t.\tParent=transcript:NC1
"""


def _pair(argv, tmp_path, capsys, out_flag, out_name, device=False):
    """Run `argv` through both CLIs with the output under t.* / j.*; the
    printed lines must agree but for the output paths."""
    t_out, j_out = str(tmp_path / f"t{out_name}"), str(tmp_path / f"j{out_name}")
    t_faba(argv + [out_flag, t_out] + (["--device", "cpu"] if device else []))
    said = capsys.readouterr()
    j_faba(argv + [out_flag, j_out])
    want = capsys.readouterr()
    assert said.out.replace(t_out, "O") == want.out.replace(j_out, "O")
    assert said.err == want.err
    return t_out, j_out


@pytest.mark.parametrize("topic", [None] + jdocs.topics())
def test_docs_print_the_jax_texts(topic, capsys):
    argv = ["docs"] + ([topic] if topic else [])
    t_faba(argv)
    got = capsys.readouterr().out
    j_faba(argv)
    want = capsys.readouterr().out
    if topic == "posterior":
        # the one sentence that says how a sweep runs: compiled in the JAX
        # package, a loop over tensors on the card in the port
        assert "lax.scan" in want and "lax.scan" not in got and "TPU" not in got
        cut = lambda s: s[: s.index("hyperpriors")] + s[s.index("Outputs per-gene"):]  # noqa: E731
        got, want = cut(got), cut(want)
    assert got == want
    assert tdocs.topics() == jdocs.topics()


def test_metagene_models_equal_jax(tmp_path):
    gff = tmp_path / "g.gff"
    gff.write_text(TRIPARTITE_GFF)
    models, nc = tmp_mg = tmg.parse_gff_transcripts(str(gff))
    same(tmp_mg, jmg.parse_gff_transcripts(str(gff)))
    same(tmg.elect_longest_isoform(models), jmg.elect_longest_isoform(jmg.parse_gff_transcripts(
        str(gff))[0]))
    chroms = np.array(["chr1"] * 6, object)
    pos = np.array([50, 400, 850, 2300, 2700, 5100])
    for kw in (dict(bins=30, include_ncrna=True), dict(bins=4), dict(bins=50, isoform="all")):
        same(tmg.metagene_metaplotr(models, nc, chroms, pos, **kw),
             jmg.metagene_metaplotr(*jmg.parse_gff_transcripts(str(gff)), chroms, pos, **kw))


@pytest.mark.parametrize("mode", ["metaplotr", "all_isoforms_ncrna", "body"])
def test_cli_metagene_matches_jax(mode, tmp_path, capsys):
    gff = tmp_path / "g.gff"
    gff.write_text(TRIPARTITE_GFF)
    sites = tmp_path / "sites.parquet"
    pd.DataFrame({"chrom": ["chr1"] * 5, "pos": [50, 400, 850, 2300, 5100]}).to_parquet(sites)
    argv = ["metagene", "--sites", str(sites), "--gff", str(gff), "--bins", "30"]
    if mode == "metaplotr":
        argv += ["--print", "--max-width", "40"]
    elif mode == "all_isoforms_ncrna":
        argv += ["--isoform", "all", "--ncrna"]
    else:
        argv += ["--body"]
    if mode == "body":
        t, j = _pair(argv, tmp_path, capsys, "--output", "")
        same(pd.read_parquet(f"{t}.metagene.parquet"), pd.read_parquet(f"{j}.metagene.parquet"))
        return
    t_dist, j_dist = tmp_path / "td.tsv", tmp_path / "jd.tsv"
    t_faba(argv + ["--output", str(tmp_path / "t.tsv"), "--distances", str(t_dist)])
    said = capsys.readouterr()
    j_faba(argv + ["--output", str(tmp_path / "j.tsv"), "--distances", str(j_dist)])
    want = capsys.readouterr()
    assert said.out.replace("t.tsv", "O") == want.out.replace("j.tsv", "O")
    assert said.err == want.err
    for a, b in (("t.tsv", "j.tsv"), ("td.tsv", "jd.tsv")):
        same(pd.read_csv(tmp_path / a, sep="\t"), pd.read_csv(tmp_path / b, sep="\t"))
    same(pd.read_parquet(tmp_path / "t.metagene.parquet"),
         pd.read_parquet(tmp_path / "j.metagene.parquet"))


@pytest.fixture()
def site_bam(tmp_path):
    """Ten 40-base reads over a C at 0-based 110 (six converted to T), two
    cells; the reference context 108..112 is GCCGT."""
    reads = []
    for i in range(10):
        conv = i < 6
        seq = list("A" * 40)
        seq[10] = "T" if conv else "C"
        reads.append(dict(name=f"r{i}", ref_id=0, pos=100, seq="".join(seq), cigar="40M",
                          cb=f"c{i % 2}", ub=f"u{i}", md="10C29" if conv else "40"))
    bam = str(tmp_path / "t.bam")
    write_bam(bam, [("chr1", 400)], reads)
    fasta = tmp_path / "ref.fa"
    fasta.write_text(">chr1\n" + "A" * 108 + "GCCGT" + "A" * 287 + "\n")
    sites = tmp_path / "s.parquet"
    pd.DataFrame({"chrom": ["chr1", "chr1"], "pos": [110, 120], "strand": ["+", "-"],
                  "pvalue": [1e-5, 0.2]}).to_parquet(sites)
    return bam, str(fasta), str(sites)


@pytest.mark.parametrize("source", ["reference", "reads"])
def test_cli_pwm_matches_jax(source, site_bam, tmp_path, capsys):
    bam, fasta, sites = site_bam
    argv = ["pwm", "--sites", sites, "--fasta", fasta, "--flank", "2", "--source", source]
    if source == "reads":
        argv += ["--bam", bam]
        t, j = _pair(argv, tmp_path, capsys, "--output", ".tsv")
        same(pd.read_csv(t, sep="\t"), pd.read_csv(j, sep="\t"))
    else:
        t, j = _pair(argv, tmp_path, capsys, "--output", "pwm")
        same(pd.read_parquet(f"{t}.pwm.parquet"), pd.read_parquet(f"{j}.pwm.parquet"))


@pytest.mark.parametrize("cmd", ["pileup", "inspect"])
def test_cli_pileup_composition_matches_jax(cmd, site_bam, tmp_path, capsys):
    bam, fasta, sites = site_bam
    argv = [cmd, "--bam", bam, "--sites", sites, "--flank", "3"]
    if cmd == "inspect":
        argv += ["--fasta", fasta]
    t, j = _pair(argv, tmp_path, capsys, "--output", "pu")
    got = pd.read_parquet(f"{t}.pileup.parquet")
    same(got, pd.read_parquet(f"{j}.pileup.parquet"))
    assert got.to_numpy().sum() > 0


@pytest.fixture()
def matrix_store(tmp_path):
    rows = ["chr1:100/m6a/CT", "chr1:150/m6a/CT", "chr1:900/atoi/AG", "chr2:100/m6a/CT"]
    x = sp.csc_matrix(np.array([[3, 0, 1], [0, 2, 0], [5, 5, 5], [9, 9, 9]], np.float32))
    be = str(tmp_path / "m.zarr")
    create_sparse_from_csc(x, be, rows, ["c0", "c1", "c2"])
    sites = tmp_path / "sites.parquet"
    pd.DataFrame({"chrom": ["chr1", "chr1"], "pos": [120, 905],
                  "pvalue_betabinom": [1e-4, 1e-2], "wt_coverage": [10.0, 4.0],
                  "n_converted": [3.0, 1.0]}).to_parquet(sites)
    gff = tmp_path / "g.gff"
    gff.write_text("chr1\tx\tgene\t60\t200\t.\t+\t.\tgene_name=GX\n")
    return be, str(sites), str(gff)


TRACKS = {
    "sum_neglog10pv": ["--regions", "chr1:50-1000", "--signal", "sum", "--bins", "10",
                       "--site-signal", "neglog10pv", "--quiet", "sites"],
    "nnz_plot": ["--regions", "chr1:50-1000", "--signal", "nnz", "--bins", "5",
                 "--plot-height", "4"],
    "log10_gene_coverage": ["--genes", "GX", "--signal", "log10-sum", "--bins", "4",
                            "--site-signal", "wt-coverage", "gff", "sites"],
    "modalities_mut": ["--regions", "chr1:50-1000", "--modalities", "atoi",
                       "--site-signal", "mut-coverage", "--quiet", "sites"],
}


@pytest.mark.parametrize("case", list(TRACKS))
def test_cli_pileup_matrix_tracks_match_jax(case, matrix_store, tmp_path, capsys):
    be, sites, gff = matrix_store
    argv = ["pileup", "--data", be]
    for a in TRACKS[case]:
        argv += {"sites": ["--sites", sites], "gff": ["--gff", gff]}.get(a, [a])
    t, j = _pair(argv, tmp_path, capsys, "--output", ".tsv")
    got = pd.read_csv(t, sep="\t")
    same(got, pd.read_csv(j, sep="\t"))
    assert got["value"].sum() > 0


def test_cli_pileup_miami_figure_matches_jax(site_bam, tmp_path, capsys):
    pytest.importorskip("matplotlib")
    bam, fasta, sites = site_bam
    gff = tmp_path / "g.gff"
    gff.write_text("chr1\tx\tgene\t90\t160\t.\t+\t.\tgene_name=GX\n")
    memb = tmp_path / "memb.tsv"
    memb.write_text("c0\tTypeA\nc1\tTypeB\n")
    argv = ["pileup", "--bam", bam, "--sites", sites, "--region", "chr1:80-200",
            "--gff", str(gff), "--cell-membership", str(memb), "--png", "--dpi", "60"]
    t, j = _pair(argv, tmp_path, capsys, "--out", "fig")
    for ext in ("svg", "pdf", "png"):
        assert os.path.getsize(f"{t}.miami.{ext}") > 0 and os.path.exists(f"{j}.miami.{ext}")
    t_faba(["pileup", "--bam", bam, "--sites", sites, "--region", "chr1:80-200",
            "--miami", str(tmp_path / "one.png"), "--dpi", "60"])
    assert "2 sites, 10 reads, 0 genes" in capsys.readouterr().out


def test_pileup_at_sites_equals_jax_on_a_planted_pair(tmp_path):
    """The port counts coverage from sorted read starts and ends; the JAX
    package walks every aligned base. On a planted wild-type arm (RAC
    C-to-T sites, SNPs, errors), with overlapping windows and a repeated
    site, the counts are equal, and the edit shows in the wild type only."""
    from legume_tpu.faba.bam import read_bam as j_read_bam
    from legume_tpu.faba.context import pileup_at_sites as j_pileup
    from legume_tpu_torch.faba.bam import read_bam
    from legume_tpu_torch.faba.bam_sim import simulate_edit_pair
    from legume_tpu_torch.faba.context import pileup_at_sites, read_fasta

    truth = simulate_edit_pair(str(tmp_path / "wt.bam"), str(tmp_path / "ct.bam"),
                               str(tmp_path / "g.gff3"), str(tmp_path / "g.fa"), n_cells=60,
                               n_genes=12, umis_per_cell=40, atoi_sites=6, m6a_sites=6, snps=4,
                               seed=3)
    fasta = read_fasta(str(tmp_path / "g.fa"))
    plus = [(c, p) for c, p, s, _ in truth["m6a"] if s == "+"]
    got = {}
    for arm in ("wt", "ct"):
        reads = read_bam(str(tmp_path / f"{arm}.bam"))
        rid = {n: i for i, n in enumerate(reads.ref_names)}
        sites = [(rid[c], p) for c, p in plus] + [(rid[c], p + 2) for c, p in plus[:2]]
        sites.append(sites[0])
        r, p = np.array([s[0] for s in sites]), np.array([s[1] for s in sites])
        for kw in (dict(flank=3), dict(flank=2, fasta=fasta)):
            got[arm] = pileup_at_sites(reads, r, p, **kw)
            same(got[arm], j_pileup(j_read_bam(str(tmp_path / f"{arm}.bam")), r, p, **kw))
    t_col = got["wt"]["channels"].index("T")
    assert got["wt"]["counts"][2, t_col] > 0 and got["ct"]["counts"][2, t_col] <= 2
