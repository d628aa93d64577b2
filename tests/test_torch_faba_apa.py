"""`faba apa` in the port (`faba/apa.py`, `faba/apa_mixture.py`) against
the JAX package's, on the CPU.

PAS peaks, per-(cell, site) usage, PDUI, the 3' UTR regions, the
fragments, and the SCAPE mixture's sites, BIC selection and EM fits are
held equal exactly (both packages run the same float64 numpy). Inputs: the
port's planted wild-type / control pair (`faba/bam_sim.py`), and a BAM of
3' reads with poly(A) soft-clip tails at two planted sites in each of six
UTRs on both strands.
"""

import numpy as np
import pytest

from legume_tpu.faba import apa as japa
from legume_tpu.faba import apa_mixture as jam
from legume_tpu.faba import bam as jbam
from legume_tpu_torch.faba import apa as tapa
from legume_tpu_torch.faba import apa_mixture as tam
from legume_tpu_torch.faba import bam as tbam
from legume_tpu_torch.faba.bam import write_bam

from faba_parity import planted_pair, same

UTRS = [(1000 + 3000 * i, 1 if i % 2 == 0 else -1) for i in range(6)]  # (start, strand)


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    return planted_pair(tmp_path_factory.mktemp("apa_pair"))


@pytest.fixture(scope="module")
def tails(tmp_path_factory):
    """Six 1-kb UTRs; two sites each (300 and 800 bases into the UTR from
    its 5' end), cells preferring one or the other; tail reads end at the
    site with a 14-base soft clip (A after a + read, T before a - read),
    reads without a tail upstream of it."""
    tmp = tmp_path_factory.mktemp("apa_tails")
    rng = np.random.default_rng(11)
    reads, bed, gff = [], [], []
    for u, (start, strand) in enumerate(UTRS):
        lo, hi = start, start + 1000
        name = f"U{u}"
        bed.append(f"chr1\t{lo}\t{hi}\t{name}\t0\t{'+' if strand > 0 else '-'}\n")
        s = "+" if strand > 0 else "-"
        gff.append(f"chr1\tsim\tgene\t{lo - 999}\t{hi}\t.\t{s}\t.\tID=gene:{name};Name={name}\n")
        gff.append(f"chr1\tsim\texon\t{lo - 999}\t{hi}\t.\t{s}\t.\tgene_id={name}\n")
        gff.append(f"chr1\tsim\tthree_prime_UTR\t{lo + 1}\t{hi}\t.\t{s}\t.\tgene_id={name}\n")
        sites = [lo + 300, lo + 800] if strand > 0 else [hi - 300, hi - 800]
        for c in range(30):
            pref = c % 2
            for k in range(int(rng.integers(20, 40))):
                site = sites[pref if rng.random() < 0.8 else 1 - pref]
                rl = 40 + int(rng.integers(0, 8))
                tail = rng.random() < 0.5
                if strand > 0:
                    end = site - int(rng.integers(0, 3)) if tail else site - int(rng.integers(60, 250))
                    r = dict(pos=end - rl, seq="C" * rl + ("A" * 14 if tail else ""),
                             cigar=f"{rl}M14S" if tail else f"{rl}M")
                else:
                    beg = site + int(rng.integers(0, 3)) if tail else site + int(rng.integers(60, 250))
                    r = dict(pos=beg, seq=("T" * 14 if tail else "") + "G" * rl,
                             cigar=f"14S{rl}M" if tail else f"{rl}M")
                reads.append(dict(r, ref_id=0, cb=f"cell{c:03d}", ub=f"u{u}_{c}_{k}"))
    reads.sort(key=lambda r: r["pos"])
    for i, r in enumerate(reads):
        r["name"] = f"r{i}"
    path = str(tmp / "tails.bam")
    write_bam(path, [("chr1", 30000)], reads)
    (tmp / "utr.bed").write_text("".join(bed))
    (tmp / "g.gff3").write_text("".join(gff))
    return path, str(tmp / "utr.bed"), str(tmp / "g.gff3")


def test_call_pas_peaks_equal():
    rng = np.random.default_rng(0)
    ends = np.concatenate([rng.normal(c, 8, rng.integers(2, 40)).round() for c in
                           rng.uniform(0, 5000, 30)]).astype(np.int64)
    for window, min_reads in ((30, 5), (10, 2), (60, 10)):
        same(japa.call_pas_peaks(ends, peak_window=window, min_reads=min_reads),
             tapa.call_pas_peaks(ends, peak_window=window, min_reads=min_reads))


@pytest.mark.parametrize("kw", [{}, {"min_reads": 20, "peak_window": 15}, {"max_sites": 1},
                                {"utr_bed": "bed"}, {"polya_min_tail_length": 10}],
                         ids=["default", "strict", "max_sites", "utr_bed", "polya"])
def test_run_apa_and_pdui_equal(pair, tails, kw):
    paths, _ = pair
    kw = dict(kw)
    runs = [(paths["wt"], paths["gff"]), (tails[0], tails[2])]
    if kw.get("utr_bed") == "bed":
        kw["utr_bed"] = tails[1]
    if "utr_bed" in kw or "polya_min_tail_length" in kw:  # the tails BAM alone has tails
        runs = runs[1:]
    for bam, gff in runs:
        j, t = japa.run_apa(bam, gff, **kw), tapa.run_apa(bam, gff, **kw)
        same(j, t)
        same(japa.compute_pdui(j), tapa.compute_pdui(t))
        assert t.counts.shape[0] > 0


def test_utr_regions_equal(pair, tails):
    paths, _ = pair
    for gff in (paths["gff"], tails[2]):
        same(jam.build_utr_regions_from_gff(gff), tam.build_utr_regions_from_gff(gff))
    same(jam.load_utr_regions_from_bed(tails[1]), tam.load_utr_regions_from_bed(tails[1]))


def test_fragments_and_site_discovery_equal(tails):
    bam, bed, _ = tails
    jr, tr = jbam.read_bam(bam), tbam.read_bam(bam)
    for ju, tu in zip(jam.load_utr_regions_from_bed(bed), tam.load_utr_regions_from_bed(bed)):
        jf = jam.extract_fragments(jr, 0, ju, jam.ScapeParams())
        tf = tam.extract_fragments(tr, 0, tu, tam.ScapeParams())
        same(jf, tf)
        same(jam.discover_sites_from_junctions(jf, 5), tam.discover_sites_from_junctions(tf, 5))
    rng = np.random.default_rng(3)
    pos = np.sort(np.concatenate([rng.normal(c, 20, 60) for c in (200, 450, 900)]))
    for gap, count in ((50.0, 10), (20.0, 3)):
        same(jam.discover_sites_bisect(pos, gap, count), tam.discover_sites_bisect(pos, gap, count))


@pytest.mark.parametrize("kw", [{}, {"write_mixture": True}, {"apa_em_pdui": True},
                                {"write_mixture": True, "drop_single_component": True,
                                 "no_umi_dedup": True}],
                         ids=["fast_pdui", "mixture", "em_pdui", "mixture_drop_no_dedup"])
def test_run_apa_mixture_equal(tails, kw):
    bam, bed, gff = tails
    out = []
    for mod in (jam, tam):
        params = mod.ScapeParams(min_fragments=20, min_coverage=5)
        out.append(mod.run_apa_mixture([bam], utr_bed=bed, params=params, skip_gene_qc=True,
                                       **kw))
    same(*out)
    assert out[1].annotations is not None and len(out[1].annotations) > 0


def test_run_apa_mixture_from_gff_with_qc_equal(pair, tails):
    paths, _ = pair
    out = []
    for mod in (jam, tam):
        params = mod.ScapeParams(min_fragments=20, min_coverage=5)
        out.append(mod.run_apa_mixture([tails[0]], tails[2], params=params, gene_min_cells=5,
                                       cell_min_genes=2))
    same(*out)
    out = [mod.run_apa_mixture([paths["wt"], paths["ct"]], paths["gff"], skip_gene_qc=True,
                               params=mod.ScapeParams(min_fragments=20, polya_min_tail_length=0))
           for mod in (jam, tam)]
    same(*out)
