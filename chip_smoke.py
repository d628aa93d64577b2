"""Quickest proof that the PyTorch/CUDA port starts on an NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught):

1. build the hand-written kernels of `legume_tpu_torch/csrc/` with nvcc
   for sm_90a and print the card's name and power limit, then which zstd
   provider (pyarrow's codec, `libzstd.so.1`) and HDF5 library the
   machine has;
2. run `senna topic` through the port's entry point with its default
   `TopicArgs` (only `epochs` cut to 5) on a simulated 100,000-cell x
   2,000-gene, 2-batch, 8-factor data set held in a `MemoryBackend`,
   with every kernel's launch count zeroed just before and read just
   after; check that the projection (K1) and collapse (K3) kernels ran,
   that the per-cell latent is a finite simplex and that the llik trace
   is finite;
3. hold every kernel against its plain torch version on the card, at
   the main path's own calls (the projections at its first 8,192-cell
   block with its basis; the collapse at that block's fine-group plane
   and batch plane, and at the first 1,024-query block of the weighted
   matched plane) and at the largest production shape (34,008 genes,
   8,192 cells, ~8.4M nonzeros, K = 64, 607 groups); time kernel, plain
   version, one library call of the same function where there is one,
   and the least time the card could take;
4. split the trainer's construction into its parts in a fresh process;
5. run `senna bge` through the port's entry point with the JAX package's
   CLI defaults (`-d 16`, 1,000 epochs, sort-dim 8, proj-dim 50, ETM on)
   on the first BGE_CELLS (25,000) of the simulated cells without their
   batches (so the marginal is unstratified and both NCE phases take K4;
   the cut halves its host Leiden), counts zeroed just before
   and read just after; check that K1, K3 and K4 ran, K4 exactly
   1,000 x levels + ceil(N / 2,048) x 100 times and every phase-2 launch
   (ceil(N / 2,048) x 100) in its axis form, that the latent and the
   feature embedding are finite, that the phase-1 loss fell and that the
   topic latent is a log-simplex;
6. phase 1 of `fit_bge` alone at the NCE anchor (2,627 pseudobulks x
   34,008 genes, H = 16, 1,000 epochs, counts made as `bench.py` makes
   them) in f32 and in bf16; the two final losses agree within 1e-2;
7. hold K4 against its plain version at the e2e phase-1 plane, one e2e
   phase-2 block in both forms (full, and the axis form phase 2 runs) and
   the anchor in f32 and bf16, each with its byte and operation bounds
   (the CUDA cores' f32 work and the tensor cores' split-TF32 products),
   and K3 at the bge run's
   own group plane (its first 8,192-cell block over its sort-dim groups),
   and time both;
8. run `senna predict` (`eval-topic` options: per-batch null, 2 delta
   sweeps, 10 refinement steps) through the port's entry point with the
   phase-2 model on 100,000 held-out cells (another seed, 2 batches, the
   genes permuted, 5% renamed `ENSG..._<name>`, 5% not in the model);
   check the mapped genes, the delta's range and the latent's simplex;
   hold the first 4,096-cell block against the port's CPU run (1e-3,
   with and without refinement; each float32 run's distance from the
   block in float64 is printed beside it); run `--decoder-only` on 10,000 of
   the cells; form the residual matrix on the card (which writers import
   is printed);
9. run `senna clustering` on that latent: kmeans (K = 10) with the BHC
   merge tree over the counts, its per-cluster sums through K3 (counts
   zeroed just before, one launch per 4,096-cell block required), held
   at one BHC plane against the plain version; hsblock (depth 4) at
   100,000 cells, and on a 5,000-cell subset against the port's CPU run
   (equal partitions up to relabelling); Leiden at 10,000 cells;
10. report whether phase 2's fine partition on the card equals the
   port's CPU projection and sort at 100,000 cells as a set partition
   (and as codes);
11. on predict's latent, through the port's CLI: `senna clustering --from`
   (kmeans, recorded into predict's manifest), `senna layout` by umap
   (CLI defaults: 15 neighbours, 200 epochs, so 2,000 SGD steps of 4,096
   edges; `--from`, recorded into the manifest) and tumap `--pcs 5` at
   all 100,000 cells, tsne on the first 10,000 and phate on the first
   2,000 cells (both dense [N, N]), `senna pseudotime` (50 nodes) at
   100,000 cells, `senna layout --method tree --from` that run, `senna
   pseudotime --velocity` with a velocity toward each cell's kNN
   neighbours of higher topic-0 share, and, where matplotlib imports,
   `senna plot --from` and `senna plot-topic` (1,000 cells: matplotlib
   draws a rectangle per cell and topic) with the topic run's
   dictionary; each command's stage seconds, peak device bytes and
   kernel launches (none of the four kernels is on these paths); every
   layout finite; umap's neighbour preservation (the share of 15 latent
   neighbours among 15 layout neighbours, 5,000 sampled cells); and on
   1,500 of the cells the card against the port's CPU run: umap after 50
   steps (and a second card run, bit-equal) and tsne after 50 iterations
   within 1e-3, phate's squared distances bit-equal and its 200-step
   refinement within 1e-3, pseudotime's nodes within 1e-4 with its tree,
   assignments, branches and root equal;
12. the `senna topic` options through the port's CLI entry point
   (`run_senna` with the cells in memory), each run at the default
   `TopicArgs` with 5 epochs and its kernel counts zeroed just before and
   read just after (K1 and K3 required): `--decoder nb-mixture,multinomial
   --decoder-weights 1 0.5 --rho-prior-weight 10 --max-coarse-features
   1000 --qc --qc-max-mito-frac 0.2` on a view of phase 2's cells with 13
   genes named `MT-` (the kept cells, each level's coarse features, every
   artifact, alpha summing to 1, the dispersion positive, the full-D
   dictionaries' columns on the simplex); `--decoder poisson --from`
   phase 2's run (its partition exactly, no sort); `--init-from` phase
   2's model (and a mismatched `-k` raising `ValueError`); `senna
   predict` with the multi-decoder model on 10,000 held-out cells; and
   on the first 4,096 cells the card against the CPU: each new decoder
   family's llik and gradients (normwise, relative 1e-5) and QC's
   statistics (exact);
13. the `senna bge` options (each run's counts zeroed just before and
   read just after): (a) `--multiome --skip-etm` on `simulate_multiome`
   (50,000 cells, 2,000 genes + 4,000 peaks, seed 13; K1, K3 and K4
   required, D = 6,000 checked; K4 held against its plain version at the
   run's phase-1 plane and first phase-2 block); (b) `--posterior 4
   --skip-etm` on phase 5's cells (4 sweeps after 1 of burn-in; pip in
   [0, 1], pip and rhat finite); (c) `pb_gibbs` at the NCE anchor from
   phase 6's f32 fit, 4 sweeps after 1 of burn-in, with seconds a sweep
   and the ESS shrink iterations; (d)
   `fit_bge` with `gene_chunk=512` on phase 5's plane, its ten phase-1
   losses within a relative 1e-4 of the dense run and no K4 launch;
14. `senna rest --from` phase 2's topic run (100,000 x 2,000, 400
   epochs; finite, loss falling; run before phase 8) and `--runs` phase
   5's and 13b's bge runs;
15. `cocoa`: `simulate_collider` at 40 individuals x 2,500 cells, 2,000
   genes, 3 types, a 2.2x amplified block of 100 genes in 6 individuals;
   `cocoa diff` through `run_cocoa` at the CLI defaults with the types as
   topics, 12 permutations and the CNV side-channel with one reference
   pass of its HMM (`COCOA_REF_ITERS`; K1 required; the
   causal genes' effects above the others', the carriers' block above
   the rest in cn_score, every timing key); `cocoa collapse` (one K3
   launch a block); K1 (K = 30) and K3 (40 groups) held against their
   plain versions at the first block each run gives them; on 25 cells
   of each individual the card against the CPU: the projections within K1's bar, caches from one
   projection equal up to distance ties of 1e-5, stats within 1e-5, z
   within 1e-4, CNV states equal (the match cache's reuse is held in
   phase 31);
16. `senna topic --cnv --from` phase 2's run (its cnv table: 80 bins,
   states in {0, 1, 2});
17. `senna vae` at the CLI defaults (`-k 16`, encoder (128, 64), 2
   levels, minibatch 100; 5 epochs) on phase 2's cells (K1 and K3
   required; llik rising), `senna predict` with that model on phase 8's
   held-out cells, `senna topic --decoder gaussian-nb --from` phase 2's
   run; the trained encoder on 4,000 cells on the card against the CPU
   (1e-3, as phase 8's; each one's distance from float64 printed);
18. `senna svd` at its defaults on phase 2's cells (K2 takes the per-cell
   Nystrom projection: one launch per 8,192-cell block, 13, required; K2
   held against its plain version and `torch.sparse.mm` at svd's first
   block), its batch-adjusted counts (written with `--save-adjusted` to a
   `.zarr` store and opened again), `senna joint-svd`
   on phase 13a's RNA and ATAC; `fit_svd` on 4,000 cells (without
   batches) on the card against the CPU, stage by stage: the same
   partition, the pseudobulk plane within 1e-5, the rSVD of one plane and
   the per-cell projection with one basis within 1e-4 (groups of singular
   values within 5% compared up to rotation); with batches the same,
   reported only (one matched neighbour may part at a near tie);
19. `senna joint-topic` at the CLI defaults (`-k 10`, encoder (128, 128),
   nb; 5 epochs) on phase 13a's RNA and ATAC, and `--decoder delta` on
   the RNA plane and a second `simulate_topic` draw of its shape (K1 and
   K3 required; llik rising); each trained joint encoder on the card
   against the CPU (1e-5 normwise);
20. `senna masked-topic` at its defaults (`-k 10`, `--window 128`,
   `--embed-dim 64`, minibatch 256; 5 epochs) on phase 2's cells with
   `--batch-files` (its null stream's collapse: K1 and K3 required) and
   `--eval-mask-fraction 0.1`; `masked-vae` and `masked-sbp
   --gene-modules 8` on 20,000 of them (loss falling); `senna predict`
   with the masked-vae model on phase 8's held-out cells, and the
   batch-null model refused (the JAX package's predict fails on it); on
   4,000 cells the card against the CPU: top-K windows and the union
   equal, the encoder (normwise) and `masked_eval_loss` within 1e-5;
21. stores: phase 2's cells written to `.zarr` and `.zarr.zip` by the
   port's own writer (no tensorstore), read back equal, with the write
   and read seconds; `senna topic --data-files x.zarr --batch-files`
   with phase 2's arguments and 1 epoch (K1 and K3 required), its
   partitions equal to phase 2's at every level;
22. annotation through the port's CLI: `qmatrix` on phase 2's dictionary
   with one gene set a simulated factor (its 50 most specific genes) and
   `--latent`; `annotate-by-enrichment --data-files x.zarr` and
   `annotate-ontology --by module-score` (a toy OBO and GAF made from the
   seed) over phase 2's cells clustered by top topic; `annotate-by-
   projection --from` phase 5's bge run and `--train-latent` onto phase
   8's held-out latent;
23. `deconvolve --from` on 10,000 of phase 2's cells at 2,000 genes (50
   archetypes; K3 one launch per 2,048-cell block, required, and held
   against its plain version at the first block's archetype plane) on
   bulk samples pooled from all cells at known type fractions, and
   `deconvolve --reference` of eight marker-block rate profiles on
   Poisson bulk samples (mean fraction error below 0.05, worst R-hat
   printed);
24. `impute` in self mode on 20,000 cells, writing its `.zarr`, and in
   reference mode with phase 8's model (5,000 held-out query cells);
25. `probe` in model mode with `--counterfactual` (20,000 held-out query
   cells, 20,000 calibration cells) and in latent mode;
26. `senna fne` at the CLI defaults (500 epochs, d = 32) on a
   stochastic-block graph of 10,000 genes in 50 modules: 500 K4 launches
   in the full form, K4 held against its plain version at that plane
   with tied weights;
27. on small inputs the card against the CPU: the Q-matrix and a
   permutation p-value equal, fne's embedding within 1e-4 after 50
   epochs, deconvolve's fractions within 0.03, a block read from x.zarr
   equal to the matrix and its K1 projection within K1's bar, QC on
   4,000 cells (statistics within 1e-6, masks equal);
28. `data-beans-sim topic` through the port's CLI with phase 2's
   arguments and seed, in a process of its own started before phase 21
   (its host-bound simulation overlaps phases 21-27): its store
   byte-equal to phase 21's x.zarr, its batch and prop files written;
   simulate and write seconds;
29. `data-beans` on x.zarr: `info`, `stat`, `list-zarr`, `qc
   --feature-min-cells 10 --report` on the card and with `--device cpu`
   (keep masks equal, totals within 1e-6), `histogram`, `subsample
   --cells 2500 --seed 7`, `subset` (5,000 cells, 500 genes),
   `take-columns` / `take-rows` (100 names each), and on the subsample
   `sort-rows`, `reorder`, `squeeze`, `convert` to `.zarr.zip` and back
   (byte-equal to it), `merge-backend` of its two halves (equal to the
   whole) and `align` of two stores on overlapping gene sets, each held
   against scipy on phase 2's matrix, with each command's seconds (each
   command in a process of its own, eight at a time, each after the
   commands whose outputs it reads; phase 31 runs meanwhile);
30. ingestion: `to-mtx` of phase 29's 2,500 cells, `from-mtx` and
   `from-mtx --streaming` (byte-equal to the source; the native parser
   required), `merge-mtx`, `from-triplets` (2,000 cells' transcripts),
   `from-zarr` (a Xenium-layout zarr v2 zlib store of the 2,500 cells),
   `from-fragments` (1M fragments over 2,000 cells, to tiles, against a
   direct count), `data-beans-sim multimodal`, `multiome`, `faba`,
   `bulk` (phase 2's top topic as labels) and `topic --reference` (phase
   29's 5,000 x 500 subset); the h5py commands skipped where h5py does
   not import, and said so;
31. `cocoa diff --gff` on phase 15's cells with a GFF of `truth.tsv`'s
   positions and phase 15's match cache: gene order and CNV states equal
   to the `--cnv-ground-truth` run's, cn_score bit for bit, K1 launched
   as often; `senna
   plot-strand` where matplotlib imports, else skipped and said;
32. faba's BAM path: a coordinate-sorted 10x-style BAM (2,000 cells x
   2,000 genes, ~2.5M reads, CB / UB / GX tags, ~20% of the UMIs spliced
   through CIGAR `N`, PCR duplicates) written by the port's `write_bam`
   with its GFF, `faba index` (a rebuild gives the same bytes), `faba
   genes`, `faba genes --splice` and `faba genes --gene-qc`: every store
   equal to the planted counts after UMI dedup, exactly; reads/s and each
   command's seconds; a BAM rewritten after its index gets a fresh one
   (fault fix 1);
33. `faba gem`: (a) `--raw` at the CLI defaults on phase 2's cells with a
   seeded binomial thinning of them as the unspliced store (K1 launched
   ceil(100,000 / 2,048) = 49 times and held at gem's 2,048-cell block;
   outputs finite, the loss falling; read, projection, pseudobulk, fit
   and write seconds); (b) `--posterior 4`, (c) `--lineage-dag` and (d)
   `gem-encoder` at its defaults on (a)'s pseudobulk stores; (e) `--raw`
   on phase 32's spliced / unspliced stores;
34. `faba dyn-assoc` on a `data-beans-sim faba` sites store (1,000 sites
   x 20,000 cells) with `--from` 33c's pseudotime lifted to (a)'s cells,
   with `--trend-method bayes` and with the GAM (`quasi`): finite, p in
   [0, 1];
35. `pinto lc` through the port's CLI entry at its defaults (K = 10,
   knn 10, 30 Gibbs, 10 greedy, 10 EM sweeps) on 100,000 planted-domain
   spatial cells (`simulate_spatial`: a 3 mm section at (4, 6) mm in µm,
   377 genes, 10 domains, 100-250 transcripts a cell, a planted ligand ->
   receptor pair; made in a process of its own started before phase 32):
   the stage seconds, edges, profile nonzeros and the plane's device
   bytes; K3 launched twice and K2 once a sweep, exactly; the cells' ARI
   against the planted domains; K3 (community sums, sizes) and K2 (the
   scores) held against their plain versions at the sweep's shapes; two
   card runs on a 20,000-cell crop bit-equal (labels, trace); on a
   4,000-cell crop the card against the CPU (edges equal, edge labels'
   ARI at least 0.95);
36. on the 20,000-cell crop through the CLI entry: `cascade`, `lc
   --gene-network` (a chain network inside each domain's markers),
   `prop` (K1), `dsvd`, `cage` (K1, 500 K4 launches), `lc-etm` (3 epochs;
   the gathers' backward through K3), `lra` (the planted pair's p at
   most 0.05, its null's floor, a control pair's above), `annotate` (a GMT of the planted markers), and `interfaces` and
   `p` where matplotlib imports (else skipped and said); K1 and K4 held
   at cage's projection block and fne plane;
37. `fagioli` through the port's CLI entry on a fine-mapping locus (`sim-sumstat
   --n 503 --p 2000`, the size of 1000 Genomes' EUR panel, 3 causal
   variants against L = 5): `map-sumstat` (plain and `--multilevel`),
   `fit-sumstat-sgvb` (the prior-variance grid, and `--prior-type ash`),
   `fit-prs-susie` and `fit-sumstat-mcmc`, each command's seconds and the
   milliseconds of one SGVB step; each causal variant (or one within 2
   positions) in the top-5 PIPs of the SuSiE fits; a small locus (200 x
   150) on the card against the CPU (PIPs within 1e-3) and twice
   bit-equal; on a cohort (`sim-qtl`, 200
   individuals x 500 cells, 2,000 genes, 5 cell types) `pseudobulk` on
   every gene (K3, one launch) with K3 held and timed at that plane, and
   `fit-qtl-sgvb --annot` on a store of one of its eGenes (K3, one
   launch per cell type);
38. `chickpea p2g --pseudobulk --knockoff-fdr 0.2 --rank 200` (the LD rank
   capped at the pseudobulks less one) through the CLI entry on
   `data-beans-sim multiome` cells (20,000 paired cells, 2,000 peaks,
   30 genes):
   K1 and K3 launched, held at the run's own first calls; the driving
   peaks rank high by PIP (the median percentile above 0.7);
39. `faba all --depth-resolution-kb 1` through the port's CLI entry on a
   planted wild-type / control pair (`simulate_edit_pair`: 2,000 cells
   an arm at ~300 UMIs, 500 genes on both strands, ~1.2M reads of 91
   bases an arm with CB / UB / MD tags, 200 A-to-G and 200 RAC C-to-T
   sites edited in the wild type only, 200 heterozygous SNPs in both
   arms, two poly(A) sites a gene), written and run in a process of its
   own started before phase 17: each arm's gene store equal to its
   planted counts after UMI dedup and its depth tiles to each cell's
   molecules starting there, exactly; the planted SNPs called and none
   among the editing calls; the edits' recall and precision and the
   poly(A) sites' recall at the bars of FABA_*; the process's seconds,
   its wait, each stage's seconds and reads a second; then, in the same
   process, on the called C-to-T sites (their strand from the GFF's
   gene): `faba pwm` from the reference and from each arm's reads,
   `metagene --ncrna`, `pileup` of each arm and `inspect` (plus-strand
   sites) and `docs`: the reference PWM shows the planted RAC, the
   reads' PWM and the pileup the edit in the wild type and not in the
   control, `inspect` the RAC under the matching reads, metagene places
   every site (FABA_MOTIF_FREQ, FABA_EDIT_SHOWS, FABA_EDIT_ABSENT);
40. `faba annotate` and `faba lineage` in processes of their own, the
   first started after phase 4, the second before phase 17: `faba
   lineage` through the port's CLI at its
   defaults (200 centroids, 200 bootstrap draws and 500 permutations an
   edge, PHATE on 2,000 landmarks) but `--latent-geometry euclidean` (the
   planted coordinates are Euclidean; cosine puts a 2-D Y on the unit
   circle) on a planted Y of LINEAGE_CELLS (100,000) cells written as
   `--latent` / `--velocity` parquets (`tests/test_lineage_forest.py`'s
   generator, scaled), held to that test's bars (one tree, at least two
   lineages, pseudotime correlated with the planted axis above 0.95) and
   a forest's; on LINEAGE_CPU_CELLS (2,000) of the cells the card
   against `--device cpu`: labels, edges, calls and trees equal, every
   number within LINEAGE_PT_ATOL; `faba annotate` at its defaults
   (projection, both tracks) on a planted gem prefix
   (`tests/test_faba_annotate.py`'s generator at ANNOTATE_CELLS, 10,000
   cells): per-cell accuracy above 0.95 and the nascent program on the
   velocity track; `faba plot` of the Y's lineage where matplotlib
   imports (the card's machine has none: a line says it was skipped);
41. after phase 34, in a process of its own beside phases 35-39: `faba
   lineage --from` phase 33's `gem_raw` fit (100,000 cells summed into
   the pseudobulks of `--raw`, H = 16) with `--markers` the simulated
   factors' panel (its bootstrap cut to LINEAGE_MARKER_BOOT draws):
   tables finite, every pseudobulk in one tree, the parents a forest;
   `faba annotate --mode enrichment` on phase 2's `senna topic` run with
   the same panel (a factor called); then `faba dyn-assoc --from` the
   lineage run, lifted to the cells of phase 34's sites store (finite
   statistics, p in [0, 1], every site given a branch); none of
   the four kernels is on the paths of phases 39d-41, and each of their
   launch counts must be 0;
42. the model-stack parts no command reaches, on the card against the
   CPU from the same inputs and parameters: the eight likelihoods of
   `models/losses.py` at 4,096 x 2,000, `IafSoftmaxEncoder` (eval mode)
   and `BipartiteDecoder` (each likelihood) forward and backward, and
   `fit_archetypes` at 10,000 x 50 with k = 8 (ARCHETYPE_ITERS steps);
43. print the script's total seconds, one JSON line of all kernels, then
   the device line last.

Phase 10 and phase 14's `--from` run before phase 8 (they need none of
its held-out cells). The simulations of phases 8, 13a, 15 and 19 run in a
pool of four processes started after phase 4, phase 28 in a process
started before phase 21, phase 32's BAM, index and counts and phase 39's
pair and `faba all` in processes started before phase 17, phase 35's
cells in a process started before phase 32, phases 37-38's loci,
cohort and multiome cells in processes started before phase 35, and
phase 40's annotate and lineage runs after phase 4 and before phase 17
and phase 41's after phase 34, so the host makes them while the card
runs the phases before them; each takes
the same function, arguments and seed it would call itself. Each phase
prints `{"mark": name, "at_s": seconds}` as it starts.

Every kernel check launches the kernel twice on the same inputs and
fails unless the two results are bit-equal (`deterministic`). Times are
the guide's method: CUDA events around REPS back-to-back calls, divided
by REPS, after warm-up; kernel, plain version and library call are timed
in turns (ROUNDS rounds of each, in that order) and each reports the
median of its rounds.

TF32 is off for matmuls and cuDNN: every float32 product runs in full
float32, as the reference package computes it.
"""

from __future__ import annotations

import copy
import importlib.util
import json
import subprocess
import sys
import tempfile
import time
import warnings
from pathlib import Path

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
FP32_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores
TF32_FLOPS = 495e12  # H100 SXM TF32 on the tensor cores, dense
WARMUP, REPS, ROUNDS = 3, 20, 3

# tolerances: normwise max|kernel - plain| / max|plain| for the
# projections (sums with cancellation), elementwise for the collapse
# (sums of non-negative values)
RTOL_K1, RTOL_K2 = 2e-4, 1e-4
ATOL_K3 = RTOL_K3 = 1e-5
F64_FACTOR_K3 = 2.0  # K3's float64 arm (check_collapse), as K4's below
# K4 (tests/test_nce_pallas.py): the loss sum within a relative 2e-5 and
# each gradient normwise, max|kernel - plain| <= 1e-4 * max|plain|. Where
# the plain float32 gradient itself lies farther than that from the same
# function in float64 (a trained gradient whose terms cancel), the
# kernel's gradient is held to float64 instead: no farther from it than
# F64_FACTOR_K4 times the plain float32 gradient is.
RTOL_K4_LOSS, RTOL_K4_GRAD = 2e-5, 1e-4
F64_FACTOR_K4 = 2.0
# bf16 against f32 final loss at the anchor (tests/test_nce_pallas.py)
RTOL_BF16_LOSS = 1e-2
# phases 13b and 13c: the posterior chains' depth (`--posterior N` burns
# in N // 4 sweeps first); each reports its seconds a sweep
POSTERIOR_SWEEPS, POSTERIOR_BURNIN = 4, 1  # cut so that the script ends near 1,000 s
# phase 5's cells: bge's host Leiden (a resolution search over a kNN graph
# of the cells) took 86-180 s at 100,000 beside the simulations and 23-26 s
# at 50,000, and the script's host is its bottleneck
BGE_CELLS = 25_000
# depth cuts that keep the script inside its limit on the slower hosts, where
# every phase takes 1.5-2x its time on the faster ones: clustering's Leiden
# on 10,000 of predict's cells (20,000), cocoa's card-against-CPU check on
# 25 cells of each individual (100, then 50), every cocoa diff with one
# reference pass of its CNV HMM (the CLI's 2: the HMM's loop over the 2,000
# genes took 17-21 s of each diff and most of the check's 37 s), and
# `data-beans`' subsample, `to-mtx` and the ingestion on 2,500 cells (5,000)
LEIDEN_CELLS, COCOA_CPU_PER_INDV, BEANS_CELLS = 10_000, 25, 2_500
COCOA_REF_ITERS = 1
# the layouts' card-against-CPU check on 1,500 cells (3,000): its CPU tsne and
# phate refinement grow faster than the square of the cells (37 s and 49 s
# at 3,000 on a CPU host, 2.4 s and 6.0 s at 1,500), and the phase took 161 s
LAYOUT_CPU_CELLS = 1_500

# Run in a fresh process: splits `MixedTrainer`'s construction at the e2e
# shapes into CUDA start-up, moving the modules to the card, the
# `torch._dynamo` import that `torch.optim`'s first optimizer triggers,
# and the AdamW constructor itself (first and second call).
SETUP_PROBE = r"""
import json, sys, time
t = time.time(); import torch; s = {"import_torch_s": time.time() - t}
t = time.time(); torch.zeros(1, device="cuda"); torch.cuda.synchronize()
s["cuda_init_s"] = time.time() - t
from legume_tpu_torch.models.decoders import NbTopicDecoder
from legume_tpu_torch.models.encoders import LogSoftmaxEncoder
g = torch.Generator().manual_seed(0)
enc = LogSoftmaxEncoder(2000, 10, (128, 1024, 128), generator=g)
decs = torch.nn.ModuleList(NbTopicDecoder(2000, 10, generator=g) for _ in range(3))
t = time.time(); enc.to("cuda"); decs.to("cuda"); torch.cuda.synchronize()
s["modules_to_card_s"] = time.time() - t
params = list(enc.parameters()) + list(decs.parameters())
t = time.time(); import torch._dynamo; s["import_dynamo_s"] = time.time() - t
s["triton_imported"] = "triton" in sys.modules
for i in (1, 2):
    t = time.time(); torch.optim.AdamW(params, lr=0.01, weight_decay=0.01)
    s[f"adamw_{i}_s"] = time.time() - t
print(json.dumps({"phase": "train_setup_split", **s}))
"""

# Phase 28 in a process of its own, started before phase 21 so that its
# host-bound simulation overlaps the card's phases 21-27: `data-beans-sim`
# through the port's CLI entry (`run_sim`), its write timed apart.
SIM_CLI = r"""
import json, sys, time
from legume_tpu_torch.cli.main import run_sim
from legume_tpu_torch.data import sim as S
from legume_tpu_torch.ops import kernels as K
w, write_topic_sim = {}, S.write_topic_sim
def timed(sim, output):
    t = time.time(); path = write_topic_sim(sim, output); w["s"] = time.time() - t
    return path
S.write_topic_sim = timed
t = time.time(); run_sim(sys.argv[1:]); run_s = time.time() - t
print(json.dumps({"run_s": run_s, "write_s": w["s"], "launches": dict(K.launch_counts)}))
"""
# A port CLI command in a process of its own (`_cli_chains`), as `python -m
# legume_tpu_torch` runs it, then the launch counts of the kernels it ran
# as the last line of its standard output.
CLI_COUNTED = r"""
import json, sys
from legume_tpu_torch.cli.main import main
from legume_tpu_torch.ops import kernels as K
rc = main(sys.argv[1:])
print(json.dumps(dict(K.launch_counts)))
sys.exit(rc)
"""
# Phase 32's host half in a process of its own, started before phase 17 so
# that it overlaps the card's phases 17-31: the simulated 10x BAM written
# with the port's `write_bam` (`faba/bam_sim.py`), its planted counts
# saved, then `faba index` (twice: the rebuild must give the same bytes),
# `faba genes`, `faba genes --splice` and `faba genes --gene-qc` through
# the port's CLI, each timed; the launch counts last (`faba genes` runs on
# the host, as in the JAX package).
BAM_CLI = r"""
import json, sys, time
import scipy.sparse as sp
from legume_tpu_torch.cli.main import run_faba
from legume_tpu_torch.faba.bam_sim import simulate_10x_bam
from legume_tpu_torch.ops import kernels as K
work, cells, genes, umis = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4])
out = {}
t = time.time()
sim = simulate_10x_bam(f"{work}/run.bam", f"{work}/run.gff", n_cells=cells, n_genes=genes,
                       umis_per_cell=umis, n_mito=13, seed=13)
out["write_s"] = time.time() - t
sp.save_npz(f"{work}/planted_spliced.npz", sim["spliced"])
sp.save_npz(f"{work}/planted_unspliced.npz", sim["unspliced"])
json.dump({"genes": sim["genes"], "barcodes": sim["barcodes"]}, open(f"{work}/planted.json", "w"))
out.update(n_reads=sim["n_reads"], n_umis=sim["n_umis"])
t = time.time(); run_faba(["index", f"{work}/run.bam"]); out["index_s"] = time.time() - t
first = open(f"{work}/run.bam.bai", "rb").read()
t = time.time(); run_faba(["index", "--force", f"{work}/run.bam"]); out["reindex_s"] = time.time() - t
out["reindex_equal"] = open(f"{work}/run.bam.bai", "rb").read() == first
for name, extra in (("genes", []), ("genes_splice", ["--splice"]), ("genes_qc", ["--gene-qc"])):
    t = time.time()
    run_faba(["genes", "--bam", f"{work}/run.bam", "--gff", f"{work}/run.gff", "--output",
              f"{work}/{name}"] + extra)
    out[f"{name}_s"] = time.time() - t
out["launches"] = dict(K.launch_counts)
print(json.dumps(out))
"""
CHILDREN: list = []  # processes the script starts; main() stops any still running


def device_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn) -> float:
    """Milliseconds per call: CUDA events around REPS back-to-back calls,
    divided by REPS, after WARMUP calls."""
    for _ in range(WARMUP):
        fn()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    a.record()
    for _ in range(REPS):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / REPS


def time_turns(**fns) -> dict:
    """`time_ms` of each function in turns, ROUNDS rounds; the median of
    each one's rounds (None for a missing function)."""
    rounds = {name: [] for name, fn in fns.items() if fn is not None}
    for _ in range(ROUNDS):
        for name in rounds:
            rounds[name].append(time_ms(fns[name]))
    return {name: (float(np.median(rounds[name])) if name in rounds else None) for name in fns}


def bit_equal(a, b) -> bool:
    if isinstance(a, tuple):
        return all(torch.equal(x, y) for x, y in zip(a, b))
    return torch.equal(a, b)


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_projection(K, basis, rows, ptr, vals, *, normed: bool, shape: str) -> dict:
    nnz, ncols, (d, k) = rows.shape[0], ptr.shape[0] - 1, basis.shape
    got = K.project(basis, rows, ptr, vals, normed=normed)
    again = K.project(basis, rows, ptr, vals, normed=normed)
    want = K.project_plain(basis, rows, ptr, vals, normed=normed)
    torch.cuda.synchronize()
    deterministic = bit_equal(got, again)
    if not deterministic:
        raise AssertionError(f"project(normed={normed}) at {shape}: two launches differ")
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    rtol = RTOL_K1 if normed else RTOL_K2
    if not (torch.isfinite(got).all() and err <= rtol * scale):
        raise AssertionError(f"project(normed={normed}) at {shape}: err {err} vs scale {scale}")
    library = None
    if not normed:  # the same function as one CSR x dense product
        csr = torch.sparse_csr_tensor(
            ptr.long(), rows.long(), vals, size=(ncols, d), check_invariants=True
        )
        lib = torch.sparse.mm(csr, basis)
        if float((lib - want).abs().max()) > rtol * scale:
            raise AssertionError("torch.sparse.mm disagrees with the plain projection")
        library = lambda: torch.sparse.mm(csr, basis)  # noqa: E731
    times = time_turns(
        ms=lambda: K.project(basis, rows, ptr, vals, normed=normed),
        plain_ms=lambda: K.project_plain(basis, rows, ptr, vals, normed=normed),
        library_ms=library,
    )
    nbytes = nnz * 8 + (ncols + 1) * 4 + d * k * 4 + ncols * k * 4
    flops = nnz * k * 2 + (nnz * 3 if normed else 0)
    bound_ms, bound_by = bound(nbytes, flops)
    return {
        "shape": shape, "nnz": nnz, "ncols": ncols, "genes": d, "k": k,
        "max_abs_err": err, "max_abs_plain": scale, "rtol": rtol,
        "deterministic": deterministic, **times, "bound_ms": bound_ms, "bound_by": bound_by,
    }


def check_collapse(K, rows, ptr, vals, seg, *, num_genes: int, num_groups: int, shape: str) -> dict:
    nnz, ncols = rows.shape[0], ptr.shape[0] - 1
    kw = dict(num_genes=num_genes, num_groups=num_groups)
    got = K.collapse(rows, ptr, vals, seg, **kw)
    want = K.collapse_plain(rows, ptr, vals, seg, **kw)
    # counts are whole numbers, whose float sums come out the same in any
    # order; the same entries scaled off the integers make the bit-equal
    # check see the order of the sums
    frac = vals * torch.linspace(0.3, 1.7, vals.shape[0], device=vals.device)
    deterministic = bit_equal(K.collapse(rows, ptr, frac, seg, **kw),
                              K.collapse(rows, ptr, frac, seg, **kw))
    torch.cuda.synchronize()
    if not deterministic:
        raise AssertionError(f"collapse at {shape}: two launches differ")
    err = float((got - want).abs().max())
    # the library yardstick: index_add_ on precomputed flat (gene, group) keys
    cols = torch.repeat_interleave(torch.arange(ncols, device=rows.device), (ptr[1:] - ptr[:-1]).long())
    sg = seg.long()[cols]
    keep = sg < num_groups
    keys = rows.long()[keep] * num_groups + sg[keep]
    kv = vals[keep]
    flat = torch.zeros(num_genes * num_groups, device=rows.device)
    lib = flat.clone().index_add_(0, keys, kv).view(num_genes, num_groups)
    # the float64 arm: where a float32 sum runs over millions of terms
    # (pinto's sweep plane), the plain version's own rounding passes the
    # bar; the kernel (and the library call) is then held to the same sum
    # in float64, no farther from it than F64_FACTOR_K3 times the plain
    # version is
    exact = torch.zeros(num_genes * num_groups, dtype=torch.float64, device=rows.device)
    exact = exact.index_add_(0, keys, kv.double()).view(num_genes, num_groups)
    err_f64, plain_f64 = (float((x.double() - exact).abs().max()) for x in (got, want))
    lib_f64 = float((lib.double() - exact).abs().max())

    def held(x, x_f64):
        if bool(((x - want).abs() <= ATOL_K3 + RTOL_K3 * want.abs()).all()):
            return "plain"
        return "float64" if x_f64 <= F64_FACTOR_K3 * plain_f64 else "failed"

    arm = held(got, err_f64)
    if arm == "failed":
        raise AssertionError(f"collapse at {shape}: max err {err}, from float64 {err_f64} "
                             f"(plain {plain_f64})")
    if held(lib, lib_f64) == "failed":
        raise AssertionError("index_add_ disagrees with the plain collapse")
    nbytes = nnz * 8 + (ncols + 1) * 4 + ncols * 4 + num_genes * num_groups * 4
    bound_ms, bound_by = bound(nbytes, nnz)
    return {
        "shape": shape, "nnz": nnz, "ncols": ncols, "genes": num_genes, "groups": num_groups,
        "max_abs_err": err, "atol": ATOL_K3, "rtol": RTOL_K3, "deterministic": deterministic,
        "bar_arm": arm, "err_f64": err_f64, "plain_err_f64": plain_f64, "library_err_f64": lib_f64,
        "plan": K.collapse_plan(ncols, num_genes, num_groups).__dict__,
        **time_turns(
            ms=lambda: K.collapse(rows, ptr, vals, seg, **kw),
            plain_ms=lambda: K.collapse_plain(rows, ptr, vals, seg, **kw),
            library_ms=lambda: flat.zero_().index_add_(0, keys, kv),
        ),
        "bound_ms": bound_ms, "bound_by": bound_by,
    }


def check_nce(K, c, q, e_f, b_f, e_a, b_a, m, *, shape: str, need_feat: bool = True) -> dict:
    """K4 against its plain version on one plane, in its full form or
    (`need_feat=False`) its axis form; `max_abs_err` is the largest over
    the gradients, the loss is held by its relative error. Each gradient
    is also measured against the plain version in float64 (`*_f64`)."""
    (p, d), h = c.shape, e_f.shape[1]
    kw = dict(need_feat=need_feat)
    got = K.nce_epoch(c, q, e_f, b_f, e_a, b_a, m, 5.0, **kw)
    again = K.nce_epoch(c, q, e_f, b_f, e_a, b_a, m, 5.0, **kw)
    want = K.nce_epoch_plain(c, q, e_f, b_f, e_a, b_a, m, 5.0, **kw)
    # the same function in float64 from the same inputs: how far each
    # float32 loss sum lies from it, in units of the float32 spacing there
    want64 = K.nce_epoch_plain(*(t.double() for t in (c, q, e_f, b_f, e_a, b_a, m)), 5.0, **kw)
    exact = float(want64[0])
    torch.cuda.synchronize()
    got_t = tuple(x for x in got if x is not None)
    deterministic = bit_equal(got_t, tuple(x for x in again if x is not None))
    if not deterministic:
        raise AssertionError(f"nce_epoch at {shape}: two launches differ")
    if not need_feat and (got[1] is not None or got[2] is not None):
        raise AssertionError(f"nce_epoch at {shape}: the axis form returned feature gradients")
    loss_k, loss_p = float(got[0]), float(want[0])
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    ulp = float(np.spacing(np.float32(abs(exact))))
    trios = [(g, w, x) for g, w, x in zip(got[1:], want[1:], want64[1:]) if w is not None]
    errs = [float((g - w).abs().max()) for g, w, _ in trios]
    scales = [float(w.abs().max()) for _, w, _ in trios]
    errs_f64 = [float((g.double() - x).abs().max()) for g, _, x in trios]
    plain_f64 = [float((w.double() - x).abs().max()) for _, w, x in trios]
    arms = ["plain" if e <= RTOL_K4_GRAD * sc else
            "float64" if pf > RTOL_K4_GRAD * sc and ef <= F64_FACTOR_K4 * pf else "failed"
            for e, sc, ef, pf in zip(errs, scales, errs_f64, plain_f64)]
    ok = all(bool(torch.isfinite(g).all()) for g in got_t)
    if not (ok and loss_rel <= RTOL_K4_LOSS and "failed" not in arms):
        raise AssertionError(f"nce_epoch at {shape}: loss rel {loss_rel}, grads {errs} vs "
                             f"{scales}; from float64 {errs_f64}, plain {plain_f64}")
    # each input read once, each output written once. The operations run
    # on two kinds of unit at once: the score product (2PDH) and ~20
    # operations an element on the CUDA cores in float32; the backward
    # products (g_ea, and g_ef in the full form, 2PDH each) on the tensor
    # cores in split TF32, three passes each. The bound takes the slower.
    feat_out = 4 * (d * h + d) if need_feat else 0
    nbytes = p * d * c.element_size() + 4 * (d * h + 2 * d + p * h + 2 * p) + 4 * (p * h + p + 1) + feat_out
    core_flops = 2 * p * d * h + 20 * p * d
    tensor_flops = 3 * (2 if need_feat else 1) * 2 * p * d * h
    bound_bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    bound_core_ms = core_flops / FP32_FLOPS * 1e3
    bound_tensor_ms = tensor_flops / TF32_FLOPS * 1e3
    bound_ms = max(bound_bytes_ms, bound_core_ms, bound_tensor_ms)
    bound_by = "bytes" if bound_ms == bound_bytes_ms else "operations"
    return {
        "shape": shape, "form": "full" if need_feat else "axis", "rows": p, "genes": d, "h": h,
        "count_dtype": str(c.dtype), "plan": {k: v for k, v in K.nce_plan(p, d, h).__dict__.items()
                                              if k in ("band_chunks", "range_tiles")},
        "max_abs_err": max(errs), "max_abs_plain": max(scales), "loss_rel_err": loss_rel,
        "grad_errs": errs, "grad_scales": scales, "grad_errs_f64": errs_f64,
        "plain_grad_errs_f64": plain_f64, "grad_bar_arms": arms,
        "loss_sum": loss_k, "loss_sum_plain": loss_p, "loss_sum_f64": exact, "f32_ulp": ulp,
        "loss_ulps_from_f64": (loss_k - exact) / ulp, "plain_ulps_from_f64": (loss_p - exact) / ulp,
        "rtol_loss": RTOL_K4_LOSS, "rtol_grad": RTOL_K4_GRAD, "deterministic": deterministic,
        # no single torch call computes the loss and the gradients
        **time_turns(
            ms=lambda: K.nce_epoch(c, q, e_f, b_f, e_a, b_a, m, 5.0, **kw),
            plain_ms=lambda: K.nce_epoch_plain(c, q, e_f, b_f, e_a, b_a, m, 5.0, **kw),
            library_ms=None,
        ),
        "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes,
        "core_flops": core_flops, "tensor_flops": tensor_flops, "bound_bytes_ms": bound_bytes_ms,
        "bound_ops_ms": max(bound_core_ms, bound_tensor_ms),
        "bound_core_ms": bound_core_ms, "bound_tensor_ms": bound_tensor_ms,
    }


def anchor_counts() -> np.ndarray:
    """The NCE anchor plane of `bench.py`: 2,627 x 34,008, ~3% occupied,
    Poisson(2) + 1 at random positions (numpy seed 11)."""
    rng = np.random.default_rng(11)
    counts = np.zeros(2_627 * 34_008, np.float32)
    nnz = int(0.03 * counts.size)
    counts[rng.integers(0, counts.size, nnz)] = rng.poisson(2.0, nnz) + 1.0
    return counts.reshape(2_627, 34_008)


def production_block(dev):
    """Synthetic block at the largest production shape: 8,192 cells with
    ~1,025 nonzeros each over 34,008 genes (~8.4M nonzeros)."""
    g = torch.Generator(device=dev).manual_seed(20240607)
    ncols, d = 8192, 34008
    counts = torch.randint(900, 1151, (ncols,), generator=g, device=dev)
    cells = torch.repeat_interleave(torch.arange(ncols, device=dev), counts)
    genes = torch.randint(0, d, (cells.shape[0],), generator=g, device=dev)
    # CSC order: genes sorted and distinct within each cell
    keys = torch.unique(cells * d + genes)
    rows = (keys % d).to(torch.int32)
    ptr = torch.zeros(ncols + 1, dtype=torch.int32, device=dev)
    ptr[1:] = torch.cumsum(torch.bincount(keys // d, minlength=ncols), 0)
    nnz = rows.shape[0]
    vals = torch.floor(-torch.log(torch.rand(nnz, generator=g, device=dev)) * 3.0) + 1.0
    basis = torch.randn(d, 64, generator=g, device=dev)
    seg = torch.randint(0, 607, (ncols,), generator=g, device=dev, dtype=torch.int32)
    return d, basis, rows, ptr, vals, seg


def same_partition(a, b) -> bool:
    """Equal as set partitions: the pairs of labels form a bijection."""
    pairs = np.unique(np.stack([np.asarray(a), np.asarray(b)], 1), axis=0)
    return len(pairs) == len(np.unique(a)) == len(np.unique(b))


def held_out_parts(sim_rows, seed: int):
    """100,000 cells of another simulation over 2,100 genes: the first
    2,000 take the training names (5% renamed `ENSG..._<NAME>`), 100 are
    not in the model, and the gene order is permuted. Returns (counts,
    gene names, cell names, batches)."""
    from legume_tpu_torch.data.sim import simulate_topic

    held = simulate_topic(rows=2100, cols=100_000, factors=8, batches=2, seed=seed)
    rng = np.random.default_rng(seed)
    names = list(sim_rows) + [f"NEW{i}" for i in range(100)]
    for i in rng.choice(2000, 100, replace=False):
        names[i] = f"ENSG{i:011d}_{names[i].upper()}"
    perm = rng.permutation(2100)
    return (held.counts.tocsr()[perm].tocsc(), [names[i] for i in perm], held.col_names,
            held.batch)


def held_out_vec(sim_rows, seed: int):
    from legume_tpu_torch.data import MemoryBackend, SparseIoVec

    counts, rows, cols, batch = prefetched("held_out", held_out_parts, sim_rows, seed)
    vec = SparseIoVec()
    vec.push(MemoryBackend(counts, rows, cols))
    return vec, batch


def collider_cohort():
    """Phase 15's cohort: `simulate_collider` at 40 individuals x 2,500
    cells, 2,000 genes, 3 types, with a 2.2x amplified block of 100
    genes in 6 of the 40 individuals. Returns (sim, counts CSC)."""
    import scipy.sparse as sp

    from legume_tpu_torch.cocoa.sim import simulate_collider

    sim = simulate_collider(n_genes=2000, n_types=3, n_indv=40, cells_per_indv=2500, seed=15)
    y = sim.counts.toarray()
    carriers = np.isin(sim.cell_indv, np.arange(6))
    blk = y[600:700][:, carriers]
    y[600:700, carriers] = blk + np.random.default_rng(15).poisson(1.2 * blk)
    return sim, sp.csc_matrix(y)


# ---- the simulations of later phases, made on the host beside phases 5-14 --
# Each is the function a phase would call, run with the same arguments in
# a process of its own (four at a time, two BLAS threads each) from the end
# of phase 4 on; a phase takes its result with `prefetched`, or makes it
# itself where nothing was started. Such a phase reports `simulate_wait_s`,
# the time it waited. The card's phases 5-14 run beside these processes, so
# their host-side seconds are taken under that contention; the overlap is
# kept because without it the script took 1,166 s (H100 80GB HBM3, 700 W),
# near its 1,200 s limit.

PREFETCH: dict = {}  # name -> Future
POOL: list = []


def start_prefetch(sim_rows):
    import concurrent.futures as cf
    import multiprocessing as mp
    import os

    from legume_tpu_torch.data.sim import simulate_multiome, simulate_topic

    saved = {k: os.environ.get(k) for k in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS",
                                            "MKL_NUM_THREADS")}
    os.environ.update({k: "2" for k in saved})
    try:
        pool = cf.ProcessPoolExecutor(max_workers=4, mp_context=mp.get_context("spawn"))
        POOL.append(pool)
        PREFETCH["held_out"] = pool.submit(held_out_parts, list(sim_rows), 43)
        PREFETCH["collider"] = pool.submit(collider_cohort)
        PREFETCH["multiome"] = pool.submit(simulate_multiome, genes=2000, peaks=4000,
                                           cols=50_000, seed=13)
        PREFETCH["delta"] = pool.submit(simulate_topic, rows=2000, cols=50_000, factors=8,
                                         batches=1, seed=19)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def prefetched(name: str, fn, *args, **kwargs):
    """`fn(*args, **kwargs)`, from the prefetch pool where it was started."""
    fut = PREFETCH.pop(name, None)
    return fut.result() if fut is not None else fn(*args, **kwargs)


def stop_children():
    for pool in POOL:  # a simulation already started runs to its end
        pool.shutdown(wait=True, cancel_futures=True)
    for proc in CHILDREN:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def layout_phase(work: str, zp: np.ndarray, topic_out: str, K, dev, card: str) -> dict:
    """Phase 11: `senna layout` (umap, tumap, tsne, phate, tree), `senna
    pseudotime` (both modes), `senna plot` and `senna plot-topic` through
    the port's CLI on the card, the card against the port's CPU run on
    LAYOUT_CPU_CELLS of the cells, and umap's neighbour preservation.
    Returns the launches of the four kernels per command (none is on these
    paths)."""
    from legume_tpu_torch.cli.main import main as cli
    from legume_tpu_torch.ops import layouts as LY
    from legume_tpu_torch.ops import principal_graph as PG
    from legume_tpu_torch.ops import rounding
    from legume_tpu_torch.ops import umap as U
    from legume_tpu_torch.ops.knn import knn_search, knn_within
    from legume_tpu_torch.utils.manifest import RunManifest
    from legume_tpu_torch.utils.output import read_table, table_path, write_table

    pred = f"{work}/predict"
    latent = table_path(f"{pred}.latent")
    cols = read_table(latent)
    names = list(cols)
    zl = np.exp(zp.astype(np.float32))  # the linear simplex the handlers lay out
    has_mpl = importlib.util.find_spec("matplotlib") is not None
    print(json.dumps({"phase": "layout_setup", "matplotlib_importable": has_mpl}), flush=True)

    def subset(stem, n):
        return write_table(f"{work}/{stem}", {k: v[:n] for k, v in cols.items()})

    lat10k, lat2k, lat1k = subset("lat10k", 10_000), subset("lat2k", 2_000), subset("lat1k", 1_000)
    # velocity: toward each cell's kNN neighbours of higher topic-0 share
    _, nbr = knn_within(zl, 15, device=dev)
    up = (zl[nbr, 0] > zl[:, None, 0])[..., None]
    vel = ((zl[nbr] - zl[:, None, :]) * up).sum(1) / np.maximum(up.sum(1), 1)
    vel_path = write_table(f"{work}/velocity", {"cell": cols[names[0]],
                                                **{f"v{j}": vel[:, j] for j in range(vel.shape[1])}})

    runs = {}
    launches = {}

    def run(name, *argv, out=None):
        K.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        on_card = not argv[0].startswith("plot")  # plot and plot-topic run on the host
        cli(["senna", *argv, *(["--device", "cuda"] if on_card else [])])
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches[name] = sum(K.launch_counts.values())
        timings = RunManifest.load(f"{out}.senna.json").timings if out else {}
        runs[name] = {"wall_s": wall, **timings,
                      "peak_device_bytes": torch.cuda.max_memory_allocated()}
        print(json.dumps({"phase": "layout_command", "command": name, **runs[name],
                          "kernel_launches": launches[name], "card": card}), flush=True)

    run("clustering_kmeans_from", "clustering", "--from", pred, "--out", f"{work}/km2",
        "--method", "kmeans", "--n-clusters", "10", out=f"{work}/km2")
    run("layout_tumap_pcs5", "layout", "--latent", latent, "--out", f"{work}/tumap",
        "--method", "tumap", "--pcs", "5", out=f"{work}/tumap")
    run("layout_umap", "layout", "--from", pred, "--out", f"{work}/umap", out=f"{work}/umap")
    run("layout_tsne_10k", "layout", "--latent", lat10k, "--out", f"{work}/tsne",
        "--method", "tsne", out=f"{work}/tsne")
    run("layout_phate_2k", "layout", "--latent", lat2k, "--out", f"{work}/phate",
        "--method", "phate", out=f"{work}/phate")
    run("pseudotime", "pseudotime", "--latent", latent, "--out", f"{work}/pt", "--root-cell", "0",
        out=f"{work}/pt")
    run("layout_tree", "layout", "--method", "tree", "--from", f"{work}/pt", "--out",
        f"{work}/tree")
    runs["layout_tree"].update({k: v for k, v in RunManifest.load(f"{work}/pt.senna.json")
                                .timings.items() if k.startswith("tree_")})
    run("pseudotime_velocity", "pseudotime", "--latent", latent, "--velocity", vel_path,
        "--out", f"{work}/ptv", out=f"{work}/ptv")
    if has_mpl:
        run("plot_from", "plot", "--from", pred, "--out", f"{work}/plot.png")
        dictionary = RunManifest.load(f"{topic_out}.senna.json").outputs["dictionary"]
        run("plot_topic_1k", "plot-topic", "--latent", lat1k, "--dictionary", dictionary,
            "--clusters", table_path(f"{work}/km2.clusters"), "--out", f"{work}/topics.png")
        for f in ("plot.png", "topics.png", "topics.png.top_genes.tsv",
                  "topics.png.dict_hinton.png"):
            if not Path(f"{work}/{f}").stat().st_size:
                raise AssertionError(f"plot output {f} is empty")

    layouts = {}
    for name in ("umap", "tumap", "tsne", "phate", "tree"):
        stem = f"{work}/{name}.tree_layout.cell_coords" if name == "tree" else f"{work}/{name}.layout"
        t = read_table(table_path(stem))
        layouts[name] = np.stack([t["x"], t["y"]], 1)
    want = {"umap": len(zl), "tumap": len(zl), "tsne": min(len(zl), 10_000),
            "phate": min(len(zl), 2_000), "tree": len(zl)}
    finite = {k: float(np.isfinite(v).all(1).mean()) for k, v in layouts.items()}
    pman = RunManifest.load(f"{pred}.senna.json")
    ptab = read_table(table_path(f"{work}/pt.pseudotime"))
    vtab = read_table(table_path(f"{work}/ptv.pseudotime"))

    # umap's neighbour preservation over 5,000 sampled cells
    rng = np.random.default_rng(0)
    sample = rng.choice(len(zl), min(len(zl), 5000), replace=False)

    def neighbours(points):
        _, idx = knn_search(points[sample], points, 16, device=dev)
        return [row[row != c][:15] for row, c in zip(idx, sample)]

    lat_nb, lay_nb = neighbours(zl), neighbours(layouts["umap"].astype(np.float32))
    preserved = float(np.mean([len(np.intersect1d(a, b)) / 15 for a, b in zip(lat_nb, lay_nb)]))

    # the card against the port's CPU run on the same LAYOUT_CPU_CELLS cells
    t_cmp = time.time()
    x3 = np.ascontiguousarray(zl[:LAYOUT_CPU_CELLS])
    src, dst, w = U.fuzzy_edges(x3, 15, device="cpu")
    a, b = U._fit_ab(0.1, 1.0)
    xc = x3 - x3.mean(0)
    u, s, _ = np.linalg.svd(xc, full_matrices=False)
    emb0 = U.init_2d_from_scores(u[:, :2] * s[:2], 0)
    sgd = dict(n_steps=50, batch=4096, n_points=len(x3), a=a, b=b)
    probs = w / w.sum()
    u_card = U._umap_sgd(0, emb0, src, dst, probs, device=dev, **sgd)
    u_again = U._umap_sgd(0, emb0, src, dst, probs, device=dev, **sgd)
    u_cpu = U._umap_sgd(0, emb0, src, dst, probs, device="cpu", **sgd)
    t_card = LY.tsne(x3, n_iter=50, device=dev)
    t_cpu = LY.tsne(x3, n_iter=50, device="cpu")
    pd_card, y0 = LY.phate_init(x3, knn=15, device=dev)
    d2_card = rounding.sq_dists(torch.as_tensor(x3).to(dev), fused=False).cpu()
    d2_cpu = rounding.sq_dists(torch.as_tensor(x3), fused=False)
    p_card = LY.phate_refine(pd_card, y0, n_iter=200, device=dev)
    p_cpu = LY.phate_refine(pd_card, y0, n_iter=200, device="cpu")
    g_card = PG.pseudotime(x3, root_cell=0, device=dev)
    g_cpu = PG.pseudotime(x3, root_cell=0, device="cpu")
    vs_cpu = {
        "umap_50_steps": float(np.abs(u_card - u_cpu).max()),
        "umap_scale": float(np.abs(u_cpu).max()),
        "umap_rerun_bit_equal": bool(np.array_equal(u_card, u_again)),
        "umap_bit_equal_to_cpu": bool(np.array_equal(u_card, u_cpu)),
        "tsne_50_iterations": float(np.abs(t_card - t_cpu).max()),
        "tsne_scale": float(np.abs(t_cpu).max()),
        "phate_sq_dists_bit_equal": bool(torch.equal(d2_card, d2_cpu)),
        "phate_refine_200": float(np.abs(p_card - p_cpu).max()),
        "pseudotime_nodes": float(np.abs(g_card.nodes - g_cpu.nodes).max()),
        "pseudotime_tree_equal": bool(np.array_equal(g_card.edges, g_cpu.edges)),
        "pseudotime_cell_to_node_differ": int((g_card.cell_to_node != g_cpu.cell_to_node).sum()),
        "pseudotime_branch_differ": int((g_card.branch != g_cpu.branch).sum()),
        "pseudotime_root_equal": g_card.root == g_cpu.root,
        "pseudotime_values": float(np.abs(g_card.pseudotime - g_cpu.pseudotime).max()),
    }
    cmp_s = time.time() - t_cmp
    print(json.dumps({
        "phase": "layout_pseudotime_plot", "cells": len(zl), "runs": runs,
        "finite_share": finite, "umap_neighbour_preservation_15": preserved,
        "manifest_layout": pman.outputs.get("layout"), "manifest_clusters": pman.outputs.get("clusters"),
        "pseudotime_range": [float(ptab["pseudotime"].min()), float(ptab["pseudotime"].max())],
        "branches": int(len(np.unique(ptab["branch"]))),
        "velocity_consistency_positive": float((vtab["consistency"] > 0).mean()),
        "card_vs_cpu_cells": len(x3), "card_vs_cpu_s": cmp_s, "card_vs_cpu": vs_cpu,
        "card": card,
    }), flush=True)
    for k, v in layouts.items():
        if v.shape != (want[k], 2) or finite[k] < (0.9 if k == "tree" else 1.0):
            raise AssertionError(f"layout {k}: shape {v.shape}, finite share {finite[k]}")
    if not (pman.outputs.get("layout", "").endswith(("umap.layout.parquet", "umap.layout.npz"))
            and pman.outputs.get("clusters")):
        raise AssertionError(f"predict manifest lacks the layout or clusters: {pman.outputs}")
    if not np.isfinite(ptab["pseudotime"]).all() or not np.isfinite(vtab["pseudotime"]).all():
        raise AssertionError("pseudotime is not finite")
    if any(launches.values()):
        raise AssertionError(f"a layout command launched a kernel: {launches}")
    if not vs_cpu["umap_rerun_bit_equal"]:
        raise AssertionError("two card runs of umap differ")
    if not vs_cpu["umap_50_steps"] <= 1e-3:
        raise AssertionError(f"umap card vs CPU {vs_cpu['umap_50_steps']} > 1e-3")
    if not vs_cpu["tsne_50_iterations"] <= 1e-3:
        raise AssertionError(f"tsne card vs CPU {vs_cpu['tsne_50_iterations']} > 1e-3")
    if not (vs_cpu["phate_sq_dists_bit_equal"] and vs_cpu["phate_refine_200"] <= 1e-3):
        raise AssertionError(f"phate card vs CPU: {vs_cpu}")
    if not (vs_cpu["pseudotime_nodes"] <= 1e-4 and vs_cpu["pseudotime_tree_equal"]
            and vs_cpu["pseudotime_root_equal"] and vs_cpu["pseudotime_cell_to_node_differ"] == 0
            and vs_cpu["pseudotime_branch_differ"] == 0):
        raise AssertionError(f"pseudotime card vs CPU: {vs_cpu}")
    return launches


def decoder_forward_and_grads(name, x, log_z, fw, device) -> tuple[torch.Tensor, dict]:
    """llik [N] and the gradients of sum(llik) (every parameter and log z)
    of a seeded decoder of family `name` on `device`."""
    from legume_tpu_torch.models.decoders import DECODERS

    kw = dict(rho_prior_weight=10.0) if name == "nb-mixture" else {}
    dec = DECODERS[name](x.shape[1], log_z.shape[1], generator=torch.Generator().manual_seed(4), **kw)
    with torch.no_grad():  # the nuisance parameters off their constant inits
        g = torch.Generator().manual_seed(5)
        for pname, p in dec.named_parameters():
            if pname != "dictionary":
                p.add_(0.3 * torch.randn(p.shape, generator=g))
    dec = dec.to(device)
    lz = torch.from_numpy(log_z).to(device).requires_grad_(True)
    _, llik = dec(lz, torch.from_numpy(x).to(device), torch.from_numpy(fw).to(device)[None, :])
    llik.sum().backward()
    grads = {n: p.grad.cpu() for n, p in dec.named_parameters()}
    grads["log_z"] = lz.grad.cpu()
    return llik.detach().cpu(), grads


def topic_options_phase(work: str, sim, vec, topic_out: str, base_levels, held_sub, K, dev,
                        card: str) -> dict:
    """Phase 12: the `senna topic` options through the port's CLI entry
    point on phase 2's cells (the JAX package's default `TopicArgs`, 5
    epochs), each run's kernel counts zeroed just before and read just
    after. Returns each kernel's launches summed over the phase's runs."""
    from legume_tpu_torch.cli.main import run_senna
    from legume_tpu_torch.data import MemoryBackend, SparseIoVec
    from legume_tpu_torch.data.qc import compute_cell_qc
    from legume_tpu_torch.senna import predict as P
    from legume_tpu_torch.utils.output import read_table, table_path

    # the same cells, with 13 genes named MT- so that QC's mito fraction is not all zero
    names = [f"MT-{g}" if i < 13 else g for i, g in enumerate(sim.row_names)]
    mt = SparseIoVec()
    mt.push(MemoryBackend(sim.counts, names, sim.col_names))
    mt.register_batches(sim.batch.astype(str))
    runs, launches = {}, {}

    def topic(name, data, *argv):
        K.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        res = run_senna(["topic", "--out", f"{work}/{name}", "--epochs", "5", *argv,
                         "--device", "cuda"], vec=data)
        torch.cuda.synchronize()
        launches[name] = dict(K.launch_counts)
        runs[name] = {"argv": list(argv), "wall_s": time.time() - t0, **res["timings"],
                      "peak_device_bytes": torch.cuda.max_memory_allocated(),
                      "launches": launches[name], "cells": len(res["latent"]),
                      "groups_per_level": res["levels"].num_groups_per_level,
                      "llik": [float(v) for v in res["scores"].llik]}
        print(json.dumps({"phase": "topic_options_run", "run": name, **runs[name], "card": card}),
              flush=True)
        if launches[name]["project_normed"] == 0 or launches[name]["collapse"] == 0:
            raise AssertionError(f"{name}: the topic run skipped K1 or K3: {launches[name]}")
        z = res["latent"]
        err = float(np.abs(np.exp(z.astype(np.float64)).sum(1) - 1.0).max())
        if not (np.isfinite(z).all() and err <= 1e-3 and np.isfinite(res["scores"].llik).all()):
            raise AssertionError(f"{name}: the latent is not a finite simplex ({err}) or the "
                                 "llik is not finite")
        return res

    # 1. the reference's default decoder and QC
    md = topic("opt_multi", mt, "--decoder", "nb-mixture,multinomial", "--decoder-weights", "1",
               "0.5", "--rho-prior-weight", "10", "--max-coarse-features", "1000", "--qc",
               "--qc-max-mito-frac", "0.2")
    stem = f"{work}/opt_multi"
    tables = {s: table_path(f"{stem}.{s}") for s in (
        "dictionary", "nb-mixture.dictionary", "multinomial.dictionary", "nb-mixture.dispersion",
        "nb-mixture.alpha", "nb-mixture.rho", "qc")}
    missing = [s for s, path in tables.items() if path is None]
    if missing:
        raise AssertionError(f"the multi-decoder run lacks {missing}")
    qc = read_table(tables["qc"])
    alpha = read_table(tables["nb-mixture.alpha"])["alpha"]
    phi = read_table(tables["nb-mixture.dispersion"])["dispersion"]
    col_sums = {}
    for s in ("dictionary", "nb-mixture.dictionary", "multinomial.dictionary"):
        t = read_table(tables[s])
        beta = np.exp(np.stack([t[f"topic{k}"] for k in range(10)], 1).astype(np.float64))
        col_sums[s] = float(np.abs(beta.sum(0) - 1.0).max())
    multi = {
        "cells": int(len(qc["keep"])), "cells_kept": int(qc["keep"].sum()),
        "mito_frac_max": float(qc["mito_frac"].max()),
        "coarse_features_per_level": [fc.num_coarse for fc in md["coarsenings"]],
        "alpha_sum": float(alpha.sum()), "dispersion_min": float(phi.min()),
        "dictionary_col_sum_max_err": col_sums,
        "rho": dict(zip(read_table(tables["nb-mixture.rho"])["coef"].tolist(),
                        read_table(tables["nb-mixture.rho"])["value"].tolist())),
    }
    if not (abs(multi["alpha_sum"] - 1.0) <= 1e-4 and (phi > 0).all() and len(phi) == len(names)
            and max(col_sums.values()) <= 1e-3 and multi["cells_kept"] == len(md["latent"])):
        raise AssertionError(f"the multi-decoder run's artifacts: {multi}")

    # 2. poisson on phase 2's partition
    fr = topic("opt_from", vec, "--decoder", "poisson", "--from", topic_out)
    same = bool(np.array_equal(fr["levels"].groups_per_level[0], base_levels.groups_per_level[0])
                and len(fr["levels"].level_maps) == len(base_levels.level_maps)
                and all(np.array_equal(a, b) for a, b in zip(fr["levels"].level_maps,
                                                             base_levels.level_maps)))
    if not same or "sort_refine_s" in fr["timings"]:
        raise AssertionError("--from did not reuse phase 2's partition exactly, or sorted again")

    # 3. warm start from phase 2's model; a mismatched K raises
    topic("opt_init", vec, "--init-from", topic_out)
    try:
        run_senna(["topic", "--out", f"{work}/opt_init_k5", "--init-from", topic_out, "-k", "5",
                   "--device", "cuda"], vec=vec)
    except ValueError as e:
        mismatch = str(e)[:80]
    else:
        raise AssertionError("--init-from with a mismatched -k ran")

    # 4. predict with run 1's model on 10,000 held-out cells
    K.reset_launch_counts()
    t0 = time.time()
    zp = P.predict_model(P.PredictArgs(model=stem, out=f"{work}/opt_predict"), vec=held_sub,
                         device=dev)
    torch.cuda.synchronize()
    launches["opt_predict"] = dict(K.launch_counts)
    p_err = float(np.abs(np.exp(zp.astype(np.float64)).sum(1) - 1.0).max())
    predict = {"cells": len(zp), "run_s": time.time() - t0, "simplex_max_err": p_err,
               "launches": launches["opt_predict"]}
    if not (np.isfinite(zp).all() and p_err <= 1e-3):
        raise AssertionError(f"predict with the multi-decoder model: {predict}")

    # 5. card against CPU on the first 4,096 cells: each new family's
    # llik and gradients (normwise, relative 1e-5), QC's statistics exact
    first = SparseIoVec()
    first.push(MemoryBackend(mt.read_columns_csc(np.arange(4096)), names))
    x = np.ascontiguousarray(first.read_columns_csc(np.arange(4096)).T.toarray(), np.float32)
    rng = np.random.default_rng(12)
    log_z = np.log(rng.dirichlet(np.ones(10), 4096)).astype(np.float32)
    fw = rng.uniform(0.2, 1.0, x.shape[1]).astype(np.float32)
    vs_cpu = {}
    for fam in ("multinomial", "poisson", "nb-mixture"):
        gl, gg = decoder_forward_and_grads(fam, x, log_z, fw, dev)
        cl, cg = decoder_forward_and_grads(fam, x, log_z, fw, "cpu")
        vs_cpu[fam] = {"llik": float((gl - cl).abs().max()) / float(cl.abs().max()),
                       **{k: float((gg[k] - cg[k]).abs().max()) / float(cg[k].abs().max())
                          for k in cg}}
    qg = compute_cell_qc(first, device=dev)
    qcpu = compute_cell_qc(first, device="cpu")
    qc_equal = {f: bool(np.array_equal(getattr(qg, f), getattr(qcpu, f)))
                for f in ("total", "n_genes", "mito_frac")}
    print(json.dumps({
        "phase": "topic_options", "multi_decoder": multi, "from_same_partition": same,
        "init_from_mismatch": mismatch, "predict": predict,
        "card_vs_cpu_4096": {"decoders_normwise_rel": vs_cpu, "qc_equal": qc_equal},
        "card": card,
    }), flush=True)
    bad = {f: v for f, d in vs_cpu.items() for k, v in d.items() if not v <= 1e-5}
    if bad or not all(qc_equal.values()):
        raise AssertionError(f"card against CPU: decoders {bad}, qc {qc_equal}")
    names_k = sorted({k for counts in launches.values() for k in counts})
    return {k: sum(counts.get(k, 0) for counts in launches.values()) for k in names_k}


def _launched(K, need: tuple, what: str) -> dict:
    got = dict(K.launch_counts)
    missing = [k for k in need if got[k] == 0]
    if missing:
        raise AssertionError(f"{what} launched none of {missing}: {got}")
    return got


def _rel_err(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def dev32(a, dev):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)


def bge_options_phase(work: str, bvec, bres, acounts, a32, K, dev, card: str, checks: dict,
                      keep: dict) -> dict:
    """Phases 13a-13d: `senna bge --multiome`, `--posterior`, `pb_gibbs`
    at the NCE anchor and `gene_chunk`. K4 is held against its plain
    version at the multiome run's own planes (rows added to `checks`).
    The multiome backends stay in `keep["multiome"]` for phases 18-19.
    Returns each run's launches."""
    from legume_tpu_torch.cli.senna_cmds.embed_cmds import BgeArgs, multiome_vec, run_bge
    from legume_tpu_torch.data import MemoryBackend
    from legume_tpu_torch.data.sim import simulate_multiome
    from legume_tpu_torch.data.visitors import visit_columns_by_block
    from legume_tpu_torch.embedding.nce import NceConfig, _neg_marginal, fit_bge
    from legume_tpu_torch.embedding.posterior import pb_gibbs
    from legume_tpu_torch.ops.random_projection import block_to_device
    from legume_tpu_torch.ops.sparse import col_ids_from_ptr, densify_block

    out = {}
    # ---- 13a: --multiome on 50,000 cells x (2,000 genes + 4,000 peaks)
    t0 = time.time()
    ms = prefetched("multiome", simulate_multiome, genes=2000, peaks=4000, cols=50_000, seed=13)
    (n_genes, n_cells), n_peaks = ms.rna.shape, ms.atac.shape[0]
    cells = [f"cell{j}" for j in range(n_cells)]
    rna = MemoryBackend(ms.rna, [f"g{i}" for i in range(n_genes)], cells)
    atac = MemoryBackend(ms.atac, [f"p{i}" for i in range(n_peaks)], cells)
    sim_s = time.time() - t0
    margs = BgeArgs(multiome=True, skip_etm=True, out=f"{work}/multiome")
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    t0 = time.time()
    mres = run_bge(margs, backends=[rna, atac], device=dev)
    torch.cuda.synchronize()
    run_s = time.time() - t0
    out["multiome"] = _launched(K, ("project_normed", "collapse", "nce_epoch"), "bge --multiome")
    fe, lat = mres["feature_embedding"], mres["latent"]
    print(json.dumps({
        "phase": "bge_multiome", "cells": n_cells, "genes": n_genes, "peaks": n_peaks,
        "d": int(fe.shape[0]), "nnz": int(ms.rna.nnz + ms.atac.nnz), "simulate_wait_s": sim_s,
        "run_s": run_s, **mres["timings"], "launches": out["multiome"],
        "groups": mres["num_groups"], "phase1_losses": mres["phase1_losses"],
        "peak_device_bytes": torch.cuda.max_memory_allocated(), "card": card,
    }), flush=True)
    if fe.shape != (n_genes + n_peaks, margs.embed_dim) or not np.isfinite(fe).all():
        raise AssertionError(f"multiome feature embedding {fe.shape} or not finite")
    if lat.shape != (n_cells, margs.embed_dim) or not np.isfinite(lat).all():
        raise AssertionError("multiome latent is not finite or has the wrong shape")
    if not mres["phase1_losses"][-1] < mres["phase1_losses"][0]:
        raise AssertionError(f"multiome phase-1 loss did not fall: {mres['phase1_losses']}")
    # K4 at the multiome planes: phase 1's [groups, 6,000] plane in the full
    # form, and the first phase-2 block (2,048 cells of the stacked axes)
    # in the axis form that phase 2 runs, each with the run's trained sides
    fit, pb = mres["result"], mres["pb"]
    pb_t, q_pb = dev32(pb, dev), dev32(_neg_marginal(pb, NceConfig.neg_alpha), dev)
    e_f, b_f = dev32(fit.e_feat, dev), dev32(fit.b_feat, dev)
    mvec = multiome_vec([rna, atac], margs.bridge_weight)
    blk = next(iter(visit_columns_by_block(mvec, block_size=NceConfig.cell_batch)))
    r, pt, v = block_to_device(blk, dev)
    x = densify_block(r, col_ids_from_ptr(pt), v, ncols=blk.ncols, num_genes=mvec.num_rows)
    nb = blk.ncols
    rows = [
        check_nce(K, pb_t, q_pb, e_f, b_f, dev32(fit.pb_embeddings[0], dev),
                  dev32(fit.pb_biases[0], dev), pb_t.sum(1), shape="multiome_phase1_plane"),
        check_nce(K, x, q_pb, e_f, b_f, dev32(fit.e_cell[:nb], dev), dev32(fit.b_cell[:nb], dev),
                  x.sum(1), shape="multiome_phase2_block_axis", need_feat=False),
    ]
    n_axis = out["multiome"]["nce_epoch_axis"]
    rows[0]["launches_in_e2e"] = out["multiome"]["nce_epoch"] - n_axis
    rows[1]["launches_in_e2e"] = n_axis
    for row in rows:
        row["path"] = "bge_multiome"
        print(json.dumps({"kernel_check": "nce_epoch", "card": card, **row}), flush=True)
    checks["nce_epoch"].extend(rows)
    keep["multiome"] = (rna, atac)
    del ms, mres, mvec, x, pb_t

    # ---- 13b: --posterior 4 on phase 5's cells (4 sweeps after 1 burn-in)
    pargs = BgeArgs(posterior=POSTERIOR_SWEEPS, skip_etm=True, out=f"{work}/bge_post")
    K.reset_launch_counts()
    t0 = time.time()
    pres = run_bge(pargs, vec=bvec, device=dev)
    torch.cuda.synchronize()
    out["posterior"] = _launched(K, ("project_normed", "collapse", "nce_epoch"), "bge --posterior")
    post = pres["posterior"]
    print(json.dumps({
        "phase": "bge_posterior", "cells": bvec.num_columns, "pb": list(pres["pb"].shape),
        "sweeps": POSTERIOR_SWEEPS, "burnin": POSTERIOR_BURNIN, "run_s": time.time() - t0,
        "posterior_s": pres["timings"]["posterior_s"], "launches": out["posterior"],
        "pip_mean": float(post.pip.mean()), "rhat_max": float(post.rhat.max()), "card": card,
    }), flush=True)
    if not (np.isfinite(post.pip).all() and np.isfinite(post.rhat).all()
            and ((post.pip >= 0) & (post.pip <= 1)).all()):
        raise AssertionError("posterior pip or rhat not finite, or pip outside [0, 1]")

    # ---- 13c: pb_gibbs at the NCE anchor from phase 6's f32 fit
    stats: dict = {}
    t0 = time.time()
    apost = pb_gibbs(acounts, a32.e_feat, a32.b_feat, a32.pb_embeddings[0],
                     np.zeros(acounts.shape[0]), n_sweeps=POSTERIOR_SWEEPS, burnin=POSTERIOR_BURNIN,
                     device=dev, stats=stats)
    torch.cuda.synchronize()
    gibbs_s = time.time() - t0
    print(json.dumps({
        "phase": "pb_gibbs_anchor", "rows": acounts.shape[0], "genes": acounts.shape[1], "h": 16,
        "sweeps": POSTERIOR_SWEEPS, "burnin": POSTERIOR_BURNIN, "seconds": gibbs_s,
        "seconds_per_sweep": gibbs_s / (POSTERIOR_SWEEPS + POSTERIOR_BURNIN),
        "ess_steps": stats["ess_steps"], "ess_shrink_iters": stats["ess_iters"],
        "ess_iters_per_step": stats["ess_iters"] / stats["ess_steps"],
        "pip_mean": float(apost.pip.mean()), "rhat_median": float(np.median(apost.rhat)),
        "card": card,
    }), flush=True)
    if not (np.isfinite(apost.pip).all() and np.isfinite(apost.e_feat_mean).all()
            and np.isfinite(apost.sigma2_trace).all()):
        raise AssertionError("anchor posterior not finite")

    # ---- 13d: gene_chunk = 512 against the dense run on phase 5's plane
    pb = bres["pb"]
    runs = {}
    for chunk in (512, 0):
        K.reset_launch_counts()
        t0 = time.time()
        r = fit_bge([pb], config=NceConfig(epochs=500, gene_chunk=chunk), device=dev)
        torch.cuda.synchronize()
        runs[chunk] = (r, time.time() - t0, K.launch_counts["nce_epoch"])
    l_c, l_d = runs[512][0].phase1_losses, runs[0][0].phase1_losses
    rel = float(np.max(np.abs(np.asarray(l_c) - l_d) / np.abs(l_d)))
    print(json.dumps({
        "phase": "gene_chunk", "pb": list(pb.shape), "epochs": 500, "gene_chunk": 512,
        "chunked_s": runs[512][1], "dense_s": runs[0][1], "k4_launches_chunked": runs[512][2],
        "k4_launches_dense": runs[0][2], "losses_rel_err_max": rel, "losses": l_c, "card": card,
    }), flush=True)
    if len(l_c) != 10 or rel > 1e-4:
        raise AssertionError(f"gene_chunk losses {l_c} against dense {l_d}: {rel}")
    if runs[512][2] != 0:
        raise AssertionError("gene_chunk > 0 launched K4; it takes the chunked loss")
    return out


def rest_phase(work: str, vec, K, dev, card: str) -> dict:
    """Phase 14a: `senna rest --from` phase 2's topic run (before phase 8,
    beside the held-out cells' simulation)."""
    from legume_tpu_torch.cli.senna_cmds.embed_cmds import RestArgs, run_rest

    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    t0 = time.time()
    res = run_rest(RestArgs(from_run=f"{work}/topic", out=f"{work}/rest"), vec=vec, device=dev)
    torch.cuda.synchronize()
    from_s = time.time() - t0
    launches = dict(K.launch_counts)
    peak = torch.cuda.max_memory_allocated()
    z, losses = res["cell_embedding"], res["losses"]
    print(json.dumps({
        "phase": "senna_rest", "cells": vec.num_columns, "genes": vec.num_rows,
        "h": int(z.shape[1]), "epochs": 400, "from_s": from_s, "fit_s": res["fit_s"],
        "losses": losses, "launches": launches, "peak_device_bytes": peak, "card": card,
    }), flush=True)
    if z.shape != (vec.num_columns, 10) or not np.isfinite(z).all():
        raise AssertionError("rest cell embedding not finite or of the wrong shape")
    if not (np.isfinite(res["feature_embedding"]).all() and losses[-1] < losses[0]):
        raise AssertionError(f"rest feature embedding not finite or loss did not fall: {losses}")
    return launches


def rest_runs_phase(work: str, dev, card: str) -> None:
    """Phase 14b: `senna rest --runs` phase 5's and 13b's bge runs."""
    from legume_tpu_torch.cli.senna_cmds.embed_cmds import RestArgs, run_rest

    t0 = time.time()
    aligned = run_rest(RestArgs(runs=[f"{work}/bge", f"{work}/bge_post"], out=f"{work}/rest_runs"),
                       device=dev)["aligned"]
    runs_s = time.time() - t0
    before = np.linalg.norm(np.asarray(aligned[1]["e_cell"]) - aligned[0]["e_cell"])
    print(json.dumps({"phase": "senna_rest_runs", "runs_s": runs_s,
                      "runs_cell_gap_after": float(before), "card": card}), flush=True)
    if not all(np.isfinite(r["e_feat"]).all() for r in aligned):
        raise AssertionError("rest --runs gave a non-finite embedding")


def _write_lines(path: str, lines) -> str:
    with open(path, "w") as f:
        f.write("\n".join(str(x) for x in lines) + "\n")
    return path


def cocoa_phase(work: str, K, dev, card: str, checks: dict, keep: dict) -> dict:
    """Phase 15: `cocoa simulate-collider` data at 40 individuals x 2,500
    cells, 2,000 genes, 3 types, with a 2.2x amplified block of 100 genes
    in 6 of the 40 individuals; `cocoa diff` at the CLI defaults with the
    types as topics, 12 permutations and the CNV side-channel; `cocoa
    collapse`; K1 and K3 held against their plain versions at the first
    block each run gives them (rows added to `checks`); and on a
    4,000-cell subset the card against the CPU. The cells, the first
    diff's result and its launches stay in `keep["cocoa"]` for phase 31."""
    from legume_tpu_torch.cli.main import run_cocoa
    from legume_tpu_torch.cocoa.diff import CocoaDiffArgs
    from legume_tpu_torch.data import MemoryBackend, SparseIoVec
    from legume_tpu_torch.data.visitors import visit_columns_by_block
    from legume_tpu_torch.ops.random_projection import block_to_device, projection_basis

    t0 = time.time()
    sim, counts = prefetched("collider", collider_cohort)
    n = counts.shape[1]
    genes = [f"g{i}" for i in range(2000)]
    sim_s = time.time() - t0

    def files(stem, idx):
        _write_lines(f"{stem}.indv.txt", [f"i{v:04d}" for v in sim.cell_indv[idx]])
        _write_lines(f"{stem}.types.txt", [f"t{v}" for v in sim.cell_type[idx]])
        return [f"{stem}.indv.txt", f"{stem}.types.txt"]

    def vec_of(idx):
        v = SparseIoVec()
        v.push(MemoryBackend(counts[:, idx], genes, [f"cell{j}" for j in idx]))
        return v

    _write_lines(f"{work}/exposure.tsv", [f"i{i:04d}\t{int(x)}" for i, x in enumerate(sim.exposure)])
    _write_lines(f"{work}/truth.tsv", ["gene_idx\tchr\tpos"] + [
        f"{i}\t{'chr1' if i < 1000 else 'chr2'}\t{i * 1000 + 500}" for i in range(2000)])

    def diff(stem, idx, device, *extra):
        indv, types = files(stem, idx)
        return run_cocoa(["diff", "--data-files", stem, "--out", f"{stem}.de", "--indv", indv,
                          "--exposure", f"{work}/exposure.tsv", "--topic-assignment", types,
                          "--permutations", "12", "--cnv-ground-truth", f"{work}/truth.tsv",
                          "--cnv-ref-iters", str(COCOA_REF_ITERS), "--device", device, *extra],
                         vec=vec_of(idx))

    full = np.arange(n)
    cvec = vec_of(full)
    K.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    res = diff(f"{work}/collider", full, str(dev))
    torch.cuda.synchronize()
    diff_s = time.time() - t0
    out = {"diff": _launched(K, ("project_normed",), "cocoa diff")}
    keep["cocoa"] = {"vec": cvec, "res": res, "stem": f"{work}/collider", "launches": out["diff"]}
    cn = res["cnv"]
    car_cols = [i for i, nm in enumerate(cn.sample_names) if int(nm[1:5]) < 6]
    oth_cols = [i for i in range(len(cn.sample_names)) if i not in car_cols]
    in_blk = np.isin(cn.order.ordered, np.arange(600, 700))
    gap = float(cn.cn_score[in_blk][:, car_cols].mean() - cn.cn_score[in_blk][:, oth_cols].mean())
    eff = res["effect"]
    causal = sim.causal_genes
    print(json.dumps({
        "phase": "cocoa_diff", "cells": n, "genes": 2000, "individuals": 40, "topics": 3,
        "permutations": 12, "knn": 10, "pb_samples": 10, "proj_dim": 30, "simulate_wait_s": sim_s,
        "run_s": diff_s, "timings": res["timings"], "launches": out["diff"],
        "peak_device_bytes": torch.cuda.max_memory_allocated(),
        "causal_abs_effect": float(np.abs(eff[causal]).mean()),
        "null_abs_effect": float(np.abs(eff[~causal]).mean()),
        "cnv_carrier_block_gap": gap, "card": card,
    }), flush=True)
    if not (np.isfinite(eff).all() and np.isfinite(res["pvalue"]).all()):
        raise AssertionError("cocoa diff effect or p-value not finite")
    if not np.abs(eff[causal]).mean() > np.abs(eff[~causal]).mean():
        raise AssertionError("cocoa diff: causal genes do not stand out")
    if not gap > 0:
        raise AssertionError(f"CNV: the carriers' amplified block does not stand out ({gap})")
    for key in ("projection_s", "match_cache_s", "stat_collect_all_exposures_s",
                "gamma_fit_all_s", "cnv_s"):
        if key not in res["timings"]:
            raise AssertionError(f"cocoa diff timings lack {key}")

    K.reset_launch_counts()
    t0 = time.time()
    col = run_cocoa(["collapse", "--data-files", f"{work}/collider", "--indv",
                     f"{work}/collider.indv.txt", "--out", f"{work}/collapse", "--device",
                     str(dev)], vec=cvec)
    torch.cuda.synchronize()
    out["collapse"] = _launched(K, ("collapse",), "cocoa collapse")
    print(json.dumps({"phase": "cocoa_collapse", "cells": n, "run_s": time.time() - t0,
                      "launches": out["collapse"], "mu_shape": list(col["mu"].shape),
                      "card": card}), flush=True)
    if out["collapse"]["collapse"] != -(-n // 8192):
        raise AssertionError(f"collapse K3 launches {out['collapse']['collapse']}: one a block")
    if col["mu"].shape != (2000, 40) or not np.isfinite(col["mu"]).all():
        raise AssertionError("collapse means not finite or of the wrong shape")

    # K1 at diff's first 8,192-cell block with its basis (K = 30, diff's
    # seed), and K3 at collapse's first block with the 40 individuals as
    # groups (the names `i0000`.. sort as the individuals do)
    blk = next(iter(visit_columns_by_block(cvec, block_size=8192)))
    r, pt, v = block_to_device(blk, dev)
    cargs = CocoaDiffArgs()
    basis = torch.from_numpy(projection_basis(2000, cargs.proj_dim, cargs.seed)).to(dev)
    seg = torch.from_numpy(sim.cell_indv[: blk.ncols].astype(np.int32)).to(dev)
    rows = {
        "project_normed": check_projection(K, basis, r, pt, v, normed=True,
                                           shape="cocoa_diff_block"),
        "collapse": check_collapse(K, r, pt, v, seg, num_genes=2000, num_groups=40,
                                   shape="cocoa_collapse_block"),
    }
    rows["project_normed"].update(launches_in_e2e=out["diff"]["project_normed"], path="cocoa_diff")
    rows["collapse"].update(launches_in_e2e=out["collapse"]["collapse"], path="cocoa_collapse")
    for name, row in rows.items():
        print(json.dumps({"kernel_check": name, "card": card, **row}), flush=True)
        checks[name].append(row)

    # ---- the card against the CPU on COCOA_CPU_PER_INDV cells of each
    # individual. The
    # two runs project through K1 and its plain version (within K1's 2e-4
    # bar), so their caches may part at near-tied neighbours; the caches
    # built from one projection on the card and on the CPU are compared.
    from legume_tpu_torch.cocoa.collapse import build_match_cache

    sub = np.concatenate([np.flatnonzero(sim.cell_indv == i)[:COCOA_CPU_PER_INDV]
                          for i in range(40)])
    t0 = time.time()
    g = diff(f"{work}/sub", sub, str(dev))
    c = diff(f"{work}/subcpu", sub, "cpu", "--no-match-cache")
    cmp_s = time.time() - t0
    proj = g["proj_nk"]
    proj_err = float(np.abs(g["proj_nk"] - c["proj_nk"]).max())
    proj_bar = RTOL_K1 * float(np.abs(c["proj_nk"]).max())
    caches = [build_match_cache(proj, sim.cell_indv[sub], 40, 10, device=d) for d in (dev, "cpu")]
    x = proj.astype(np.float64)
    rows, cols = np.nonzero(caches[0].idx != caches[1].idx)
    gap = np.abs(np.linalg.norm(x[rows] - x[caches[0].idx[rows, cols]], axis=1)
                 - np.linalg.norm(x[rows] - x[caches[1].idx[rows, cols]], axis=1))
    stat_err = max(_rel_err(getattr(g["stat"], f), getattr(c["stat"], f))
                   for f in ("y1_sum_kdp", "y0_sum_kdp", "y1_sum_kdi", "size_kp", "size_kip"))
    z_err = float(np.abs(g["z"] - c["z"]).max())
    states_equal = bool(np.array_equal(g["cnv"].states, c["cnv"].states))
    print(json.dumps({
        "phase": "cocoa_card_vs_cpu", "cells": len(sub), "seconds": cmp_s,
        "cache_entries_differ_same_projection": int(len(rows)),
        "cache_tie_gap_max": float(gap.max()) if len(gap) else 0.0,
        "cache_entries_differ_e2e": int((g["cache"].idx != c["cache"].idx).sum()),
        "projection_max_abs_diff": proj_err, "projection_bar": proj_bar,
        "stat_rel_err": stat_err, "z_abs_err": z_err, "cnv_states_equal": states_equal,
        "card": card,
    }), flush=True)
    if (gap > 1e-5).any() or stat_err > 1e-5 or z_err > 1e-4 or not states_equal \
            or proj_err > proj_bar:
        raise AssertionError("cocoa on the card differs from the CPU")
    return out


def topic_cnv_phase(work: str, vec, K, dev, card: str) -> dict:
    """Phase 16: `senna topic --cnv --from` phase 2's run."""
    from legume_tpu_torch.cli.main import run_senna
    from legume_tpu_torch.utils.output import read_table, table_path

    K.reset_launch_counts()
    t0 = time.time()
    res = run_senna(["topic", "--from", f"{work}/topic", "--out", f"{work}/topic_cnv", "--cnv",
                     "--epochs", "5", "--device", str(dev)], vec=vec)
    torch.cuda.synchronize()
    launches = _launched(K, ("collapse",), "senna topic --cnv --from")
    cnv = read_table(table_path(f"{work}/topic_cnv.cnv"))
    print(json.dumps({
        "phase": "topic_cnv", "cells": vec.num_columns, "run_s": time.time() - t0,
        "cnv_s": res["timings"]["cnv_s"], "rows": int(len(cnv["state"])),
        "pseudobulks": int(len(np.unique(cnv["pseudobulk"]))),
        "bins": int(len(np.unique(cnv["bin"]))), "launches": launches, "card": card,
    }), flush=True)
    if list(cnv) != ["pseudobulk", "bin", "state", "log_ratio"] or len(np.unique(cnv["bin"])) != 80:
        raise AssertionError(f"topic --cnv table: {list(cnv)}")
    if not (np.isin(cnv["state"], [0, 1, 2]).all() and np.isfinite(cnv["log_ratio"]).all()):
        raise AssertionError("topic --cnv states or log-ratios out of range")
    return launches


# ---- phases 17-20: vae, svd / joint-svd, joint-topic, the masked models ------


def _run_line(name: str, res_timings: dict, t0: float, launches: dict, card: str, **extra) -> dict:
    line = {"phase": name, "run_s": time.time() - t0, "timings": res_timings,
            "launches": launches, "peak_device_bytes": torch.cuda.max_memory_allocated(),
            **extra, "card": card}
    print(json.dumps(line), flush=True)
    return line


def _subset(vec, n: int, with_batches: bool = True):
    """The first `n` cells of `vec` as a vec of their own."""
    from legume_tpu_torch.data import MemoryBackend, SparseIoVec

    sub = SparseIoVec()
    sub.push(MemoryBackend(vec.read_columns_csc(np.arange(n)), vec.row_names(),
                           vec.column_names()[:n]))
    if with_batches and vec.num_batches > 1:
        sub.register_batches(np.asarray(vec.batch_names())[vec.batch_membership()[:n]])
    return sub


class fixed_order_products:
    """Within the block, `torch.nn.functional.linear` (every `nn.Linear`)
    sums its products in float64 from the float32 operands and rounds the
    result to float32 once: a fixed order on any device, in place of the
    library's blocked float32 sums."""

    def __enter__(self):
        self.orig = torch.nn.functional.linear

        def linear(x, w, b=None):
            y = x.double() @ w.double().T
            return (y if b is None else y + b.double()).float()

        torch.nn.functional.linear = linear

    def __exit__(self, *exc):
        torch.nn.functional.linear = self.orig


def vae_phase(work: str, vec, hvec, held_batch_file: str, K, dev, card: str) -> dict:
    """Phase 17: `senna vae` at the CLI defaults (5 epochs) on phase 2's
    cells, `senna predict` with that model on phase 8's held-out cells,
    `senna topic --decoder gaussian-nb --from` phase 2; on 4,000 cells
    the trained encoder on the card against the CPU (1e-4)."""
    from legume_tpu_torch.cli.main import run_senna
    from legume_tpu_torch.data.visitors import visit_columns_by_block
    from legume_tpu_torch.senna import predict as P
    from legume_tpu_torch.senna.topic import build_encoder, load_model

    out = {}
    K.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    res = run_senna(["vae", "--out", f"{work}/vae", "--epochs", "5", "--device", str(dev)], vec=vec)
    torch.cuda.synchronize()
    out["vae"] = _launched(K, ("project_normed", "collapse"), "senna vae")
    z, llik = res["latent"], np.asarray(res["scores"].llik)
    _run_line("senna_vae", res["timings"], t0, out["vae"], card, cells=vec.num_columns,
              genes=vec.num_rows, groups_per_level=res["levels"].num_groups_per_level,
              llik=llik.tolist(), latent_shape=list(z.shape))
    if z.shape != (vec.num_columns, 16) or not np.isfinite(z).all():
        raise AssertionError("vae latent not finite or of the wrong shape")
    if not (np.isfinite(llik).all() and llik[-1] > llik[0]):
        raise AssertionError(f"vae llik not finite or not rising: {llik}")

    K.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    zp = P.predict_model(P.PredictArgs(model=f"{work}/vae", out=f"{work}/vae_predict",
                                       batch_files=[held_batch_file]), vec=hvec, device=dev)
    torch.cuda.synchronize()
    out["vae_predict"] = dict(K.launch_counts)
    _run_line("senna_predict_vae", {}, t0, out["vae_predict"], card, cells=hvec.num_columns,
              latent_shape=list(zp.shape))
    if zp.shape != (hvec.num_columns, 16) or not np.isfinite(zp).all():
        raise AssertionError("vae predict latent not finite or of the wrong shape")

    K.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    g = run_senna(["topic", "--from", f"{work}/topic", "--out", f"{work}/topic_gnb", "--decoder",
                   "gaussian-nb", "--epochs", "5", "--device", str(dev)], vec=vec)
    torch.cuda.synchronize()
    out["topic_gaussian_nb"] = _launched(K, ("project_normed", "collapse"),
                                         "senna topic --decoder gaussian-nb")
    gl = np.asarray(g["scores"].llik)
    _run_line("topic_gaussian_nb", g["timings"], t0, out["topic_gaussian_nb"], card,
              llik=gl.tolist())
    if not (np.isfinite(gl).all() and np.isfinite(g["latent"]).all()):
        raise AssertionError("topic --decoder gaussian-nb: llik or latent not finite")

    # the trained encoder on the first 4,000 cells, card against CPU within
    # 1e-3, phase 8's bar for the topic encoder: the card's float32 latent
    # lies ~2e-4 from the same encoder in float64 (the CPU's ~1e-4; both
    # printed), so a bar of 1e-4 would sit below the card's own rounding
    meta, flat, genes = load_model(f"{work}/vae")
    first = _subset(vec, 4000)
    remap = P.build_gene_remap(genes, first.row_names())
    zs = {d: P.score_dense_backend(first, build_encoder(meta, flat, device=d), remap, device=d)
          for d in (dev, "cpu")}
    x64 = P._dense_block(next(iter(visit_columns_by_block(first, block_size=4096))), remap,
                         "cpu").double()
    with torch.no_grad():
        z64 = build_encoder(meta, flat, device="cpu").double()(x64, train=False)[0].numpy()
    err = float(np.abs(zs[dev] - zs["cpu"]).max())
    card_f64, cpu_f64 = (float(np.abs(zs[d] - z64).max()) for d in (dev, "cpu"))
    print(json.dumps({"phase": "vae_card_vs_cpu", "cells": 4000, "latent_max_abs_err": err,
                      "card_vs_f64": card_f64, "cpu_vs_f64": cpu_f64, "card": card}), flush=True)
    # open fault 1: the same encoder with every layer's product summed in a
    # fixed order (float64 accumulation of the float32 operands, rounded
    # once), the rest of the forward in float32 as before; if the card's
    # extra distance from float64 is cuBLAS's summation order, it goes here
    with fixed_order_products():
        fixed = {d: P.score_dense_backend(first, build_encoder(meta, flat, device=d), remap,
                                          device=d) for d in (dev, "cpu")}
    print(json.dumps({
        "phase": "fault1_summation_order", "cells": 4000,
        "card_f32_vs_f64": card_f64, "cpu_f32_vs_f64": cpu_f64,
        "card_fixed_vs_f64": float(np.abs(fixed[dev] - z64).max()),
        "cpu_fixed_vs_f64": float(np.abs(fixed["cpu"] - z64).max()),
        "card_fixed_vs_cpu_fixed": float(np.abs(fixed[dev] - fixed["cpu"]).max()),
        "card_f32_vs_card_fixed": float(np.abs(zs[dev] - fixed[dev]).max()), "card": card,
    }), flush=True)
    if not err <= 1e-3:
        raise AssertionError(f"vae latent on the card vs the CPU: {err} > 1e-3 (from float64: "
                             f"card {card_f64}, CPU {cpu_f64})")
    return out


def svd_phase(work: str, vec, multiome, K, dev, card: str, checks: dict) -> dict:
    """Phase 18: `senna svd` at its defaults on phase 2's cells (13 K2
    launches, K2 held against its plain version at svd's first block),
    the batch-adjusted counts written to `{out}.adjusted.zarr`
    (`--save-adjusted`), `senna joint-svd` on phase 13a's multiome
    modalities; on 4,000 cells the card against the CPU (factors within
    1e-4 up to sign)."""
    from legume_tpu_torch.cli.main import run_senna
    from legume_tpu_torch.data.visitors import visit_columns_by_block
    from legume_tpu_torch.ops.random_projection import block_to_device

    from legume_tpu_torch.data.sparse_io import open_sparse_matrix

    out = {}
    K.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    res = run_senna(["svd", "--data-files", "phase2", "--out", f"{work}/svd", "--device", str(dev),
                     "--save-adjusted"], vec=vec)
    torch.cuda.synchronize()
    out["svd"] = _launched(K, ("project_normed", "collapse", "project_raw"), "senna svd")
    f = res["factors"]
    adj = open_sparse_matrix(f"{work}/svd.adjusted.zarr")
    adjusted = {"shape": list(adj.shape), "nnz": adj.num_nonzeros,
                "bytes": _store_bytes(f"{work}/svd.adjusted.zarr")}
    if adj.shape != vec.shape:
        raise AssertionError(f"svd adjusted store has shape {adj.shape}")
    _run_line("senna_svd", res["timings"], t0, out["svd"], card, cells=vec.num_columns,
              factors_shape=list(f.shape), singular_values=res["singular_values"].tolist(),
              adjusted=adjusted)
    n_blocks = -(-vec.num_columns // 8192)
    if out["svd"]["project_raw"] != n_blocks:
        raise AssertionError(f"svd K2 launches {out['svd']['project_raw']}, one a block ({n_blocks})")
    if f.shape != (vec.num_columns, 20) or not np.isfinite(f).all():
        raise AssertionError("svd factors not finite or of the wrong shape")

    # K2 at svd's first block: log1p values, svd's basis
    blk = next(iter(visit_columns_by_block(vec, block_size=8192)))
    r, pt, v = block_to_device(blk, dev)
    basis = torch.from_numpy(np.ascontiguousarray(res["basis"], np.float32)).to(dev)
    row = check_projection(K, basis, r, pt, torch.log1p(v), normed=False, shape="svd_block")
    row.update(launches_in_e2e=out["svd"]["project_raw"], path="senna_svd")
    print(json.dumps({"kernel_check": "project_raw", "card": card, **row}), flush=True)
    checks["project_raw"].append(row)

    K.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    j = run_senna(["joint-svd", "--data-files", "rna", "--data-files", "atac", "--out",
                   f"{work}/joint_svd", "--device", str(dev)], vecs=list(multiome))
    torch.cuda.synchronize()
    out["joint_svd"] = _launched(K, ("project_normed", "collapse", "project_raw"), "joint-svd")
    _run_line("senna_joint_svd", j["timings"], t0, out["joint_svd"], card,
              cells=multiome[0].num_columns, features=[m.num_rows for m in multiome],
              factors_shape=list(j["factors"].shape))
    d_joint = sum(m.num_rows for m in multiome)
    if not np.isfinite(j["factors"]).all() or j["basis"].shape != (d_joint, 20):
        raise AssertionError(f"joint-svd factors not finite, or the basis is not [{d_joint}, 20]")

    # the batch-matched plane takes each cell's nearest neighbours across
    # batches from the projection, which the card and the CPU give 1e-6
    # apart: at near ties they part (phase 15 saw it in cocoa's cache),
    # so the stages are held without batches and the batched run reported
    vs_cpu = svd_card_vs_cpu(_subset(vec, 4000, with_batches=False), f"{work}/svd4k", dev)
    batched = svd_card_vs_cpu(_subset(vec, 4000), f"{work}/svd4kb", dev)
    print(json.dumps({"phase": "svd_card_vs_cpu", "cells": 4000, **vs_cpu,
                      "with_batches_reported": batched, "card": card}), flush=True)
    if not (vs_cpu["same_partition"] and vs_cpu["plane_max_rel_err"] <= 1e-5
            and vs_cpu["rsvd_held_columns"] and vs_cpu["rsvd_basis_max_abs_err"] <= 1e-4
            and vs_cpu["rsvd_factors_max_rel_err"] <= 1e-4
            and vs_cpu["projection_max_rel_err"] <= 1e-4):
        raise AssertionError(f"svd on the card vs the CPU: {vs_cpu}")
    return out


def svd_card_vs_cpu(first, out: str, dev) -> dict:
    """`fit_svd` on the card and on the CPU, held stage by stage: the
    partition equal and the pseudobulk plane the basis is fitted on
    within 1e-5 (the collapse's bar); the rSVD of the CPU's plane on both
    devices, within 1e-4 by `svd_held_errors`; the per-cell projection of
    the cells through K2 and its plain version with the CPU's basis
    within 1e-4 of each column's largest value. The end-to-end factors'
    distance is reported beside them: the plane's 1e-5 turns components
    whose singular values lie a few percent apart by about its size over
    their gap."""
    from legume_tpu_torch.ops.rsvd import rsvd
    from legume_tpu_torch.senna import svd as S
    from legume_tpu_torch.utils.prng import key_from_seed

    fits = {d: S.fit_svd(S.SvdArgs(out=f"{out}_{d}"), vec=first, device=d) for d in (str(dev), "cpu")}
    g, c = fits[str(dev)], fits["cpu"]
    plane_err = float(np.abs(g["pb_dp"] - c["pb_dp"]).max() / np.abs(c["pb_dp"]).max())
    x = np.log1p(c["pb_dp"])
    k = len(c["singular_values"])
    key = key_from_seed(S.SvdArgs.seed, 23)
    rs = {}
    for d in (str(dev), "cpu"):
        u, sv, _ = rsvd(torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(d), k, key=key)
        rs[d] = {"basis": u, "singular_values": sv, "factors": S.project_cells(
            first, u, block_size=8192, device="cpu")}
    held, basis_err, f_err = svd_held_errors(rs[str(dev)], rs["cpu"])
    proj = {d: S.project_cells(first, c["basis"], block_size=8192, device=d)
            for d in (str(dev), "cpu")}
    proj_err = float((np.abs(proj[str(dev)] - proj["cpu"]) / np.abs(proj["cpu"]).max(0)).max())
    e2e_held, e2e_basis, e2e_f = svd_held_errors(g, c)
    knn = {}
    if first.num_batches > 1:  # the matched neighbours, each from its own projection
        from legume_tpu_torch.ops.knn import matched_neighbors_across_batches

        memb = first.batch_membership()
        idx = {d: matched_neighbors_across_batches(fits[d]["levels"].proj_kn.T.copy(), memb,
                                                   first.num_batches, 10, device=d)[0]
               for d in (str(dev), "cpu")}
        same_proj = matched_neighbors_across_batches(c["levels"].proj_kn.T.copy(), memb,
                                                     first.num_batches, 10, device=str(dev))[0]
        knn = {"matched_entries_differ": int((idx[str(dev)] != idx["cpu"]).sum()),
               "matched_entries_differ_same_projection": int((same_proj != idx["cpu"]).sum()),
               "projection_max_abs_diff": float(np.abs(g["levels"].proj_kn
                                                       - c["levels"].proj_kn).max())}
    return {
        "same_partition": bool(np.array_equal(g["levels"].groups_per_level[0],
                                              c["levels"].groups_per_level[0])),
        "plane_max_rel_err": plane_err, "singular_values_cpu": c["singular_values"].tolist(),
        "rsvd_held_columns": held, "rsvd_basis_max_abs_err": basis_err,
        "rsvd_factors_max_rel_err": f_err, "projection_max_rel_err": proj_err,
        "e2e_held_columns": e2e_held, "e2e_basis_max_abs_err": e2e_basis,
        "e2e_factors_max_rel_err": e2e_f, **knn,
    }


def svd_held_errors(got: dict, want: dict, gap: float = 0.05):
    """(held columns, basis error, factor error) of two svd fits. The
    columns group where neighbouring singular values lie within `gap`
    of each other; each group is compared up to its rotation (a sign for
    one column): the basis as U_got A against U_want with A = U_got^T
    U_want over the group, the factors as F_got A against F_want
    relative to each column's largest value. The last group is not held:
    its gap to the components the truncation drops is unknown, and the
    rSVD's trailing vectors follow the QR's rounding."""
    s = want["singular_values"]
    bounds, j = [], 0
    while j < len(s):
        e = j + 1
        while e < len(s) and s[e - 1] - s[e] <= gap * s[e - 1]:
            e += 1
        bounds.append((j, e))
        j = e
    basis_err = f_err = 0.0
    held = []
    for a, b in bounds[:-1]:
        rot = got["basis"][:, a:b].T @ want["basis"][:, a:b]
        basis_err = max(basis_err, float(np.abs(got["basis"][:, a:b] @ rot
                                                - want["basis"][:, a:b]).max()))
        scale = np.abs(want["factors"][:, a:b]).max(0)
        f_err = max(f_err, float((np.abs(got["factors"][:, a:b] @ rot - want["factors"][:, a:b])
                                  / scale).max()))
        held.extend(range(a, b))
    return held, basis_err, f_err


def joint_topic_phase(work: str, multiome, K, dev, card: str) -> dict:
    """Phase 19: `senna joint-topic` at the CLI defaults (5 epochs) on
    phase 13a's RNA and ATAC; `--decoder delta` on the RNA plane and a
    second `simulate_topic` draw of its shape; the trained joint encoder
    on the card against the CPU (1e-5, normwise)."""
    from legume_tpu_torch.cli.main import run_senna
    from legume_tpu_torch.data import MemoryBackend
    from legume_tpu_torch.data.sim import simulate_topic

    out, runs = {}, {}
    rna, _ = multiome
    t0 = time.time()
    second = prefetched("delta", simulate_topic, rows=rna.num_rows, cols=rna.num_columns,
                        factors=8, batches=1, seed=19)
    sim_s = time.time() - t0
    pairs = {"joint_topic": list(multiome),
             "joint_topic_delta": [rna, MemoryBackend(second.counts)]}
    for name, mods in pairs.items():
        K.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        res = run_senna(["joint-topic", *[a for _ in mods for a in ("--data-files", "m")],
                         "--out", f"{work}/{name}", "--epochs", "5", "--device", str(dev),
                         *(["--decoder", "delta"] if name.endswith("delta") else [])], vecs=mods)
        torch.cuda.synchronize()
        out[name] = _launched(K, ("project_normed", "collapse"), name)
        llik = np.asarray(res["scores"].llik)
        _run_line(name, res["timings"], t0, out[name], card, cells=mods[0].num_columns,
                  features=[m.num_rows for m in mods], pseudobulks=int(res["pb_latent"].shape[0]),
                  llik=llik.tolist(), **({"simulate_wait_s": sim_s} if name.endswith("delta") else {}))
        if not (np.isfinite(llik).all() and llik[-1] > llik[0]
                and np.isfinite(res["pb_latent"]).all()):
            raise AssertionError(f"{name}: llik not finite or not rising, or latent not finite")
        runs[name] = res
    errs = {}
    for name, res in runs.items():
        enc = res["trainer"].encoder
        x = res["input"][:4000]
        with torch.no_grad():
            got = enc(torch.from_numpy(x).to(dev), train=False)[0].cpu()
            want = copy.deepcopy(enc).cpu()(torch.from_numpy(x), train=False)[0]
        errs[name] = float((got - want).abs().max() / want.abs().max())
    print(json.dumps({"phase": "joint_topic_card_vs_cpu", "rows": int(min(4000, len(x))),
                      "encoder_normwise_rel_err": errs, "card": card}), flush=True)
    if not all(e <= 1e-5 for e in errs.values()):
        raise AssertionError(f"joint encoder on the card vs the CPU: {errs}")
    return out


def _masked_argv(name: str, out: str, dev, *extra) -> list:
    return [name, "--data-files", "phase2", "--out", out, "--epochs", "5", "--device", str(dev),
            *extra]


def masked_gather_checks(K, res, dev, card: str, gathers: int, checks: dict):
    """K3 at the shapes of the masked-topic gathers' backward (phase 20's
    largest K3 caller): one training step of a copy of the trained model
    on its first minibatch, a pre-hook on each gather's backward node
    keeping the gradient it receives; each gather's group sum (a column
    for each window slot, the gradient's width as genes, the table's rows
    as groups, as `_RowGather.backward` forms it) held against its plain
    version and `index_add_`. `gathers` is the run's gather launches, one
    a step for each of the two tables."""
    from legume_tpu_torch.models import indexed as I

    model = copy.deepcopy(res["model"]).train()
    data, mb = res["data"], 256
    cfg = I.MaskedTrainConfig(minibatch=mb, null_plane=res["null_plane"],
                              null_membership=res["null_membership"])
    batch = I._Batcher(data, cfg, dev)
    ids_b = torch.from_numpy(data.ids[:mb]).to(dev)
    vals_b = torch.from_numpy(data.vals[:mb]).to(dev)
    rng = np.random.default_rng(20)
    mask = torch.from_numpy(rng.random(ids_b.shape) < 0.15).to(dev) & (vals_b > 0)
    eps = torch.from_numpy(rng.standard_normal((mb, model.n_topics)).astype(np.float32)).to(dev)
    union, lq, valid, null_b = batch(ids_b, batch.memb[:mb])
    loss, _ = model(ids_b, vals_b, union, lq, valid, mask, train=True, eps=eps, null_vals=null_b)
    nodes, todo, seen = [], [loss.grad_fn], set()
    while todo:
        fn = todo.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        if fn.name().startswith("_RowGather"):
            nodes.append(fn)
        todo.extend(nxt for nxt, _ in fn.next_functions)
    got = []
    for node in nodes:
        (ids,) = node.saved_tensors
        node.register_prehook(lambda grads, node=node, ids=ids:
                              got.append((node.rows, ids, grads[0].detach().clone())))
    loss.mean().backward()
    torch.cuda.synchronize()
    if sorted(g.numel() // i.numel() for _, i, g in got) != [1, model.rho.shape[1]]:
        raise AssertionError(f"masked step: gathers of widths "
                             f"{[g.numel() // i.numel() for _, i, g in got]}, expected log phi's "
                             f"and rho's")
    for rows, ids, grad in got:
        m = ids.numel()
        h = grad.numel() // m
        g = grad.reshape(m, h).to(torch.float32).contiguous().reshape(-1)
        col_ptr = torch.arange(0, (m + 1) * h, h, dtype=torch.int32, device=dev)
        row_ids = torch.arange(h, dtype=torch.int32, device=dev).repeat(m)
        shape = "masked_gather_rho" if h > 1 else "masked_gather_log_phi"
        row = check_collapse(K, row_ids, col_ptr, g, ids.reshape(-1).to(torch.int32),
                             num_genes=h, num_groups=rows, shape=shape)
        row["launches_in_e2e"] = gathers // 2
        row["path"] = "masked_topic"
        print(json.dumps({"kernel_check": "collapse", "card": card, **row}), flush=True)
        checks["collapse"].append(row)


def masked_phase(work: str, vec, hvec, K, dev, card: str, checks: dict) -> dict:
    """Phase 20: `masked-topic` at its defaults (5 epochs) on phase 2's
    cells with `--batch-files` (its null stream's collapse takes K1 and
    K3, its gathers' backward K3 twice a step, held at those shapes by
    `masked_gather_checks`) and `--eval-mask-fraction 0.1`; `masked-vae`
    and `masked-sbp
    --gene-modules 8` on 20,000 of them; `senna predict` with the
    masked-vae model on phase 8's held-out cells (and the batch-null
    model refused, as the JAX package's predict fails on it); on 4,000
    cells the card against the CPU: windows and unions equal, the encoder
    and `masked_eval_loss` within 1e-5."""
    from legume_tpu_torch.cli.main import run_senna
    from legume_tpu_torch.models import indexed as I
    from legume_tpu_torch.senna import predict as P

    out = {}
    bfile = _write_lines(f"{work}/train.batch.txt", np.asarray(vec.batch_names())[
        vec.batch_membership()])
    runs = {}
    sub20 = _subset(vec, 20_000, with_batches=False)
    plan = {
        "masked_topic": (vec, ["--batch-files", bfile, "--eval-mask-fraction", "0.1"],
                         ("project_normed", "collapse")),
        "masked_vae": (sub20, [], ()),
        "masked_sbp": (sub20, ["--gene-modules", "8"], ()),
    }
    for name, (data, extra, need) in plan.items():
        K.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        res = run_senna(_masked_argv(name.replace("_", "-"), f"{work}/{name}", dev, *extra), vec=data)
        torch.cuda.synchronize()
        out[name] = _launched(K, need, name)
        trace = np.asarray(res["trace"])
        _run_line(name, res["timings"], t0, out[name], card, cells=data.num_columns,
                  window=128, trace=trace.tolist(), eval_loss=res["eval_loss"])
        if not (np.isfinite(trace).all() and trace[-1] < trace[0]
                and np.isfinite(res["latent"]).all()):
            raise AssertionError(f"{name}: loss not finite or not falling, or latent not finite")
        runs[name] = res
    if runs["masked_topic"]["eval_loss"] is None or not np.isfinite(runs["masked_topic"]["eval_loss"]):
        raise AssertionError("masked-topic: no finite held-out eval loss")
    steps = 5 * (vec.num_columns // 256)
    gathers = out["masked_topic"]["collapse_gather"]
    if gathers != 2 * steps:
        raise AssertionError(f"masked-topic: {gathers} K3 gather launches, expected {2 * steps}")
    masked_gather_checks(K, runs["masked_topic"], dev, card, gathers, checks)

    K.reset_launch_counts()
    t0 = time.time()
    zp = P.predict_model(P.PredictArgs(model=f"{work}/masked_vae", out=f"{work}/masked_predict"),
                         vec=hvec, device=dev)
    torch.cuda.synchronize()
    out["masked_predict"] = dict(K.launch_counts)
    try:
        P.predict_model(P.PredictArgs(model=f"{work}/masked_topic", out=f"{work}/mp_null"),
                        vec=hvec, device=dev)
    except ValueError as e:
        refused = str(e)[:100]
    else:
        raise AssertionError("predict ran a masked model trained with a batch-null stream")
    _run_line("senna_predict_masked", {}, t0, out["masked_predict"], card, cells=hvec.num_columns,
              latent_shape=list(zp.shape), batch_null_model_refused=refused)
    if zp.shape != (hvec.num_columns, 10) or not np.isfinite(zp).all():
        raise AssertionError("masked predict latent not finite or of the wrong shape")

    # card against CPU on the first 4,000 cells with masked-topic's model
    res = runs["masked_topic"]
    first = _subset(vec, 4000)
    card_dev = str(dev)
    win = {d: I.build_topk_windows(first, 128, device=d) for d in (card_dev, "cpu")}
    same_windows = bool(np.array_equal(win[card_dev].ids, win["cpu"].ids)
                        and np.array_equal(win[card_dev].vals, win["cpu"].vals))
    ids = torch.from_numpy(win["cpu"].ids[:256])
    same_union = bool(torch.equal(I.union_ids(ids.to(dev), 4096, vec.num_rows).cpu(),
                                  I.union_ids(ids, 4096, vec.num_rows)))
    data = I.IndexedData(ids=res["data"].ids[:4000], vals=res["data"].vals[:4000],
                         log_q=res["data"].log_q, n_genes=vec.num_rows)
    memb = res["null_membership"][:4000]
    cfg = I.MaskedTrainConfig(minibatch=256, eval_mask_frac=0.1, null_plane=res["null_plane"],
                              null_membership=memb)
    cpu_model = copy.deepcopy(res["model"]).cpu()
    models = ((card_dev, res["model"]), ("cpu", cpu_model))
    z = {d: I.encode_all(m, data, null_plane=res["null_plane"], null_membership=memb, device=d)
         for d, m in models}
    ev = {d: I.masked_eval_loss(m, data, cfg, device=d) for d, m in models}
    # the encoder's log theta held normwise, as the joint encoder's
    # (values reach about -16: a float32 rounding there is 1e-6)
    enc_err = float(np.abs(z[card_dev] - z["cpu"]).max())
    enc_rel = enc_err / float(np.abs(z["cpu"]).max())
    ev_err = abs(ev[card_dev] - ev["cpu"])
    print(json.dumps({"phase": "masked_card_vs_cpu", "cells": 4000, "windows_equal": same_windows,
                      "union_equal": same_union, "encoder_max_abs_err": enc_err,
                      "encoder_normwise_rel_err": enc_rel, "eval_loss": ev,
                      "eval_loss_abs_err": ev_err, "card": card}), flush=True)
    if not (same_windows and same_union and enc_rel <= 1e-5 and ev_err <= 1e-5):
        raise AssertionError(f"masked on the card vs the CPU: windows {same_windows}, union "
                             f"{same_union}, encoder {enc_rel}, eval loss {ev_err}")
    return out


# ---- phases 21-27: stores, annotation, deconvolution, impute, probe, fne --


def storage_libraries() -> dict:
    """Which zstd provider and HDF5 library the machine has (the port's
    stores need pyarrow's zstd; `.h5` needs h5py)."""
    import ctypes
    import ctypes.util

    def loadable(name: str) -> bool:
        try:
            ctypes.CDLL(name)
            return True
        except OSError:
            return False

    try:
        import pyarrow as pa

        pa_zstd = bool(pa.Codec.is_available("zstd"))
    except ImportError:
        pa_zstd = False
    return {
        "zstd_pyarrow": pa_zstd, "libzstd.so.1": loadable("libzstd.so.1"),
        "libhdf5": ctypes.util.find_library("hdf5") or ctypes.util.find_library("hdf5_serial"),
        "h5py": importlib.util.find_spec("h5py") is not None,
        "tensorstore": importlib.util.find_spec("tensorstore") is not None,
    }


def _store_bytes(path: str) -> int:
    p = Path(path)
    return p.stat().st_size if p.is_file() else sum(f.stat().st_size for f in p.rglob("*")
                                                     if f.is_file())


def store_phase(work: str, sim, res, K, dev, card: str) -> tuple[dict, str]:
    """Phase 21: phase 2's cells written to `.zarr` and `.zarr.zip` by the
    port's writer and read back equal to the matrix in memory; `senna
    topic --data-files x.zarr --batch-files` with phase 2's arguments and
    1 epoch gives phase 2's partitions at every level."""
    from legume_tpu_torch.cli.main import run_senna
    from legume_tpu_torch.data.sparse_io import create_sparse_from_csc, open_sparse_matrix

    line, out = {}, {}
    for ext in (".zarr", ".zarr.zip"):
        path = f"{work}/x{ext}"
        t0 = time.time()
        create_sparse_from_csc(sim.counts, path, sim.row_names, sim.col_names)
        line[f"write{ext}_s"] = time.time() - t0
        line[f"bytes{ext}"] = _store_bytes(path)
        t0 = time.time()
        b = open_sparse_matrix(path)
        got = b.read_columns_csc(np.arange(b.num_columns))
        line[f"read{ext}_s"] = time.time() - t0
        if not (got.shape == sim.counts.shape and (got != sim.counts).nnz == 0
                and b.row_names() == list(sim.row_names)
                and b.column_names() == list(sim.col_names)):
            raise AssertionError(f"{path} read back unlike the matrix written")
    store = f"{work}/x.zarr"
    bfile = _write_lines(f"{work}/x.batch.txt", sim.batch.astype(str))
    K.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    r = run_senna(["topic", "--data-files", store, "--batch-files", bfile, "--out",
                   f"{work}/topic_zarr", "--epochs", "1", "--device", str(dev)])
    torch.cuda.synchronize()
    out["topic_zarr"] = _launched(K, ("project_normed", "collapse"), "topic --data-files x.zarr")
    same = [bool(np.array_equal(a, b)) for a, b in zip(r["levels"].groups_per_level,
                                                       res["levels"].groups_per_level)]
    _run_line("senna_topic_zarr", r["timings"], t0, out["topic_zarr"], card,
              cells=sim.counts.shape[1], nnz=int(sim.counts.nnz), **line,
              memory_run_timings=res["timings"], same_partitions_as_memory=same)
    if not (len(same) == len(res["levels"].groups_per_level) and all(same)):
        raise AssertionError(f"topic from x.zarr: partitions unlike phase 2's: {same}")
    return out, store


def _factor_gmt(work: str, sim, top: int = 50) -> str:
    """One gene set per simulated factor: its `top` most specific genes."""
    lb = np.log(sim.beta)
    spec = lb - lb.mean(1, keepdims=True)
    lines = [f"factor{k}\tsimulated\t" + "\t".join(sim.row_names[i] for i in
                                                   np.argsort(-spec[:, k])[:top])
             for k in range(sim.beta.shape[1])]
    return _write_lines(f"{work}/factors.gmt", lines)


def _toy_ontology(work: str, sim, seed: int = 7) -> tuple[str, str]:
    """An OBO of a root, one term a factor and two subterms each, and a GAF
    that annotates each subterm with 10 of its factor's top genes, the
    factor term with the next 20 and every term with 5 random genes."""
    rng = np.random.default_rng(seed)
    lb = np.log(sim.beta)
    spec = lb - lb.mean(1, keepdims=True)
    obo = ["format-version: 1.2", "", "[Term]", "id: CL:0000000", "name: cell", ""]
    gaf = ["!gaf-version: 2.2"]
    names = sim.row_names
    for k in range(sim.beta.shape[1]):
        fac = f"CL:{1000 + k:07d}"
        obo += ["[Term]", f"id: {fac}", f"name: factor{k} cell", "is_a: CL:0000000 ! cell", ""]
        order = np.argsort(-spec[:, k])
        gaf += [f"SIM\t{i}\t{names[i]}\t\t{fac}" for i in order[20:40]]
        for s in range(2):
            sub = f"CL:{2000 + 2 * k + s:07d}"
            obo += ["[Term]", f"id: {sub}", f"name: factor{k} subtype{s}", f"is_a: {fac}", ""]
            gaf += [f"SIM\t{i}\t{names[i]}\t\t{sub}" for i in order[10 * s : 10 * s + 10]]
            gaf += [f"SIM\t{i}\t{names[i]}\t\t{sub}" for i in rng.choice(len(names), 5)]
    return (_write_lines(f"{work}/toy.obo", obo), _write_lines(f"{work}/toy.gaf", gaf))


def annotation_phase(work: str, sim, res, topic_out: str, store: str, K, dev, card: str) -> dict:
    """Phase 22: `qmatrix` on phase 2's dictionary with one gene set a
    simulated factor, and `--latent` phase 2's latent; `annotate-by-
    enrichment --data-files x.zarr` and `annotate-ontology` (a toy OBO
    and GAF) over phase 2's cells clustered by their top topic (phase 9's
    clusters are of the held-out cells); `annotate-by-projection --from`
    phase 5's bge run and `--train-latent` (phase 2's latent and clusters,
    onto phase 8's held-out latent)."""
    from legume_tpu_torch.cli.main import run_senna
    from legume_tpu_torch.utils.output import read_table, table_path, write_table

    out = {}
    gmt = _factor_gmt(work, sim)
    obo, gaf = _toy_ontology(work, sim)
    top = res["latent"].argmax(1)
    clusters = write_table(f"{work}/topic_top.clusters",
                           {"cell": np.asarray(sim.col_names), "cluster": top})
    runs = {
        "qmatrix": ["qmatrix", "--dictionary", table_path(f"{topic_out}.dictionary"),
                    "--markers", gmt, "--latent", table_path(f"{topic_out}.latent"),
                    "--out", f"{work}/qm"],
        "annotate_by_enrichment": ["annotate-by-enrichment", "--data-files", store,
                                   "--clusters", clusters, "--markers", gmt, "--num-perm", "20",
                                   "--bootstrap", "20", "--out", f"{work}/abe"],
        "annotate_ontology": ["annotate-ontology", "--data-files", store, "--clusters", clusters,
                              "--obo", obo, "--gaf", gaf, "--by", "module-score",
                              "--out", f"{work}/ont"],
        "annotate_by_projection_from": ["annotate-by-projection", "--from",
                                        f"{work}/bge.gem.json", "--markers", gmt,
                                        "--out", f"{work}/abp"],
        "annotate_by_projection_train": ["annotate-by-projection", "--train-latent",
                                         table_path(f"{topic_out}.latent"), "--train-clusters",
                                         clusters, "--latent", table_path(f"{work}/predict.latent"),
                                         "--out", f"{work}/abt"],
    }
    results = {}
    for name, argv in runs.items():
        K.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        # annotate-ontology and annotate-by-enrichment run on the host alone
        on_card = argv[0] in ("qmatrix", "annotate-by-projection")
        results[name] = run_senna(argv + ["--device", str(dev)] if on_card else argv)
        torch.cuda.synchronize()
        out[name] = dict(K.launch_counts)
        extra = {}
        if name == "qmatrix":
            q = results[name]
            best = q["z"].argmax(1)
            extra = {"sets": len(q["labels"]), "topics": int(q["z"].shape[1]),
                     "significant_pairs": int((q["q"] < 0.05).sum()),
                     "best_topic_per_set": best.tolist(),
                     "best_z": q["z"][np.arange(len(best)), best].tolist()}
            cells = read_table(table_path(f"{work}/qm.cell_annotation"))
            extra["cell_labels"] = {str(k): int(v) for k, v in zip(
                *np.unique(cells["annotation"], return_counts=True))}
            if not (np.isfinite(q["z"]).all() and len(cells["annotation"]) == len(top)):
                raise AssertionError("qmatrix: z not finite or cell labels missing")
        else:
            table = read_table(table_path(argv[argv.index("--out") + 1] + ".annotation"))
            extra = {"rows": len(table["annotation"]), "labels": {
                str(k): int(v) for k, v in zip(*np.unique(table["annotation"],
                                                          return_counts=True))}}
        _run_line(name, {}, t0, out[name], card, **extra)
    return out


def _bulk_tsv(path: str, counts, genes, names) -> str:
    import pandas as pd

    pd.DataFrame(np.asarray(counts, np.float32), index=names, columns=genes).to_csv(path, sep="\t")
    return path


def deconvolve_phase(work: str, sim, vec, res, K, dev, card: str, checks: dict, *,
                     n: int = 10_000, archetypes: int = 50) -> dict:
    """Phase 23: `deconvolve --from` at full gene width on 10,000 of phase
    2's cells (its latent as the run's, the cells' top simulated factor
    as the annotation; bulk samples pooled from all 100,000 cells at known
    type fractions; one granularity of 50 archetypes), its sums through
    K3 (one launch per 2,048-cell block, K3 held at the first block's
    archetype plane); `deconvolve --reference` of eight marker-block rate
    profiles on Poisson bulk samples of known fractions."""
    import pandas as pd

    from legume_tpu_torch.cli.main import run_senna
    from legume_tpu_torch.data.visitors import visit_columns_by_block
    from legume_tpu_torch.ops.random_projection import block_to_device
    from legume_tpu_torch.utils.output import read_table, table_path, write_table

    out = {}
    sub = _subset(vec, n, with_batches=False)
    genes, cells = list(sim.row_names), list(sim.col_names)
    types = sim.theta.argmax(1)
    n_types = sim.theta.shape[1]
    rng = np.random.default_rng(23)
    lat = write_table(f"{work}/dec_run.latent", {"cell": np.asarray(cells[:n]), **{
        f"topic{k}": res["latent"][:n, k] for k in range(res["latent"].shape[1])}})
    Path(f"{work}/dec_run.senna.json").write_text(json.dumps(
        {"command": "topic", "inputs": {}, "outputs": {"latent": lat}}))
    ann = _write_lines(f"{work}/dec_ann.tsv", [f"{c}\ttype{k}" for c, k in zip(cells[:n], types)])
    planted = rng.dirichlet(np.ones(n_types), 4)
    csc = sim.counts.tocsc()
    bulk = np.stack([np.asarray(csc[:, np.concatenate([
        rng.choice(np.nonzero(types == k)[0], int(round(planted[s, k] * 2000)))
        for k in range(n_types)])].sum(1)).ravel() for s in range(4)])
    bulk_path = _bulk_tsv(f"{work}/bulk.tsv", bulk, genes, [f"s{s}" for s in range(4)])
    K.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    frac = run_senna(["deconvolve", "--bulk", bulk_path, "--from", f"{work}/dec_run",
                      "--annotation", ann, "--archetypes", str(archetypes), "--out", f"{work}/dec",
                      "--device", str(dev)], vec=sub)
    torch.cuda.synchronize()
    out["deconvolve"] = _launched(K, ("collapse",), "deconvolve --from")
    memb = read_table(table_path(f"{work}/dec.membership"))[f"archetype_k{archetypes}"]
    r_comp = int(memb.max()) + 1
    k3_expected = -(-n // 2048)
    err = np.abs(np.asarray(frac) - planted)
    _run_line("senna_deconvolve_from", {}, t0, out["deconvolve"], card, cells=n, genes=len(genes),
              archetypes=r_comp, plane_shape=[len(genes), r_comp], collapse_expected=k3_expected,
              fraction_abs_err_mean=float(err.mean()), fraction_abs_err_max=float(err.max()))
    if out["deconvolve"]["collapse"] != k3_expected:
        raise AssertionError(f"deconvolve K3 launches {out['deconvolve']['collapse']}, "
                             f"expected {k3_expected}")
    if not (np.isfinite(frac).all() and np.abs(np.asarray(frac).sum(1) - 1).max() < 1e-3):
        raise AssertionError("deconvolve --from: fractions not a finite simplex")
    # K3 at the archetype plane: the first 2,048-cell block over the communities
    blk = next(iter(visit_columns_by_block(sub, block_size=2048)))
    r, p, v = block_to_device(blk, dev)
    seg = torch.from_numpy(np.where(memb[:2048] >= 0, memb[:2048], r_comp).astype(np.int32)).to(dev)
    row = check_collapse(K, r, p, v, seg, num_genes=len(genes), num_groups=r_comp,
                         shape="archetype_plane")
    row.update(launches_in_e2e=out["deconvolve"]["collapse"], path="senna_deconvolve")
    print(json.dumps({"kernel_check": "collapse", "card": card, **row}), flush=True)
    checks["collapse"].append(row)

    # direct mode: eight rate profiles over the same genes, each with a
    # block of markers (the simulated types' mean profiles overlap too much
    # for any chain to separate), and Poisson bulk samples at known
    # fractions, 50,000 counts each
    mu = rng.gamma(0.3, 1.0, (len(genes), n_types)) * 5.0
    block = len(genes) // (2 * n_types)
    for k in range(n_types):
        mu[k * block : (k + 1) * block, k] *= 10.0
    mu /= mu.sum(0, keepdims=True)
    pd.DataFrame(mu, index=genes, columns=[f"type{k}" for k in range(n_types)]).reset_index(
        names="gene").to_parquet(f"{work}/dec_ref.parquet")
    true_ref = rng.dirichlet(np.ones(n_types), 6)
    lam = true_ref @ mu.T
    y = rng.poisson(50_000 * lam / lam.sum(1, keepdims=True))
    ref_bulk = _bulk_tsv(f"{work}/bulk_ref.tsv", y, genes, [f"r{s}" for s in range(6)])
    K.reset_launch_counts()
    t0 = time.time()
    dres = run_senna(["deconvolve", "--bulk", ref_bulk, "--reference", f"{work}/dec_ref.parquet",
                      "--out", f"{work}/dec_ref", "--device", str(dev)])
    torch.cuda.synchronize()
    out["deconvolve_reference"] = dict(K.launch_counts)
    ref_err = np.abs(dres.fractions - true_ref)
    _run_line("senna_deconvolve_reference", {}, t0, out["deconvolve_reference"], card,
              samples=6, types=n_types, fraction_abs_err_mean=float(ref_err.mean()),
              fraction_abs_err_max=float(ref_err.max()), worst_rhat=float(dres.rhat.max()),
              min_ess=float(dres.ess.min()))
    if not ref_err.mean() < 0.05:
        raise AssertionError(f"deconvolve --reference: mean fraction error {ref_err.mean()}")
    return out


def impute_probe_phase(work: str, vec, hvec, res, topic_out: str, K, dev, card: str, *,
                       n: int = 20_000, n_query: int = 5000) -> dict:
    """Phases 24-25: `impute` in self mode on 20,000 of phase 2's cells
    (writing its `.zarr`) and in reference mode (phase 8's model; 5,000
    held-out query cells against phase 2's 100,000); `probe` in model mode
    with `--counterfactual` (20,000 held-out query cells against 20,000
    calibration cells of phase 2) and in latent mode."""
    from legume_tpu_torch.cli.main import run_senna
    from legume_tpu_torch.data.sparse_io import open_sparse_matrix
    from legume_tpu_torch.utils.output import table_path, write_table

    out = {}
    sub = _subset(vec, n, with_batches=False)
    lat_all = table_path(f"{topic_out}.latent")
    lat = write_table(f"{work}/imp_sub.latent", {"cell": np.asarray(sub.column_names()), **{
        f"topic{k}": res["latent"][:n, k] for k in range(res["latent"].shape[1])}})
    runs = {
        "impute": (["impute", "--data-files", "x", "--latent", lat, "--out", f"{work}/imp"],
                   dict(vec=sub)),
        "impute_reference": (["impute", "--data-files", "q", "--model", topic_out,
                              "--reference-latent", lat_all, "--reference-data", "x",
                              "--out", f"{work}/impref"],
                             dict(vecs=[_subset(hvec, n_query, with_batches=False), vec])),
        "probe": (["probe", "--model", topic_out, "--data-files", "q", "--calibration", "c",
                   "--counterfactual", "--out", f"{work}/probe"],
                  dict(vecs=[_subset(hvec, n, with_batches=False), sub])),
        "probe_latent": (["probe", "--train-latent", lat_all, "--heldout-latent",
                          table_path(f"{work}/predict.latent"), "--out", f"{work}/probe_lat"], {}),
    }
    for name, (argv, kw) in runs.items():
        K.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        got = run_senna(argv + ["--device", str(dev)], **kw)
        torch.cuda.synchronize()
        out[name] = dict(K.launch_counts)
        extra = {}
        if name == "impute":
            b = open_sparse_matrix(f"{work}/imp.zarr")
            extra = {"store_shape": list(b.shape), "store_nnz": b.num_nonzeros,
                     "store_bytes": _store_bytes(f"{work}/imp.zarr")}
            if b.shape != sub.shape or not np.isfinite(got).all():
                raise AssertionError("impute: store of the wrong shape or values not finite")
        elif name == "impute_reference":
            extra = {"shape": list(got.shape)}
            if got.shape != (n_query, vec.num_rows) or not np.isfinite(got).all():
                raise AssertionError("impute --model: wrong shape or values not finite")
        elif name == "probe":
            extra = {"verdict": got.verdict, "flag_rate": got.flag_rate,
                     "threshold": got.threshold, "counterfactual": got.counterfactual}
            if not (np.isfinite(got.q_fit).all() and np.isfinite(got.cal_fit).all()):
                raise AssertionError("probe: fit scores not finite")
        else:
            extra = {"verdict": got.verdict, "drift_score": got.drift_score,
                     "novelty_frac": got.novelty_frac}
        _run_line(name, {}, t0, out[name], card, **extra)
    return out


def sbm_edges(n: int, modules: int, seed: int, within: int = 15):
    """A weighted stochastic-block graph: `n` genes in `modules` equal
    modules, each gene tied to `within` random genes of its module and one
    anywhere, weights 1-3."""
    rng = np.random.default_rng(seed)
    module = np.arange(n) % modules
    size = n // modules
    src = np.repeat(np.arange(n), within + 1)
    mates = rng.integers(0, size, (n, within)) * modules + module[:, None]
    dst = np.concatenate([mates, rng.integers(0, n, (n, 1))], 1).ravel()
    keep = src != dst
    w = rng.integers(1, 4, keep.sum())
    return [(f"gene{a}", f"gene{b}", float(c)) for a, b, c in zip(src[keep], dst[keep], w)], module


def fne_phase(work: str, K, dev, card: str, checks: dict, *, nodes: int = 10_000,
              modules: int = 50) -> dict:
    """Phase 26: `senna fne` with the CLI defaults (500 epochs, d = 32) on a
    stochastic-block graph of 10,000 genes in 50 modules: every epoch one
    K4 launch in its full form (500 required, none in the axis form); K4
    held against its plain version at that plane with tied weights."""
    from legume_tpu_torch.cli.main import run_senna
    from legume_tpu_torch.senna.fne import fne_plane

    edges, module = sbm_edges(nodes, modules, seed=26)
    path = _write_lines(f"{work}/edges.tsv", (f"{a}\t{b}\t{w:g}" for a, b, w in edges))
    K.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    res = run_senna(["fne", "--edges", path, "--out", f"{work}/fne", "--device", str(dev)])
    torch.cuda.synchronize()
    launches = _launched(K, ("nce_epoch",), "senna fne")
    emb = res.embedding
    order = np.asarray([int(n[4:]) for n in res.names])
    unit = emb / np.maximum(np.linalg.norm(emb, axis=1, keepdims=True), 1e-12)
    mod = module[order]
    cos = unit[:2000] @ unit.T  # the first 2,000 genes against all
    same = mod[:2000, None] == mod[None, :]
    _run_line("senna_fne", {}, t0, launches, card, nodes=len(res.names), edges=len(edges),
              losses=res.losses, cos_within=float(cos[same].mean()),
              cos_across=float(cos[~same].mean()))
    if launches["nce_epoch"] != 500 or launches["nce_epoch_axis"] != 0:
        raise AssertionError(f"fne K4 launches {launches}, expected 500 in the full form")
    if not (np.isfinite(emb).all() and res.losses[-1] < res.losses[0]):
        raise AssertionError(f"fne: embedding not finite or loss not falling: {res.losses}")
    # K4 at fne's plane, tied weights: e_axis = e_feat, b_axis = b_feat
    names, plane, q = fne_plane(edges, 0.75)
    c = dev32(plane, dev)
    e, b = dev32(emb, dev), dev32(res.bias, dev)
    row = check_nce(K, c, dev32(q, dev), e, b, e, b, c.sum(1), shape="fne_plane_tied")
    row.update(launches_in_e2e=launches["nce_epoch"], path="senna_fne")
    print(json.dumps({"kernel_check": "nce_epoch", "card": card, **row}), flush=True)
    checks["nce_epoch"].append(row)
    return {"fne": launches}


def slice11_card_vs_cpu(work: str, sim, topic_out: str, store: str, dev, card: str) -> None:
    """Phase 27 on small inputs, the card against the CPU: the Q-matrix
    and a permutation p-value equal, fne's embedding within 1e-4 after 50
    epochs, deconvolve's fractions within 0.03 (chains of two generators),
    a block read from x.zarr equal to the matrix with its K1 projection
    within K1's bar of the CPU's, and QC on 4,000 cells (statistics
    within 1e-6, keep masks equal)."""
    from legume_tpu_torch.data.sparse_io import open_sparse_matrix
    from legume_tpu_torch.ops import kernels as K
    from legume_tpu_torch.ops.enrichment import geneset_topic_qmatrix, gsea_permutation_pvalue
    from legume_tpu_torch.ops.random_projection import projection_basis
    from legume_tpu_torch.senna.deconvolve import DeconvConfig, deconvolve
    from legume_tpu_torch.senna.fne import fit_fne
    from legume_tpu_torch.senna.predict import _load_log_dictionary
    from legume_tpu_torch.data.knowledge import read_gmt

    rep = {}
    log_dict = _load_log_dictionary(topic_out, list(sim.row_names))
    sets = read_gmt(f"{work}/factors.gmt")
    qs = {d: geneset_topic_qmatrix(log_dict.T, list(sim.row_names), sets, n_perm=50, seed=1,
                                   device=d) for d in (dev, "cpu")}
    rep["qmatrix_equal"] = all(np.array_equal(qs[dev][k], qs["cpu"][k])
                               for k in ("es", "z", "pvalue", "q"))
    rng = np.random.default_rng(27)
    scores, mask = rng.normal(size=2000), rng.random(2000) < 0.02
    gs = [gsea_permutation_pvalue(scores, mask, n_permutations=500, seed=3, device=d)
          for d in (dev, "cpu")]
    rep["gsea_equal"] = gs[0] == gs[1]
    edges, _ = sbm_edges(500, 5, seed=27)
    fs = [fit_fne(edges, epochs=50, seed=1, device=d) for d in (dev, "cpu")]
    rep["fne_embedding_max_abs_err"] = float(np.abs(fs[0].embedding - fs[1].embedding).max())
    rep["fne_loss_max_abs_err"] = float(np.abs(np.subtract(fs[0].losses, fs[1].losses)).max())
    d_, r_ = 300, 4
    mu = rng.gamma(0.3, 1.0, (d_, r_)) * 5.0
    for m in range(r_):
        mu[m * 60 : (m + 1) * 60, m] *= 10.0
    frac = rng.dirichlet(np.ones(r_), 4)
    lam = frac @ mu.T
    y = rng.poisson(lam / lam.sum(1, keepdims=True) * 50_000).astype(np.float32)
    ds = [deconvolve(y, mu / mu.sum(0), config=DeconvConfig(n_sweeps=400, burn_in=150, seed=1),
                     device=d) for d in (dev, "cpu")]
    rep["deconvolve_fraction_max_abs_err"] = float(np.abs(ds[0].fractions - ds[1].fractions).max())
    rep["deconvolve_vs_truth_max_abs_err"] = [float(np.abs(x.fractions - frac).max()) for x in ds]
    b = open_sparse_matrix(store)
    cols = np.arange(min(4096, b.num_columns))
    blk = b.read_columns_csc(cols)
    rep["store_block_equal"] = bool((blk != sim.counts[:, cols]).nnz == 0)
    basis = projection_basis(b.num_rows, 50, 5)
    proj = {}
    for d in (dev, "cpu"):
        rows = torch.from_numpy(blk.indices.astype(np.int32)).to(d)
        ptr = torch.from_numpy(blk.indptr.astype(np.int32)).to(d)
        vals = torch.from_numpy(blk.data.astype(np.float32)).to(d)
        proj[d] = K.project(torch.from_numpy(basis).to(d), rows, ptr, vals, normed=True).cpu()
    scale = float(proj["cpu"].abs().max())
    rep["store_block_k1_rel_err"] = float((proj[dev] - proj["cpu"]).abs().max()) / scale
    rep.update(qc_card_vs_cpu(store, dev))
    print(json.dumps({"phase": "slice11_card_vs_cpu", **rep, "card": card}), flush=True)
    if not (rep["qmatrix_equal"] and rep["gsea_equal"] and rep["fne_embedding_max_abs_err"] <= 1e-4
            and rep["deconvolve_fraction_max_abs_err"] <= 0.03 and rep["store_block_equal"]
            and rep["store_block_k1_rel_err"] <= RTOL_K1 and rep["qc_stat_rel_err"] <= 1e-6
            and rep["qc_masks_equal"]):
        raise AssertionError(f"slice 11 on the card vs the CPU: {rep}")


# ---- phases 28-31: data-beans, data-beans-sim, ingestion, GFF ---------------


def _sync(dev):
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def _cli(run, argv) -> tuple[str, float]:
    """(standard output, seconds) of one CLI call."""
    import contextlib
    import io

    buf = io.StringIO()
    t0 = time.time()
    with contextlib.redirect_stdout(buf):
        run(argv)
    return buf.getvalue(), time.time() - t0


def _same_files(a: str, b: str) -> bool:
    """Two store directories hold the same files, byte for byte."""
    fa = sorted(p.relative_to(a) for p in Path(a).rglob("*") if p.is_file())
    fb = sorted(p.relative_to(b) for p in Path(b).rglob("*") if p.is_file())
    return fa == fb and all((Path(a) / f).read_bytes() == (Path(b) / f).read_bytes() for f in fa)


def _decodes_to(path: str, want, rows=None, cols=None) -> bool:
    """The store at `path` holds `want` (scipy) with these row / column names."""
    from legume_tpu_torch.data.sparse_io import open_sparse_matrix

    b = open_sparse_matrix(path)
    got = b.read_columns_csc(np.arange(b.num_columns))
    ok = got.shape == want.shape and (got != want).nnz == 0
    if rows is not None:
        ok = ok and b.row_names() == list(rows)
    if cols is not None:
        ok = ok and b.column_names() == list(cols)
    return bool(ok)


def start_beans_sim(work: str, sim, *, factors: int = 8, batches: int = 2, seed: int = 42):
    """Start phase 28's `data-beans-sim topic` with phase 2's arguments and
    seed in a process of its own (`SIM_CLI`)."""
    d, n = sim.counts.shape
    proc = subprocess.Popen(
        [sys.executable, "-c", SIM_CLI, "topic", "--rows", str(d), "--cols", str(n), "--factors",
         str(factors), "--batches", str(batches), "--seed", str(seed), "--output",
         f"{work}/beans_sim"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        cwd=Path(__file__).resolve().parent)
    CHILDREN.append(proc)
    return proc, time.time()


def beans_sim_phase(work: str, sim, store: str, started, card: str, *, factors: int = 8) -> dict:
    """Phase 28: `data-beans-sim topic` through the port's CLI with phase
    2's arguments and seed (started by `start_beans_sim`): its store
    byte-equal to phase 21's x.zarr (so it decodes equal), its batch and
    prop files written."""
    from legume_tpu_torch.utils.output import read_table, table_path

    proc, t_start = started
    out_text, err = proc.communicate()
    if proc.returncode != 0:
        raise AssertionError(f"data-beans-sim topic failed: {err[-2000:]}")
    line = json.loads(out_text.strip().splitlines()[-1])
    waited_s = time.time() - t_start
    out = f"{work}/beans_sim"
    same = _same_files(f"{out}.zarr", store)
    batch = np.loadtxt(f"{out}.batch.gz", dtype=np.int64)
    prop = read_table(table_path(f"{out}.prop"))
    d, n = sim.counts.shape
    print(json.dumps({
        "phase": "data_beans_sim_topic", "cells": n, "genes": d, "run_s": line["run_s"],
        "simulate_s": line["run_s"] - line["write_s"], "write_s": line["write_s"],
        "since_start_s": waited_s, "store_bytes": _store_bytes(f"{out}.zarr"),
        "store_equals_phase21_x_zarr": same, "batch_equal": bool(np.array_equal(batch, sim.batch)),
        "prop_columns": len(prop), "launches": line["launches"], "card": card,
    }), flush=True)
    if not same or not np.array_equal(batch, sim.batch) or len(prop) != factors + 1:
        raise AssertionError("data-beans-sim topic: store, batch or prop unlike phase 2's")
    return {"data_beans_sim_topic": line["launches"]}


def _add_counts(total: dict, counts: dict) -> dict:
    for k, v in counts.items():
        total[k] = total.get(k, 0) + v
    return total


def _cli_chains(chains: dict, workers: int = 8, after: dict | None = None
                ) -> tuple[dict, float, dict]:
    """Chains of port CLI commands (`CLI_COUNTED`, each in a process of its
    own, each first importing torch): the chains side by side, at most
    `workers` at a time (one a core of the card's host), each
    chain's commands in order, a chain named in `after` starting once the
    chains it lists have ended. Returns (each command's seconds, the wall
    seconds of them all, the kernel launches the commands reported, summed);
    a failed command raises with the end of its standard error."""
    import concurrent.futures as cf
    import threading

    secs: dict = {}
    launches: dict = {}
    lock = threading.Lock()
    root = Path(__file__).resolve().parent
    after = after or {}
    ended = {name: threading.Event() for name in chains}

    def chain(key, steps):
        for dep in after.get(key, ()):
            ended[dep].wait()
        try:
            run_steps(steps)
        finally:
            ended[key].set()

    def run_steps(steps):
        for name, argv in steps:
            t0 = time.time()
            p = subprocess.run([sys.executable, "-c", CLI_COUNTED, *argv],
                               capture_output=True, text=True, cwd=root)
            secs[name] = time.time() - t0
            if p.returncode != 0:
                raise AssertionError(f"{' '.join(argv[:2])} failed: {p.stderr[-1500:]}")
            with lock:
                _add_counts(launches, json.loads(p.stdout.strip().splitlines()[-1]))

    # chains that wait are submitted last, so a waiting thread holds no
    # worker a runnable chain needs
    order = sorted(chains, key=lambda k: k in after)
    t0 = time.time()
    with cf.ThreadPoolExecutor(workers) as ex:
        for fut in [ex.submit(chain, k, chains[k]) for k in order]:
            fut.result()
    return secs, time.time() - t0, launches


def beans_phase(work: str, sim, store: str, K, dev, card: str, *, sub_cells: int = 20_000,
                subset_cells: int = 5000, subset_genes: int = 500, take: int = 100,
                meanwhile=None) -> dict:
    """Phase 29: `data-beans` through the port's CLI, each output held
    against scipy on phase 2's matrix in memory: on x.zarr `info`, `stat`,
    `list-zarr`, `qc` on the card against a `--device cpu` run (keep masks
    equal, totals within 1e-6 relative), `histogram`, `subsample`, `subset`
    and `take-*`; on the subsample the store rewrites (`sort-rows`,
    `reorder`, `squeeze`, `convert`, the halves' `merge-backend`, `align`).
    The commands on the card (`qc`, `histogram`) and the printing ones run
    in this process; the ones that write stores run as port CLI processes
    (`CLI_COUNTED`), eight at a time, each after the commands whose outputs
    it reads, phase 30's `to-mtx` of the subsample among them, while this
    thread runs `meanwhile` (another phase). Returns the launches of every
    command, those of the processes as each reported them."""
    import pandas as pd

    from legume_tpu_torch.cli.main import run_beans

    X = sim.counts.tocsc()
    d, n = X.shape
    genes, cells = list(sim.row_names), list(sim.col_names)
    secs, checks = {}, {}
    rng = np.random.default_rng(29)
    K.reset_launch_counts()

    def cmd(name, argv):
        text, secs[name] = _cli(run_beans, argv)
        return text

    text = cmd("info", ["info", store])
    checks["info"] = text.split() == ["rows:", str(d), "cols:", str(n), "nnz:", str(X.nnz)]
    st = json.loads(cmd("stat", ["stat", store]))
    checks["stat"] = (st["nnz"] == X.nnz and abs(st["total"] - float(X.sum())) <= 1e-6 * st["total"]
                      and st["zero_rows"] == int((np.asarray(X.sum(1)).ravel() == 0).sum()))
    lz = cmd("list_zarr", ["list-zarr", store]).splitlines()
    checks["list_zarr"] = f"/by_column/data  [array {X.nnz} float32]" in lz
    qc = {}
    for name, device in (("qc_card", str(dev)), ("qc_cpu", "cpu")):
        cmd(name, ["qc", store, "--output", f"{work}/{name}", "--feature-min-cells", "10",
                   "--report", "--device", device])
        qc[name] = pd.read_parquet(f"{work}/{name}.qc.parquet")
    g, c = qc["qc_card"], qc["qc_cpu"]
    tot = np.asarray(X.sum(0)).ravel()
    qc_rel = float(np.max(np.abs(g.total.to_numpy() - c.total.to_numpy()) / np.maximum(c.total, 1)))
    checks["qc"] = (bool(np.array_equal(g.keep, c.keep)) and qc_rel <= 1e-6
                    and bool(np.allclose(g.total, tot, rtol=1e-6, atol=0))
                    and Path(f"{work}/qc_card.qc.features.parquet").exists()
                    and Path(f"{work}/qc_card.qc.report.json").exists())
    hist = cmd("histogram", ["histogram", store, "--device", str(dev)])
    checks["histogram"] = f"median total: {np.median(tot):.0f}" in hist
    launches = dict(K.launch_counts)

    # the name files the store-writing commands take; the rewrites of a
    # whole store read the subsample (`subsample --seed 7`'s cells)
    sc = np.sort(rng.choice(n, subset_cells, replace=False))
    sg = np.sort(rng.choice(d, subset_genes, replace=False))
    tc = rng.choice(n, take, replace=False)
    tg = rng.choice(d, take, replace=False)
    pick = np.sort(np.random.default_rng(7).choice(n, sub_cells, replace=False))
    sub, Xs, scells = f"{work}/sub20k.zarr", X[:, pick], [cells[j] for j in pick]
    half = len(pick) // 2
    row_tot = np.asarray(Xs.sum(1)).ravel()
    cut = float(np.median(row_tot))
    ga, gb = np.arange(0, 3 * d // 4), np.arange(d // 4, d)
    ca, cb = np.arange(0, half), np.arange(half, len(pick))
    w = lambda name, lines: _write_lines(f"{work}/{name}.txt", lines)  # noqa: E731
    b = ["data-beans"]
    chains = {
        # phase 30's `to-mtx` of the subsample (gzip level 9) and `convert`
        # to .zarr.zip and back (on x.zarr it took 80 s of the phase's wall)
        # run on the subsample, each after it, beside the rest
        "subsample": [("subsample", b + ["subsample", store, "--output", sub,
                                         "--cells", str(sub_cells), "--seed", "7"])],
        "convert": [("convert_zip", b + ["convert", sub, "--output", f"{work}/conv.zarr.zip"]),
                    ("convert_back", b + ["convert", f"{work}/conv.zarr.zip", "--output",
                                          f"{work}/conv_back.zarr"])],
        "to_mtx": [("to_mtx", b + ["to-mtx", sub, "--output", f"{work}/m20k"])],
        "subset": [("subset", b + ["subset", store, "--output", f"{work}/subset.zarr", "--columns",
                                   w("subset.cols", [cells[j] for j in rng.permutation(sc)]),
                                   "--rows", w("subset.rows", [genes[i] for i in
                                                               rng.permutation(sg)])])],
        "take": [("take_columns", b + ["take-columns", store, "--columns",
                                       w("take.cols", [cells[j] for j in tc]), "--output",
                                       f"{work}/take_cols.tsv"]),
                 ("take_rows", b + ["take-rows", store, "--rows",
                                    w("take.rows", [genes[i] for i in tg]), "--output",
                                    f"{work}/take_rows.tsv"])],
        "sort_rows": [("sort_rows", b + ["sort-rows", sub, "--rows",
                                         w("genes.rev", genes[::-1]), "--output",
                                         f"{work}/sorted.zarr"])],
        "reorder": [("reorder", b + ["reorder", sub, "--columns", w("cells.rev", scells[::-1]),
                                     "--output", f"{work}/reordered.zarr"])],
        "squeeze": [("squeeze", b + ["squeeze", sub, "--output", f"{work}/squeezed.zarr",
                                     "--min-row-total", str(cut)])],
        **{f"half{i}": [(f"subset_half{i}", b + ["subset", sub, "--output",
                                                  f"{work}/half{i}.zarr", "--columns",
                                                  w(f"half{i}", part)])]
           for i, part in enumerate((scells[:half], scells[half:]))},
        "merge": [("merge_backend", b + ["merge-backend", f"{work}/half0.zarr",
                                         f"{work}/half1.zarr", "--output", f"{work}/merged.zarr"])],
        **{f"al{t}": [(f"subset_align{t}", b + ["subset", sub, "--output", f"{work}/al{t}.zarr",
                                                "--columns", w(f"al{t}.c", [scells[j] for j in cj]),
                                                "--rows", w(f"al{t}.r", [genes[i] for i in gi])])]
           for t, gi, cj in (("A", ga, ca), ("B", gb, cb))},
        "align": [("align", b + ["align", f"{work}/alA.zarr", f"{work}/alB.zarr"])],
    }
    # each command that reads another's output waits for it; the others
    # (and the chains' first commands) run eight at a time from the start
    after = {k: ["subsample"] for k in ("convert", "to_mtx", "sort_rows", "reorder", "squeeze",
                                        "half0", "half1", "alA", "alB")}
    after.update(merge=["half0", "half1"], align=["alA", "alB"])
    import concurrent.futures as cf

    with cf.ThreadPoolExecutor(1) as ex:
        fut = ex.submit(_cli_chains, chains, after=after)
        if meanwhile is not None:
            meanwhile()
        run_secs, wall_s, sub_launches = fut.result()
    secs.update(run_secs)
    _add_counts(launches, sub_launches)

    checks["subsample"] = _decodes_to(sub, Xs, genes, scells)
    checks["subset"] = _decodes_to(f"{work}/subset.zarr", X[sg][:, sc], [genes[i] for i in sg],
                                   [cells[j] for j in sc])
    a = pd.read_csv(f"{work}/take_cols.tsv", sep="\t", index_col=0)
    bt = pd.read_csv(f"{work}/take_rows.tsv", sep="\t", index_col=0)
    checks["take"] = (list(a.columns) == [cells[j] for j in tc]
                      and np.array_equal(a.to_numpy(), X[:, tc].toarray())
                      and list(bt.columns) == [genes[i] for i in tg]
                      and np.array_equal(bt.to_numpy(), X[tg].toarray().T))
    checks["sort_rows"] = _decodes_to(f"{work}/sorted.zarr", Xs[::-1], genes[::-1], scells)
    checks["reorder"] = _decodes_to(f"{work}/reordered.zarr", Xs[:, ::-1], genes, scells[::-1])
    kept = np.flatnonzero(row_tot >= cut)
    checks["squeeze"] = _decodes_to(f"{work}/squeezed.zarr", Xs[kept], [genes[i] for i in kept],
                                    scells)
    checks["convert"] = _decodes_to(f"{work}/conv.zarr.zip", Xs, genes, scells) and _same_files(
        f"{work}/conv_back.zarr", sub)
    checks["merge_backend"] = _decodes_to(
        f"{work}/merged.zarr", Xs, genes, [f"{c}@0" for c in scells[:half]]
        + [f"{c}@1" for c in scells[half:]])
    pos = np.argsort(np.asarray(genes), kind="stable")  # the aligned row order: sorted names
    union = [genes[i] for i in pos]
    ok = True
    for t, gi, cj in (("A", ga, ca), ("B", gb, cb)):
        keep = np.zeros(d, bool)
        keep[gi] = True
        want = Xs[:, cj][pos].multiply(keep[pos][:, None]).tocsc()
        want.eliminate_zeros()
        ok = ok and _decodes_to(f"{work}/al{t}.aligned", want, union, [scells[j] for j in cj])
    checks["align"] = bool(ok)
    print(json.dumps({"phase": "data_beans", "cells": n, "genes": d, "nnz": int(X.nnz),
                      "seconds": secs, "store_commands_wall_s": wall_s, "checks": checks,
                      "qc_total_rel_err_card_vs_cpu": qc_rel, "qc_kept": int(g.keep.sum()),
                      "launches": launches, "card": card}), flush=True)
    failed = [k for k, v in checks.items() if not v]
    if failed:
        raise AssertionError(f"data-beans outputs unlike scipy's: {failed}")
    return {"data_beans": launches}


def _xenium_store(root: str, csr, genes: list, chunk: int = 1 << 20) -> str:
    """A raw CSR zarr v2 store in the Xenium cell_feature_matrix layout
    (indptr over the features, indices the cells; zlib, C order), written
    with numpy and zlib."""
    import zlib

    def put(field, arr):
        adir = Path(root) / "cell_features" / field
        adir.mkdir(parents=True, exist_ok=True)
        arr = np.ascontiguousarray(arr)
        c = min(chunk, max(arr.shape[0], 1))
        meta = {"zarr_format": 2, "shape": list(arr.shape), "chunks": [c, *arr.shape[1:]],
                "dtype": arr.dtype.str, "compressor": {"id": "zlib", "level": 1},
                "fill_value": 0, "order": "C", "filters": None}
        (adir / ".zarray").write_text(json.dumps(meta))
        for i, c0 in enumerate(range(0, arr.shape[0], c)):
            block = np.zeros((c, *arr.shape[1:]), arr.dtype)
            part = arr[c0 : c0 + c]
            block[: len(part)] = part
            key = ".".join([str(i)] + ["0"] * (arr.ndim - 1))
            (adir / key).write_bytes(zlib.compress(block.tobytes(), 1))

    m = csr
    put("data", m.data.astype(np.float32))
    put("indices", m.indices.astype(np.uint32))
    put("indptr", m.indptr.astype(np.uint32))
    put("cell_id", np.stack([np.arange(m.shape[1], dtype=np.uint32),
                             np.ones(m.shape[1], np.uint32)], 1))
    (Path(root) / "cell_features" / ".zattrs").write_text(json.dumps(
        {"feature_keys": genes, "feature_ids": genes,
         "feature_types": ["Gene Expression"] * len(genes)}))
    (Path(root) / ".zgroup").write_text('{"zarr_format": 2}')
    return root


def ingest_phase(work: str, sim, res, store: str, card: str, *, mtx_cells: int = 20_000,
                 triplet_cells: int = 2000, fragments: int = 1_000_000,
                 fragment_cells: int = 2000) -> dict:
    """Phase 30: on phase 29's subsampled cells (`mtx_cells`) and their `to-mtx`
    files (written in phase 29's window, its seconds in that line),
    `from-mtx` and `from-mtx --streaming` (both byte-equal to the source
    store; the native parser required), `merge-mtx` of two such files,
    `from-triplets` on a parquet of 2,000 cells' transcripts, `from-zarr`
    on a Xenium-layout zarr v2 store of those cells, `from-fragments`
    on simulated fragments over 2,000 cells to tiles, and the other
    `data-beans-sim` commands (`multimodal`, `multiome`, `faba` at their
    defaults, `bulk` of x.zarr with phase 2's top topic as labels, `topic
    --reference` phase 29's subset store at the default 1,000 cells), all
    as port CLI processes (`CLI_COUNTED`), eight at a time in one pool
    (their inputs are written first); the h5py commands skipped where h5py
    does not import, and said so.
    Returns the launches the processes reported, summed."""
    import gzip

    import pandas as pd
    import scipy.sparse as sp

    from legume_tpu_torch.cli.main import run_beans
    from legume_tpu_torch.data import ioaccel
    from legume_tpu_torch.data.sparse_io import open_sparse_matrix

    parser = ioaccel.parser()
    print(json.dumps({"phase": "ioaccel", "parser": parser, "card": card}), flush=True)
    if parser != "native":
        raise AssertionError("the native MatrixMarket parser did not build")
    checks = {}
    t_inputs = time.time()
    src = f"{work}/sub20k.zarr"
    sb = open_sparse_matrix(src)
    S = sb.read_columns_csc(np.arange(sb.num_columns))
    genes, cells = sb.row_names(), sb.column_names()
    d, n = S.shape
    if n != mtx_cells:
        raise AssertionError(f"phase 29's subsample holds {n} cells, not {mtx_cells}")
    m = f"{work}/m20k"
    # one row per transcript of the first 2,000 cells
    T = S[:, :triplet_cells].tocoo()
    reps = T.data.astype(np.int64)
    g_names, c_names = np.asarray(genes, dtype=object), np.asarray(cells, dtype=object)
    pd.DataFrame({"feature_name": np.repeat(g_names[T.row], reps),
                  "cell_id": np.repeat(c_names[T.col], reps)}).to_parquet(f"{work}/tx.parquet")
    _xenium_store(f"{work}/cfm.zarr", S.tocsr(), genes)
    # fragments: chrom, start, end, barcode, count over 5 chromosomes
    rng = np.random.default_rng(30)
    chrom = rng.integers(1, 6, fragments)
    start = rng.integers(0, 5_000_000, fragments)
    length = rng.integers(50, 600, fragments)
    bc = rng.integers(0, fragment_cells, fragments)
    cnt = rng.integers(1, 4, fragments)
    text = "\n".join(f"chr{a}\t{s}\t{s + ln}\tBC{b:05d}\t{c}"
                     for a, s, ln, b, c in zip(chrom, start, length, bc, cnt)) + "\n"
    Path(f"{work}/frags.tsv.gz").write_bytes(gzip.compress(text.encode(), 1))
    del text
    labels = np.asarray(res["latent"]).argmax(1)
    pd.DataFrame({"cell": list(sim.col_names), "label": [f"t{k}" for k in labels]}).to_csv(
        f"{work}/labels.tsv", sep="\t", index=False)
    inputs_s = time.time() - t_inputs

    names = ["--rows", f"{m}.features.tsv.gz", "--cols", f"{m}.barcodes.tsv.gz"]
    b, s_ = ["data-beans"], ["data-beans-sim"]
    # the commands that do not read the MatrixMarket files, then the three
    # that do
    jobs = {
        "from_triplets": b + ["from-triplets", "--table", f"{work}/tx.parquet", "--output",
                              f"{work}/tx.zarr"],
        "from_zarr": b + ["from-zarr", f"{work}/cfm.zarr", "--output", f"{work}/fz.zarr"],
        "from_fragments": b + ["from-fragments", "--fragments", f"{work}/frags.tsv.gz",
                               "--output", f"{work}/frags.zarr", "--tile-size", "5000"],
        **{f"sim_{x}": s_ + [x, "--output", f"{work}/sim_{x}"]
           for x in ("multimodal", "multiome", "faba")},
        "sim_bulk": s_ + ["bulk", "--backend", store, "--labels", f"{work}/labels.tsv",
                          "--output", f"{work}/sim_bulk"],
        # the copula's NB quantiles run gene by gene on the host (scipy), so
        # its reference is phase 29's 5,000-cell x 500-gene subset
        "sim_topic_reference": s_ + ["topic", "--reference", f"{work}/subset.zarr", "--output",
                                     f"{work}/sim_copula"],
    }
    mtx_jobs = {
        "from_mtx": b + ["from-mtx", "--mtx", f"{m}.matrix.mtx.gz", *names, "--output",
                         f"{work}/fm.zarr"],
        "from_mtx_streaming": b + ["from-mtx", "--mtx", f"{m}.matrix.mtx.gz", *names, "--output",
                                   f"{work}/fms.zarr", "--streaming"],
        "merge_mtx": b + ["merge-mtx", f"{m}.matrix.mtx.gz", f"{m}.matrix.mtx.gz", "--rows",
                          f"{m}.features.tsv.gz", "--cols", f"{m}.barcodes.tsv.gz",
                          f"{m}.barcodes.tsv.gz", "--output", f"{work}/mm.zarr"],
    }
    # one pool of eight for all eleven: the three MatrixMarket readers take
    # the first workers free
    secs, wall_s, launches = _cli_chains({k: [(k, v)] for k, v in {**jobs, **mtx_jobs}.items()})

    checks["from_mtx"] = _same_files(f"{work}/fm.zarr", src)
    checks["from_mtx_streaming"] = _same_files(f"{work}/fms.zarr", src)
    checks["merge_mtx"] = _decodes_to(f"{work}/mm.zarr", sp.hstack([S, S], format="csc"), genes,
                                      cells + [f"{c}@1" for c in cells])
    go, co = np.argsort(g_names[:d]), np.argsort(c_names[:triplet_cells])
    Ts = S[:, :triplet_cells].tocsc()
    used_g = np.asarray(Ts.sum(1)).ravel()[go] > 0
    used_c = np.asarray(Ts.sum(0)).ravel()[co] > 0
    want = Ts[go][:, co][used_g][:, used_c]
    checks["from_triplets"] = _decodes_to(f"{work}/tx.zarr", want, list(g_names[go][used_g]),
                                          list(c_names[:triplet_cells][co][used_c]))
    fz = open_sparse_matrix(f"{work}/fz.zarr")
    got = fz.read_columns_csc(np.arange(fz.num_columns))
    checks["from_zarr"] = bool(got.shape == S.shape and (got != S).nnz == 0
                               and fz.row_names() == genes)
    fb = open_sparse_matrix(f"{work}/frags.zarr")
    F = fb.read_columns_csc(np.arange(fb.num_columns)).tocoo()
    tile = (start + start + length) // 2 // 5000
    rname = np.asarray(fb.row_names(), dtype=object)[F.row]
    cname = np.asarray(fb.column_names(), dtype=object)[F.col]
    got = pd.DataFrame({"r": rname, "c": cname, "v": F.data}).groupby(["r", "c"]).v.sum()
    exp = pd.DataFrame({"r": [f"chr{a}:{t * 5000}-{(t + 1) * 5000}" for a, t in zip(chrom, tile)],
                        "c": [f"BC{b:05d}" for b in bc], "v": cnt}).groupby(["r", "c"]).v.sum()
    checks["from_fragments"] = bool(fb.num_columns == len(np.unique(bc))
                                    and got.sort_index().equals(exp.sort_index().astype(got.dtype)))
    checks["sim_multimodal"] = all(Path(f"{work}/sim_multimodal.mod{i}.zarr").exists()
                                   for i in (0, 1))
    checks["sim_multiome"] = Path(f"{work}/sim_multiome.genes.gff").exists()
    checks["sim_faba"] = open_sparse_matrix(f"{work}/sim_faba.zarr").num_rows == 100
    fr = pd.read_parquet(f"{work}/sim_bulk.fractions.parquet").iloc[:, 1:].to_numpy()
    bulk = pd.read_parquet(f"{work}/sim_bulk.bulk.parquet")
    checks["sim_bulk"] = bool(np.allclose(fr.sum(1), 1.0)
                              and bulk.shape == (20, sim.counts.shape[0] + 1))
    ref = open_sparse_matrix(f"{work}/subset.zarr")
    cb = open_sparse_matrix(f"{work}/sim_copula.zarr")
    checks["sim_topic_reference"] = (cb.shape == (ref.num_rows, 1000)
                                     and cb.row_names() == ref.row_names())
    print(json.dumps({"phase": "ingest", "cells": n, "genes": d, "nnz": int(S.nnz),
                      "mtx_gz_bytes": Path(f"{m}.matrix.mtx.gz").stat().st_size,
                      "transcripts": int(reps.sum()), "fragments": fragments,
                      "fragment_cells": fragment_cells, "inputs_s": inputs_s, "seconds": secs,
                      "commands_wall_s": wall_s, "checks": checks, "launches": launches,
                      "card": card}), flush=True)
    h5_cmds = ["from-h5ad", "from-10x-matrix", "from-10x-molecule", "to-h5ad", "list-h5"]
    if importlib.util.find_spec("h5py") is None:
        print(json.dumps({"phase": "beans_h5", "h5py_importable": False, "skipped": h5_cmds,
                          "card": card}), flush=True)
    else:
        _, t_h5 = _cli(run_beans, ["to-h5ad", src, "--output", f"{work}/s.h5ad"])
        _, t_back = _cli(run_beans, ["from-h5ad", "--h5ad", f"{work}/s.h5ad", "--output",
                                     f"{work}/h5back.zarr"])
        checks["h5ad_round_trip"] = _same_files(f"{work}/h5back.zarr", src)
        print(json.dumps({"phase": "beans_h5", "h5py_importable": True,
                          "seconds": {"to_h5ad": t_h5, "from_h5ad": t_back},
                          "round_trip_equal": checks["h5ad_round_trip"],
                          "not_run": h5_cmds[1:3] + h5_cmds[4:], "card": card}), flush=True)
    failed = [k for k, v in checks.items() if not v]
    if failed:
        raise AssertionError(f"ingestion outputs unlike their sources: {failed}")
    return {"ingest": launches}


def gff_phase(work: str, kept: dict, K, dev, card: str) -> dict:
    """Phase 31: `cocoa diff --gff` on phase 15's cells with a GFF written
    from the gene positions of phase 15's `truth.tsv` (TSS on the +
    strand at each position), reusing phase 15's match cache: its gene
    order and CNV states (and states table) equal the `--cnv-ground-truth`
    run's, its cn_score bit for bit, and K1 launches as often;
    `senna plot-strand` where matplotlib imports, else skipped and said."""
    import pandas as pd

    from legume_tpu_torch.cli.main import run_cocoa, run_senna
    from legume_tpu_torch.utils.output import read_table, table_path

    c = kept["cocoa"]
    stem, ref = c["stem"], c["res"]
    gff = f"{work}/genes.gff3"
    with open(f"{work}/truth.tsv") as f, open(gff, "w") as g:
        next(f)
        g.write("##gff-version 3\n")
        for line in f:
            i, chrom, pos = line.split()
            g.write(f"{chrom}\tsim\tgene\t{int(pos) + 1}\t{int(pos) + 800}\t.\t+\t.\t"
                    f"ID=gene:g{i};Name=g{i}\n")
    K.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    res = run_cocoa(["diff", "--data-files", stem, "--out", f"{stem}.gff.de", "--indv",
                     f"{stem}.indv.txt", "--exposure", f"{work}/exposure.tsv",
                     "--topic-assignment", f"{stem}.types.txt", "--permutations", "12",
                     "--gff", gff, "--cnv-ref-iters", str(COCOA_REF_ITERS), "--device",
                     str(dev)], vec=c["vec"])
    _sync(dev)
    run_s = time.time() - t0
    launches = _launched(K, ("project_normed",), "cocoa diff --gff")
    a, b = res["cnv"], ref["cnv"]
    same_order = bool(np.array_equal(a.order.ordered, b.order.ordered))
    states_equal = bool(np.array_equal(a.states, b.states))
    score_err = float(np.abs(a.cn_score - b.cn_score).max())
    tabs = [read_table(table_path(f"{p}.cnv.states")) for p in (f"{stem}.gff.de", f"{stem}.de")]
    tables_equal = tabs[0].keys() == tabs[1].keys() and all(
        np.array_equal(tabs[0][k], tabs[1][k]) for k in tabs[1])
    same_k1 = launches["project_normed"] == c["launches"]["project_normed"]
    print(json.dumps({
        "phase": "cocoa_diff_gff", "cells": c["vec"].num_columns, "run_s": run_s,
        "timings": res["timings"], "launches": launches,
        "k1_launches_truth_run": c["launches"]["project_normed"],
        "match_cache_reused": bool(res["timings"].get("match_cache_reused", False)),
        "gene_order_equal": same_order, "cnv_states_equal": states_equal,
        "cn_score_max_abs_diff": score_err, "cnv_states_tables_equal": tables_equal,
        "peak_device_bytes": torch.cuda.max_memory_allocated(), "card": card,
    }), flush=True)
    if not (same_order and states_equal and score_err == 0.0 and tables_equal and same_k1
            and res["timings"].get("match_cache_reused")):
        raise AssertionError("cocoa diff --gff unlike the --cnv-ground-truth run")
    if importlib.util.find_spec("matplotlib") is None:
        print(json.dumps({"phase": "plot_strand", "matplotlib_importable": False,
                          "skipped": ["senna plot-strand"], "card": card}), flush=True)
    else:
        eff = np.abs(res["effect"])
        pd.DataFrame({"gene": [f"g{i}" for i in range(len(eff))], "effect": eff}).to_parquet(
            f"{work}/activity.parquet")
        t0 = time.time()
        outs = run_senna(["plot-strand", "--activity", f"{work}/activity.parquet", "--gff", gff,
                          "--out", f"{work}/strand"])
        print(json.dumps({"phase": "plot_strand", "matplotlib_importable": True,
                          "seconds": time.time() - t0, "images": len(outs), "card": card}),
              flush=True)
    return {"diff_gff": launches}


# ---- phases 32-34: faba's BAM path, faba gem, faba dyn-assoc ----------------

# ~1.25M UMIs, ~2.5M reads: the host process beside phases 17-31 took
# 320-400 s at twice that, its load slowing the phases it runs beside
BAM_CELLS, BAM_GENES, BAM_UMIS = 2000, 2000, 625


def start_bam(work: str, *, cells: int = BAM_CELLS, genes: int = BAM_GENES,
              umis: int = BAM_UMIS):
    """Start phase 32's host half (`BAM_CLI`) in a process of its own."""
    Path(f"{work}/bam").mkdir(exist_ok=True)
    proc = subprocess.Popen(
        [sys.executable, "-c", BAM_CLI, f"{work}/bam", str(cells), str(genes), str(umis)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        cwd=Path(__file__).resolve().parent)
    CHILDREN.append(proc)
    return proc, time.time(), cells, genes


def bam_phase(work: str, started, card: str) -> dict:
    """Phase 32: the BAM's `faba index` (a rebuild gives the same bytes)
    and `faba genes` with and without `--splice` and with `--gene-qc`, from
    `start_bam`'s process: each store equal to the planted counts after
    UMI dedup, exactly (the QC run's on the genes and cells it kept). Then
    fault fix 1 on a small BAM: rewritten after its index, a ranged read
    rebuilds the index and equals the full scan."""
    import os

    import pandas as pd
    import scipy.sparse as sp

    from legume_tpu_torch.data.sparse_io import open_sparse_matrix
    from legume_tpu_torch.faba import bam as tbam
    from legume_tpu_torch.faba.bam_sim import simulate_10x_bam

    proc, t_start, cells, genes = started
    t0 = time.time()
    out, err = proc.communicate(timeout=900)
    wait_s = time.time() - t0
    if proc.returncode != 0:
        raise AssertionError(f"the BAM process failed: {err[-2000:]}")
    res = json.loads(out.strip().splitlines()[-1])
    d = f"{work}/bam"
    names = json.load(open(f"{d}/planted.json"))
    ps = sp.load_npz(f"{d}/planted_spliced.npz").tocsc()
    pu = sp.load_npz(f"{d}/planted_unspliced.npz").tocsc()
    checks = {
        "genes": _decodes_to(f"{d}/genes", ps + pu, names["genes"], names["barcodes"]),
        "spliced": _decodes_to(f"{d}/genes_splice.spliced", ps, names["genes"], names["barcodes"]),
        "unspliced": _decodes_to(f"{d}/genes_splice.unspliced", pu, names["genes"],
                                 names["barcodes"]),
    }
    qc = pd.read_parquet(f"{d}/genes_qc.cell_qc.parquet")
    kept_genes = open_sparse_matrix(f"{d}/genes_qc").row_names()
    gk = np.isin(names["genes"], kept_genes)
    ck = qc["keep"].to_numpy()
    checks["gene_qc"] = _decodes_to(f"{d}/genes_qc", (ps + pu)[gk][:, ck],
                                    np.asarray(names["genes"])[gk],
                                    np.asarray(names["barcodes"])[ck])
    mito_dropped = sum(g not in kept_genes for g in names["genes"][-13:])
    # fault fix 1: a small BAM rewritten after its index
    small = f"{work}/bam/small.bam"
    simulate_10x_bam(small, f"{work}/bam/small.gff", n_cells=60, n_genes=40, seed=1)
    tbam.build_bam_index(small)
    simulate_10x_bam(small, f"{work}/bam/small.gff", n_cells=120, n_genes=40, seed=2)
    t_bam = os.path.getmtime(small)
    os.utime(small + ".bai", (t_bam - 10, t_bam - 10))
    full = tbam.read_bam(small)
    got = tbam.read_bam(small, region=("chr1", 0, 1 << 30))
    m = full.ref_id == 0
    checks["stale_index_rebuilt"] = bool(np.array_equal(got.pos, full.pos[m])
                                         and os.path.getmtime(small + ".bai") >= t_bam)
    checks["reindex_equal"] = bool(res["reindex_equal"])
    line = {
        "phase": "faba_bam", "cells": cells, "genes": genes, "reads": res["n_reads"],
        "umis": res["n_umis"], "bam_bytes": os.path.getsize(f"{d}/run.bam"),
        "process_s": time.time() - t_start, "wait_s": wait_s,
        "seconds": {k: v for k, v in res.items() if k.endswith("_s")},
        "reads_per_s": {k: res["n_reads"] / res[f"{k}_s"]
                        for k in ("genes", "genes_splice", "genes_qc")},
        "gene_qc_kept": [int(gk.sum()), int(ck.sum())], "mito_genes_dropped": mito_dropped,
        "checks": checks, "launches": res["launches"], "card": card,
    }
    print(json.dumps(line), flush=True)
    if not all(checks.values()):
        raise AssertionError(f"faba genes / index unlike the planted counts: {checks}")
    return {"faba_genes": res["launches"]}


def _frame(path: str) -> np.ndarray:
    import pandas as pd

    return pd.read_parquet(path).iloc[:, 1:].to_numpy(np.float64)


def _gem_outputs_ok(prefix: str) -> bool:
    names = ("gene_embedding", "velocity", "gene_velocity", "latent", "cell_embedding",
             "feature_embedding")
    return all(np.isfinite(_frame(f"{prefix}.{n}.parquet")).all() for n in names)


def gem_phase(work: str, sim, store: str, K, dev, card: str, checks: dict, *,
              thin: float = 0.3) -> dict:
    """Phase 33: (a) `faba gem --raw` at the CLI defaults on phase 2's
    cells (x.zarr) and a seeded binomial thinning of them as the unspliced
    store: K1 launched ceil(N / 2,048) times, outputs finite, the loss
    falling, K1 held at gem's block; (b) `--posterior 4`, (c)
    `--lineage-dag` and (d) `gem-encoder` at its defaults on (a)'s
    pseudobulk stores (the sums of (a)'s partition, so (b) and (c) refit
    (a)'s fit from the same inputs); (e) `faba gem --raw` on phase 32's
    spliced / unspliced stores. Returns each run's launches and what
    phase 34 reads."""
    import math

    import pandas as pd
    import scipy.sparse as sp

    from legume_tpu_torch.cli.main import run_faba
    from legume_tpu_torch.data.sparse_io import create_sparse_from_csc, open_sparse_matrix
    from legume_tpu_torch.data.visitors import visit_columns_by_block
    from legume_tpu_torch.ops.random_projection import block_to_device, projection_basis

    t0 = time.time()
    c = sim.counts.tocsc()
    u = c.copy()
    u.data = np.random.default_rng(33).binomial(c.data.astype(np.int64), thin).astype(np.float32)
    u.eliminate_zeros()
    ustore = f"{work}/unspliced.zarr"
    create_sparse_from_csc(u, ustore, sim.row_names, sim.col_names)
    thin_s = time.time() - t0
    n = c.shape[1]
    runs: dict = {}
    launches: dict = {}

    def gem(name, argv, need=()):
        K.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        timings = run_faba(argv + ["--output", f"{work}/{name}", "--device", str(dev)])
        _sync(dev)
        launches[name] = _launched(K, need, f"faba {name}")
        runs[name] = {"run_s": time.time() - t0, "timings": timings,
                      "peak_device_bytes": torch.cuda.max_memory_allocated()}
        losses = timings["losses"]
        ok = _gem_outputs_ok(f"{work}/{name}") and losses[-1] < losses[0]
        print(json.dumps({"phase": f"faba_{name}", **runs[name], "launches": launches[name],
                          "outputs_finite_loss_falls": ok, "card": card}), flush=True)
        if not ok:
            raise AssertionError(f"faba {name}: outputs not finite or the loss did not fall")
        return timings

    # (a) --raw at the defaults
    gem("gem_raw", ["gem", "--spliced", store, "--unspliced", ustore, "--raw"],
        need=("project_normed",))
    want = math.ceil(n / 2048)
    if launches["gem_raw"]["project_normed"] != want:
        raise AssertionError(f"faba gem --raw: K1 {launches['gem_raw']['project_normed']} "
                             f"launches, want {want}")
    be = open_sparse_matrix(store)
    blk = next(iter(visit_columns_by_block(be, block_size=2048)))
    basis = torch.from_numpy(projection_basis(be.num_rows, 16, 0)).to(dev)
    r = check_projection(K, basis, *block_to_device(blk, dev), normed=True,
                         shape="faba gem --raw block (2,048 cells, K = 16)")
    checks["project_normed"].append({**r, "path": "gem_raw", "launches_in_e2e": want})
    print(json.dumps({"phase": "kernel_check", "kernel": "project_normed", **r, "card": card}),
          flush=True)

    # (a)'s pseudobulk stores
    groups = np.load(f"{work}/gem_raw.partition.npz")["fine_groups"]
    onehot = sp.csr_matrix((np.ones(n, np.float32), (np.arange(n), groups)))
    pbn = [f"pb{j}" for j in range(onehot.shape[1])]
    for nm, m in (("pb_s.zarr", c), ("pb_u.zarr", u)):
        create_sparse_from_csc(sp.csc_matrix(m @ onehot), f"{work}/{nm}", sim.row_names, pbn)
    pb_in = ["--spliced", f"{work}/pb_s.zarr", "--unspliced", f"{work}/pb_u.zarr"]
    # (b) --posterior 4 on (a)'s fit
    t = gem("gem_posterior", ["gem", "--posterior", "4"] + pb_in)
    post = pd.read_parquet(f"{work}/gem_posterior.delta_posterior.parquet")
    pips = post[["delta_pip", "beta_pip"]].to_numpy()
    fit_gap = float(np.abs(_frame(f"{work}/gem_posterior.gene_embedding.parquet")
                           - _frame(f"{work}/gem_raw.gene_embedding.parquet")).max())
    sweeps = 8 + max(8 // 4, 2)
    post_line = {"phase": "faba_gem_posterior_check", "sweeps": sweeps,
                 "s_per_sweep": t["posterior_s"] / sweeps, "rhat_max": t["posterior_rhat_max"],
                 "pip_range": [float(pips.min()), float(pips.max())],
                 "fit_gap_to_a": fit_gap, "card": card}
    print(json.dumps(post_line), flush=True)
    if not (pips.min() >= 0 and pips.max() <= 1 and np.isfinite(t["posterior_rhat_max"])
            and fit_gap <= 1e-5):
        raise AssertionError(f"faba gem --posterior: {post_line}")
    # (c) --lineage-dag
    gem("gem_lineage", ["gem", "--lineage-dag"] + pb_in)
    pt = pd.read_parquet(f"{work}/gem_lineage.dag_pseudotime.parquet")
    fate = _frame(f"{work}/gem_lineage.dag_fate.parquet")
    if not (pt.pseudotime.between(0, 1).all() and np.isfinite(fate).all()):
        raise AssertionError("faba gem --lineage-dag: pseudotime outside [0, 1] or fate not finite")
    # (d) gem-encoder at its defaults
    gem("gem_encoder", ["gem-encoder"] + pb_in)
    # (e) from the user's BAM: phase 32's stores
    d = f"{work}/bam"
    gem("gem_bam", ["gem", "--raw", "--spliced", f"{d}/genes_splice.spliced", "--unspliced",
                    f"{d}/genes_splice.unspliced"], need=("project_normed",))
    print(json.dumps({"phase": "faba_gem", "cells": n, "genes": c.shape[0],
                      "unspliced_thinning": thin, "thin_and_write_s": thin_s,
                      "pseudobulks": len(pbn), "k1_launches": launches["gem_raw"]["project_normed"],
                      "card": card}), flush=True)
    # phase 34's pseudotime: (c)'s dag pseudotime lifted to (a)'s cells
    cell_pt = pt.set_index("cell").loc[pbn, "pseudotime"].to_numpy()[groups]
    return {"launches": launches, "cell_pseudotime": cell_pt}


def assoc_phase(work: str, cell_pt: np.ndarray, K, dev, card: str, *, genes: int = 500,
                cells: int = 20_000) -> dict:
    """Phase 34: `faba dyn-assoc` on a `data-beans-sim faba` sites store
    (`genes` x 2 sites, `cells` cells) with `--from` a pseudotime the port
    wrote (phase 33c's dag pseudotime over (a)'s first `cells` cells),
    once with `--trend-method bayes` and once with the quasi-binomial GAM
    (its IRLS on the card): finite outputs, p-values in [0, 1]."""
    import pandas as pd

    from legume_tpu_torch.cli.main import run_faba, run_sim

    t0 = time.time()
    run_sim(["faba", "--genes", str(genes), "--cols", str(cells), "--seed", "34", "--output",
             f"{work}/sites"])
    sim_s = time.time() - t0
    pd.DataFrame({"cell": [f"cell{i}" for i in range(cells)],
                  "pseudotime": cell_pt[:cells]}).to_parquet(f"{work}/lift.pseudotime.parquet")
    launches = {}
    for name, extra in (("assoc_bayes", ["--trend-method", "bayes"]),
                        ("assoc_gam", ["--trend-method", "quasi"])):
        K.reset_launch_counts()
        t0 = time.time()
        run_faba(["dyn-assoc", "--backend", f"{work}/sites.zarr", "--from", f"{work}/lift",
                  "--output", f"{work}/{name}", "--device", str(dev)] + extra)
        _sync(dev)
        launches[name] = dict(K.launch_counts)
        df = pd.read_parquet(f"{work}/{name}.assoc.parquet")
        num = df.select_dtypes("number").to_numpy(np.float64)
        ok = bool(np.isfinite(num).all() and df.pvalue.between(0, 1).all() and len(df) > 0)
        print(json.dumps({"phase": f"faba_dyn_{name}", "sites": len(df), "cells": cells,
                          "simulate_s": sim_s, "run_s": time.time() - t0, "launches": launches[name],
                          "finite_p_in_unit": ok, "card": card}), flush=True)
        if not ok:
            raise AssertionError(f"faba dyn-assoc ({name}): non-finite output or p outside [0, 1]")
    return launches


def qc_card_vs_cpu(store: str, dev, cells: int = 4000) -> dict:
    """Phase 27's QC check: `compute_cell_qc` on the first 4,000 cells of
    x.zarr (13 genes named `MT-`) on the card and on the CPU."""
    from legume_tpu_torch.data import MemoryBackend
    from legume_tpu_torch.data.qc import compute_cell_qc
    from legume_tpu_torch.data.sparse_io import open_sparse_matrix

    b = open_sparse_matrix(store)
    names = [f"MT-{g}" if i < 13 else g for i, g in enumerate(b.row_names())]
    mb = MemoryBackend(b.read_columns_csc(np.arange(cells)), names, b.column_names()[:cells])
    q = {d: compute_cell_qc(mb, ribo_pattern="^g1", device=d) for d in (str(dev), "cpu")}
    g, c = q[str(dev)], q["cpu"]
    err = max(float(np.max(np.abs(getattr(g, f) - getattr(c, f))
                           / np.maximum(np.abs(getattr(c, f)), 1e-12)))
              for f in ("total", "n_genes", "mito_frac", "ribo_frac"))
    kw = dict(min_genes=5, max_mito_frac=float(np.quantile(c.mito_frac, 0.9)))
    return {"qc_cells": cells, "qc_stat_rel_err": err,
            "qc_masks_equal": bool(np.array_equal(g.keep_mask(**kw), c.keep_mask(**kw)))}


# ---- phases 35-36: pinto -----------------------------------------------------

# Planted-domain spatial cells (`simulate_spatial`): a 3 mm section placed
# millimetres from the origin (µm, as Xenium or MERFISH write them), the
# 377 genes of 10x's Xenium Human Multi-Tissue and Cancer panel, 10
# domains of 20 marker genes each, 100-250 transcripts a cell.
PINTO_CELLS, PINTO_GENES, PINTO_DOMAINS, PINTO_MARKERS = 100_000, 377, 10, 20
PINTO_CROP, PINTO_CPU_CROP = 20_000, 4_000
PINTO_ETM_EPOCHS = 3  # lc-etm's depth (the CLI's default is 60)
PINTO_ARI_BAND = 0.95  # card against CPU, edge labels (the CPU tests' bar)
# planted domains recovered: each domain's cells in one community. Both
# packages' samplers merge domains (4 of 10 communities used on 3,000 of
# these cells on the CPU, the same labels in each), so the ARI is
# reported and completeness is held (0.99 there).
PINTO_COMPLETENESS = 0.9

# Phase 35's simulation in a process of its own, started before phase 32 so
# that the host makes it while the card runs phases 32-34 (started before
# phase 2 it slowed bge's host Leiden beside it).
PINTO_SIM = r"""
import json, sys, time
import numpy as np
import scipy.sparse as sp
from chip_smoke import simulate_spatial
work, cells, genes, domains = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4])
t = time.time()
sim = simulate_spatial(cells, genes, domains)
sp.save_npz(f"{work}/counts.npz", sim.pop("counts"))
np.savez(f"{work}/sim.npz", **sim)
print(json.dumps({"simulate_s": time.time() - t}))
"""


def simulate_spatial(cells: int, genes: int, domains: int, *, markers: int = PINTO_MARKERS,
                     seed: int = 14) -> dict:
    """Cells uniform over a 3 mm square at (4, 6) mm; each in the domain of
    its nearest of `domains` random centres (Voronoi); counts Poisson of
    100-250 transcripts a cell over its domain's program (a shared Gamma
    background, the domain's `markers` genes six times as high). The last
    two genes are a planted ligand -> receptor pair: the ligand in 5% of
    cells (senders), the receptor in each sender's 5 nearest neighbours."""
    import scipy.sparse as sp
    from scipy.spatial import cKDTree

    rng = np.random.default_rng(seed)
    origin = np.array([4000.0, 6000.0])
    coords = origin + rng.uniform(0.0, 3000.0, (cells, 2))
    centres = origin + rng.uniform(300.0, 2700.0, (domains, 2))
    domain = cKDTree(centres).query(coords)[1]
    base = rng.gamma(2.0, 0.5, genes)
    prog = np.tile(base, (domains, 1))
    for c in range(domains):
        prog[c, c * markers : (c + 1) * markers] *= 6.0
    lig, rec = genes - 2, genes - 1
    prog[:, [lig, rec]] *= 0.1
    prog /= prog.sum(1, keepdims=True)
    lib = rng.integers(100, 251, cells)
    counts = np.empty((cells, genes), np.float32)
    for lb in range(0, cells, 20_000):
        ub = min(lb + 20_000, cells)
        counts[lb:ub] = rng.poisson(prog[domain[lb:ub]] * lib[lb:ub, None])
    senders = rng.random(cells) < 0.05
    nbr = cKDTree(coords).query(coords[senders], k=6)[1][:, 1:]
    receivers = np.zeros(cells, bool)
    receivers[nbr.ravel()] = True
    counts[senders, lig] += rng.poisson(8.0, int(senders.sum()))
    counts[receivers, rec] += rng.poisson(4.0, int(receivers.sum()))
    return {"counts": sp.csc_matrix(counts.T), "coords": coords, "domain": domain,
            "ligand": lig, "receptor": rec}


def start_pinto_sim(work: str, *, cells: int = PINTO_CELLS, genes: int = PINTO_GENES,
                    domains: int = PINTO_DOMAINS):
    Path(f"{work}/pinto").mkdir(exist_ok=True)
    proc = subprocess.Popen(
        [sys.executable, "-c", PINTO_SIM, f"{work}/pinto", str(cells), str(genes), str(domains)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        cwd=Path(__file__).resolve().parent)
    CHILDREN.append(proc)
    return proc, time.time()


def ari(a, b) -> float:
    """Adjusted Rand index of two labelings."""
    _, ia = np.unique(np.asarray(a), return_inverse=True)
    _, ib = np.unique(np.asarray(b), return_inverse=True)
    table = np.zeros((ia.max() + 1, ib.max() + 1))
    np.add.at(table, (ia, ib), 1)

    def pairs(x):
        return x * (x - 1) / 2.0

    s_ij, s_a, s_b = pairs(table).sum(), pairs(table.sum(1)).sum(), pairs(table.sum(0)).sum()
    expected = s_a * s_b / pairs(len(ia))
    return float((s_ij - expected) / (0.5 * (s_a + s_b) - expected))


def completeness(labels, planted) -> float:
    """The share of cells in their planted domain's majority community:
    1 when every domain lies inside one community (communities may merge
    domains; the collapsed sampler leaves some of its K unused)."""
    labels, planted = np.asarray(labels), np.asarray(planted)
    hits = sum(np.bincount(labels[planted == p]).max() for p in np.unique(planted))
    return float(hits / len(planted))


def _spatial_vec(csc, genes, cells):
    from legume_tpu_torch.data import MemoryBackend, SparseIoVec

    vec = SparseIoVec()
    vec.push(MemoryBackend(csc, genes, cells))
    return vec


def _crop(coords: np.ndarray, n: int) -> np.ndarray:
    """The `n` cells nearest the section's centre in the max norm (a
    square window), in their original order."""
    centre = (coords.min(0) + coords.max(0)) / 2
    return np.sort(np.argsort(np.abs(coords - centre).max(1), kind="stable")[:n])


def _coords_tsv(path: str, cells, coords) -> str:
    with open(path, "w") as f:
        f.write("".join(f"{c}\t{x:.3f}\t{y:.3f}\n" for c, (x, y) in zip(cells, coords)))
    return path


def pinto_phase(work: str, started, K, dev, card: str, checks: dict, *,
                crop: int = PINTO_CROP, cpu_crop: int = PINTO_CPU_CROP) -> dict:
    """Phase 35: `pinto lc` at its CLI defaults on the planted cells, its
    stages, kernel launches and plane; K2 and K3 at the sweep's shapes;
    two card runs bit-equal on a crop; the card against the CPU on a
    smaller crop."""
    import scipy.sparse as sp

    from legume_tpu_torch.cli.main import run_pinto
    from legume_tpu_torch.ops.gamma import digamma
    from legume_tpu_torch.ops.gene_stats import nb_fisher_weights
    from legume_tpu_torch.pinto import lc as tlc
    from legume_tpu_torch.utils import prng

    proc, t_start = started
    t0 = time.time()
    out, err = proc.communicate(timeout=900)
    wait_s = time.time() - t0
    if proc.returncode != 0:
        raise AssertionError(f"the pinto simulation failed: {err[-2000:]}")
    d = f"{work}/pinto"
    csc = sp.load_npz(f"{d}/counts.npz").tocsc()
    sim = dict(np.load(f"{d}/sim.npz"))
    coords, domain = sim["coords"], sim["domain"]
    n, ng = csc.shape[1], csc.shape[0]
    genes = [f"g{i}" for i in range(ng)]
    genes[int(sim["ligand"])], genes[int(sim["receptor"])] = "LIG", "REC"
    cells = [f"c{j}" for j in range(n)]
    vec = _spatial_vec(csc, genes, cells)
    xy = _coords_tsv(f"{d}/xy.tsv", cells, coords)
    print(json.dumps({"phase": "pinto_sim", "cells": n, "genes": ng, "nnz": int(csc.nnz),
                      "transcripts_per_cell": float(csc.sum() / n),
                      "process_s": time.time() - t_start, "wait_s": wait_s,
                      **json.loads(out.strip().splitlines()[-1]), "card": card}), flush=True)

    planes = []
    build = tlc.SweepPlane.from_csr
    tlc.SweepPlane.from_csr = staticmethod(lambda p, device: planes.append(build(p, device))
                                           or planes[-1])
    try:
        K.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        res = run_pinto(["lc", "--data-files", "mem", "--coords", xy, "--out", f"{d}/lc",
                         "--device", str(dev)], vec=vec)
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches = dict(K.launch_counts)
        peak = torch.cuda.max_memory_allocated()
    finally:
        tlc.SweepPlane.from_csr = build
    plane = planes[-1]
    sweeps = len(res.scores_trace)
    cell_ari = ari(res.propensity.argmax(1), domain)
    cell_comp = completeness(res.propensity.argmax(1), domain)
    line = {
        "phase": "pinto_lc", "cells": n, "edges": plane.n_edges, "profile_nnz": res.profile_nnz,
        "plane_bytes": plane.nbytes, "peak_device_bytes": peak, "wall_s": wall,
        "timings": res.timings, "sweeps": sweeps,
        "phases": {p: sum(1 for q, _ in res.scores_trace if q == p) for p in ("gibbs", "em")},
        "launches": launches, "cell_ari_vs_planted": cell_ari,
        "domain_completeness": cell_comp,
        "communities_used": int(len(np.unique(res.edge_labels))),
        "trace_first_last": [res.scores_trace[0][1], res.scores_trace[-1][1]], "card": card,
    }
    print(json.dumps(line), flush=True)
    if launches["collapse"] != 2 * sweeps or launches["project_raw"] != sweeps:
        raise AssertionError(f"pinto lc: {sweeps} sweeps but launches {launches}")
    if not (np.isfinite(res.propensity).all() and cell_comp >= PINTO_COMPLETENESS):
        raise AssertionError(f"pinto lc: planted domains not recovered ({cell_comp})")

    # K3 (the community sums and sizes) and K2 (the scores) at the sweep's shapes
    lab = torch.from_numpy(res.edge_labels.astype(np.int32)).to(dev)
    k = 10
    for row in (
        check_collapse(K, plane.rows, plane.ptr, plane.vals, lab, num_genes=plane.n_genes,
                       num_groups=k, shape=f"pinto lc sweep [{plane.n_genes} x {plane.n_edges}] "
                                           f"-> {k} communities"),
        check_collapse(K, plane.tot_rows, plane.tot_ptr, plane.edge_tot, lab, num_genes=1,
                       num_groups=k, shape=f"pinto lc community sizes [1 x {plane.n_edges}]"),
    ):
        row.update(path="pinto_lc", launches_in_e2e=launches["collapse"])
        checks["collapse"].append(row)
        print(json.dumps({"kernel_check": "collapse", "card": card, **row}), flush=True)
    cnt = K.collapse(plane.rows, plane.ptr, plane.vals, lab, num_genes=plane.n_genes, num_groups=k)
    size = K.collapse(plane.tot_rows, plane.tot_ptr, plane.edge_tot, lab, num_genes=1,
                      num_groups=k)[0]
    log_rate = (digamma(1.0 + cnt) - torch.log(1.0 + size)[None, :]).contiguous()
    row = check_projection(K, log_rate, plane.rows, plane.ptr, plane.vals, normed=False,
                           shape=f"pinto lc sweep scores [{plane.n_edges} x {plane.n_genes}] "
                                 f"x [{plane.n_genes} x {k}]")
    row.update(path="pinto_lc", launches_in_e2e=launches["project_raw"])
    checks["project_raw"].append(row)
    print(json.dumps({"kernel_check": "project_raw", "card": card, **row}), flush=True)
    del planes, plane, lab, cnt, size, log_rate

    # two card runs on a crop bit-equal; the card against the CPU on a smaller one
    sel = _crop(coords, crop)
    cvec = _spatial_vec(csc[:, sel], genes, [cells[i] for i in sel])
    w = nb_fisher_weights(cvec, device=dev)
    runs = []
    for _ in range(2):
        t0 = time.time()
        r = tlc.fit_link_community(cvec, coords[sel], gene_weights=w, device=dev)
        runs.append((r, time.time() - t0))
    same = (np.array_equal(runs[0][0].edge_labels, runs[1][0].edge_labels)
            and runs[0][0].scores_trace == runs[1][0].scores_trace)
    small = _crop(coords, cpu_crop)
    svec = _spatial_vec(csc[:, small], genes, [cells[i] for i in small])
    sw = nb_fisher_weights(svec, device="cpu")
    on = {}
    for where in ("card", "cpu"):
        t0 = time.time()
        on[where] = (tlc.fit_link_community(svec, coords[small], gene_weights=sw,
                                            device=dev if where == "card" else "cpu"),
                     time.time() - t0)
    g, c = on["card"][0], on["cpu"][0]
    vs_cpu = {"edges_equal": bool(np.array_equal(g.edges, c.edges)),
              "edge_label_ari": ari(g.edge_labels, c.edge_labels) if len(g.edges) == len(c.edges)
              else None,
              "labels_differ": int((g.edge_labels != c.edge_labels).sum())
              if len(g.edges) == len(c.edges) else None,
              "cell_ari_vs_planted": [ari(x.propensity.argmax(1), domain[small]) for x in (g, c)],
              "seconds": [on["card"][1], on["cpu"][1]]}
    # the sweep's Gumbel noise takes XLA's CPU log (`prng.log_f32_rows`) on
    # the card too; how often would the card's own `torch.log` differ?
    keys = prng.split(prng.key(7), 2)
    u = prng.uniform_keys(keys, 2_000_000, dev, float(np.finfo(np.float32).tiny), 1.0)
    log_differs = int((torch.log(u).view(torch.int32)
                       != prng.log_f32_rows(u).view(torch.int32)).sum())
    print(json.dumps({"phase": "pinto_lc_repeat_and_cpu", "crop": crop, "bit_equal": same,
                      "torch_log_differs": [log_differs, int(u.numel())],
                      "seconds": [s for _, s in runs], "edges": len(runs[0][0].edges),
                      "cpu_crop": cpu_crop, "card_vs_cpu": vs_cpu, "card": card}), flush=True)
    if not same:
        raise AssertionError("pinto lc: two card runs differ")
    if not (vs_cpu["edges_equal"] and vs_cpu["edge_label_ari"] >= PINTO_ARI_BAND):
        raise AssertionError(f"pinto lc: the card unlike the CPU {vs_cpu}")
    return {"kept": dict(csc=csc, genes=genes, cells=cells, coords=coords, domain=domain,
                         sel=sel, lig=int(sim["ligand"]), rec=int(sim["receptor"])),
            "launches": {"pinto_lc": launches}}


def pinto_commands_phase(work: str, kept: dict, K, dev, card: str, checks: dict, *,
                         etm_epochs: int = PINTO_ETM_EPOCHS) -> dict:
    """Phase 36: the other `pinto` commands on phase 35's crop through the
    port's CLI entry (cells in memory), each with its counts zeroed just
    before and read just after; K1 and K4 held at cage's shapes."""
    import pandas as pd

    from legume_tpu_torch.cli.main import run_pinto
    from legume_tpu_torch.data.visitors import visit_columns_by_block
    from legume_tpu_torch.ops.random_projection import block_to_device, projection_basis
    from legume_tpu_torch.senna.fne import fne_plane
    from legume_tpu_torch.utils.prng import DEFAULT_PROJECTION_SEED

    d = f"{work}/pinto"
    sel, genes = kept["sel"], kept["genes"]
    cells = [kept["cells"][i] for i in sel]
    csc = kept["csc"][:, sel]
    vec = _spatial_vec(csc, genes, cells)
    domain = kept["domain"][sel]
    xy = _coords_tsv(f"{d}/crop.tsv", cells, kept["coords"][sel])
    m = PINTO_MARKERS
    net = _write_lines(f"{d}/modules.tsv", [f"{genes[c * m + i]}\t{genes[c * m + i + s]}"
                                           for c in range(PINTO_DOMAINS)
                                           for i in range(m - 2) for s in (1, 2)])
    gmt = _write_lines(f"{d}/markers.gmt", [f"domain{c}\tplanted\t" + "\t".join(genes[c * m:(c + 1) * m])
                                           for c in range(PINTO_DOMAINS)])
    pairs = _write_lines(f"{d}/lr.tsv", ["LIG\tREC", f"{genes[0]}\tREC"])
    runs = [
        ("pinto_cascade", ["cascade"], ("collapse", "project_raw")),
        ("pinto_gene_network", ["lc", "--gene-network", net], ("collapse", "project_raw")),
        ("pinto_prop", ["prop"], ("project_normed",)),
        ("pinto_dsvd", ["dsvd"], ()),
        ("pinto_cage", ["cage"], ("project_normed", "nce_epoch")),
        ("pinto_lc_etm", ["lc-etm", "--epochs", str(etm_epochs)], ("collapse_gather",)),
        ("pinto_lra", ["lra", "--pairs", pairs], ()),
    ]
    launches, lines, results = {}, {}, {}
    for name, argv, need in runs:
        out = f"{d}/{name}"
        K.reset_launch_counts()
        t0 = time.time()
        results[name] = run_pinto([argv[0], "--data-files", "mem", "--coords", xy, "--out", out,
                                   "--device", str(dev), *argv[1:]], vec=vec)
        torch.cuda.synchronize()
        lines[name] = {"seconds": time.time() - t0}
        launches[name] = _launched(K, need, name)
    gn = results["pinto_gene_network"]
    lines["pinto_gene_network"]["cell_ari_vs_planted"] = ari(gn.propensity.argmax(1), domain)
    for name, prefix in (("pinto_cascade", "edges"), ("pinto_prop", "edges"),
                         ("pinto_lc_etm", "edges")):
        ed = pd.read_parquet(f"{d}/{name}.{prefix}.parquet")
        lines[name]["edges"] = len(ed)
    prop = pd.read_parquet(f"{d}/pinto_prop.propensity.parquet")
    lines["pinto_prop"]["cell_ari_vs_planted"] = ari(prop.iloc[:, 1:].to_numpy().argmax(1), domain)
    etm = pd.read_parquet(f"{d}/pinto_lc_etm.propensity.parquet").iloc[:, 1:].to_numpy()
    lines["pinto_lc_etm"]["cell_ari_vs_planted"] = ari(etm.argmax(1), domain)
    fac = pd.read_parquet(f"{d}/pinto_dsvd.pair_factors.parquet")
    lines["pinto_dsvd"]["factors_finite"] = bool(np.isfinite(fac.iloc[:, 2:].to_numpy()).all())
    lra = pd.read_parquet(f"{d}/pinto_lra.lra.parquet")
    lines["pinto_lra"]["pvalues"] = lra["pvalue"].tolist()
    cage_lat = pd.read_parquet(f"{d}/pinto_cage.latent.parquet")
    cage_edges = pd.read_parquet(f"{d}/pinto_cage.edges.parquet")
    lines["pinto_cage"]["gated_edges"] = len(cage_edges)
    if launches["pinto_cage"]["nce_epoch"] != 500:
        raise AssertionError(f"cage: {launches['pinto_cage']['nce_epoch']} K4 launches, not 500")

    K.reset_launch_counts()
    t0 = time.time()
    run_pinto(["annotate", "--data-files", "mem", "--edges", f"{d}/pinto_gene_network.edges.parquet",
               "--markers", gmt, "--out", f"{d}/pinto_annotate"], vec=vec)
    ann = pd.read_parquet(f"{d}/pinto_annotate.annotation.parquet")
    lines["pinto_annotate"] = {"seconds": time.time() - t0, "annotations": ann["annotation"].tolist()}
    launches["pinto_annotate"] = dict(K.launch_counts)
    if importlib.util.find_spec("matplotlib") is None:
        lines["pinto_figures"] = {"matplotlib_importable": False,
                                  "skipped": ["pinto interfaces", "pinto p"]}
    else:
        t0 = time.time()
        run_pinto(["interfaces", "--coords", xy, "--propensity",
                   f"{d}/pinto_gene_network.propensity.parquet", "--edges",
                   f"{d}/pinto_gene_network.edges.parquet", "--out", f"{d}/pinto_interfaces"])
        run_pinto(["p", "--coords", xy, "--from", f"{d}/pinto_gene_network", "--out",
                   f"{d}/pinto_figures"])
        lines["pinto_figures"] = {"matplotlib_importable": True, "seconds": time.time() - t0}
    print(json.dumps({"phase": "pinto_commands", "cells": len(cells), **lines,
                      "launches": launches, "card": card}), flush=True)
    # the gene-swap null draws from the ligand's (mean, Moran's I) bin, about
    # 20 of these 377 genes, so p = 1 / (1 + draws) ~ 0.05 is its floor: the
    # planted pair is held to p <= 0.05 (every draw below it), the control
    # pair above
    ok = (lra["pvalue"].iloc[0] <= 0.05 < lra["pvalue"].iloc[1]
          and lines["pinto_dsvd"]["factors_finite"]
          and np.isfinite(cage_lat.iloc[:, 1:].to_numpy()).all()
          and np.isfinite(etm).all() and any(a.startswith("domain") for a in ann["annotation"]))
    if not ok:
        raise AssertionError(f"pinto commands: {lines}")

    # K1 and K4 at cage's shapes: its projection's first block, its fne plane
    basis = torch.from_numpy(projection_basis(csc.shape[0], 30, DEFAULT_PROJECTION_SEED)).to(dev)
    blk = next(iter(visit_columns_by_block(vec, block_size=8192)))
    row = check_projection(K, basis, *block_to_device(blk, dev), normed=True,
                           shape=f"pinto cage projection block ({blk.ncols} cells, K = 30)")
    row.update(path="pinto_cage", launches_in_e2e=launches["pinto_cage"]["project_normed"])
    checks["project_normed"].append(row)
    print(json.dumps({"kernel_check": "project_normed", "card": card, **row}), flush=True)
    names, plane, q = fne_plane(list(zip(cage_edges["src"], cage_edges["dst"],
                                         cage_edges["weight"])), 0.75)
    emb = cage_lat.iloc[:, 1:].to_numpy(np.float32)[np.asarray(names, np.int64)]
    c = torch.from_numpy(plane).to(dev)
    e = torch.from_numpy(np.ascontiguousarray(emb)).to(dev)
    b = torch.zeros(len(names), device=dev)
    row = check_nce(K, c, torch.from_numpy(q).to(dev), e, b, e, b, c.sum(1),
                    shape=f"pinto cage fne plane, tied ({len(names)} x {len(names)}, "
                          f"H = {e.shape[1]})")
    row.update(path="pinto_cage", launches_in_e2e=launches["pinto_cage"]["nce_epoch"])
    checks["nce_epoch"].append(row)
    print(json.dumps({"kernel_check": "nce_epoch", "card": card, **row}), flush=True)
    return launches


# ---- phases 37-38: fagioli and chickpea ------------------------------------
FAGIOLI_LOCUS = (503, 2000)  # 1000 Genomes' EUR panel x a 2,000-variant locus
FAGIOLI_SMALL = (200, 150)  # the locus held card against CPU
FAGIOLI_L = 5  # map-sumstat's default L; the locus plants 3 causal variants
FAGIOLI_MCMC = (100, 50)  # fit-sumstat-mcmc's samples and burn-in (CLI: 1,000 and 200)
SGVB_STEP_PROBE = 200  # steps timed for the milliseconds of one SGVB step
SGVB_CARD_BAND = 1e-3  # small locus: max |PIP card - PIP CPU| after map-sumstat's 1,500 steps
COHORT = {"indv": 200, "cells_per_indv": 500, "genes": 2000, "types": 5}
QTL_EGENES = 1  # fit-qtl-sgvb's eGenes, at the CLI's 600 steps and grid of 3
MULTIOME = {"cols": 20_000, "peaks": 2_000, "genes": 30, "factors": 8}
P2G_STEPS, P2G_CIS_WINDOW = 300, 20_000  # tests/test_cli_surface.py's p2g settings
# the LD eigenspace's rank, capped at the pseudobulks less one: at the
# CLI's 20 (of ~140 pseudobulks) the driving peak's median PIP percentile
# is 0.5 on these cells (0.9 at full rank; the JAX package's the same)
P2G_RANK = 200
P2G_PERCENTILE = 0.7  # the driving peak's median PIP percentile (tests/test_cli_surface.py)

# A port CLI command that does no device work, in a process of its own, then
# its seconds as the last line of its standard output.
TIMED_CLI = r"""
import json, sys, time
from legume_tpu_torch.cli.main import main
t = time.time(); rc = main(sys.argv[1:])
print(json.dumps({"run_s": time.time() - t}))
sys.exit(rc)
"""


def start_genetics_sims(work: str, *, locus=FAGIOLI_LOCUS, small=FAGIOLI_SMALL, cohort=COHORT,
                        multiome=MULTIOME) -> dict:
    """Phases 37-38's inputs through the port's simulators, each in a process
    of its own: the locus and the small locus (`fagioli sim-sumstat`, 3
    shared causal variants in 3 LD blocks), the cohort (`fagioli sim-qtl`)
    and the paired cells (`data-beans-sim multiome`)."""
    d = Path(f"{work}/genetics")
    d.mkdir(exist_ok=True)

    def sumstat(n, p, out, seed):
        return ["fagioli", "sim-sumstat", "--out", f"{d}/{out}", "--n", str(n), "--p", str(p),
                "--num-causal-blocks", "3", "--num-independent-causal", "0", "--seed", str(seed)]

    cmds = {
        "locus": sumstat(*locus, "locus", 15),
        "small": sumstat(*small, "small", 16),
        "cohort": ["fagioli", "sim-qtl", "--out", f"{d}/cohort", "--indv", str(cohort["indv"]),
                   "--cells-per-indv", str(cohort["cells_per_indv"]), "--genes",
                   str(cohort["genes"]), "--num-cell-types", str(cohort["types"]), "--seed", "15"],
        "multiome": ["data-beans-sim", "multiome", "--cols", str(multiome["cols"]), "--peaks",
                     str(multiome["peaks"]), "--genes", str(multiome["genes"]), "--factors",
                     str(multiome["factors"]), "--output", f"{d}/mo"],
    }
    started = {}
    for name, argv in cmds.items():
        proc = subprocess.Popen([sys.executable, "-c", TIMED_CLI, *argv], stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True,
                                cwd=Path(__file__).resolve().parent)
        CHILDREN.append(proc)
        started[name] = (proc, time.time())
    return started


def _simulated(started: dict, name: str) -> dict:
    """Wait for simulation `name`: its own seconds and the seconds from its
    start to the end of the wait."""
    proc, t0 = started[name]
    out, err = proc.communicate()
    if proc.returncode != 0:
        raise AssertionError(f"{name} simulation failed: {err[-1500:]}")
    return {"run_s": json.loads(out.strip().splitlines()[-1])["run_s"],
            "since_start_s": time.time() - t0}


class first_calls:
    """Within the block, the first call of `K.project` per basis shape and of
    `K.collapse` per (genes, groups) are kept as the main path makes them
    (`seen[name][key] = (args, keywords)`), to hold those calls' shapes
    against the plain versions afterwards."""

    def __init__(self, K):
        self.K, self.seen = K, {"project": {}, "collapse": {}}

    def __enter__(self):
        self.orig = {n: getattr(self.K, n) for n in self.seen}

        def spy(name):
            def call(*a, **kw):
                key = tuple(a[0].shape) if name == "project" else (kw["num_genes"],
                                                                   kw["num_groups"])
                keep = {k: v for k, v in kw.items() if k not in ("out", "also_count")}
                self.seen[name].setdefault(key, (a, keep))
                return self.orig[name](*a, **kw)
            return call

        for n in self.seen:
            setattr(self.K, n, spy(n))
        return self.seen

    def __exit__(self, *exc):
        for n, fn in self.orig.items():
            setattr(self.K, n, fn)


def _held_collapse(K, seen, checks, path: str, launches: int, what: str):
    for (genes, groups), (a, kw) in seen["collapse"].items():
        rows, ptr, vals, seg = a[:4]
        checks["collapse"].append({
            **check_collapse(K, rows, ptr, vals, seg, num_genes=genes, num_groups=groups,
                             shape=f"{what} ({genes} rows x {ptr.shape[0] - 1} cells -> "
                                   f"{groups} groups, {rows.shape[0]} nonzeros)"),
            "path": path, "launches_in_e2e": launches,
        })


def _recovered(pip: np.ndarray, causal) -> bool:
    """Each causal variant, or one within 2 positions of it, in the top-5
    PIPs (tests/test_sgvb.py's bar)."""
    top = np.argsort(-pip)[:5]
    return all(np.min(np.abs(top - c)) <= 2 for c in causal)


def fagioli_phase(work: str, started: dict, K, dev, card: str, checks: dict, *,
                  mcmc=FAGIOLI_MCMC, qtl_genes: int = QTL_EGENES,
                  step_probe: int = SGVB_STEP_PROBE) -> dict:
    """Phase 37: the fine-mapping commands on the locus, the small locus on
    the card against the CPU, then `pseudobulk` and `fit-qtl-sgvb` on the
    cohort, K3 held at their planes."""
    import pandas as pd
    import scipy.sparse as sp

    from legume_tpu_torch.cli.main import run_fagioli
    from legume_tpu_torch.data.sparse_io import create_sparse_from_csc, open_sparse_matrix
    from legume_tpu_torch.models import sgvb

    g = f"{work}/genetics"
    sims = {name: _simulated(started, name) for name in ("locus", "small")}
    loc = f"{g}/locus"
    truth = pd.read_parquet(f"{loc}.truth.parquet")
    causal = np.unique(truth["variant_idx"].to_numpy())
    if not 0 < len(causal) <= FAGIOLI_L:
        raise AssertionError(f"the locus plants {len(causal)} causal variants, L = {FAGIOLI_L}")
    geno = np.load(f"{loc}.geno.npy")
    z = pd.read_csv(f"{loc}.sumstat.tsv", sep="\t")["z"].to_numpy()

    # one SGVB step at the locus: map-sumstat's design, L and family
    design = sgvb.RssDesign.from_genotypes(geno, z)
    fit = lambda n: sgvb.fit_regression(design.x_tilde, design.y_tilde, L=FAGIOLI_L,  # noqa: E731
                                        config=sgvb.SgvbConfig(num_steps=n), device=dev)
    fit(10)
    _sync(dev)
    t0 = time.time()
    fit(step_probe)
    _sync(dev)
    step_ms = (time.time() - t0) / step_probe * 1e3

    inputs = ["--zscores", f"{loc}.sumstat.tsv", "--geno", f"{loc}.geno.npy", "--device",
              str(dev)]
    runs = {
        "map_sumstat": (["map-sumstat"], "finemap"),
        "map_sumstat_multilevel": (["map-sumstat", "--multilevel"], "finemap"),
        "fit_sumstat_sgvb": (["fit-sumstat-sgvb"], "finemap"),
        "fit_sumstat_sgvb_ash": (["fit-sumstat-sgvb", "--prior-type", "ash"], "finemap"),
        "fit_prs_susie": (["fit-prs-susie"], "prs_weights"),
        "fit_sumstat_mcmc": (["fit-sumstat-mcmc", "--samples", str(mcmc[0]), "--burn-in",
                              str(mcmc[1])], "mcmc"),
    }
    secs, recovered, finite = {}, {}, {}
    K.reset_launch_counts()
    for name, (argv, table) in runs.items():
        _, secs[name] = _cli(run_fagioli, argv[:1] + inputs + ["--out", f"{g}/{name}"] + argv[1:])
        frame = pd.read_parquet(f"{g}/{name}.{table}.parquet")
        num = frame.select_dtypes("number").to_numpy()
        finite[name] = bool(len(frame) == geno.shape[1] and np.isfinite(num).all())
        if "pip" in frame and name != "fit_sumstat_sgvb_ash":
            recovered[name] = _recovered(frame["pip"].to_numpy(), causal)
    locus_launches = dict(K.launch_counts)

    # the small locus: the card twice and the CPU once
    sm = ["map-sumstat", "--zscores", f"{g}/small.sumstat.tsv", "--geno", f"{g}/small.geno.npy"]
    pips = {}
    for run_name, d in (("card_a", dev), ("card_b", dev), ("cpu", "cpu")):
        _cli(run_fagioli, sm + ["--out", f"{g}/small_{run_name}", "--device", str(d)])
        pips[run_name] = pd.read_parquet(f"{g}/small_{run_name}.finemap.parquet")["pip"].to_numpy()
    card_cpu = float(np.abs(pips["card_a"] - pips["cpu"]).max())
    card_equal = bool(np.array_equal(pips["card_a"], pips["card_b"]))
    print(json.dumps({
        "phase": "fagioli_locus", "individuals": geno.shape[0], "variants": geno.shape[1],
        "L": FAGIOLI_L, "causal": causal.tolist(), "sgvb_step_ms": step_ms,
        "rss_rank": int(design.x_tilde.shape[0]), "seconds": secs, "recovered": recovered,
        "finite": finite, "mcmc_samples_burn_in": list(mcmc), "launches": locus_launches,
        "small_locus_card_vs_cpu_pip_max_abs": card_cpu, "small_locus_card_bit_equal": card_equal,
        "simulations": sims, "card": card,
    }), flush=True)
    if not all(recovered.values()) or not all(finite.values()):
        raise AssertionError(f"fagioli locus: recovered {recovered}, finite {finite}")
    if not card_equal or not card_cpu <= SGVB_CARD_BAND:
        raise AssertionError(f"small locus: card runs equal {card_equal}, card vs CPU {card_cpu}")

    # the cohort: pseudobulk on every gene, fit-qtl-sgvb on a few eGenes
    sims["cohort"] = _simulated(started, "cohort")
    coh = f"{g}/cohort"
    annot = pd.read_csv(f"{coh}.annotations.tsv.gz", sep="\t", header=None,
                        names=["cell", "individual", "celltype"])
    Path(f"{coh}.indv.txt").write_text("\n".join(annot["individual"]) + "\n")
    K.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    with first_calls(K) as seen:
        _, secs["pseudobulk"] = _cli(run_fagioli, ["pseudobulk", "--backend", f"{coh}.zarr",
                                                   "--indv", f"{coh}.indv.txt", "--out",
                                                   f"{g}/pb", "--device", str(dev)])
    pb_launches = _launched(K, ("collapse",), "fagioli pseudobulk")
    pb_bytes = torch.cuda.max_memory_allocated()
    be = open_sparse_matrix(f"{coh}.zarr")
    n_indv = annot["individual"].nunique()
    pb = pd.read_parquet(f"{g}/pb.pseudobulk.parquet")
    pb_ok = pb.shape == (be.num_rows, n_indv + 1) and np.isfinite(pb.iloc[:, 1:].to_numpy()).all()
    _held_collapse(K, seen, checks, "fagioli_pseudobulk", pb_launches["collapse"],
                   "fagioli pseudobulk")
    del seen

    egenes = list(dict.fromkeys(pd.read_parquet(f"{coh}.truth.parquet")["gene"]))[:qtl_genes]
    names = be.row_names()
    csc = be.read_columns_csc(np.arange(be.num_columns))
    new_row = np.full(csc.shape[0], -1)
    new_row[[names.index(x) for x in egenes]] = np.arange(len(egenes))
    keep = new_row[csc.indices] >= 0  # the eGenes' entries, in column order
    ptr = np.concatenate([[0], np.cumsum(keep)])[csc.indptr]
    create_sparse_from_csc(sp.csc_matrix((csc.data[keep], new_row[csc.indices[keep]], ptr),
                                         shape=(len(egenes), csc.shape[1])),
                           f"{g}/egenes.zarr", egenes, be.column_names())
    K.reset_launch_counts()
    with first_calls(K) as seen:
        _, secs["fit_qtl_sgvb"] = _cli(run_fagioli, [
            "fit-qtl-sgvb", "--backend", f"{g}/egenes.zarr", "--annot",
            f"{coh}.annotations.tsv.gz", "--geno", f"{coh}.geno.npy", "--out", f"{g}/qtl",
            "--device", str(dev)])
    qtl_launches = _launched(K, ("collapse",), "fagioli fit-qtl-sgvb")
    res = pd.read_parquet(f"{g}/qtl.qtl.parquet")
    types = annot["celltype"].nunique()
    truth_q = pd.read_parquet(f"{coh}.truth.parquet")
    hits = 0
    for (gene, ct), sub in res.groupby(["gene", "celltype"]):
        want = set(truth_q[(truth_q["gene"] == gene)
                           & truth_q["celltype"].isin([-1, int(ct[2:])])]["variant"])
        hits += int(sub.loc[sub["pip"].idxmax(), "variant"].lstrip("v")) in want
    qtl_ok = (qtl_launches["collapse"] == types and np.isfinite(res[["pip", "effect"]]).all().all()
              and len(res) > 0)
    _held_collapse(K, seen, checks, "fit_qtl_sgvb", qtl_launches["collapse"],
                   "fagioli fit-qtl-sgvb")
    del seen
    print(json.dumps({
        "phase": "fagioli_cohort", "individuals": n_indv, "cells": be.num_columns,
        "genes": be.num_rows, "cell_types": types, "nnz": int(csc.nnz), "seconds": secs,
        "pseudobulk_launches": pb_launches, "pseudobulk_peak_device_bytes": pb_bytes,
        "pseudobulk_ok": bool(pb_ok), "qtl_genes": egenes, "fit_qtl_sgvb_launches": qtl_launches,
        "fit_qtl_sgvb_tests": len(res), "fit_qtl_sgvb_top_is_causal": hits,
        "fit_qtl_sgvb_fits": int(res.groupby(["gene", "celltype"]).ngroups),
        "simulations": sims, "card": card,
    }), flush=True)
    if not pb_ok or not qtl_ok:
        raise AssertionError(f"fagioli cohort: pseudobulk ok {pb_ok}, fit-qtl-sgvb ok {qtl_ok}")
    return {"fagioli_pseudobulk": pb_launches, "fit_qtl_sgvb": qtl_launches}


def chickpea_phase(work: str, started: dict, K, dev, card: str, checks: dict, *,
                   steps: int = P2G_STEPS) -> dict:
    """Phase 38: `chickpea p2g --pseudobulk --knockoff-fdr 0.2` on the paired
    cells; K1 and K3 launched and held at the run's own first calls; the
    driving peaks rank high."""
    import pandas as pd

    from legume_tpu_torch.cli.main import run_chickpea

    sim = _simulated(started, "multiome")
    g = f"{work}/genetics"
    mo = f"{g}/mo"
    K.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    with first_calls(K) as seen:
        text, secs = _cli(run_chickpea, [
            "p2g", "--rna", f"{mo}.rna.zarr", "--atac", f"{mo}.atac.zarr", "--gff",
            f"{mo}.genes.gff", "--out", f"{g}/p2g", "--pseudobulk", "--knockoff-fdr", "0.2",
            "--cis-window", str(P2G_CIS_WINDOW), "--rank", str(P2G_RANK), "--steps", str(steps),
            "--device", str(dev)])
    launches = _launched(K, ("project_normed", "collapse"), "chickpea p2g --pseudobulk")
    peak_bytes = torch.cuda.max_memory_allocated()
    links = pd.read_parquet(f"{g}/p2g.p2g.parquet")
    truth = pd.read_parquet(f"{mo}.truth.parquet").set_index("gene")["peak"]
    pctls = []
    for gene, grp in links.groupby("gene"):
        m = grp["peak"] == truth.loc[gene]
        if m.any():
            pctls.append(float(grp["pip"].rank(pct=True)[m].iloc[0]))
    med = float(np.median(pctls)) if pctls else 0.0
    for basis_shape, (a, kw) in seen["project"].items():
        checks["project_normed"].append({
            **check_projection(K, *a[:4], normed=True,
                               shape=f"chickpea p2g projection ({a[0].shape[0]} genes, K = "
                                     f"{a[0].shape[1]}, {a[2].shape[0] - 1} cells)"),
            "path": "chickpea_p2g", "launches_in_e2e": launches["project_normed"],
        })
    _held_collapse(K, seen, checks, "chickpea_p2g", launches["collapse"], "chickpea p2g")
    del seen
    print(json.dumps({
        "phase": "chickpea_p2g", "cells": MULTIOME["cols"], "peaks": MULTIOME["peaks"],
        "genes": MULTIOME["genes"], "steps": steps, "rank": P2G_RANK, "seconds": secs,
        "launches": launches,
        "peak_device_bytes": peak_bytes, "said": [ln for ln in text.splitlines() if ln][-3:],
        "links": len(links), "selected": int(links["selected"].sum()),
        "genes_with_truth": len(pctls), "driving_peak_pip_percentile_median": med,
        "simulation": sim, "card": card,
    }), flush=True)
    if len(pctls) < 0.75 * MULTIOME["genes"] or not med > P2G_PERCENTILE:
        raise AssertionError(f"chickpea p2g: {len(pctls)} genes, median percentile {med}")
    return {"chickpea_p2g": launches}


# ---- phase 39: faba all on a planted wild-type / control pair ----------------

# The pair's size: 2,000 cells an arm at ~300 UMIs, 500 genes (two poly(A)
# sites each), ~1.2M reads an arm; a 10x run holds tens of millions of reads
# and ~20,000 genes, so this is ~1/30 of one in reads and 1/40 in genes.
FABA_ALL = {"n_cells": 2000, "n_genes": 500, "umis_per_cell": 300, "atoi_sites": 200,
            "m6a_sites": 200, "snps": 200}
FABA_ALL_DEPTH_KB = 1.0  # --depth-resolution-kb
FABA_PEAK_WINDOW = 30  # run_apa's peak window: the distance that merges read ends
# Bars fixed from the port's CPU run of the same generator (seed 16) at 400
# cells x 100 genes x 300 UMIs, 40 sites of each kind, the same molecules a
# gene (`PERF.md` section 6): recall A-to-G 0.8, C-to-T 0.925 (the misses sit
# at genes of a few reads, two of them under the VAF mask), SNPs 0.975,
# poly(A) sites 0.97 (every called site within 5 bases of a planted one),
# the edits' precision 1.0
FABA_EDIT_RECALL, FABA_EDIT_PRECISION, FABA_SNP_RECALL, FABA_PAS_RECALL = 0.75, 0.95, 0.95, 0.9
# phase 39d's bars: the RAC context's frequencies in the reference PWM; the
# planted edit rates are 0.1-0.3, so at a called site T takes a tenth of
# the column or more in the wild type (0.22 of the pileup's column at this
# size) and sequencing errors alone (1e-3 a base) in the control
FABA_MOTIF_FREQ, FABA_EDIT_SHOWS, FABA_EDIT_ABSENT = 0.9, 0.1, 0.01
# The faba-all process: the pair written with the port's `write_bam`
# (`faba/bam_sim.py::simulate_edit_pair`), its truth pickled, then `faba all`
# through the port's CLI entry (`CLI_COUNTED`, as `python -m legume_tpu_torch`
# runs it), its stage seconds in the run's manifest.
FABA_ALL_CLI = r"""
import json, pickle, subprocess, sys, time
from legume_tpu_torch.faba.bam_sim import simulate_edit_pair
work, size, counted = sys.argv[1], json.loads(sys.argv[2]), sys.argv[3]
t = time.time()
truth = simulate_edit_pair(f"{work}/wt.bam", f"{work}/ct.bam", f"{work}/edit.gff3",
                           f"{work}/edit.fa", seed=16, **size)
write_s = time.time() - t
pickle.dump(truth, open(f"{work}/truth.pkl", "wb"))
argv = ["faba", "all", "--bam", f"{work}/wt.bam", "--control-bam", f"{work}/ct.bam", "--gff",
        f"{work}/edit.gff3", "--genome", f"{work}/edit.fa", "--output", f"{work}/run",
        "--depth-resolution-kb", sys.argv[4]]
t = time.time()
p = subprocess.run([sys.executable, "-c", counted, *argv], capture_output=True, text=True)
all_s = time.time() - t
if p.returncode:
    sys.exit(p.stderr[-3000:])
# the small faba commands on the called C-to-T sites (phase 39d): their
# strand from the gene that holds them
import numpy as np, pandas as pd
from legume_tpu_torch.cli.main import run_faba
from legume_tpu_torch.data.sparse_io import open_sparse_matrix
from legume_tpu_torch.faba.genes import parse_gff_genes
from legume_tpu_torch.ops import kernels as K
model = parse_gff_genes(f"{work}/edit.gff3")
rows = [(n.split(":")[0], int(n.split(":")[1].split("/")[0]))
        for n in open_sparse_matrix(f"{work}/run.m6a.zarr").row_names()]
strand = []
for c, q in rows:
    g = np.nonzero((model.chrom == model.chrom_names.index(c)) & (model.start <= q)
                   & (model.end > q))[0]
    strand.append("+" if model.strand[g[0]] > 0 else "-")
sites = pd.DataFrame({"chrom": [c for c, _ in rows], "pos": [q for _, q in rows],
                      "strand": strand})
sites.to_parquet(f"{work}/m6a_sites.parquet")
sites[sites.strand == "+"].to_parquet(f"{work}/m6a_plus.parquet")
s, plus = f"{work}/m6a_sites.parquet", f"{work}/m6a_plus.parquet"
small = {}
for name, argv in (
        ("pwm_reference", ["pwm", "-s", s, "-f", f"{work}/edit.fa", "-o", f"{work}/pwm_ref"]),
        ("pwm_reads_wt", ["pwm", "-s", s, "-f", f"{work}/edit.fa", "-o", f"{work}/pwm_wt",
                          "--source", "reads", "--bam", f"{work}/wt.bam"]),
        ("pwm_reads_ct", ["pwm", "-s", s, "-f", f"{work}/edit.fa", "-o", f"{work}/pwm_ct",
                          "--source", "reads", "--bam", f"{work}/ct.bam"]),
        ("metagene", ["metagene", "-s", s, "-g", f"{work}/edit.gff3", "-o",
                      f"{work}/metagene.tsv", "--ncrna"]),
        ("pileup_wt", ["pileup", "--bam", f"{work}/wt.bam", "--sites", plus, "--output",
                       f"{work}/pu_wt"]),
        ("pileup_ct", ["pileup", "--bam", f"{work}/ct.bam", "--sites", plus, "--output",
                       f"{work}/pu_ct"]),
        ("inspect", ["inspect", "--bam", f"{work}/wt.bam", "--sites", plus, "--fasta",
                     f"{work}/edit.fa", "--output", f"{work}/inspect"]),
        ("docs", ["docs"])):
    K.reset_launch_counts()
    t = time.time()
    run_faba(argv)
    small[name] = {"run_s": time.time() - t, "launches": dict(K.launch_counts)}
print(json.dumps({"write_s": write_s, "all_s": all_s, "sites": len(sites), "small": small,
                  "launches": json.loads(p.stdout.strip().splitlines()[-1])}))
"""


def start_faba_all(work: str, size: dict = FABA_ALL):
    """Start phase 39's host half (`FABA_ALL_CLI`) in a process of its own."""
    Path(f"{work}/faba_all").mkdir(exist_ok=True)
    proc = subprocess.Popen(
        [sys.executable, "-c", FABA_ALL_CLI, f"{work}/faba_all", json.dumps(size), CLI_COUNTED,
         str(FABA_ALL_DEPTH_KB)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        cwd=Path(__file__).resolve().parent)
    CHILDREN.append(proc)
    return proc, time.time()


def _site_set(path: str) -> set:
    """(chrom, pos) of the rows of an editing store (`chr:pos/modality/XY`)."""
    from legume_tpu_torch.data.sparse_io import open_sparse_matrix

    if not Path(path).exists():
        return set()
    return {(n.split(":")[0], int(n.split(":")[1].split("/")[0]))
            for n in open_sparse_matrix(path).row_names()}


def faba_all_checks(d: str, truth: dict) -> tuple[dict, dict]:
    """`faba all`'s outputs under `d/run` against the planted truth: each
    arm's gene store equals its planted counts after UMI dedup, its depth
    tiles each cell's molecules starting in the tile, exactly; the planted
    SNPs called and none among the editing calls; the planted edits called
    at FABA_EDIT_RECALL / FABA_EDIT_PRECISION; the poly(A) sites called
    within FABA_PEAK_WINDOW of planted ones. Returns (checks, figures)."""
    import pandas as pd
    import scipy.sparse as sp

    from legume_tpu_torch.data.sparse_io import open_sparse_matrix

    checks, figs = {}, {}
    res_bp = int(FABA_ALL_DEPTH_KB * 1000)
    for arm, tag in (("wt", ""), ("control", ".ct")):
        t = truth[arm]
        checks[f"genes{tag}"] = _decodes_to(f"{d}/run{tag}.genes.zarr", t["genes"],
                                            truth["genes"], t["barcodes"])
        db = open_sparse_matrix(f"{d}/run{tag}.depth.zarr")
        per_contig = db.num_rows // (1 + int(t["mol_ref"].max()))
        tile = t["mol_ref"] * per_contig + t["mol_start"] // res_bp
        want = sp.coo_matrix((np.ones(len(tile), np.float32), (tile, t["mol_cell"])),
                             shape=(db.num_rows, len(t["barcodes"]))).tocsc()
        checks[f"depth{tag}"] = _decodes_to(f"{d}/run{tag}.depth.zarr", want, None, t["barcodes"])
    snp = pd.read_parquet(f"{d}/run.snp/snp_sites.parquet")
    called = snp[snp["genotype"] != "./."]
    planted = {(c, p) for c, p, _, _ in truth["snps"]}
    got_snp = set(zip(called["chr"], called["pos"].astype(int))) & planted
    figs["snp_recall"] = len(got_snp) / len(planted)
    checks["snps_called"] = figs["snp_recall"] >= FABA_SNP_RECALL
    edits = {}
    for name in ("atoi", "m6a"):
        got = _site_set(f"{d}/run.{name}.zarr")
        want = {(c, p) for c, p, _, _ in truth[name]}
        figs[f"{name}_recall"] = len(got & want) / len(want)
        figs[f"{name}_precision"] = len(got & want) / max(len(got), 1)
        figs[f"{name}_called"] = len(got)
        checks[name] = (figs[f"{name}_recall"] >= FABA_EDIT_RECALL
                        and figs[f"{name}_precision"] >= FABA_EDIT_PRECISION)
        edits[name] = got
    checks["snps_not_edits"] = not (planted & (edits["atoi"] | edits["m6a"]))
    ab = open_sparse_matrix(f"{d}/run.apa.zarr")
    pas = {g: (p, q) for g, p, q, _ in truth["pas"]}
    off, hit = [], set()
    for n in ab.row_names():
        gene, rest = n.split("/apa/")
        center = int(rest.split("@")[1])
        near = min(pas[gene], key=lambda x: abs(x - center))
        off.append(abs(near - center))
        hit.add((gene, near))
    figs["pas_called"] = len(off)
    figs["pas_offset_max"] = int(max(off)) if off else None
    figs["pas_recall"] = len(hit) / (2 * len(pas))
    checks["pas"] = bool(off) and max(off) <= FABA_PEAK_WINDOW \
        and figs["pas_recall"] >= FABA_PAS_RECALL
    return checks, figs


def faba_all_phase(work: str, started, card: str) -> dict:
    """Phase 39: `faba all --depth-resolution-kb 1` on `start_faba_all`'s
    planted pair (a wild type and a control), its host work in that
    process beside the card's phases 17-38; the outputs held against the
    planted truth (`faba_all_checks`). Returns the process's launches."""
    import pickle

    proc, t_start = started
    t0 = time.time()
    out, err = proc.communicate(timeout=1200)
    wait_s = time.time() - t0
    if proc.returncode != 0:
        raise AssertionError(f"the faba all process failed: {err[-2000:]}")
    res = json.loads(out.strip().splitlines()[-1])
    d = f"{work}/faba_all"
    with open(f"{d}/truth.pkl", "rb") as f:
        truth = pickle.load(f)
    t0 = time.time()
    checks, figs = faba_all_checks(d, truth)
    stages = json.load(open(f"{d}/run.gem.json"))["timings"]
    reads = truth["wt"]["n_reads"] + truth["control"]["n_reads"]
    print(json.dumps({
        "phase": "faba_all", **FABA_ALL, "reads": [truth["wt"]["n_reads"],
                                                   truth["control"]["n_reads"]],
        "process_s": time.time() - t_start, "wait_s": wait_s, "write_s": res["write_s"],
        "faba_all_s": res["all_s"], "stages": stages, "reads_per_s": reads / res["all_s"],
        "check_s": time.time() - t0, "checks": checks, **figs, "launches": res["launches"],
        "card": card,
    }), flush=True)
    failed = [k for k, v in checks.items() if not v]
    if failed:
        raise AssertionError(f"faba all unlike the planted truth: {failed} {figs}")
    small_checks, small_figs = faba_small_checks(d, res["sites"])
    print(json.dumps({"phase": "faba_small_commands", "sites": res["sites"],
                      "runs": res["small"], "checks": small_checks, **small_figs,
                      "card": card}), flush=True)
    failed = [k for k, v in small_checks.items() if not v]
    if failed:
        raise AssertionError(f"faba pwm / metagene / pileup unlike the planted pair: {failed} "
                             f"{small_figs}")
    return {"faba_all": res["launches"],
            **{f"faba_{name}": r["launches"] for name, r in res["small"].items()}}


def faba_small_checks(d: str, n_sites: int) -> tuple[dict, dict]:
    """Phase 39d on the called C-to-T sites: the reference PWM shows the
    planted RAC (R at -2, A at -1, C at 0, each above FABA_MOTIF_FREQ); the
    reads' PWM and the pileup show the C-to-T edit at the site in the wild
    type (T above FABA_EDIT_SHOWS of the column) and not in the control
    (below FABA_EDIT_ABSENT); `inspect` folds the matching reads into the
    reference's RAC; metagene places every site."""
    import pandas as pd

    checks, figs = {}, {}
    ref = pd.read_parquet(f"{d}/pwm_ref.pwm.parquet").set_index("offset")
    figs["pwm_rac"] = [float(ref.loc[-2, ["A", "G"]].sum()), float(ref.loc[-1, "A"]),
                       float(ref.loc[0, "C"])]
    checks["pwm_rac"] = min(figs["pwm_rac"]) >= FABA_MOTIF_FREQ
    for arm in ("wt", "ct"):
        pwm = pd.read_parquet(f"{d}/pwm_{arm}.pwm.parquet").set_index("offset")
        figs[f"pwm_reads_t_{arm}"] = float(pwm.loc[0, "T"])
        pu = pd.read_parquet(f"{d}/pu_{arm}.pileup.parquet").set_index("offset")
        col = pu.loc[0, ["A", "C", "G", "T", "ref_match"]].astype(float)
        figs[f"pileup_t_{arm}"] = float(col["T"] / max(col.sum(), 1.0))
    checks["edit_in_wt"] = min(figs["pwm_reads_t_wt"], figs["pileup_t_wt"]) >= FABA_EDIT_SHOWS
    checks["no_edit_in_ct"] = max(figs["pwm_reads_t_ct"], figs["pileup_t_ct"]) <= FABA_EDIT_ABSENT
    ins = pd.read_parquet(f"{d}/inspect.pileup.parquet").set_index("offset")[["A", "C", "G", "T"]]
    figs["inspect_consensus"] = "".join(ins.loc[o].astype(float).idxmax() for o in (-2, -1, 0))
    checks["inspect_rac"] = figs["inspect_consensus"][0] in "AG" \
        and figs["inspect_consensus"][1:] == "AC"
    mg = pd.read_csv(f"{d}/metagene.tsv", sep="\t")
    figs["metagene_placed"] = float(mg["count"].sum())
    checks["metagene_places_every_site"] = figs["metagene_placed"] == n_sites
    return checks, figs


# ---- slice 17: faba lineage / annotate / plot, the small faba commands, the
# model-stack parts ------------------------------------------------------------

# (a): the planted Y of tests/test_lineage_forest.py at LINEAGE_CELLS cells,
# held to that test's bars; LINEAGE_CPU_CELLS of them on the card against
# `--device cpu` (labels, edges, calls and trees equal, pseudotime within
# LINEAGE_PT_ATOL); (b)'s marker bootstrap cut to LINEAGE_MARKER_BOOT draws
# (the CLI's 200: each draw is a k-means of the 100,000 cells); (c) the
# planted gem prefix of tests/test_faba_annotate.py at ANNOTATE_CELLS cells
LINEAGE_CELLS, LINEAGE_CPU_CELLS, LINEAGE_MARKER_BOOT = 100_000, 2_000, 20
LINEAGE_PT_CORR, LINEAGE_PT_ATOL = 0.95, 1e-5
ANNOTATE_CELLS, ANNOTATE_ACCURACY, ANNOTATE_NASCENT = 10_000, 0.95, 0.8
ARCHETYPE_SHAPE = (10_000, 50, 8)  # (f): cells, dimensions, archetypes
# (f)'s bars, card against CPU: the likelihoods relative 1e-5 (of each
# row's magnitude, at least 1); each forward output within 1e-5 and each
# gradient within 1e-4 of its largest entry; fit_archetypes after
# ARCHETYPE_ITERS steps within 1e-3 of its span
RTOL_LIKELIHOOD, RTOL_FORWARD, RTOL_GRAD, ARCHETYPE_ITERS = 1e-5, 1e-5, 1e-4, 100
# Port CLI commands in a process of their own, in order, each through
# `run_faba` with its kernel counts zeroed just before: its seconds, what
# it returned (its stage seconds, where it reports them) and its launches.
FABA_RUNS = r"""
import json, sys, time
from legume_tpu_torch.cli.main import run_faba
from legume_tpu_torch.ops import kernels as K
out = {}
for name, argv in json.loads(sys.argv[1]):
    K.reset_launch_counts()
    t = time.time()
    timings = run_faba(argv)
    out[name] = {"run_s": time.time() - t, "timings": timings, "launches": dict(K.launch_counts)}
print(json.dumps(out))
"""


def y_trajectory(n: int, seed: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """tests/test_lineage_forest.py's Y at `n` cells (its 300 / 200 / 200
    split scaled): a trunk along x, two arms, velocity along the flow with
    N(0, 0.3^2) noise. Returns (theta [n, 2], velocity [n, 2])."""
    rng = np.random.default_rng(seed)
    nt = n * 3 // 7
    na = (n - nt) // 2
    sizes = (nt, na, n - nt - na)

    def seg(a, b, m):
        t = rng.uniform(0, 1, m)[:, None]
        return np.array(a) + t * (np.array(b) - np.array(a)) + rng.normal(0, 0.05, (m, 2))

    theta = np.vstack([seg([0, 0], [1, 0], sizes[0]), seg([1, 0], [2, 1], sizes[1]),
                       seg([1, 0], [2, -1], sizes[2])]).astype(np.float32)
    flow = np.repeat(np.array([[1, 0], [0.7, 0.7], [0.7, -0.7]]), sizes, axis=0)
    return theta, (flow + rng.normal(0, 0.3, (n, 2))).astype(np.float32)


def _cell_table(path: str, mat: np.ndarray, names, cols) -> str:
    import pandas as pd

    pd.DataFrame(mat, columns=cols).assign(cell=list(names)).set_index("cell").reset_index() \
        .to_parquet(path)
    return path


def planted_gem_prefix(prefix: str, n: int, seed: int = 0) -> tuple[str, np.ndarray]:
    """tests/test_faba_annotate.py's gem prefix at `n` cells: two types
    along two axes of an H = 4 co-embedded space, type A's velocity toward a
    third axis (the Gamma program), 60 genes in three panels. Returns (the
    marker TSV, the planted type of each cell)."""
    import pandas as pd

    rng = np.random.default_rng(seed)
    h, nh = 4, n // 2
    a, b, c = np.eye(h, dtype=np.float32)[:3]
    cells = np.vstack([a + rng.normal(0, 0.15, (nh, h)), b + rng.normal(0, 0.15, (nh, h))])
    vel = np.vstack([c + rng.normal(0, 0.1, (nh, h)), b + rng.normal(0, 0.1, (nh, h))])
    spl = np.vstack([a + rng.normal(0, 0.1, (20, h)), b + rng.normal(0, 0.1, (20, h)),
                     c + rng.normal(0, 0.1, (20, h))])
    names, genes = [f"cell{i}" for i in range(2 * nh)], [f"g{i}" for i in range(60)]
    cols = [f"h{j}" for j in range(h)]
    _cell_table(f"{prefix}.cell_embedding.parquet", cells.astype(np.float32), names, cols)
    _cell_table(f"{prefix}.velocity.parquet", vel.astype(np.float32), names, cols)
    rows = [f"{g}/count/spliced" for g in genes] + [f"{g}/count/unspliced" for g in genes]
    pd.DataFrame(np.vstack([spl, spl]).astype(np.float32), columns=cols).assign(feature=rows) \
        .set_index("feature").reset_index().to_parquet(f"{prefix}.feature_embedding.parquet")
    json.dump({"model_type": "embedding"}, open(f"{prefix}.gem.json", "w"))
    markers = _write_lines(f"{prefix}.markers.tsv", [
        f"g{i}\t{t}" for t, lo in (("Alpha", 0), ("Beta", 20), ("Gamma", 40))
        for i in range(lo, lo + 20)])
    return markers, np.array(["Alpha"] * nh + ["Beta"] * nh)


def _start_faba_runs(runs: list) -> tuple:
    proc = subprocess.Popen([sys.executable, "-c", FABA_RUNS, json.dumps(runs)],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            cwd=Path(__file__).resolve().parent)
    CHILDREN.append(proc)
    return proc, time.time()


def _faba_runs_result(started, what: str) -> tuple[dict, float]:
    """(each run's line, the seconds the main process waited)."""
    proc, _ = started
    t0 = time.time()
    out, err = proc.communicate(timeout=1200)
    if proc.returncode != 0:
        raise AssertionError(f"the {what} process failed: {err[-2500:]}")
    return json.loads(out.strip().splitlines()[-1]), time.time() - t0


def start_annotate_projection(work: str, dev, *, cells: int = ANNOTATE_CELLS) -> dict:
    """Phase 40's `faba annotate` process (the CLI defaults) on the planted
    gem prefix. Its 100 bootstrap Leidens on the host took 636 s beside
    three other processes on the host of an NVIDIA H100 80GB HBM3
    (700.00 W), so it starts after phase 4 and runs beside phases 5-39."""
    d = f"{work}/lineage"
    Path(d).mkdir(exist_ok=True)
    markers, truth = planted_gem_prefix(f"{d}/gem", cells)
    return {"dir": d, "markers": markers, "truth": truth, "annotate": _start_faba_runs([
        ("faba_annotate_projection", ["annotate", "--from", f"{d}/gem", "--markers", markers,
                                      "--out", f"{d}/ann", "--device", str(dev)])])}


def start_lineage_y(work: str, dev, *, cells: int = LINEAGE_CELLS,
                    cpu_cells: int = LINEAGE_CPU_CELLS) -> dict:
    """Phase 40's `faba lineage` process: the Y (the CLI defaults but
    `--latent-geometry euclidean`), then the subset on the card and on the
    CPU."""
    d = f"{work}/lineage"
    Path(d).mkdir(exist_ok=True)
    theta, vel = y_trajectory(cells)
    names = [f"cell{i}" for i in range(cells)]
    sub = np.random.default_rng(40).choice(cells, cpu_cells, replace=False)
    sub.sort()
    for tag, idx in (("y", slice(None)), ("sub", sub)):
        _cell_table(f"{d}/{tag}.latent.parquet", theta[idx], np.asarray(names)[idx], ["h0", "h1"])
        _cell_table(f"{d}/{tag}.velocity.parquet", vel[idx], np.asarray(names)[idx], ["v0", "v1"])

    def lineage(tag, out, device):
        return ["lineage", "--latent", f"{d}/{tag}.latent.parquet", "--velocity",
                f"{d}/{tag}.velocity.parquet", "--latent-geometry", "euclidean", "--out",
                f"{d}/{out}", "--device", device]

    return {
        "theta": theta, "sub": sub,
        "lineage": _start_faba_runs([
            ("faba_lineage", lineage("y", "y", str(dev))),
            ("faba_lineage_subset", lineage("sub", "sub_card", str(dev))),
            ("faba_lineage_subset_cpu", lineage("sub", "sub_cpu", "cpu"))]),
    }


def _forest_ok(prefix: str, n_cells: int) -> dict:
    """Finite tables; every cell in exactly one tree; the selected edges'
    parents a forest (each node one parent at most, no cycle, one root a
    tree)."""
    import pandas as pd

    tables = {t: pd.read_parquet(f"{prefix}.{t}.parquet") for t in
              ("nodes", "edges", "trees", "pseudotime", "cell_lineage_weights", "curves")}
    finite = all(np.isfinite(tables[t].select_dtypes("number").to_numpy(np.float64)).all()
                 for t in ("nodes", "curves", "cell_lineage_weights"))
    trees = tables["trees"]
    # each cell's node lies in exactly one tree; a tree too small for a
    # curve leaves its cells' pseudotime and tree NaN, as in the JAX package
    placed = tables["pseudotime"]["pseudotime"].notna()
    one_tree = bool(len(tables["pseudotime"]) == n_cells
                    and int(trees["n_cells"].sum()) == n_cells
                    and tables["pseudotime"]["tree"][placed].notna().all())
    sel = tables["edges"][tables["edges"]["selected"] > 0]
    parent = {}
    forest = True
    for frm, to in zip(sel["directed_from"].astype(int), sel["directed_to"].astype(int)):
        forest &= to not in parent
        parent[to] = frm
    for v in list(parent):
        seen, x = set(), v
        while x in parent and forest:
            forest &= x not in seen
            seen.add(x)
            x = parent[x]
    forest &= len(trees) == len(tables["nodes"]) - len(parent)
    return {"tables_finite": bool(finite), "each_cell_one_tree": one_tree,
            "parents_form_a_forest": bool(forest)}


def slice17_phase(work: str, started: dict, K, dev, card: str) -> dict:
    """Phase 40: collect the lineage and annotate processes and hold them;
    `faba plot` of the Y's lineage where matplotlib imports."""
    import pandas as pd

    d = started["dir"]
    runs, wait = _faba_runs_result(started["lineage"], "faba lineage")
    ann, ann_wait = _faba_runs_result(started["annotate"], "faba annotate")
    runs.update(ann)
    theta = started["theta"]
    pt = pd.read_parquet(f"{d}/y.pseudotime.parquet")
    trees = pd.read_parquet(f"{d}/y.trees.parquet")
    lineages = pd.read_parquet(f"{d}/y.lineages.parquet")
    corr = float(np.corrcoef(theta[:, 0], np.nan_to_num(pt.pseudotime))[0, 1])
    n_lin = int(lineages["lineage"].nunique())
    y_line = {"phase": "faba_lineage", "cells": len(theta), **runs["faba_lineage"],
              "trees": len(trees), "lineages": n_lin, "pseudotime_corr": corr,
              "process_wait_s": wait, **_forest_ok(f"{d}/y", len(theta)), "card": card}
    print(json.dumps(y_line), flush=True)
    if not (len(trees) == 1 and n_lin >= 2 and corr > LINEAGE_PT_CORR
            and y_line["tables_finite"] and y_line["each_cell_one_tree"]):
        raise AssertionError(f"faba lineage on the planted Y below its bars: {y_line}")
    # the subset on the card against --device cpu
    same, gaps = {}, {}
    for t in ("nodes", "edges", "trees", "lineages", "pseudotime", "cell_lineage_weights"):
        a = pd.read_parquet(f"{d}/sub_card.{t}.parquet")
        b = pd.read_parquet(f"{d}/sub_cpu.{t}.parquet")
        num = [c for c in a.columns if a[c].dtype.kind == "f"]
        same[t] = bool(a.drop(columns=num).equals(b.drop(columns=num)))
        same[f"{t}_nan"] = bool((a[num].isna() == b[num].isna()).all().all())
        gaps[t] = float(np.nanmax(np.abs(a[num].to_numpy(np.float64) - b[num].to_numpy(np.float64)),
                                  initial=0.0)) if num else 0.0
    sub_line = {"phase": "faba_lineage_card_vs_cpu", "cells": len(started["sub"]),
                "card_s": runs["faba_lineage_subset"]["run_s"],
                "cpu_s": runs["faba_lineage_subset_cpu"]["run_s"], "equal": same,
                "max_abs_gap": gaps, "bar": LINEAGE_PT_ATOL, "card": card}
    print(json.dumps(sub_line), flush=True)
    if not (all(same.values()) and max(gaps.values()) <= LINEAGE_PT_ATOL):
        raise AssertionError(f"faba lineage on the card unlike the CPU: {sub_line}")
    # (c) projection mode on the planted gem prefix
    got = pd.read_parquet(f"{d}/ann.spliced.annotation.parquet")["annotation"].to_numpy()
    velo = pd.read_parquet(f"{d}/ann.velocity.annotation.parquet")["annotation"].to_numpy()
    acc = float((got == started["truth"]).mean())
    nascent = float((velo[started["truth"] == "Alpha"] == "Gamma").mean())
    a_line = {"phase": "faba_annotate_projection", "cells": len(got),
              **runs["faba_annotate_projection"], "accuracy": acc, "nascent_gamma": nascent,
              "process_wait_s": ann_wait, "card": card}
    print(json.dumps(a_line), flush=True)
    if not (acc > ANNOTATE_ACCURACY and nascent > ANNOTATE_NASCENT):
        raise AssertionError(f"faba annotate (projection) below its bars: {a_line}")
    # (e) faba plot needs matplotlib
    if importlib.util.find_spec("matplotlib") is None:
        print(json.dumps({"phase": "faba_plot", "skipped": "matplotlib does not import here",
                          "card": card}), flush=True)
    else:
        from legume_tpu_torch.cli.main import run_faba

        K.reset_launch_counts()
        t0 = time.time()
        run_faba(["plot", "-f", f"{d}/y", "--latent", f"{d}/y.latent.parquet", "-o",
                  f"{d}/y.plot.png", "--device", str(dev)])
        runs["faba_plot"] = {"launches": dict(K.launch_counts)}
        print(json.dumps({"phase": "faba_plot", "run_s": time.time() - t0,
                          "bytes": Path(f"{d}/y.plot.png").stat().st_size, "card": card}),
              flush=True)
    return {name: r["launches"] for name, r in runs.items()}


def start_lineage_from_gem(work: str, topic_out: str, gmt: str, dev) -> tuple:
    """Phase 41's process: `faba lineage --from` phase 33's gem_raw fit (its
    tables are over the pseudobulks `--raw` sums the cells into) with the
    factors' panel, `faba annotate --mode enrichment` on phase 2's topic
    run."""
    d = f"{work}/lineage"
    Path(d).mkdir(exist_ok=True)
    return _start_faba_runs([
        ("faba_lineage_from", ["lineage", "--from", f"{work}/gem_raw", "--markers", gmt,
                               "--marker-n-boot", str(LINEAGE_MARKER_BOOT), "--out",
                               f"{d}/gem", "--device", str(dev)]),
        ("faba_annotate_enrichment", ["annotate", "--from", topic_out, "--mode", "enrichment",
                                      "--markers", gmt, "--out", f"{d}/topic", "--device",
                                      str(dev)]),
    ])


def lineage_from_gem_phase(work: str, started, n_cells: int, K, dev, card: str) -> dict:
    """Phase 41: hold the process's outputs; then `faba dyn-assoc --from` the
    lineage run on phase 34's sites store, its pseudobulks' pseudotime and
    branch lifted to their cells (phase 33's partition), as phase 34 lifts
    the DAG pseudotime."""
    import pandas as pd

    from legume_tpu_torch.cli.main import run_faba

    d = f"{work}/lineage"
    runs, wait = _faba_runs_result(started, "lineage --from")
    pt = pd.read_parquet(f"{d}/gem.pseudotime.parquet")
    forest = _forest_ok(f"{d}/gem", len(pt))
    annot = pd.read_parquet(f"{d}/gem.trajectory_annotation.parquet")
    line = {"phase": "faba_lineage_from_gem", "cells": n_cells, "pseudobulks": len(pt),
            **runs["faba_lineage_from"], **forest, "node_types": {
                str(k): int(v) for k, v in annot["cell_type"].value_counts().items()},
            "marker_boot": LINEAGE_MARKER_BOOT, "process_wait_s": wait, "card": card}
    print(json.dumps(line), flush=True)
    if not all(forest.values()):
        raise AssertionError(f"faba lineage --from gem_raw: {line}")
    groups = np.load(f"{work}/gem_raw.partition.npz")["fine_groups"]
    lifted = pt.set_index("cell").loc[[f"pb{g}" for g in groups]]
    lifted.index = [f"cell{i}" for i in range(len(groups))]
    lifted.rename_axis("cell").reset_index().to_parquet(f"{d}/gem_cells.pseudotime.parquet")
    K.reset_launch_counts()
    t0 = time.time()
    run_faba(["dyn-assoc", "--backend", f"{work}/sites.zarr", "--from", f"{d}/gem_cells",
              "--output", f"{d}/gem_assoc", "--device", str(dev)])
    _sync(dev)
    runs["faba_dyn_assoc_lineage"] = {"run_s": time.time() - t0,
                                      "launches": dict(K.launch_counts)}
    assoc = pd.read_parquet(f"{d}/gem_assoc.assoc.parquet")
    stats = assoc[["log_fold_change", "z", "log_bf", "pvalue"]].to_numpy(np.float64)
    a_line = {"phase": "faba_dyn_assoc_lineage", **runs["faba_dyn_assoc_lineage"],
              "sites": len(assoc), "branches": int(assoc["branch"].nunique()),
              "finite_p_in_unit": bool(np.isfinite(stats).all() and len(assoc)
                                       and assoc.pvalue.between(0, 1).all()), "card": card}
    print(json.dumps(a_line), flush=True)
    if not (a_line["finite_p_in_unit"] and assoc["branch"].notna().all()):
        raise AssertionError(f"faba dyn-assoc --from the lineage: {a_line}")
    enr = pd.read_parquet(f"{d}/topic.enrichment.factors.parquet")
    cells = pd.read_parquet(f"{d}/topic.enrichment.annotation.parquet")
    e_line = {"phase": "faba_annotate_enrichment", **runs["faba_annotate_enrichment"],
              "factor_calls": list(enr["call"]), "cells": len(cells),
              "cells_called": int((cells["annotation"] != "unassigned").sum()), "card": card}
    print(json.dumps(e_line), flush=True)
    if not (len(cells) == n_cells and (enr["call"] != "unassigned").any()):
        raise AssertionError(f"faba annotate --mode enrichment: {e_line}")
    return {name: r["launches"] for name, r in runs.items()}


def model_stack_phase(dev, card: str, *, shape=ARCHETYPE_SHAPE) -> None:
    """Phase 42: the model-stack parts no command reaches, the card against
    the CPU on the same inputs: the eight likelihoods; `IafSoftmaxEncoder`
    (eval-mode forward, the parameters' gradients) and `BipartiteDecoder`
    (each likelihood's scores, llik and gradients) from the same
    parameters; `fit_archetypes` at `shape` from the same Dirichlet starts."""
    from legume_tpu_torch.models import decoders, encoders, losses
    from legume_tpu_torch.ops.archetypal import fit_archetypes

    rng = np.random.default_rng(42)
    n, d = 4096, 2000
    x = rng.poisson(2.0, (n, d)).astype(np.float32)
    x[rng.uniform(size=(n, d)) < 0.3] = 0.0
    recon = rng.dirichlet(np.ones(d), n).astype(np.float32)
    inputs = {
        "gaussian_neg_log_prob": (rng.normal(0, 1, (n, 16)), rng.normal(0, 1, (n, 16)),
                                  rng.normal(0, 0.5, (n, 16))),
        "topic_log_likelihood": (x, np.log(recon)),
        "topic_likelihood": (x, recon),
        "poisson_log_likelihood": (x, rng.gamma(2.0, 1.0, (n, d))),
        "nb_log_likelihood": (x, rng.gamma(2.0, 2.0, (n, d)), rng.normal(0, 1, d)),
        "zi_topic_log_likelihood": (x, np.log(recon), rng.normal(0, 1, d)),
        "dirichlet_log_likelihood": (x, rng.gamma(1.0, 1.0, (n, d)) + 0.05),
        "gaussian_log_likelihood": (x, rng.normal(2, 1, (n, d))),
    }
    gaps = {}
    for name, args in inputs.items():
        got, want = (getattr(losses, name)(*(torch.from_numpy(np.asarray(a, np.float32)).to(where)
                                             for a in args)).cpu().double()
                     for where in (dev, "cpu"))
        gaps[name] = float(((got - want).abs() / want.abs().clamp(min=1.0)).max())

    def run_module(make, call, where):
        torch.manual_seed(0)
        mod = make().to(where)
        out = call(mod, where)
        sum(o.double().sum() * (i + 1) for i, o in enumerate(out)).backward()
        return ([o.detach().cpu().double() for o in out],
                {k: p.grad.detach().cpu().double() for k, p in mod.named_parameters()})

    xt = x[:512, :400]
    lz = np.log(rng.dirichlet(np.ones(10), 512)).astype(np.float32)
    modules = {
        "iaf_encoder": (lambda: encoders.IafSoftmaxEncoder(400, 10, (128, 64), n_flows=2).eval(),
                        lambda m, w: m(torch.from_numpy(xt).to(w), train=False)),
        **{f"bipartite_{lik}": (lambda lik=lik: decoders.BipartiteDecoder(400, 10, lik),
                                lambda m, w: m(torch.from_numpy(lz).to(w),
                                               torch.from_numpy(xt).to(w)))
           for lik in ("block", "symmetric", "poisson")},
    }
    for name, (make, call) in modules.items():
        (go, gg), (wo, wg) = (run_module(make, call, w) for w in (dev, "cpu"))
        gaps[name] = max(float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))
                         for a, b in zip(go, wo))
        gaps[f"{name}_grad"] = max(float((gg[k] - wg[k]).abs().max() / wg[k].abs().max().clamp(
            min=1e-30)) for k in wg)
    n_cells, dim, k = shape
    corners = rng.normal(0, 3, (k, dim)).astype(np.float32)
    xa = rng.dirichlet(np.ones(k) * 0.4, n_cells).astype(np.float32) @ corners
    t0 = time.time()
    z_card = fit_archetypes(xa, k, n_iter=ARCHETYPE_ITERS, seed=0, device=dev)
    _sync(dev)
    card_s = time.time() - t0
    t0 = time.time()
    z_cpu = fit_archetypes(xa, k, n_iter=ARCHETYPE_ITERS, seed=0, device="cpu")
    cpu_s = time.time() - t0
    gaps["fit_archetypes"] = float(np.abs(z_card[0] - z_cpu[0]).max() / np.ptp(z_cpu[0]))
    bars = {**{nm: RTOL_LIKELIHOOD for nm in inputs},
            **{nm: RTOL_FORWARD for nm in modules},
            **{f"{nm}_grad": RTOL_GRAD for nm in modules}, "fit_archetypes": 1e-3}
    line = {"phase": "model_stack_card_vs_cpu", "gaps": gaps, "bars": bars,
            "archetypes": {"shape": list(shape), "iters": ARCHETYPE_ITERS, "card_s": card_s,
                           "cpu_s": cpu_s, "a_rows_sum_to_1": bool(
                               np.allclose(z_card[1].sum(1), 1.0, atol=1e-4))},
            "card": card}
    print(json.dumps(line), flush=True)
    failed = [nm for nm, g in gaps.items() if not g <= bars[nm]]
    if failed or not line["archetypes"]["a_rows_sum_to_1"]:
        raise AssertionError(f"model stack on the card unlike the CPU: {failed} {line}")


def mark(name: str, t_script: float) -> None:
    """The script's seconds when a phase starts: the line the per-phase
    wall times of `PERF.md` section 5 are read from."""
    print(json.dumps({"mark": name, "at_s": time.time() - t_script}), flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible to torch", file=sys.stderr)
        return 2
    t_script = time.time()
    work = tempfile.TemporaryDirectory()
    try:
        return run(work.name, t_script)
    finally:
        stop_children()
        work.cleanup()


def run(work: str, t_script: float) -> int:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    warnings.filterwarnings("ignore", message="Sparse CSR tensor support is in beta")

    from legume_tpu_torch.cli.senna_cmds.embed_cmds import BgeArgs, run_bge
    from legume_tpu_torch.data import MemoryBackend, SparseIoVec
    from legume_tpu_torch.data.sim import simulate_topic
    from legume_tpu_torch.data.visitors import visit_columns_by_block
    from legume_tpu_torch.embedding.nce import NceConfig, _neg_marginal, fit_bge
    from legume_tpu_torch.ops import kernels as K
    from legume_tpu_torch.ops.sparse import col_ids_from_ptr, densify_block
    from legume_tpu_torch.ops.collapse import MATCHED_CELL_BLOCK, matched_block
    from legume_tpu_torch.ops.knn import matched_neighbors_across_batches
    from legume_tpu_torch.ops.random_projection import block_to_device, projection_basis
    from legume_tpu_torch.senna.topic import TopicArgs, fit_topic_model

    dev = torch.device("cuda")

    # ---- phase 1: build --------------------------------------------------
    t0 = time.time()
    reports = K.build_kernels()
    print(json.dumps({"phase": "build", "seconds": time.time() - t0}), flush=True)
    for name, rep in reports.items():
        regs = [ln.strip() for ln in rep.splitlines() if "registers" in ln or "spill" in ln]
        print(json.dumps({"ptxas": name, "lines": regs}), flush=True)
    card = device_line()
    print(card, flush=True)
    print(json.dumps({"phase": "storage_libraries", **storage_libraries()}), flush=True)

    # ---- phase 2: senna topic end to end ---------------------------------
    mark("2 senna topic", t_script)
    t0 = time.time()
    sim = simulate_topic(rows=2000, cols=100_000, factors=8, batches=2, seed=42)
    vec = SparseIoVec()
    vec.push(MemoryBackend(sim.counts, sim.row_names, sim.col_names))
    vec.register_batches(sim.batch.astype(str))
    sim_s = time.time() - t0
    args = TopicArgs(epochs=5)
    args.out = f"{work}/topic"  # the model phase 8 predicts with
    K.reset_launch_counts()
    t0 = time.time()
    res = fit_topic_model(args, vec=vec, device=dev)
    torch.cuda.synchronize()
    e2e_s = time.time() - t0
    launches = dict(K.launch_counts)
    z, llik = res["latent"], np.asarray(res["scores"].llik)
    simplex_err = float(np.abs(np.exp(z.astype(np.float64)).sum(1) - 1.0).max())
    e2e = {
        "phase": "senna_topic", "cells": vec.num_columns, "genes": vec.num_rows,
        "nnz": int(sim.counts.nnz), "simulate_s": sim_s, "fit_s": e2e_s,
        **{k: v for k, v in res["timings"].items()},
        "launches": launches, "groups_per_level": res["levels"].num_groups_per_level,
        "llik": llik.tolist(), "latent_shape": list(z.shape), "simplex_max_err": simplex_err,
        "peak_device_bytes": torch.cuda.max_memory_allocated(),
    }
    print(json.dumps(e2e), flush=True)
    if launches["project_normed"] == 0 or launches["collapse"] == 0:
        raise AssertionError(f"main path skipped a kernel: {launches}")
    if z.shape != (vec.num_columns, args.n_latent_topics) or not np.isfinite(z).all():
        raise AssertionError("per-cell latent is not finite or has the wrong shape")
    if simplex_err > 1e-3:
        raise AssertionError(f"per-cell latent is not a simplex: {simplex_err}")
    if not (len(llik) == args.epochs and np.isfinite(llik).all()):
        raise AssertionError("llik trace is not finite")

    # ---- phase 3: kernels against their plain versions -------------------
    mark("3 kernel checks", t_script)
    # The main path's own calls: its first block of 8,192 cells (K1, and
    # K3's group and batch planes of `collect_basic_stats`) and its first
    # block of matched cells (K3's weighted plane of `collect_matched_stats`).
    levels = res["levels"]
    d_e2e, n_cells = vec.num_rows, vec.num_columns
    blk = next(iter(visit_columns_by_block(vec, block_size=args.block_size)))
    rows, ptr, vals = block_to_device(blk, dev)
    basis = torch.from_numpy(levels.basis_dk).to(dev)
    fine = levels.groups_per_level[0].astype(np.int32)
    n_fine = levels.num_groups_per_level[0]
    batches = vec.batch_membership().astype(np.int32)
    n_batches = vec.num_batches
    seg = torch.from_numpy(fine[: blk.ncols]).to(dev)
    bseg = torch.from_numpy(batches[: blk.ncols]).to(dev)
    m_idx, m_dist, m_valid = matched_neighbors_across_batches(
        levels.proj_kn.T.copy(), batches, n_batches, args.knn_cells, device=dev
    )
    mrows, mptr, mvals, _, mseg = matched_block(
        vec, fine, m_idx, m_dist, m_valid, 0, MATCHED_CELL_BLOCK, device=dev
    )
    # K3 launches of the e2e run by plane: one group and one batch launch
    # per block of 8,192 cells, one matched launch per 1,024 queries
    n_blocks = -(-n_cells // args.block_size)
    plane_launches = {
        "group_plane": n_blocks, "batch_plane": n_blocks,
        "matched_plane": -(-n_cells // MATCHED_CELL_BLOCK),
    }
    if sum(plane_launches.values()) != launches["collapse"]:
        raise AssertionError(f"K3 launches {launches['collapse']} are not {plane_launches}")
    # K = 200 (past the first design's cap of 128): the same block with
    # the port's seeded basis at that width
    wide = torch.from_numpy(projection_basis(d_e2e, 200, 7)).to(dev)
    checks = {
        "project_normed": [
            check_projection(K, basis, rows, ptr, vals, normed=True, shape="e2e_block"),
            check_projection(K, wide, rows, ptr, vals, normed=True, shape="e2e_block_k200"),
        ],
        "project_raw": [
            check_projection(K, basis, rows, ptr, vals, normed=False, shape="e2e_block"),
            check_projection(K, wide, rows, ptr, vals, normed=False, shape="e2e_block_k200"),
        ],
        "collapse": [
            check_collapse(K, rows, ptr, vals, seg, num_genes=d_e2e, num_groups=n_fine,
                           shape="group_plane"),
            check_collapse(K, rows, ptr, vals, bseg, num_genes=d_e2e, num_groups=n_batches,
                           shape="batch_plane"),
            check_collapse(K, mrows, mptr, mvals, mseg, num_genes=d_e2e, num_groups=n_fine,
                           shape="matched_plane"),
        ],
    }
    for row in checks["collapse"]:
        row["launches_in_e2e"] = plane_launches[row["shape"]]
        row["path"] = "senna_topic"
    for name in ("project_normed", "project_raw"):
        for row in checks[name]:
            row["launches_in_e2e"] = launches[name] if row["shape"] == "e2e_block" else 0
            row["path"] = "senna_topic"
    d, pbasis, prows, pptr, pvals, pseg = production_block(dev)
    production = {
        "project_normed": check_projection(K, pbasis, prows, pptr, pvals, normed=True, shape="production"),
        "project_raw": check_projection(K, pbasis, prows, pptr, pvals, normed=False, shape="production"),
        "collapse": check_collapse(K, prows, pptr, pvals, pseg, num_genes=d, num_groups=607,
                                   shape="production"),
    }
    for name, rows_ in checks.items():
        production[name]["launches_in_e2e"] = 0
        production[name]["path"] = "production_shape"
        for row in rows_ + [production[name]]:
            print(json.dumps({"kernel_check": name, "card": card, **row}), flush=True)
        rows_.append(production[name])

    # ---- phase 4: where the trainer's construction spends its time ---------
    mark("4 set-up split", t_script)
    probe = subprocess.run(
        [sys.executable, "-c", SETUP_PROBE], capture_output=True, text=True, check=True,
        cwd=Path(__file__).resolve().parent,
    )
    print(probe.stdout.strip().splitlines()[-1], flush=True)
    # phase 40's annotate process: its host Leidens run beside phases 5-39
    slice17_started = start_annotate_projection(work, dev)
    # the later phases' simulations, on the host from here on (after the
    # first kernel timings and the set-up split, which they would disturb;
    # started before phase 4 they took bge's Leiden from 25.5 to 77.3 s)
    start_prefetch(sim.row_names)

    # ---- phase 5: senna bge end to end -----------------------------------
    mark("5 senna bge", t_script)
    # The first BGE_CELLS simulated cells without their batches: with
    # batches bge takes the stratified marginal, which has no kernel.
    bvec = SparseIoVec()
    bvec.push(MemoryBackend(sim.counts[:, :BGE_CELLS], sim.row_names,
                            sim.col_names[:BGE_CELLS]))
    bargs = BgeArgs()
    ncfg = NceConfig()
    bargs.out = f"{work}/bge"  # phase 14 aligns these outputs
    before_bytes = torch.cuda.memory_allocated()  # what the topic phase still holds
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    t0 = time.time()
    bres = run_bge(bargs, vec=bvec, device=dev)
    torch.cuda.synchronize()
    bge_s = time.time() - t0
    blaunches = dict(K.launch_counts)
    n_blocks2 = -(-bvec.num_columns // ncfg.cell_batch)
    k4_expected = bargs.epochs * 1 + n_blocks2 * ncfg.phase2_epochs
    lat, fe, tl = bres["latent"], bres["feature_embedding"], bres["topic_latent"]
    p1 = bres["phase1_losses"]
    tl_err = float(np.abs(np.exp(tl.astype(np.float64)).sum(1) - 1.0).max())
    print(json.dumps({
        "phase": "senna_bge", "cells": bvec.num_columns, "genes": bvec.num_rows,
        "groups": bres["num_groups"], "topics": int(tl.shape[1]), "run_s": bge_s,
        **bres["timings"], "launches": blaunches, "nce_epoch_expected": k4_expected,
        "phase1_losses": p1, "phase2_losses_first_last": [bres["phase2_losses"][0],
                                                          bres["phase2_losses"][-1]],
        "latent_shape": list(lat.shape), "feature_embedding_shape": list(fe.shape),
        "topic_latent_simplex_max_err": tl_err,
        "device_bytes_before": before_bytes,
        "peak_device_bytes": torch.cuda.max_memory_allocated(), "card": card,
    }), flush=True)
    if min(blaunches["project_normed"], blaunches["collapse"], blaunches["nce_epoch"]) == 0:
        raise AssertionError(f"bge skipped a kernel: {blaunches}")
    if blaunches["collapse"] != -(-bvec.num_columns // 8192):
        raise AssertionError(f"bge K3 launches {blaunches['collapse']}: one per 8,192-cell block")
    if blaunches["nce_epoch"] != k4_expected:
        raise AssertionError(f"K4 launched {blaunches['nce_epoch']} times, expected {k4_expected}")
    if blaunches["nce_epoch_axis"] != n_blocks2 * ncfg.phase2_epochs:
        raise AssertionError(f"K4's axis form launched {blaunches['nce_epoch_axis']} times, "
                             f"expected every phase-2 step ({n_blocks2 * ncfg.phase2_epochs})")
    if lat.shape != (bvec.num_columns, bargs.embed_dim) or not np.isfinite(lat).all():
        raise AssertionError("bge cell latent is not finite or has the wrong shape")
    if fe.shape != (bvec.num_rows, bargs.embed_dim) or not np.isfinite(fe).all():
        raise AssertionError("bge feature embedding is not finite or has the wrong shape")
    if not p1[-1] < p1[0]:
        raise AssertionError(f"bge phase-1 loss did not fall: {p1}")
    if tl_err > 1e-3:
        raise AssertionError(f"bge topic latent is not a log-simplex: {tl_err}")

    # ---- phase 6: phase 1 at the NCE anchor, f32 and bf16 ------------------
    mark("6 NCE anchor", t_script)
    acounts = anchor_counts()
    anchor = {}
    for dt in ("float32", "bfloat16"):
        K.reset_launch_counts()
        t0 = time.time()
        ares = fit_bge([acounts], config=NceConfig(embedding_dim=16, epochs=1000, compute_dtype=dt),
                       device=dev)
        torch.cuda.synchronize()
        anchor[dt] = ares
        print(json.dumps({
            "phase": "nce_anchor", "compute_dtype": dt, "rows": acounts.shape[0],
            "genes": acounts.shape[1], "h": 16, "epochs": 1000, "fit_s": time.time() - t0,
            "phase1_s": ares.timings["phase1_s"], "final_loss": ares.phase1_losses[-1],
            "phase1_losses": ares.phase1_losses, "nce_epoch_launches": K.launch_counts["nce_epoch"],
            "card": card,
        }), flush=True)
        if K.launch_counts["nce_epoch"] != 1000:
            raise AssertionError(f"anchor {dt}: {K.launch_counts['nce_epoch']} K4 launches")
    l32, l16 = anchor["float32"].phase1_losses[-1], anchor["bfloat16"].phase1_losses[-1]
    if not abs(l16 - l32) <= RTOL_BF16_LOSS * abs(l32):
        raise AssertionError(f"anchor bf16 final loss {l16} vs f32 {l32}")

    # ---- phase 7: K4 against its plain version -----------------------------
    mark("7 K4 checks", t_script)
    # The e2e run's phase-1 plane (its groups x 2,000 genes) with its
    # trained feature side, one of its phase-2 blocks (2,048 cells), and
    # the anchor plane in f32 and bf16 with that run's trained sides; and
    # K3 at the bge run's own group plane.
    fit = bres["result"]
    pb = bres["pb"]
    pb_t = dev32(pb, dev)
    q_pb = dev32(_neg_marginal(pb, ncfg.neg_alpha), dev)
    e_f, b_f = dev32(fit.e_feat, dev), dev32(fit.b_feat, dev)
    n_pb = pb.shape[0]
    blk = next(iter(visit_columns_by_block(bvec, block_size=ncfg.cell_batch)))
    r, pt, v = block_to_device(blk, dev)
    x = densify_block(r, col_ids_from_ptr(pt), v, ncols=blk.ncols, num_genes=bvec.num_rows)
    nb = blk.ncols
    k4 = [
        check_nce(K, pb_t, q_pb, e_f, b_f, dev32(fit.pb_embeddings[0], dev),
                  dev32(fit.pb_biases[0], dev), pb_t.sum(1), shape="e2e_phase1_plane"),
        check_nce(K, x, q_pb, e_f, b_f, dev32(fit.e_cell[:nb], dev), dev32(fit.b_cell[:nb], dev),
                  x.sum(1), shape="e2e_phase2_block"),
        check_nce(K, x, q_pb, e_f, b_f, dev32(fit.e_cell[:nb], dev), dev32(fit.b_cell[:nb], dev),
                  x.sum(1), shape="e2e_phase2_block_axis", need_feat=False),
    ]
    # phase 1 takes the full form; phase 2, the feature side frozen, the axis form
    k4[0]["launches_in_e2e"] = bargs.epochs
    k4[1]["launches_in_e2e"] = 0
    k4[2]["launches_in_e2e"] = n_blocks2 * ncfg.phase2_epochs
    for row in k4:
        row["path"] = "senna_bge"
    ac = dev32(acounts, dev)
    anchor_checks = []
    for dt, cdt in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        ares = anchor[dt]
        row = check_nce(
            K, ac.to(cdt), dev32(_neg_marginal(acounts, ncfg.neg_alpha), dev),
            dev32(ares.e_feat, dev), dev32(ares.b_feat, dev),
            dev32(ares.pb_embeddings[0], dev), dev32(ares.pb_biases[0], dev),
            ac.sum(1), shape=f"anchor_{dt}",
        )
        row["launches_in_e2e"] = 0
        row["launches_in_anchor_run"] = 1000
        row["path"] = "nce_anchor"
        anchor_checks.append(row)
    for row in k4 + anchor_checks:
        print(json.dumps({"kernel_check": "nce_epoch", "card": card, **row}), flush=True)
    checks["nce_epoch"] = k4 + anchor_checks
    # K3 in bge: one launch per 8,192-cell block over the sort-dim groups
    cblk = next(iter(visit_columns_by_block(bvec, block_size=8192)))
    cr, cp, cv = block_to_device(cblk, dev)
    cseg = torch.from_numpy(np.asarray(bres["groups"][: cblk.ncols], np.int32)).to(dev)
    row = check_collapse(K, cr, cp, cv, cseg, num_genes=bvec.num_rows,
                         num_groups=bres["num_groups"], shape="bge_group_plane")
    row["launches_in_e2e"] = blaunches["collapse"]
    row["path"] = "senna_bge"
    print(json.dumps({"kernel_check": "collapse", "card": card, **row}), flush=True)
    checks["collapse"].append(row)

    # ---- phases 10 and 14a, before predict: they need no held-out cell, so
    # they run while its simulation (in the pool since phase 4) ends (phase
    # 16 ran here too: beside the pool its host collapse took 28.7-40.7 s,
    # after it 8.8 s)
    mark("10, 14a fault-1 report, rest --from", t_script)
    # phase 2's fine partition on the card against the port's CPU projection
    # and sort of the same cells with the same arguments
    from legume_tpu_torch.ops import random_projection as rp
    from legume_tpu_torch.senna.topic import compute_level_sort_dims

    t0 = time.time()
    _, proj_cpu = rp.project_columns(
        vec, max(args.proj_dim, args.n_latent_topics), block_size=args.block_size,
        batch_membership=batches if n_batches > 1 else None, seed=args.seed, device="cpu",
    )
    codes_cpu = rp.binary_sort_columns(
        proj_cpu, compute_level_sort_dims(args.sort_dim, args.num_levels)[0], seed=args.seed,
        device="cpu",
    )
    print(json.dumps({
        "phase": "fault1_fine_partition", "cells": n_cells, "cpu_s": time.time() - t0,
        "same_set_partition": same_partition(levels.fine_codes, codes_cpu),
        "same_codes": bool(np.array_equal(levels.fine_codes, codes_cpu)),
        "groups_card": int(len(np.unique(levels.fine_codes))),
        "groups_cpu": int(len(np.unique(codes_cpu))),
        "proj_max_abs_diff": float(np.abs(levels.proj_kn - proj_cpu).max()), "card": card,
    }), flush=True)

    rest_launches = rest_phase(work, vec, K, dev, card)

    # ---- phase 8: senna predict at full width -----------------------------
    mark("8 senna predict", t_script)
    from legume_tpu_torch.data import MemoryBackend as Mem
    from legume_tpu_torch.data import blosc_codec
    from legume_tpu_torch.senna import predict as P
    from legume_tpu_torch.senna.topic import build_model, load_model
    from legume_tpu_torch.utils.manifest import RunManifest
    from legume_tpu_torch.utils.output import have_parquet, read_table, table_path

    t0 = time.time()
    hvec, hbatch = held_out_vec(sim.row_names, seed=43)
    held_sim_s = time.time() - t0
    n_held = hvec.num_columns
    bfile = f"{work}/held.batch.txt"
    Path(bfile).write_text("\n".join(f"donor{'AB'[b]}" for b in hbatch) + "\n")
    pargs = P.PredictArgs(model=args.out, out=f"{work}/predict", batch_files=[bfile],
                          delta_iters=2, refine_steps=10)
    K.reset_launch_counts()
    t0 = time.time()
    zp = P.predict_model(pargs, vec=hvec, device=dev)
    torch.cuda.synchronize()
    predict_s = time.time() - t0
    plaunches = dict(K.launch_counts)
    pman = RunManifest.load(f"{work}/predict.senna.json")
    dtab = read_table(table_path(f"{work}/predict.delta"))
    delta = np.stack([dtab[f"batch{b}"] for b in range(2)], 1)
    p_err = float(np.abs(np.exp(zp.astype(np.float64)).sum(1) - 1.0).max())

    # the first 4,096-cell block on the card and on the CPU, same inputs
    meta, flat, genes = load_model(args.out)
    remap = P.build_gene_remap(genes, hvec.row_names())
    cb = P.read_batch_labels([bfile], n_held)
    prof = P._batch_mean_profiles(hvec, remap, cb, block_size=4096)
    log_dict = P._load_log_dictionary(args.out, genes)
    first = SparseIoVec()
    first.push(Mem(hvec.read_columns_csc(np.arange(4096)), hvec.row_names()))
    enc_cpu = build_model(meta, flat, device="cpu")[0]
    enc_dev = build_model(meta, flat, device=dev)[0]
    # Card against CPU within 1e-3, with and without refinement. The
    # encoder's float32 rounding alone moves log z by 1e-4 to 4e-4 at these
    # weights (each float32 run against the same block in float64 on the
    # CPU, printed beside it), so a bar of 1e-4 without refinement would
    # sit below the reference's own error.
    block_err = {}
    for steps in (0, 10):
        kw = dict(block_size=4096, cell_batch=cb[:4096], batch_profiles=prof, log_dict=log_dict,
                  refine_steps=steps)
        z_c = P.score_dense_backend(first, enc_cpu, remap, device="cpu", **kw)
        z_g = P.score_dense_backend(first, enc_dev, remap, device=dev, **kw)
        block_err[steps] = float(np.abs(z_g - z_c).max())
        if steps == 0:
            x64 = P._dense_block(next(iter(visit_columns_by_block(first, block_size=4096))),
                                 remap, "cpu").double()
            with torch.no_grad():
                z64 = enc_cpu.double()(x64, torch.from_numpy(prof[cb[:4096]]).double(),
                                       train=False)[0].numpy()
            enc_cpu.float()
            card_f64, cpu_f64 = float(np.abs(z_g - z64).max()), float(np.abs(z_c - z64).max())
        if not block_err[steps] <= 1e-3:
            raise AssertionError(f"predict block, {steps} refinement steps: card vs CPU "
                                 f"{block_err[steps]} > 1e-3")
    e2e_vs_block = float(np.abs(zp[:4096] - z_g).max())

    sub = SparseIoVec()
    sub.push(Mem(hvec.read_columns_csc(np.arange(10_000)), hvec.row_names()))
    t0 = time.time()
    zd = P.predict_model(P.PredictArgs(model=args.out, out=f"{work}/predict_dec",
                                       decoder_only=True), vec=sub, device=dev)
    torch.cuda.synchronize()
    decoder_only_s = time.time() - t0
    d_err = float(np.abs(np.exp(zd.astype(np.float64)).sum(1) - 1.0).max())

    t0 = time.time()
    resid = P.residual_csc(hvec, zp, log_dict, remap, delta_db=delta, cell_batch=cb, device=dev)
    torch.cuda.synchronize()
    residual_s = time.time() - t0
    writers = {"zarr (pyarrow zstd)": storage_libraries()["zstd_pyarrow"],
               "h5 (h5py)": importlib.util.find_spec("h5py") is not None,
               "h5 blosc (libblosc)": blosc_codec.available(),
               "parquet (pandas, pyarrow)": have_parquet()}
    print(json.dumps({
        "phase": "senna_predict", "cells": n_held, "genes": hvec.num_rows,
        "mapped_genes": pman.params["n_mapped"], "simulate_wait_s": held_sim_s, "run_s": predict_s,
        **pman.timings, "launches": plaunches, "delta_min": float(delta.min()),
        "delta_max": float(delta.max()), "latent_shape": list(zp.shape),
        "latent_finite": bool(np.isfinite(zp).all()), "simplex_max_err": p_err,
        "first_block_card_vs_cpu": {"refine_0": block_err[0], "refine_10": block_err[10]},
        "first_block_vs_f64": {"card": card_f64, "cpu": cpu_f64},
        "first_block_e2e_vs_alone": e2e_vs_block,
        "decoder_only": {"cells": sub.num_columns, "run_s": decoder_only_s,
                         "simplex_max_err": d_err, "finite": bool(np.isfinite(zd).all())},
        "residual": {"shape": list(resid.shape), "nnz": int(resid.nnz), "seconds": residual_s,
                     "finite": bool(np.isfinite(resid.data).all())},
        "writers_importable": writers, "card": card,
    }), flush=True)
    if pman.params["n_mapped"] != 2000:
        raise AssertionError(f"predict mapped {pman.params['n_mapped']} of 2,000 genes")
    if not (0.01 <= delta.min() and delta.max() <= 100.0):
        raise AssertionError(f"delta outside [0.01, 100]: {delta.min()}, {delta.max()}")
    if zp.shape != (n_held, args.n_latent_topics) or not np.isfinite(zp).all() or p_err > 1e-3:
        raise AssertionError(f"predict latent is not a finite simplex ({p_err})")
    if not np.isfinite(zd).all() or d_err > 1e-3:
        raise AssertionError(f"decoder-only latent is not a finite simplex ({d_err})")
    if resid.shape != hvec.shape or not np.isfinite(resid.data).all():
        raise AssertionError("residual matrix is not finite or has the wrong shape")

    # ---- phase 9: senna clustering on that latent ---------------------------
    mark("9 clustering", t_script)
    from legume_tpu_torch.ops.hsblock import hsblock_clustering
    from legume_tpu_torch.ops.leiden import knn_adjacency
    from legume_tpu_torch.senna.clustering import ClusteringArgs, cluster_latent, run_clustering

    latent_path = table_path(f"{work}/predict.latent")
    K.reset_launch_counts()
    t0 = time.time()
    km = run_clustering(ClusteringArgs(latent=latent_path, out=f"{work}/km", method="kmeans",
                                       n_clusters=10), vec=hvec, device=dev)
    torch.cuda.synchronize()
    kmeans_bhc_s = time.time() - t0
    claunches = dict(K.launch_counts)
    bhc_blocks = -(-n_held // ClusteringArgs.bhc_block_size)
    cut = read_table(table_path(f"{work}/km.bhc.cut"))
    t0 = time.time()
    hs = run_clustering(ClusteringArgs(latent=latent_path, out=f"{work}/hs", method="hsblock",
                                       hsblock_depth=4), device=dev)
    torch.cuda.synchronize()
    hsblock_s = time.time() - t0
    adj5 = knn_adjacency(np.exp(zp[:5000]), k=15, device=dev)
    hs_card = hsblock_clustering(adj5, max_depth=4, seed=0, device=dev).membership
    hs_cpu = hsblock_clustering(adj5, max_depth=4, seed=0, device="cpu").membership
    t0 = time.time()
    ld = cluster_latent(zp[:LEIDEN_CELLS], ClusteringArgs(method="leiden"), device=dev)
    leiden_s = time.time() - t0
    print(json.dumps({
        "phase": "senna_clustering", "cells": n_held, "kmeans_bhc_s": kmeans_bhc_s,
        "kmeans_clusters": int(km.max()) + 1, "bhc_consensus_clusters": int(cut["consensus"].max()) + 1,
        "launches": claunches, "collapse_expected": bhc_blocks, "hsblock_s": hsblock_s,
        "hsblock_clusters": int(hs.max()) + 1,
        "hsblock_5000_card_vs_cpu_same_partition": same_partition(hs_card, hs_cpu),
        "hsblock_5000_clusters": [int(hs_card.max()) + 1, int(hs_cpu.max()) + 1],
        "leiden_cells": LEIDEN_CELLS, "leiden_s": leiden_s, "leiden_clusters": int(ld.max()) + 1,
        "card": card,
    }), flush=True)
    if claunches["collapse"] != bhc_blocks:
        raise AssertionError(f"BHC K3 launches {claunches['collapse']}, expected {bhc_blocks}")
    if not same_partition(hs_card, hs_cpu):
        raise AssertionError("hsblock on the card and on the CPU gave different partitions")
    # K3 at one BHC plane: the first 4,096-cell block over the k-means labels
    hblk = next(iter(visit_columns_by_block(hvec, block_size=ClusteringArgs.bhc_block_size)))
    hr, hp, hv = block_to_device(hblk, dev)
    hseg = torch.from_numpy(km[: hblk.ncols].astype(np.int32)).to(dev)
    row = check_collapse(K, hr, hp, hv, hseg, num_genes=hvec.num_rows, num_groups=int(km.max()) + 1,
                         shape="bhc_plane")
    row["launches_in_e2e"] = claunches["collapse"]
    row["path"] = "senna_clustering"
    print(json.dumps({"kernel_check": "collapse", "card": card, **row}), flush=True)
    checks["collapse"].append(row)

    # ---- phase 11: senna layout, pseudotime and plot on that latent ---------
    mark("11 layout", t_script)
    layout_launches = layout_phase(work, zp, args.out, K, dev, card)

    # ---- phase 12: the senna topic options ------------------------------------
    mark("12 topic options", t_script)
    option_launches = topic_options_phase(work, sim, vec, args.out, levels, sub, K, dev, card)

    # ---- phases 13-16: bge options, rest, cocoa, topic --cnv -----------------
    mark("13-16 bge options, rest --runs, cocoa, topic --cnv", t_script)
    kept: dict = {}
    slice9 = bge_options_phase(work, bvec, bres, acounts, anchor["float32"], K, dev, card, checks,
                               kept)
    slice9["rest"] = rest_launches
    rest_runs_phase(work, dev, card)
    slice9.update(cocoa_phase(work, K, dev, card, checks, kept))
    slice9["topic_cnv"] = topic_cnv_phase(work, vec, K, dev, card)

    # ---- phases 17-20: vae, svd / joint-svd, joint-topic, masked models ----
    mark("17-20 vae, svd, joint, masked", t_script)
    bam_started = start_bam(work)  # phase 32's host half, meanwhile
    faba_all_started = start_faba_all(work)  # phase 39's host half, meanwhile
    slice17_started.update(start_lineage_y(work, dev))  # phase 40's lineage, meanwhile
    slice10 = vae_phase(work, vec, hvec, bfile, K, dev, card)
    slice10.update(svd_phase(work, vec, kept["multiome"], K, dev, card, checks))
    slice10.update(joint_topic_phase(work, kept["multiome"], K, dev, card))
    slice10.update(masked_phase(work, vec, hvec, K, dev, card, checks))

    # ---- phases 21-27: stores, annotation, deconvolve, impute, probe, fne --
    mark("21-27 stores .. fne", t_script)
    beans_sim = start_beans_sim(work, sim)  # phase 28, on the host meanwhile
    slice11, store = store_phase(work, sim, res, K, dev, card)
    slice11.update(annotation_phase(work, sim, res, args.out, store, K, dev, card))
    slice11.update(deconvolve_phase(work, sim, vec, res, K, dev, card, checks))
    slice11.update(impute_probe_phase(work, vec, hvec, res, args.out, K, dev, card))
    slice11.update(fne_phase(work, K, dev, card, checks))
    slice11_card_vs_cpu(work, sim, args.out, store, dev, card)

    # ---- phases 28-31: data-beans-sim, data-beans, ingestion, GFF -----------
    mark("28-31 data-beans, ingest, gff", t_script)
    slice12 = beans_sim_phase(work, sim, store, beans_sim, card)
    # 5,000 cells for to-mtx, convert and the ingestion: the depth cut that
    # keeps the script near 1,000 s with phases 35-36
    # phase 31 runs on the card while phase 29's CLI processes run
    slice12.update(beans_phase(work, sim, store, K, dev, card, sub_cells=BEANS_CELLS,
                               meanwhile=lambda: slice12.update(gff_phase(work, kept, K, dev,
                                                                          card))))
    slice12.update(ingest_phase(work, sim, res, store, card, mtx_cells=BEANS_CELLS))

    # ---- phases 32-34: faba index / genes, faba gem, faba dyn-assoc -------------
    mark("32-34 faba bam, gem, assoc", t_script)
    pinto_started = start_pinto_sim(work)  # phase 35's cells, on the host meanwhile
    slice13 = bam_phase(work, bam_started, card)
    gem_res = gem_phase(work, sim, store, K, dev, card, checks)
    slice13.update(gem_res["launches"])
    slice13.update(assoc_phase(work, gem_res["cell_pseudotime"], K, dev, card))
    # phase 41's process, beside phases 35-39: it reads phases 2, 33 and 34
    from_gem_started = start_lineage_from_gem(work, args.out, _factor_gmt(work, sim), dev)

    # ---- phases 35-36: pinto ----------------------------------------------------
    mark("35-36 pinto", t_script)
    genetics = start_genetics_sims(work)  # phases 37-38's inputs, on the host meanwhile
    pinto = pinto_phase(work, pinto_started, K, dev, card, checks)
    slice14 = pinto["launches"]
    slice14.update(pinto_commands_phase(work, pinto["kept"], K, dev, card, checks))

    # ---- phases 37-38: fagioli, chickpea ------------------------------------------
    mark("37-38 fagioli, chickpea", t_script)
    slice15 = fagioli_phase(work, genetics, K, dev, card, checks)
    slice15.update(chickpea_phase(work, genetics, K, dev, card, checks))

    # ---- phase 39: faba all ---------------------------------------------------------
    mark("39 faba all", t_script)
    slice16 = faba_all_phase(work, faba_all_started, card)

    # ---- phases 40-42: faba lineage / annotate / plot, the model stack -----------
    mark("40-42 faba lineage, annotate, model stack", t_script)
    slice17 = slice17_phase(work, slice17_started, K, dev, card)
    slice17.update(lineage_from_gem_phase(work, from_gem_started, sim.counts.shape[1], K, dev,
                                          card))
    launched = {path: {k: v for k, v in counts.items() if v}
                for path, counts in {**slice17, **{k: v for k, v in slice16.items()
                                                   if k != "faba_all"}}.items()}
    print(json.dumps({"phase": "slice17_launches", "expected": 0,
                      "launched": {p: c for p, c in launched.items() if c}, "card": card}),
          flush=True)
    if any(launched.values()):
        raise AssertionError(f"a kernel launched on a path that has none: {launched}")
    model_stack_phase(dev, card)

    # ---- phase 43: the kernels line, then the device line -----------------
    # Each kernel's numbers are those of its main-path shape with the most
    # e2e launches; `max_abs_err` is the largest over its checked shapes,
    # and `shapes` holds every checked shape, each with the run (`path`)
    # whose launches `launches_in_e2e` counts. `launches` is the count of
    # the kernel's own main paths: `senna topic` for K1, `senna svd` for
    # K2, `senna topic` and `senna clustering`'s BHC sums for K3, `senna
    # bge` for K4; `launches_bge` is each kernel's count in bge,
    # `launches_clustering` K3's in clustering, `launches_topic_options`
    # each kernel's count summed over phase 12's runs, and
    # `launches_<path>` its count in each run of phases 13-20 (multiome,
    # posterior, rest, diff, collapse, topic_cnv; vae, vae_predict,
    # topic_gaussian_nb, svd, joint_svd, joint_topic, joint_topic_delta,
    # masked_topic, masked_vae, masked_sbp, masked_predict; topic_zarr,
    # qmatrix, annotate_by_enrichment, annotate_ontology,
    # annotate_by_projection_from, annotate_by_projection_train,
    # deconvolve, deconvolve_reference, impute, impute_reference, probe,
    # probe_latent, fne; data_beans_sim_topic, data_beans, ingest,
    # diff_gff; faba_genes, gem_raw, gem_posterior, gem_lineage,
    # gem_encoder, gem_bam, assoc_bayes, assoc_gam; pinto_lc, pinto_cascade,
    # pinto_gene_network, pinto_prop, pinto_dsvd, pinto_cage, pinto_lc_etm,
    # pinto_lra, pinto_annotate; fagioli_pseudobulk, fit_qtl_sgvb,
    # chickpea_p2g; faba_all, faba_pwm_reference, faba_pwm_reads_wt,
    # faba_pwm_reads_ct, faba_metagene, faba_pileup_wt, faba_pileup_ct,
    # faba_inspect, faba_docs; faba_lineage, faba_lineage_subset,
    # faba_lineage_subset_cpu, faba_annotate_projection, faba_plot where
    # matplotlib imports, faba_lineage_from, faba_dyn_assoc_lineage,
    # faba_annotate_enrichment: none of the four kernels is on slice 17's
    # paths, so each of its counts is 0, as the slice17_launches line says).
    meta = {
        "project_normed": ("legume_tpu_torch/csrc/project.cu", "legume_tpu/ops/pallas_kernels.py:352"),
        "project_raw": ("legume_tpu_torch/csrc/project.cu", "legume_tpu/ops/pallas_kernels.py:93"),
        "collapse": ("legume_tpu_torch/csrc/collapse.cu", "legume_tpu/ops/pallas_kernels.py:480"),
        "nce_epoch": ("legume_tpu_torch/csrc/nce_epoch.cu", "legume_tpu/embedding/nce_pallas.py:101"),
    }
    kernels = []
    for name, (source, replaces) in meta.items():
        main = max(checks[name], key=lambda r: r.get("launches_in_e2e", 0))
        entry = {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": (blaunches[name] if name == "nce_epoch" else launches[name]
                         + claunches[name] + (slice10["svd"][name] if name == "project_raw" else 0)),
            "launches_bge": blaunches[name],
            "launches_layout_pseudotime_plot": sum(layout_launches.values()),
            "launches_topic_options": option_launches.get(name, 0),
            **{f"launches_{path}": counts[name]
               for path, counts in {**slice9, **slice10, **slice11, **slice12,
                                    **slice13, **slice14, **slice15,
                                    **slice16, **slice17}.items()},
            **({"launches_clustering": claunches[name]} if name == "collapse" else {}),
            **({"launches_axis": blaunches["nce_epoch_axis"]} if name == "nce_epoch" else {}),
            "max_abs_err": max(r["max_abs_err"] for r in checks[name]),
            "deterministic": all(r["deterministic"] for r in checks[name]),
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": main["library_ms"], "shape": main["shape"],
        }
        if len(checks[name]) > 1:
            keep = ("shape", "form", "launches_in_e2e", "max_abs_err", "deterministic", "ms",
                    "plain_ms", "bound_ms", "bound_by", "bound_bytes_ms", "bound_ops_ms",
                    "bound_core_ms", "bound_tensor_ms", "library_ms")
            entry["shapes"] = [{"path": r.get("path"), **{k: r[k] for k in keep if k in r}}
                               for r in checks[name]]
        kernels.append(entry)
    print(json.dumps({"phase": "total", "seconds": time.time() - t_script, "card": card}),
          flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                   "count": torch.cuda.device_count()},
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
