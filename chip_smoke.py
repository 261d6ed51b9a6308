#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (svim_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which raises (non-zero exit) on failure:
  1. environment: a CUDA device is required; prints the card's name and
     power limit (nvidia-smi) and the torch / CUDA versions;
  2. build: compiles the eight kernel sources, csrc/wavefront.cu,
     span_distance.cu, agglomerate.cu, collect_scan.cu,
     classify_segments.cu, genotype_support.cu, ins_matrices.cu and
     gotoh.cu, with
     nvcc (all at once) and, beside them, the port's native host library
     (svim_tpu_torch/native: scan session, POA) with g++, all into
     svim_tpu_torch/_build;
  2b. in a process of its own, started after the build: one wrapper call
     of the COLLECT, GENOTYPE and INS matrix kernels at the bench's shapes
     runs the device kernels its design says (torch.profiler: one a call),
     and the GENOTYPE and INS calls enqueue under
     torch.cuda.set_sync_debug_mode("error");
  2c. in a process of its own for each fault of INS_TRAPS (pair columns out
     of partition order, a pair outside the matrices), started after the
     build: the INS matrix kernel takes seeded columns as the host builds
     them, the plain version refuses the faulty ones (ValueError) and the
     kernel traps on them (the process dies of a CUDA error); then the
     first designs of GENOTYPE's join and of the INS matrices (their
     sources at SLICE_DESIGN_COMMIT) are built, and the registers, spills
     and shared memory of present and first designs logged (cuobjdump);
  3. kernel vs plain version on the card: banded_distance_cuda against
     banded_distance_torch on seeded inputs (half near-identical pairs, half
     random) at the main path's shapes and at one case per code path of the
     kernel (warp kernel with a ragged last CTA, the strip layout with
     staged and unstaged strings, narrow passes that resolve and that run
     on to W, empty and one-character strings, and every case of the card
     tests of tests/test_torch_wavefront.py, which need jax to be collected
     and so run nowhere); outputs must be exactly equal, above the band
     too, through the dispatcher as well (one launch a call), and 64
     resolved entries must equal the O(nm) dynamic program below; then at
     L = W = 32,768 (WIDE_SHAPES: pairs the ladder resolves and unrelated
     pairs that run to W, through either strip layout) every pair must
     equal the native edit distance and a seeded sample of them the plain
     version; the first design of the kernel (WAVEFRONT_DESIGN_COMMIT, one
     CTA a pair with a barrier a front) is timed beside the present one in
     turns at the warp shape MAIN_SHAPE and on unrelated pairs at L = W =
     16,384 and 32,768 (DESIGN_SHAPES);
  4. golden slice: `alignment --edit_backend wavefront` on the simulated
     workload of tests/test_golden_vcf.py must write a variants.vcf
     byte-equal to tests/golden/variants.golden.vcf (##fileDate aside) and
     resolve its partitions by the same routes as svim_tpu
     (GOLDEN_TELEMETRY);
  5. bench-size slice: the bench.py workload at 8192 reads through the port
     with --edit_backend wavefront and with the default; both variants.vcf
     must be byte-equal and equal to svim_tpu's (BENCH_VCF_SHA256), and the
     clustering telemetry must equal svim_tpu's (BENCH_TELEMETRY); prints
     stage seconds, calls per class, kernel launches and reads/s through
     COLLECT+CLUSTER;
  5b. tie-free slice: svim_tpu_torch.workloads.tiefree_workload at 8192
     reads, the workload whose partitions the device labels, with
     --incremental_cluster off and either edit backend: VCF sha256,
     telemetry and accepted labelings by route equal to svim_tpu's
     (TIEFREE_*), with labelings accepted on the fused and on the matrix
     route and the agglomeration kernel launched; then at the CLI's
     defaults: the same VCF; prints stage seconds of each run;
  6. linkage ops on the card: every call the main path made to the
     agglomeration ops in phases 4-5b (all three must have been called, on
     the card) is re-run on the CPU and must agree, and is run through
     the kernel (csrc/agglomerate.cu) and through the plain version on the
     card: merges, heights, min_gap, dropped, has_wall and dedup_ambiguous
     must be equal bit for bit on every row; every INS matrix call goes
     through csrc/ins_matrices.cu and the plain version on the card,
     bit-equal to each other, to the run's own matrices and to the CPU's
     on every cell off the diagonal, and the agglomeration call that took
     them gives bit-equal outputs on either; so do the seeded cases of
     ins_matrix_cases (P = 32 and 128, padding pairs only, spans 0 and past
     2^24, wrapping starts, norms around 1), and the kernel is timed beside
     its first design (in turns, outputs bit-equal off the diagonal), its
     plain version and bound at the bench's largest call and at
     INS_TIMED_SHAPES; the same for seeded tie-free
     partitions, whose labels built from the card's merges must equal exact
     float64 host linkage, and for the seeded cases of agglomerate_cases
     (every kind with and without the wall, negative starts, zero spans,
     wrapping coordinates, 3 and 128 valid slots in one call, padding
     partitions, exact ties, matrices that are not symmetric, valid counts
     across the packing of 32-slot partitions four a CTA, norms around the
     range of the build's written-out division, tiny distances, B = 8 and
     1024); logs each kernel's registers and spills (cuobjdump) and prints
     kernel and plain ms at B = 1024 with full partitions at P = 128 and
     P = 32 beside the bound and beside the rescan design's ms (the
     kernel's source at RESCAN_DESIGN_COMMIT, built in the same process
     when git or that commit's files unpacked under _chipwork/<commit>
     have it);
  7. distance kernel vs plain version on the card: span_position_matrix_cuda
     against span_position_matrix_torch on seeded partitions at P in {32,
     128} and B in {8, 1024, 8192}, with and without the same-read wall,
     plus the case of tests/test_parallel.py, P = 64 and 256, P not a
     multiple of 4, B = 1, more partitions than the card holds CTAs, P too
     large to stage in shared memory, each forced path of the kernel once
     and norms in, on the edges of and outside the range of its written-out
     division (distance_cases), then untimed every case of the card tests
     of tests/test_torch_distance.py (_distance_cross); outputs must be
     bit-equal; prints kernel and plain ms per shape (no entry point calls
     this kernel, as in the JAX package);
  8. streaming slice: the bench BAM rewritten as level-0 BGZF (over 96 MiB,
     same records) through `alignment --edit_backend wavefront --profile`
     must stream (io.bamstream.BATCHES), launch the wavefront kernel, match
     BENCH_TELEMETRY["wavefront"] and hash to BENCH_VCF_SHA256; prints stage
     seconds and reads/s through COLLECT+CLUSTER; the golden workload under
     `--stream_input --batch_reads 64` must write the golden VCF (with
     --edit_backend wavefront);
  9. the other inputs: the golden workload as SAM text and as a
     queryname-sorted BAM (SA entries as real supplementary records) with
     --edit_backend wavefront must write VCFs hashing to svim_tpu's
     (SAM_VCF_SHA256, QUERYNAME_VCF_SHA256) and launch the wavefront kernel;
 10. the default main path, mid-scan incremental clustering
     (--incremental_cluster auto, which phases 4, 5, 8 and 9 switch off
     because their pinned telemetry and launch counts were measured so):
     the bench BAM one-shot with --batch_reads 512 and both edit backends,
     once with the scan delivered in chunks of 512 rows (partitions must be
     reused from the mid-scan memo) and once as the scan comes (reuse is
     whatever the walker's lead allows), and the golden workload in chunks
     of 64; every VCF must hash to the pinned one; prints COLLECT and
     CLUSTER seconds beside phase 5's `off` runs;
 10b. every agglomeration call of the recorded tie-free runs (phase 5b,
     both edit backends) and of the chunked mid-scan `wavefront` run of
     phase 10 launched again on its own inputs and timed on the card
     (B, P, the largest valid count, kernel ms beside the rescan design's
     and the bound); these rows join the `kernels` line's `by_shape`;
 11. the other flags on the golden workload: --device_backend host must
     write the golden VCF with no kernel launch; --profile_trace (with
     --edit_backend wavefront) must write the golden VCF and Chrome traces
     under traces/ whose CLUSTER trace names the wavefront kernel.
 12. `reads` mode: stub ngmlr, minimap2, samtools and gunzip executables on
     PATH (svim_tpu_torch.workloads.stub_aligners; the aligner "produces"
     the golden records as SAM text, the samtools stub sorts them into a
     BGZF BAM with the port's io layer) and `reads <wd> <fastq> <genome>
     --edit_backend wavefront`: the golden VCF, as many wavefront launches
     as phase 4, and a second run that re-uses the cached BAM without a new
     stub call;
 13. --distributed: the bench workload with `--distributed --edit_backend
     wavefront --profile` as 2 and as 3 rank subprocesses sharing the one
     card (3 leaves uneven ranges), and the golden workload as 2; every rank
     must exit 0, name a CUDA device in its log, launch the wavefront
     kernel and hold neither jax nor svim_tpu in its interpreter; rank 0's
     variants.vcf must hash to the pinned one and the ranks' eligible
     partition counts must sum to the single-process count; prints each
     rank's stage seconds and exchange bytes beside phase 5's
     single-process seconds (ranks that share a card and its host's cores:
     a correctness run, no scaling figure);
 14. --num_shards: the bench workload with `--num_shards 8 --edit_backend
     wavefront`: pinned VCF, "8 shards over 1 device(s)" in the log; every
     COLLECT scan and GENOTYPE join the run made is re-run unsharded on its
     recorded inputs and must be equal, as must the two agglomeration ops on
     seeded partitions cut into 8; entry.entry() and
     entry.dryrun_multichip(8) run on the card.
 15. the COLLECT kernels: every call the main path made to
     ops.cigar_kernel.collect_scan and ops.segments_kernel.
     classify_groups_fused in phases 4, 5, 5b, 8, 9 and 14 (recorded as
     clones on the card) runs again through csrc/collect_scan.cu and
     csrc/classify_segments.cu and through the plain versions on the card:
     bit-equal to each other and to the path's own outputs; so must the
     seeded cases (collect_cases: every K bucket up to 8192 at thresholds 1
     and 40, clip-only and clipped rows, zero-length ops, ops 3, 9 and 10,
     K = 40,000, N = 1, an overflowing table whose re-run gives every
     event, 8 shards with one overflowing merged as the whole batch;
     K = 1001, K = 8192 at N = 1,000, rows past what the scan's grid
     stages in shared memory at K = 32; classify_cases: S = 2, 64, 128, 256 with key
     ties, invalid slots in the middle, gated and padding groups, every
     code, twins and cross-contig pairs, the warp route at S = 3, 4, 5, 7,
     8, 16, 32 and a max_segments cut inside a warp's segment).  Both ops,
     and the 8-shard scan, must enqueue on card tensors under
     torch.cuda.set_sync_debug_mode("error") (and, in phase 2b, a process
     started after the build, a call of either must run one device kernel:
     torch.profiler, KERNELS_PER_CALL); prints the launch floor (an empty
     kernel; an empty cooperative grid meeting at one barrier) and kernel
     and plain ms beside the bound by bytes and beside the first designs
     (their sources at COLLECT_DESIGN_COMMIT, built in the same process,
     timed in turns, outputs bit-equal) at the bench batch shapes, for the
     scan at N = 4096 with K = 128, 512, 1024, 2048 and 8192 and for the
     classify at G = 512, S = 8.
 16. GENOTYPE's join: every call the main path made to
     ops.genotype_kernel.genotype_support_batched in phases 4, 5, 5b, 8
     and 14 (recorded as clones on the card; phase 9's SAM text genotypes
     by host region queries and its queryname input skips genotyping, as
     in svim_tpu) runs again through
     csrc/genotype_support.cu and through the plain version on the card:
     equal to each other and to the path's own counts; so must the seeded
     cases (genotype_cases: the cap at 499, 500 and 501 qualifying rows,
     width 0, 1 and 8192, S = 8, 64 and 8192, past the shared-memory stage,
     repeated and INT_MAX support ids, INT_MAX and INT_MIN table ids,
     wrapping margins, both types in a call, C = 1 and 4096); the join
     enqueues under torch.cuda.set_sync_debug_mode("error"); prints kernel
     ms beside its first design's (in turns, counts equal), plain ms and the
     bound at the bench's join and at C = 4096, slice_len = 8192, S = 64,
     and the host seconds of the bench's and the
     tie-free run's whole join through the kernel and through the plain
     version on the card; golden and both bench runs launch the kernel
     once.
 17. (run after 5b, so that phases 6, 15 and 16 take its recorded calls)
     all six SV classes at the scale of the two accuracy harnesses of
     scripts/eval_accuracy.py, made by background makers
     (svim_tpu_torch.workloads.stress_workload: 54 Mb over five contigs,
     12% read noise, 15% repeats, cut&paste DUP:INT;
     independent_workload: the donor-genome projection, reads from both
     strands and both haplotypes), on STRESS_PATHS: the stress workload at
     the CLI's defaults and with --edit_backend wavefront
     --incremental_cluster off, the independent one at the defaults.  Each
     VCF must hash to svim_tpu's and give its per-class (tp, fp, fn)
     (STRESS_VCF_SHA256, STRESS_CLASSES); stress_wavefront's telemetry and
     accepted labelings by route must equal svim_tpu's (STRESS_TELEMETRY,
     STRESS_DEVICE_BY_ROUTE); the COLLECT, classify and GENOTYPE kernels
     must run on every path, the agglomeration wherever a partition went
     to the card, the wavefront and INS matrix kernels on
     stress_wavefront.  Every device call is recorded: the linkage ops go
     to phase 6, COLLECT and GENOTYPE to phases 15 and 16, and every
     wavefront call runs again through the kernel and the plain version
     on the card, equal to each other and to the run's output; every rung
     of the consensus pool's Gotoh ladder (csrc/gotoh.cu) is held pair
     for pair to the host aligner at the rung's band (GotohRungs,
     gotoh_rungs_against_host).  Logs what the calls held (scans and their overflows, CIGAR widths, the
     reference ids classified, the GENOTYPE table's contigs, fused-entry
     partitions by type, the DUP_INT candidate round, the wavefront calls'
     shapes and variants), each run's stage seconds and, from a traced run
     of each path in a process of its own, its device busy time.
 18. (run after 17, for the same reason) a chromosome of a 30x sample at
     the scale a user runs it: svim_tpu_torch.workloads.sample_workload at
     its defaults (~114,000 ONT-like reads of 3,001 CIGAR ops on a contig
     the length of GRCh38 chr20, split partners on one the length of chr21,
     280 DEL and 280 INS loci of 12-30 reads whose breakpoints differ, a
     1.1 GB BAM of 4.3 GB inflated), made by a background maker from the
     start of the run, whose inflated stream must hash to svim_tpu's input
     (SAMPLE_INFLATED_SHA256).  The BAM is over the streaming threshold, so
     COLLECT streams it (no mid-scan clustering, as in svim_tpu), on
     SAMPLE_PATHS: the CLI's defaults (sample_auto) and --edit_backend
     wavefront --incremental_cluster off (sample_wavefront: the resident
     INS route).  Each VCF must hash to svim_tpu's (SAMPLE_VCF_SHA256), its
     per-class (tp, fp, fn) (SAMPLE_CLASSES), telemetry and accepted
     labelings by route (SAMPLE_TELEMETRY) must equal svim_tpu's; the
     COLLECT, classify, GENOTYPE and agglomeration kernels must run on both
     paths, the wavefront and INS matrix kernels on sample_wavefront; every
     device call is recorded as in phase 17 (phases 6, 15 and 16 replay
     the linkage, COLLECT and GENOTYPE calls, the wavefront calls are
     replayed here).  Logs the generation's seconds and bytes, windows and
     batches streamed, resident and shared memory at each batch, scans and
     overflows, partitions by route and pad bucket, the GENOTYPE joins'
     shapes and table rows, wavefront launches by kernel variant, stage
     seconds, reads/s through COLLECT+CLUSTER and, from a traced run of
     each path in a process of its own, device busy time.
 19. (run after 18, for the same reason) the same chromosome with loci of
     all six classes: svim_tpu_torch.workloads.sample_classes_workload (60
     loci of each of INV, DUP:TANDEM, DUP:INT, three of its sources copied
     to 3, 4 and 5 destinations, and BND beside the 280 DEL and 280 INS
     loci; three loci a class of 40-100 or 40-60 reads; no split-read
     partition with an exact tie), made by a background maker, whose
     inflated stream must hash to svim_tpu's input
     (SAMPLE_CLASSES_INFLATED_SHA256), through the CLI at its defaults
     (SAMPLE_CLASSES_PATH, streamed).  The VCF's sha256, per-class (tp,
     fp, fn), telemetry and accepted labelings by route must equal
     svim_tpu's (SAMPLE_CLASSES_*); partitions of each of DEL, INV,
     DUP_TAN, DUP_INT and BND must reach the agglomeration kernel's fused
     entry, one fused launch must run at P = 128, and the DUP_INT
     candidate round must call the matrix entry and launch it.  Every
     device call is recorded as in phase 18 (phases 6, 15 and 16 replay
     them).  Logs what phase 18 logs, with the fused-entry partitions by
     type and pad bucket and the candidate round's calls.
 20. (run last, on a quiet card) the repo's measuring entry points on the
     bench workload of phase 5, each in a process of its own:
     bench_torch.py at 8,192 reads with its defaults must exit 0 behind
     its gate (its CLI run's variants.vcf hashing to BENCH_VCF_SHA256),
     print bench.py's four keys with a metric that names cuda and this
     card, run on this card and launch both COLLECT kernels in its timed
     rounds (its launches are the path "bench_torch"); then
     scripts/measure_multihost_torch.py, profile_stream_vs_oneshot_torch.py
     and profile_ins_torch.py each run once to their JSON lines.  Logs the
     bench's result, rounds, launches, baseline and card, each script's
     lines and seconds, and the phase's seconds.
 21. (run after 19, for the same reason as 17) the long tail of a real
     sample: svim_tpu_torch.workloads.longtail_workload (the sample with a
     collapsed repeat of 100 kb at 1,000x over the background, reads of 8
     diverged copies carrying 3-12 DEL and INS of 40-300 bp each, and 8
     loci of 40-80 kb reads across 5-30 kb insertions; a BAM COLLECT
     streams) and longtail_region_workload (the same on a 1.2 Mb host, a
     BAM under 96 MiB: one-shot COLLECT with mid-scan clustering), made by
     background makers whose inflated streams must hash to svim_tpu's
     inputs, on LONGTAIL_PATHS: the CLI's defaults and --edit_backend
     wavefront --incremental_cluster off on the long tail, the defaults on
     the region.  Each VCF must hash to svim_tpu's with its per-class (tp,
     fp, fn), the streamed paths' telemetry and accepted labelings by
     route must equal svim_tpu's (workloads.LONGTAIL_*); each path's route
     counters (a [paths] line: COLLECT's re-runs with their counts and
     bounds, wavefront launches by variant, GENOTYPE's candidates joined by
     the kernel and by the host, partitions subsampled by type) must show
     a re-run, subsampled DEL and INS partitions and both joins, and
     longtail_wavefront the wavefront kernel's strip layout at L = 32,768
     and an agglomeration launch at P = 128 (the subsampled INS partitions
     on the resident route).
     Every device call is recorded (phases 6, 15 and 16 replay the linkage,
     COLLECT, re-runs included, and GENOTYPE calls); the wavefront calls
     are replayed here: warp launches through the plain version, strip
     ones through the kernel again and against the native edit distance on
     every pair, and a seeded sample of their pairs (LONGTAIL_PLAIN_PAIRS)
     through the plain version.  Logs what the calls held, stage seconds,
     the strip launches' device ms a pair beside the bound of the launch
     and beside the first design's in turns and, from a traced run of
     longtail_wavefront in a process of its own, device busy time.
 22. (run after 16) COMBINE's consensus aligner, csrc/gotoh.cu, at the
     pool's shapes (gotoh_cases: a polish round of 20 members of 1-3 kb at
     band 64, one of 300 bp, one 10 kb pair) and on the ladder's other
     rungs (pairs of the full matrix, pairs that graze band 64 and 128
     and end on the full matrix): every pair's band ladder on the card
     against the host aligner, every rung it ran against the plain
     version on the card and against the host aligner at the rung's band,
     and the first rung's device ms beside its bound by operations
     (GOTOH_OPS_PER_CELL a band cell), the plain version's and the host
     aligner's ms.
The script imports torch and the port, never jax or the JAX package: the
inputs come from svim_tpu_torch.workloads.
Then one JSON line describing the kernels, the card line, and the last
line {"ok": true, "device": {...}}.  Scratch files go to
svim_tpu_torch/_build/smoke (git-ignored).
"""

import json
import os
import re
import subprocess
import sys
import time

# svim_tpu's VCF on the bench workload (shared with bench_torch.py) and the
# kernels' launch counters
from svim_tpu_torch.ops import KERNEL_COUNTERS
from svim_tpu_torch.workloads import BENCH_VCF_SHA256, vcf_sha256

ROOT = os.path.dirname(os.path.abspath(__file__))
SCRATCH = os.path.join(ROOT, "svim_tpu_torch", "_build", "smoke")
BENCH_READS = 8192
# (B, L, W) of the JSON timing: the main path's costliest launch on the
# 8192-read workload (two launches of ~8k pairs at L=1024, W=1024)
MAIN_SHAPE = (8192, 1024, 1024)
GOLDEN = os.path.join(ROOT, "tests", "golden", "variants.golden.vcf")
# where the clustering stage resolved its device-eligible partitions: the
# counts svim_tpu's own run gives on the CPU (with mid-scan incremental
# clustering off, as the phases that pin them run the port: partitions
# reused from the mid-scan memo are not counted, and how many are depends on
# the scan's timing; tests/test_torch_pipeline.py checks the golden ones).  On both workloads every partition has exact float64 ties
# (pre_tie) or a resident INS labeling the float32 guard rejects
# (resident_relink), in svim_tpu too; phase 6 covers accepted labelings.
_NO_TELEMETRY = {"device": 0, "pre_tie": 0, "pre_wall": 0, "post_tie": 0,
                 "post_wall": 0, "resident_relink": 0}
GOLDEN_TELEMETRY = dict(_NO_TELEMETRY, pre_tie=11, pre_wall=2,
                        resident_relink=3)
BENCH_TELEMETRY = {"wavefront": dict(_NO_TELEMETRY, pre_tie=96,
                                     resident_relink=96),
                   "auto": dict(_NO_TELEMETRY, pre_tie=192)}
# the same for the golden workload as SAM text (equal to the golden
# fixture's) and as a queryname-sorted BAM (workloads.sam_text /
# queryname_bam), from svim_tpu's CPU runs with --edit_backend wavefront
# --incremental_cluster off; tests/test_torch_workloads.py checks both
SAM_VCF_SHA256 = ("a59cd4b5438e42f0b4d728cfa4dff7b0"
                  "3028aca61fd823004605ed1f25446da8")
QUERYNAME_VCF_SHA256 = ("6296cf39aa2176464f1ac4072ac971cc"
                        "6228edbc67482247d37b92dcca95e383")
# the tie-free workload (svim_tpu_torch.workloads.tiefree_workload) at 8192
# reads: sha256 of svim_tpu's variants.vcf (##fileDate lines left out; one
# hash for either edit backend), its clustering telemetry, and how many of
# its accepted labelings (`device`) each CLUSTER route decided, all from
# svim_tpu's CPU runs with --incremental_cluster off
TIEFREE_READS = 8192
TIEFREE_VCF_SHA256 = ("3cacea0334817fd7aa58a7b0e94d7e0b"
                      "1b601b215417c407a46b141f8d045f72")
TIEFREE_TELEMETRY = {"auto": dict(_NO_TELEMETRY, device=133, pre_tie=8,
                                  post_tie=51),
                     "wavefront": dict(_NO_TELEMETRY, device=135,
                                       pre_tie=2, post_tie=20,
                                       resident_relink=35)}
TIEFREE_DEVICE_BY_ROUTE = {"auto": {"fused": 74, "matrix": 59},
                           "wavefront": {"fused": 74, "resident": 61}}
# the two accuracy harnesses of scripts/eval_accuracy.py at seed 1
# (svim_tpu_torch.workloads.stress_workload, --big, and
# independent_workload, --independent) and the paths phase 17 drives on
# them: (workload, flags).  From svim_tpu's CPU runs: the sha256 of its
# variants.vcf (##fileDate lines left out; on the stress workload one hash
# for either edit backend), its per-class (tp, fp, fn) from evaluate_vcf,
# and for stress_wavefront (--incremental_cluster off) its clustering
# telemetry and accepted labelings by route: none on any route, since the
# simulated reads of a locus share their breakpoints (exact float64 ties)
STRESS_SEED = 1
STRESS_PATHS = {"stress_auto": ("stress", []),
                "stress_wavefront": ("stress", [
                    "--edit_backend", "wavefront",
                    "--incremental_cluster", "off"]),
                "independent_auto": ("independent", [])}
STRESS_VCF_SHA256 = {"stress": ("3e12db2609fb0a84fd1fd550df1a87d3"
                                "78d60a66bde291667dc736bcc70135d4"),
                     "independent": ("677e4fcb1a835007efc15ae72809478414"
                                     "ec3a7578eaa5dfc4049413f99b2b37")}
STRESS_CLASSES = {
    "stress": {"ALL": (344, 0, 1), "BND": (140, 0, 0), "DEL": (60, 0, 0),
               "DUP:INT": (25, 0, 0), "DUP:TANDEM": (35, 0, 0),
               "INS": (49, 0, 1), "INV": (35, 0, 0)},
    "independent": {"ALL": (62, 3, 0), "BND": (32, 0, 0), "DEL": (8, 0, 0),
                    "DUP:INT": (5, 0, 0), "DUP:TANDEM": (7, 0, 0),
                    "INS": (6, 3, 0), "INV": (4, 0, 0)}}
STRESS_TELEMETRY = dict(_NO_TELEMETRY, pre_tie=174, pre_wall=25, post_tie=1,
                        resident_relink=50)
STRESS_DEVICE_BY_ROUTE = {}
# a chromosome of a 30x sample (svim_tpu_torch.workloads.sample_workload at
# its defaults and SAMPLE_SEED: ~114,000 reads on a contig the length of
# chr20, 560 DEL and INS loci, a BAM over the streaming threshold) and the
# paths phase 18 drives on it: their flags.  From svim_tpu's CPU runs: the
# sha256 of the generator's inflated BAM stream, and for each path the
# sha256 of svim_tpu's variants.vcf (##fileDate lines left out), its
# per-class (tp, fp, fn) from evaluate_vcf, its clustering telemetry and
# its accepted labelings by route (a streamed input clusters nothing
# mid-scan, so both are the same on every run).  svim_tpu took 19 s with
# the defaults and 3,081 s with --edit_backend wavefront (its jnp
# wavefront on the CPU), the same VCF on either path
SAMPLE_SEED = 1
SAMPLE_PATHS = {"sample_auto": [],
                "sample_wavefront": ["--edit_backend", "wavefront",
                                     "--incremental_cluster", "off"]}
SAMPLE_INFLATED_SHA256 = ("b73e25de74462c7879ba6bc94ba08301"
                          "f597f268a1990bca3f5fdca04876f7d8")
SAMPLE_VCF_SHA256 = {path: ("fa923cb6f07ab7b1a0e1c984833542bc"
                            "a0ddf89d341ac3b5fe765f0ad8f0f02c")
                     for path in SAMPLE_PATHS}
SAMPLE_CLASSES = {path: {"ALL": (560, 56, 0), "DEL": (280, 0, 0),
                         "INS": (280, 56, 0)} for path in SAMPLE_PATHS}
SAMPLE_TELEMETRY = {"sample_auto": (dict(_NO_TELEMETRY, device=160,
                                         pre_tie=163, post_tie=237),
                                    {"fused": 99, "matrix": 61}),
                    "sample_wavefront": (dict(_NO_TELEMETRY, device=206,
                                              pre_tie=51, post_tie=130,
                                              resident_relink=173),
                                         {"fused": 99, "resident": 107})}
# the sample with loci of all six classes (phase 19:
# svim_tpu_torch.workloads.sample_classes_workload at SAMPLE_SEED, 60 loci of
# each split-read class beside the DEL and INS loci) and the path phase 19
# drives on it, the CLI's defaults.  From svim_tpu's CPU run: the
# sha256 of the generator's inflated BAM stream and of variants.vcf
# (##fileDate lines left out), its per-class (tp, fp, fn) from evaluate_vcf,
# its clustering telemetry (the DUP_INT candidate round's included) and its
# accepted labelings by route
SAMPLE_CLASSES_PATH = "sample_classes_auto"
SAMPLE_CLASSES_INFLATED_SHA256 = ("1ea8004973774e5823378235adb59b5f"
                                  "929b31da839eb771f8c46095b2150d2b")
SAMPLE_CLASSES_VCF_SHA256 = ("64d0a3d4d1b88349ec06252b91a912bd"
                             "caed2cc9a341ab18426ae93ac2ef97a4")
SAMPLE_CLASSES_CLASSES = {"ALL": (1099, 58, 1), "BND": (359, 3, 1),
                          "DEL": (280, 0, 0), "DUP:INT": (60, 0, 0),
                          "DUP:TANDEM": (60, 0, 0), "INS": (280, 55, 0),
                          "INV": (60, 0, 0)}
SAMPLE_CLASSES_TELEMETRY = (dict(_NO_TELEMETRY, device=208, pre_tie=152,
                                 pre_wall=60, post_tie=443),
                            {"fused": 135, "matrix": 73})
# the signature types whose partitions phase 19 must see on the
# agglomeration kernel's fused entry (named here, not read from the port's
# device_cluster.FUSED_TYPES: the check does not follow the code it checks)
FUSED_ENTRY_TYPES = ("DEL", "INV", "DUP_TAN", "DUP_INT", "BND")
# (B, P) of the distance kernel's JSON timing: the largest listed shape
DISTANCE_MAIN_SHAPE = (8192, 128)
LINKAGE_OPS = ("span_position_agglomerate_batched", "agglomerate_batched",
               "ins_matrices_from_pairs")
# the runs whose agglomeration calls are launched again and timed one by one
# (phase 10b): tie-free with either edit backend, and mid-scan clustering
# with the scan in chunks
RECORDED_MIDSCAN_PATH = "incremental_wavefront_chunked"
TIMED_CALL_PATHS = ("tiefree_auto", "tiefree_wavefront",
                    RECORDED_MIDSCAN_PATH)


def log(phase, message):
    print("[{0}] {1}".format(phase, message), flush=True)


def phase_environment():
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is false: this smoke "
                           "test needs an NVIDIA card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log("env", "card: {0}; torch {1}; CUDA {2}; python {3}".format(
        card, torch.__version__, torch.version.cuda, sys.version.split()[0]))
    os.makedirs(SCRATCH, exist_ok=True)
    return card


def phase_build():
    import threading

    from svim_tpu_torch import native
    from svim_tpu_torch.ops import (
        _build,
        cigar_kernel,
        distance_kernel,
        genotype_kernel,
        gotoh_kernel,
        linkage_kernel,
        segments_kernel,
        wavefront_kernel,
    )

    started = time.perf_counter()
    host = {}

    def build_host():
        try:
            native.get_library()
        except BaseException as error:  # re-raised on the main thread below
            host["error"] = error
        host["seconds"] = time.perf_counter() - started

    # g++ compiles the host library while the nvcc processes run
    thread = threading.Thread(target=build_host)
    thread.start()
    try:
        _build.build(_build.KERNEL_SOURCES)
        wavefront_kernel._kernel_library()
        distance_kernel._kernel_library()
        cigar_kernel._kernel_library()
        slots = linkage_kernel._kernel_library().agglomerate_max_slots()
        classify_slots = segments_kernel._kernel_library(
            ).classify_max_slots()
        genotype_kernel._kernel_library()
        linkage_kernel._ins_kernel_library()
        gotoh_kernel._kernel_library()
        log("build", "{0} built (in parallel) and loaded in {1:.2f}s (nvcc "
            "{2}); DPX add-min: {3}; agglomeration up to P = {4}; classify "
            "up to S = {5}".format(
                ", ".join(name + ".cu" for name in _build.KERNEL_SOURCES),
                time.perf_counter() - started,
                json.dumps({name: round(seconds, 2) for name, seconds
                            in _build.BUILD_SECONDS.items()}),
                wavefront_kernel.uses_dpx(), slots, classify_slots))
    finally:
        thread.join()
    if "error" in host:
        raise host["error"]
    for directory in (os.path.dirname(native.library_path()),
                      _build.BUILD_DIR):
        if os.path.dirname(directory) != os.path.join(ROOT, "svim_tpu_torch"):
            raise AssertionError("built outside svim_tpu_torch/_build: "
                                 + directory)
    log("build", "native host library (svim_tpu_torch/native, g++) ready "
        "after {0:.2f}s".format(host["seconds"]))


def start_kernels_a_call():
    """Phase 2b, started beside the later phases: kernels_a_call() in a
    process of its own, whose torch.profiler session is the process's
    first (a second session in one process was seen to miss kernels that
    ctypes launched: phase 15's missed the scan kernel after phase 11's
    traces, and phase 11's the wavefront kernel after an earlier session).
    Returns the process for finish_kernels_a_call()."""
    return subprocess.Popen(
        [sys.executable, "-c", "import sys; sys.path.insert(0, sys.argv[1]); "
         "import chip_smoke; chip_smoke.kernels_a_call()", ROOT],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def finish_kernels_a_call(process):
    """Waits for phase 2b's process, prints its lines, raises unless it
    passed."""
    output, _ = process.communicate()
    sys.stdout.write(output)
    if process.returncode != 0:
        raise AssertionError("phase 2b (device kernels a call) "
                             "failed with exit code {0}".format(
                                 process.returncode))


def kernels_a_call():
    """Phase 2b: a call of each wrapper of the COLLECT, GENOTYPE and INS
    matrix kernels at the bench's shapes (N = 4096, K = 32; G = 256, S = 2;
    GENOTYPE_BENCH_SHAPE; INS_BENCH_SHAPE) runs the device kernels its
    design says (the module's KERNELS_PER_CALL: one each),
    counted in the Chrome trace of torch.profiler; the GENOTYPE and INS
    calls also enqueue under torch.cuda.set_sync_debug_mode("error")."""
    import numpy as np
    import torch

    from svim_tpu_torch.ops import genotype_kernel, linkage_kernel

    rng = np.random.default_rng(20261017)
    scan_args = _on_card((_random_cigar_rows(rng, 4096, 32),
                          np.zeros(4096, np.int32))) + [40, 16384]
    classify_args, classify_kwargs = _classify_call(
        classify_inputs(rng, 256, 2))
    calls = []
    for kernel, args, kwargs in (
            ("collect_scan", scan_args, {}),
            ("classify_segments", _on_card(classify_args), classify_kwargs)):
        module, cuda, _ = _collect_module(kernel)
        calls.append((kernel, module, "LAUNCHES", module.KERNELS_PER_CALL,
                      lambda cuda=cuda, args=args, kwargs=kwargs:
                      cuda(*args, **kwargs)))
    genotype_args = _on_card(genotype_timed_inputs(rng,
                                                   *GENOTYPE_BENCH_SHAPE))
    ins_args = _on_card(_ins_inputs(rng, *INS_BENCH_SHAPE))
    calls += [
        ("genotype_support", genotype_kernel, "LAUNCHES",
         genotype_kernel.KERNELS_PER_CALL,
         lambda: genotype_kernel.genotype_support_batched_cuda(
             *genotype_args)),
        ("ins_matrices", linkage_kernel, "INS_LAUNCHES",
         linkage_kernel.INS_KERNELS_PER_CALL,
         lambda: linkage_kernel.ins_matrices_from_pairs_cuda(*ins_args))]
    for kernel, module, attribute, per_call, call in calls:
        launches = getattr(module, attribute)
        call()
        names = _device_kernels(call)
        if getattr(module, attribute) - launches != 2 \
                or len(names) != per_call:
            raise AssertionError("{0}: {1} device kernels a call ({2}), {3} "
                                 "counted launches".format(
                                     kernel, len(names), names,
                                     getattr(module, attribute) - launches))
        setattr(module, attribute, launches)
        log("kernels", "{0} at the bench's shape: {1} device kernel(s) a "
            "call ({2})".format(kernel, len(names), ", ".join(names)))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        genotype_kernel.genotype_support_batched(*genotype_args)
        linkage_kernel.ins_matrices_from_pairs(*ins_args)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    log("kernels", "sync check: genotype_support_batched and "
        "ins_matrices_from_pairs enqueued on card tensors under "
        "torch.cuda.set_sync_debug_mode('error') without a host sync")


def _pairs(rng, batch, length):
    """Half near-identical pairs (0-50 edits), half independent random."""
    import numpy as np

    alphabet = np.frombuffer(b"ACGT", dtype=np.uint8)
    a_codes = np.zeros((batch, length), dtype=np.uint8)
    b_codes = np.zeros((batch, length), dtype=np.uint8)
    a_lens = np.zeros(batch, dtype=np.int32)
    b_lens = np.zeros(batch, dtype=np.int32)
    for row in range(batch):
        a = alphabet[rng.integers(0, 4, size=rng.integers(length // 2,
                                                          length + 1))]
        if row % 2 == 0:
            b = list(a)
            for _ in range(rng.integers(0, 51)):
                position = int(rng.integers(0, max(1, len(b))))
                edit = rng.integers(0, 3)
                if edit == 0 and b:
                    b[position] = alphabet[rng.integers(0, 4)]
                elif edit == 1:
                    b.insert(position, alphabet[rng.integers(0, 4)])
                elif b:
                    del b[position]
            b = np.asarray(b[:length], dtype=np.uint8)
        else:
            b = alphabet[rng.integers(0, 4, size=rng.integers(length // 2,
                                                              length + 1))]
        a_codes[row, :len(a)] = a
        b_codes[row, :len(b)] = b
        a_lens[row] = len(a)
        b_lens[row] = len(b)
    return a_codes, a_lens, b_codes, b_lens


def _edit_distance_dp(a, b):
    """Levenshtein distance by the O(nm) dynamic program."""
    previous = list(range(len(b) + 1))
    for i, char_a in enumerate(a, start=1):
        current = [i] + [0] * len(b)
        for j, char_b in enumerate(b, start=1):
            current[j] = min(previous[j] + 1, current[j - 1] + 1,
                             previous[j - 1] + (char_a != char_b))
        previous = current
    return previous[len(b)]


def _time_ms(function, repeats, warm_up=True):
    import torch

    if warm_up:
        function()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(repeats):
        result = function()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / repeats, result


def _device_ms(function, repeats):
    """ms a call of `function` on the card: a spin kernel holds the stream
    while the host enqueues the `repeats` calls, so that the events time
    the card's work and not the host's launch overhead (a call with small
    inputs takes less time on the card than in its Python wrapper)."""
    import torch

    function()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(2_000_000 + 1_000_000 * repeats)
    start.record()
    for _ in range(repeats):
        result = function()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / repeats, result


def kernel_shapes():
    """(B, L, W, variant): the main path's lengths and pow4 bands at a small
    and a full batch, the full launches of the 8192-read workload, and
    W=4096 and W=16384 (the strip layout), each on the code path the
    wrapper picks (variant None); then one case per code path of the
    kernel: the warp kernel with a ragged last CTA (B not a multiple of the
    4 pairs a CTA) at a narrow and at the widest band, the shapes of
    tests/test_torch_wavefront.py's card tests that the list lacked (B = 64
    at L, W = 1024, 256; L = 2048), and the strip layout forced with staged
    and with unstaged strings at three shapes (the last one that file's: 5
    pairs, strings shorter than their rows, W = 300)."""
    shapes = [(batch, length, band, None) for length in (512, 1024)
              for band in (64, 128, 256, 1024) for batch in (8, 1024)]
    shapes += [(8192, 512, 64, None), (8192, 512, 256, None),
               MAIN_SHAPE + (None,), (8, 8192, 4096, None),
               (8, 16384, 16384, None), (2051, 512, 64, None),
               (2051, 1024, 1024, None), (67, 300, 100, None),
               (64, 1024, 256, None), (8, 2048, 1024, None)]
    shapes += [(batch, length, band, variant)
               for variant in ("strip", "strip_unstaged")
               for batch, length, band in ((64, 512, 256), (16, 1024, 1024),
                                           (5, 1024, 300))]
    return shapes


# phase 3 at the widest band the resident route uses (L = W = 32,768): pairs
# of 16-32 kb with a few hundred to a few thousand edits, which the ladder's
# rungs resolve, and unrelated pairs, which run to W; (label, B, edits or
# None for unrelated), each through both strip layouts
WIDE_LENGTH = 32768
WIDE_SHAPES = (("resolved", 64, 1500), ("full band", 16, None))
WIDE_PLAIN_PAIRS = 2   # pairs of each through the plain version
# the launches timed beside the first design in phase 3: the warp shape and
# unrelated pairs of L/2-L characters that run to W (B, L = W)
DESIGN_SHAPES = ((264, 16384), (132, 32768))


def _random_codes(rng, size):
    import numpy as np

    return np.frombuffer(b"ACGT", dtype=np.uint8)[rng.integers(0, 4, size)]


def _wide_pairs(rng, batch, length, edits):
    """(B, L) codes and lengths: strings of L/2 to L characters, each b a
    copy of a with up to `edits` substitutions and a deletion of up to
    edits / 4 characters, or (edits None) an unrelated string."""
    import numpy as np

    a_codes = np.zeros((batch, length), dtype=np.uint8)
    b_codes = np.zeros((batch, length), dtype=np.uint8)
    a_lens = np.zeros(batch, dtype=np.int32)
    b_lens = np.zeros(batch, dtype=np.int32)
    for row in range(batch):
        a = _random_codes(rng, int(rng.integers(length // 2, length + 1)))
        if edits is None:
            b = _random_codes(rng, int(rng.integers(length // 2,
                                                    length + 1)))
        else:
            b = a.copy()
            places = rng.integers(0, len(b), int(rng.integers(0, edits + 1)))
            b[places] = _random_codes(rng, len(places))
            cut = int(rng.integers(0, edits // 4 + 1))
            b = np.concatenate([b[:len(b) // 2], b[len(b) // 2 + cut:]])
        a_codes[row, :len(a)] = a
        b_codes[row, :len(b)] = b
        a_lens[row], b_lens[row] = len(a), len(b)
    return a_codes, a_lens, b_codes, b_lens


def _native_distances(a_codes, a_lens, b_codes, b_lens):
    import numpy as np

    from svim_tpu_torch import native

    pairs = [(a_codes[row, :a_lens[row]].tobytes().decode(),
              b_codes[row, :b_lens[row]].tobytes().decode())
             for row in range(len(a_lens))]
    return np.asarray(native.aligner.edit_distance_batch(pairs),
                      dtype=np.int64)


def phase_wide_kernels(first_design):
    """Phase 3 at L = W = 32,768 and the first design's times: WIDE_SHAPES
    through both strip layouts (one launch each, equal to each other and to
    the native edit distance on every pair; WIDE_PLAIN_PAIRS of each shape
    through the plain version), then DESIGN_SHAPES and MAIN_SHAPE timed
    beside the first design in turns.  Returns ({label: ms, first design
    ms, bound ms, what binds it, pairs resolved on a rung}, max |error|)."""
    import numpy as np
    import torch

    from svim_tpu_torch.ops import wavefront_kernel as wk

    from svim_tpu_torch.ops import _build

    paths = {"present": _build.library_path("wavefront")}
    if first_design is not None:
        paths["first design"] = first_design.path
    for which, path in paths.items():
        for line in _resource_usage(path) or ["cuobjdump not found"]:
            log("resources", "wavefront, {0}: {1}".format(which, line))
    rng = np.random.default_rng(20261017)
    max_abs_err = 0
    picked = []
    for label, batch, edits in WIDE_SHAPES:
        codes = _wide_pairs(rng, batch, WIDE_LENGTH, edits)
        args = [torch.from_numpy(x).cuda() for x in codes]
        exact = _native_distances(*codes)
        for variant in ("strip", "strip_unstaged"):
            before = wk.VARIANT_LAUNCHES[variant]
            got = wk.banded_distance_cuda(*args, WIDE_LENGTH, variant=variant)
            if wk.VARIANT_LAUNCHES[variant] != before + 1:
                raise AssertionError("the {0} layout was not launched".format(
                    variant))
            values = got.cpu().numpy().astype(np.int64)
            max_abs_err = max(max_abs_err, int(np.abs(values - exact).max()))
            if not np.array_equal(values, exact):
                raise AssertionError("{0} pairs at L = W = {1}, {2}: {3} of "
                                     "{4} differ from the native edit "
                                     "distance".format(
                                         label, WIDE_LENGTH, variant,
                                         int((values != exact).sum()),
                                         batch))
        rows = sorted(rng.choice(batch, WIDE_PLAIN_PAIRS,
                                 replace=False).tolist())
        picked.append(([x[rows] for x in codes], exact[rows]))
        log("kernel", "{0} pairs at L = W = {1} (B={2}): both strip layouts "
            "equal to the native edit distance on every pair (distances "
            "{3}..{4})".format(label, WIDE_LENGTH, batch, int(exact.min()),
                               int(exact.max())))
    sample = [np.concatenate([codes[index] for codes, _ in picked])
              for index in range(4)]
    started = time.perf_counter()
    plain = wk.banded_distance_torch(
        *[torch.from_numpy(x).cuda() for x in sample],
        WIDE_LENGTH).cpu().numpy().astype(np.int64)
    exact = np.concatenate([distances for _, distances in picked])
    max_abs_err = max(max_abs_err, int(np.abs(plain - exact).max()))
    if not np.array_equal(plain, exact):
        raise AssertionError("the plain version differs from the kernel on "
                             "the sampled pairs at L = W = {0}".format(
                                 WIDE_LENGTH))
    log("kernel", "{0} sampled pairs at L = W = {1}: the plain version "
        "equals the kernel ({2:.1f} s)".format(
            len(exact), WIDE_LENGTH, time.perf_counter() - started))

    designs = {}
    timed = [("B={0} L={1} W={2} (warp)".format(*MAIN_SHAPE),
              _pairs(rng, MAIN_SHAPE[0], MAIN_SHAPE[1]), MAIN_SHAPE[2], 10)]
    timed += [("B={0} L=W={1} unrelated".format(batch, length),
               _wide_pairs(rng, batch, length, None), length, 1)
              for batch, length in DESIGN_SHAPES]
    for label, codes, band, repeats in timed:
        args = [torch.from_numpy(x).cuda() for x in codes] + [band]
        ms, first_ms = time_wavefront_designs(args, first_design, repeats)
        values = wk.banded_distance_cuda(*args).cpu().numpy()
        bound, bound_by, cells = wavefront_bound_ms(
            codes[1], codes[3], values, codes[0].shape[1], band)
        designs[label] = {"ms": ms, "first_design_ms": first_ms,
                          "bound_ms": bound, "bound_by": bound_by,
                          "cells": cells}
        log("kernel", "{0}: {1!r} ms, the first design {2!r} ms (in turns); "
            "bound {3!r} ms by {4} ({5} cells)".format(
                label, ms, first_ms, bound, bound_by, cells))
    return designs, max_abs_err


# int32 operations of one DP cell (a compare, an add, two min, an add-min)
# and the card's int32 rate: 132 SMs x 64 int32 lanes x 1.98 GHz, half the
# 67 TFLOP/s float32 rate counted as one operation a lane and clock
OPS_PER_CELL = 5
INT32_OPS_PER_SECOND = 132 * 64 * 1.98e9
HBM_BYTES_PER_SECOND = 3.35e12
FLOAT32_FLOPS_PER_SECOND = 67e12


def _band_cells(a_lens, b_lens, widths):
    """Cells 1 <= i <= m, 1 <= j <= n with |i - j| <= w, per pair."""
    import numpy as np

    m = a_lens.astype(np.int64)[:, None]
    n = b_lens.astype(np.int64)[:, None]
    w = widths.astype(np.int64)[:, None]
    i = np.arange(1, int(a_lens.max()) + 1, dtype=np.int64)[None, :]
    per_row = np.minimum(n, i + w) - np.maximum(1, i - w) + 1
    return np.where(i <= m, np.maximum(per_row, 0), 0).sum(axis=1)


def wavefront_bound_ms(a_lens, b_lens, values, length, band):
    """The least time the card could take for one launch on these inputs:
    bytes (both code matrices and length vectors read once, the result
    written once) over the memory rate, or the DP cells this data needs
    times OPS_PER_CELL over the int32 rate.  A pair whose distance k is
    within the band needs the cells |i - j| <= k; any other pair within
    reach of the band needs the whole band; a pair with |m - n| > W none.
    Returns (ms, "bytes" or "operations", cells)."""
    import numpy as np

    widths = np.where(values <= band, values,
                      np.minimum(band, np.maximum(a_lens, b_lens)))
    widths = np.where(np.abs(a_lens.astype(np.int64) - b_lens) > band, -1,
                      widths)
    cells = int(_band_cells(a_lens, b_lens, widths).sum())
    batch = len(a_lens)
    bytes_ms = (2 * batch * length + 12 * batch) / HBM_BYTES_PER_SECOND * 1e3
    ops_ms = cells * OPS_PER_CELL / INT32_OPS_PER_SECOND * 1e3
    if ops_ms >= bytes_ms:
        return ops_ms, "operations", cells
    return bytes_ms, "bytes", cells


def phase_kernels(shapes, dp_samples=64):
    import numpy as np
    import torch

    from svim_tpu_torch.ops import wavefront_kernel as wk

    rng = np.random.default_rng(20261016)
    timings = {}
    max_abs_err = 0
    dp_checked = 0
    for batch, length, band, variant in shapes:
        a_codes, a_lens, b_codes, b_lens = _pairs(rng, batch, length)
        if batch == 5:
            # strings of at most 600 characters in rows of `length`
            short = _pairs(rng, batch, 600)
            a_codes[:], b_codes[:] = 0, 0
            a_codes[:, :600], b_codes[:, :600] = short[0], short[2]
            a_lens, b_lens = short[1], short[3]
        if variant is None and batch == 67:
            # empty, one-character and far-apart strings beside the rest
            a_lens[:6] = (0, 0, 1, 1, 2, length)
            b_lens[:6] = (0, 1, 0, 1, 1, 3)
        args = [torch.from_numpy(x).cuda() for x in (a_codes, a_lens,
                                                     b_codes, b_lens)]
        tensors = (args[0], args[1], args[2], args[3], band)
        # one run of the plain version: ~2L dependent steps of small
        # launches, seconds at the widest shapes
        plain_ms, plain = _time_ms(lambda: wk.banded_distance_torch(*tensors),
                                   1, warm_up=False)
        kernel_ms, kernel = _time_ms(
            lambda: wk.banded_distance_cuda(*tensors, variant=variant), 5)
        if variant is None:
            # the dispatcher the main path calls: one launch, the same values
            before = wk.LAUNCHES
            routed = wk.banded_distance(*tensors)
            if wk.LAUNCHES != before + 1 or not torch.equal(routed, kernel):
                raise AssertionError("banded_distance on CUDA tensors at B={0}"
                                     " L={1} W={2}: {3} launches, equal to "
                                     "the wrapper's output: {4}".format(
                                         batch, length, band,
                                         wk.LAUNCHES - before,
                                         torch.equal(routed, kernel)))
        plain = plain.cpu().numpy()
        kernel = kernel.cpu().numpy()
        max_abs_err = max(max_abs_err, int(np.abs(
            plain.astype(np.int64) - kernel.astype(np.int64)).max()))
        mismatches = int((plain != kernel).sum())
        if mismatches:
            raise AssertionError("kernel != plain at B={0} L={1} W={2} "
                                 "variant={3}: {4} entries differ".format(
                                     batch, length, band, variant,
                                     mismatches))
        resolved = np.flatnonzero(kernel <= band)
        # 64 resolved entries against the O(nm) reference DP, spread over
        # the L=512 shapes (the DP is pure Python)
        if length == 512 and dp_checked < dp_samples and len(resolved):
            for row in resolved[:16].tolist():
                a = a_codes[row, :a_lens[row]].tobytes().decode()
                b = b_codes[row, :b_lens[row]].tobytes().decode()
                expected = _edit_distance_dp(a, b)
                if expected != int(kernel[row]):
                    raise AssertionError("kernel distance {0} != DP {1} at "
                                         "B={2} L={3} W={4} row {5}".format(
                                             kernel[row], expected, batch,
                                             length, band, row))
                dp_checked += 1
        bound_ms, bound_by, cells = wavefront_bound_ms(a_lens, b_lens, kernel,
                                                       length, band)
        path = variant or wk.kernel_variant(length, band)
        # how the in-kernel rungs fared: resolved at band 63, 255, 1023 or
        # 4095 (each tried where it is below half the pair's band), or run
        # to W
        reach = np.minimum(band, np.maximum(a_lens, b_lens))
        early, below = 0, -1
        for rung in (63, 255, 1023, 4095):
            early += int(((kernel > below) & (kernel <= rung)
                          & (reach > 2 * rung)).sum())
            below = rung
        if variant is None:
            timings[(batch, length, band)] = (kernel_ms, plain_ms, bound_ms,
                                              bound_by)
        log("kernel", "B={0} L={1} W={2} path={3}{4}: equal ({5} resolved, "
            "{6} on a rung, {7} run to W); kernel {8:.3f} ms, plain "
            "{9:.3f} ms, bound {10:.4f} ms by {11} ({12} cells)".format(
                batch, length, band, path, " (forced)" if variant else "",
                len(resolved), early, batch - early, kernel_ms, plain_ms,
                bound_ms, bound_by, cells))
    if wk.kernel_variant(WIDE_LENGTH, WIDE_LENGTH) != "strip" \
            or wk.kernel_variant(120000, 4096) != "strip_unstaged":
        raise AssertionError("the widest bands do not take the strip layout")
    if dp_checked < dp_samples:
        raise AssertionError("only {0} resolved entries checked against the "
                             "DP".format(dp_checked))
    log("kernel", "{0} resolved entries equal the reference DP".format(
        dp_checked))
    return timings, max_abs_err


def _normalized_vcf(path):
    with open(path) as handle:
        return [line for line in handle if not line.startswith("##fileDate")]


def _run_port(arguments):
    """cli.main in this process (so the launch counters are readable), its
    console log sent to <working_dir>.console.log and its tail printed when
    the run fails; detaches the log handlers the run added."""
    import contextlib
    import logging

    from svim_tpu_torch import cli

    root = logging.getLogger()
    before = list(root.handlers)
    console_path = arguments[1].rstrip("/") + ".console.log"
    try:
        with open(console_path, "w") as console, \
                contextlib.redirect_stderr(console):
            code = cli.main(arguments)
    finally:
        for handler in root.handlers[:]:
            if handler not in before:
                root.removeHandler(handler)
                handler.close()
    if code != 0:
        with open(console_path) as console:
            sys.stderr.write(console.read()[-6000:])
    return code


def _stage_seconds(working_dir):
    """Unrounded stage timings from the run's SVIM_*.log (--profile)."""
    logs = sorted(name for name in os.listdir(working_dir)
                  if name.startswith("SVIM_") and name.endswith(".log"))
    with open(os.path.join(working_dir, logs[-1])) as handle:
        for line in handle:
            if "Stage seconds: " in line:
                return json.loads(line.split("Stage seconds: ", 1)[1])
    raise AssertionError("no stage timings in the log of " + working_dir)


def _calls_per_class(vcf_path):
    counts = {}
    for line in _normalized_vcf(vcf_path):
        if line.startswith("#"):
            continue
        match = re.search(r"SVTYPE=([A-Z:]+)", line)
        sv_type = match.group(1) if match else "?"
        counts[sv_type] = counts.get(sv_type, 0) + 1
    return counts


class LinkageRecorder:
    """Stands in for the plain PyTorch linkage ops in device_cluster while
    the main path runs, and keeps each call's inputs and outputs on the
    host so phase 6 can re-run them on the CPU.  Each call is filed under
    the `label` the recorder holds when it is made (the path's name)."""

    def __init__(self):
        from svim_tpu_torch.cluster import device_cluster

        self.module = device_cluster
        self.originals = {name: getattr(device_cluster, name)
                          for name in LINKAGE_OPS}
        self.calls = []
        self.labels = []
        self.label = None

    def _wrap(self, name):
        original = self.originals[name]

        def recorded(*args, **kwargs):
            outputs = original(*args, **kwargs)
            self.calls.append((name, _to_cpu(args), _to_cpu(kwargs),
                               _to_cpu(outputs), _devices(args)))
            self.labels.append(self.label)
            return outputs
        return recorded

    def of(self, labels):
        """(label, op name, args, kwargs) of the calls filed under
        `labels`, in the order they were made."""
        return [(label, name, args, kwargs) for label, (name, args, kwargs,
                                                        _, _)
                in zip(self.labels, self.calls) if label in labels]

    def __enter__(self):
        for name in LINKAGE_OPS:
            setattr(self.module, name, self._wrap(name))
        return self

    def __exit__(self, *exc):
        for name, original in self.originals.items():
            setattr(self.module, name, original)


def _to_cpu(value):
    import torch

    if isinstance(value, torch.Tensor):
        return value.cpu()
    if isinstance(value, (tuple, list)):
        return type(value)(_to_cpu(item) for item in value)
    if isinstance(value, dict):
        return {key: _to_cpu(item) for key, item in value.items()}
    return value


def _devices(args):
    import torch

    return {arg.device.type for arg in args if isinstance(arg, torch.Tensor)}


def _telemetry():
    from svim_tpu_torch.cluster import device_cluster

    counts = device_cluster.TELEMETRY.as_dict()
    return {key: counts[key] for key in _NO_TELEMETRY}


# launch counts of every kernel, per path the smoke drives
PATH_LAUNCHES = {}
# the port's route counters, per path the smoke drives (_route_counts)
PATH_ROUTES = {}


def _route_modules():
    from svim_tpu_torch import genotype
    from svim_tpu_torch.cluster import cluster
    from svim_tpu_torch.collect import packed
    from svim_tpu_torch.ops import wavefront_kernel

    return packed, wavefront_kernel, genotype, cluster


def _reset_route_counts():
    packed, wavefront_kernel, genotype, cluster = _route_modules()
    packed.RERUNS.clear()
    wavefront_kernel.VARIANT_LAUNCHES.update(
        dict.fromkeys(wavefront_kernel.VARIANTS, 0))
    genotype.JOINED.update(kernel=0, host=0)
    cluster.LARGE_PARTITIONS.clear()


def _route_counts():
    """The port's route counters since the last reset: COLLECT's re-runs
    (true count, bound before, bound after), the wavefront kernel's
    launches by variant, the candidates GENOTYPE joined by the kernel and
    by the host, and the partitions CLUSTER subsampled, by type."""
    packed, wavefront_kernel, genotype, cluster = _route_modules()
    return {"collect_reruns": [list(rerun) for rerun in packed.RERUNS],
            "wavefront_by_variant": dict(wavefront_kernel.VARIANT_LAUNCHES),
            "genotype_joined": dict(genotype.JOINED),
            "large_partitions": dict(cluster.LARGE_PARTITIONS)}


def _drive(path, arguments, chunk=0):
    """One run of the port's CLI as a path of the smoke: every kernel's
    launch count and the route counters are set to 0 just before it and
    read just after (into PATH_LAUNCHES[path] and PATH_ROUTES[path]).  With `chunk` the one-shot scan is delivered in
    claims of that many rows (workloads.chunked_scan).  Returns the
    wavefront kernel's count."""
    import contextlib

    from svim_tpu_torch import workloads
    from svim_tpu_torch.ops import (
        launch_counts,
        reset_launch_counts,
        wavefront_kernel,
    )

    reset_launch_counts()
    _reset_route_counts()
    with workloads.chunked_scan(chunk) if chunk else contextlib.nullcontext():
        code = _run_port(arguments)
    PATH_LAUNCHES[path] = launch_counts()
    PATH_ROUTES[path] = _route_counts()
    if code != 0:
        raise RuntimeError("{0} exited with {1}".format(path, code))
    return PATH_LAUNCHES[path]["wavefront_banded_distance"]


def _vcf_sha256(working_dir):
    return vcf_sha256(os.path.join(working_dir, "variants.vcf"))


def phase_golden():
    """Returns the golden workload's (bam, genome)."""
    from svim_tpu_torch import workloads

    directory = os.path.join(SCRATCH, "golden")
    os.makedirs(directory, exist_ok=True)
    bam, genome = workloads.golden_workload(directory)
    working_dir = os.path.join(directory, "wd")
    launches = _drive("golden", ["alignment", working_dir, bam, genome,
                                 "--edit_backend", "wavefront",
                                 "--incremental_cluster", "off"])
    if _normalized_vcf(os.path.join(working_dir, "variants.vcf")) \
            != _normalized_vcf(GOLDEN):
        raise AssertionError("golden slice: variants.vcf differs from "
                             "tests/golden/variants.golden.vcf")
    if launches <= 0:
        raise AssertionError("golden slice launched no wavefront kernel")
    telemetry = _telemetry()
    if telemetry != GOLDEN_TELEMETRY:
        raise AssertionError("golden slice telemetry {0} != svim_tpu's {1}"
                             .format(telemetry, GOLDEN_TELEMETRY))
    log("golden", "variants.vcf byte-equal to the golden fixture; telemetry "
        "{0} equals svim_tpu's; wavefront kernel launches {1}".format(
            json.dumps(telemetry), launches))
    return bam, genome


# a workload's maker: svim_tpu_torch.workloads.<name>_workload(directory,
# argument) in a process of its own
_MAKER_SCRIPT = """
import sys
sys.path.insert(0, sys.argv[1])
from svim_tpu_torch import workloads
getattr(workloads, sys.argv[2] + "_workload")(sys.argv[3], int(sys.argv[4]))
"""
# each workload's maker argument (reads; a harness's seed) and the files it
# writes: the BAM, and the stress harnesses' truth set
WORKLOADS = {"bench": (BENCH_READS, "bench.bam"),
             "tiefree": (TIEFREE_READS, "tiefree.bam"),
             "stress": (STRESS_SEED, "reads.bam", "truth.json"),
             "independent": (STRESS_SEED, "reads.bam", "truth.json"),
             "sample": (SAMPLE_SEED, "sample.bam", "truth.json",
                        "sample.json"),
             "sample_classes": (SAMPLE_SEED, "sample.bam", "truth.json",
                                "sample.json"),
             "longtail": (SAMPLE_SEED, "sample.bam", "truth.json",
                          "sample.json"),
             "longtail_region": (SAMPLE_SEED, "sample.bam", "truth.json",
                                 "sample.json")}


def _workload_paths(name):
    argument, bam, *_truth = WORKLOADS[name]
    directory = os.path.join(SCRATCH, "{0}{1}".format(name, argument))
    return (directory, os.path.join(directory, bam),
            os.path.join(directory, "genome.fa"))


def _workload_made(name):
    directory = _workload_paths(name)[0]
    return all(os.path.exists(os.path.join(directory, file_name))
               for file_name in WORKLOADS[name][1:] + ("genome.fa",))


def start_workloads():
    """Starts the makers of the workloads that are not on disk yet.  Each
    is tens of seconds or more of host Python (simulation, record
    parsing), so they run beside each other and beside the kernel phases.
    Returns {name: (process, start time)} for _workload()."""
    makers = {}
    for name, (argument, *_files) in WORKLOADS.items():
        directory = _workload_paths(name)[0]
        if not _workload_made(name):
            os.makedirs(directory, exist_ok=True)
            makers[name] = (subprocess.Popen(
                [sys.executable, "-c", _MAKER_SCRIPT, ROOT, name, directory,
                 str(argument)]), time.perf_counter())
    return makers


def _workload(makers, name):
    """(directory, bam, genome) of a workload: waits for its maker, or
    makes it here when none was started and it is not on disk."""
    directory, bam, genome = _workload_paths(name)
    started = time.perf_counter()
    if name in makers:
        process, started = makers.pop(name)
        if process.wait() != 0:
            raise RuntimeError("making the {0} workload failed".format(name))
    elif not _workload_made(name):
        os.makedirs(directory, exist_ok=True)
        subprocess.run([sys.executable, "-c", _MAKER_SCRIPT, ROOT, name,
                        directory, str(WORKLOADS[name][0])], check=True)
    else:
        return directory, bam, genome
    log(name, "made the {0} workload ({1}) in {2:.1f}s, in a process of its "
        "own ({3} bytes of BAM)".format(
            name, os.path.basename(directory), time.perf_counter() - started,
            os.path.getsize(bam)))
    return directory, bam, genome


def phase_bench(card, recorder, makers):
    """Returns the bench workload's (bam, genome) and the stage seconds of
    its two runs by edit backend."""
    directory, bam, genome = _workload(makers, "bench")
    results = {}
    off_seconds = {}
    for backend in ("wavefront", "auto"):
        working_dir = os.path.join(directory, "wd_" + backend)
        # the timed run goes through the ops themselves; the recorded
        # run that follows feeds phase 6
        started = time.perf_counter()
        launches = _drive("bench_" + backend,
                          ["alignment", working_dir, bam, genome,
                           "--edit_backend", backend, "--profile",
                           "--incremental_cluster", "off"])
        wall = time.perf_counter() - started
        seconds = _stage_seconds(working_dir)
        off_seconds[backend] = seconds
        rate = BENCH_READS / (seconds["collect"] + seconds["cluster"])
        telemetry = _telemetry()
        calls = _calls_per_class(os.path.join(working_dir, "variants.vcf"))
        results[backend] = (working_dir, launches)
        log("bench", "{0}: wall {1:.2f}s; stages {2}; calls {3}; telemetry "
            "{4}; wavefront launches {5}, agglomeration launches {8}; "
            "{6:.1f} reads/s through COLLECT+CLUSTER on {7}".format(
                backend, wall, json.dumps(seconds), json.dumps(calls),
                json.dumps(telemetry), launches, rate, card,
                PATH_LAUNCHES["bench_" + backend]["agglomerate"]))
        if telemetry != BENCH_TELEMETRY[backend]:
            raise AssertionError("bench slice ({0}) telemetry {1} != "
                                 "svim_tpu's {2}".format(
                                     backend, telemetry,
                                     BENCH_TELEMETRY[backend]))
    if results["wavefront"][1] <= 0:
        raise AssertionError("bench slice launched no wavefront kernel")
    if PATH_LAUNCHES["bench_wavefront"]["agglomerate"] <= 0:
        raise AssertionError("bench slice (wavefront) launched no "
                             "agglomeration kernel on its resident route")
    if _normalized_vcf(os.path.join(results["wavefront"][0], "variants.vcf")) \
            != _normalized_vcf(os.path.join(results["auto"][0],
                                            "variants.vcf")):
        raise AssertionError("bench slice: wavefront and auto variants.vcf "
                             "differ")
    digest = _vcf_sha256(results["wavefront"][0])
    if digest != BENCH_VCF_SHA256:
        raise AssertionError("bench slice: variants.vcf (sha256 {0}) differs "
                             "from svim_tpu's".format(digest))
    log("bench", "wavefront and auto variants.vcf are byte-equal, and equal "
        "to svim_tpu's (sha256)")
    recorder.label = "bench_wavefront"
    with recorder:
        code = _run_port(["alignment", os.path.join(directory, "wd_recorded"),
                          bam, genome, "--edit_backend", "wavefront",
                          "--incremental_cluster", "off"])
    if code != 0:
        raise RuntimeError("recorded bench slice exited with {0}".format(code))
    return bam, genome, off_seconds


class RouteCounter:
    """While active, counts per CLUSTER route (fused, matrix, resident) the
    partitions whose device labeling was accepted (FallbackTelemetry's
    `device`, which does not say by which route)."""

    ROUTES = {"fused": "_consume_fused", "matrix": "_consume_matrix",
              "resident": "_consume_resident"}

    def __init__(self):
        from svim_tpu_torch.cluster import device_cluster

        self.module = device_cluster
        self.device = {route: 0 for route in self.ROUTES}

    def _wrap(self, route, original):
        def counted(*args, **kwargs):
            before = self.module.TELEMETRY.device
            results = original(*args, **kwargs)
            self.device[route] += self.module.TELEMETRY.device - before
            return results
        return counted

    def __enter__(self):
        self.originals = {name: getattr(self.module, name)
                          for name in self.ROUTES.values()}
        for route, name in self.ROUTES.items():
            setattr(self.module, name, self._wrap(route,
                                                  self.originals[name]))
        return self

    def __exit__(self, *exc):
        for name, original in self.originals.items():
            setattr(self.module, name, original)


def phase_tiefree(card, recorder, makers):
    """The tie-free workload at TIEFREE_READS reads through the CLI on the
    card: with --incremental_cluster off and either edit backend the VCF
    must hash to svim_tpu's, the telemetry and the accepted labelings a
    route must equal svim_tpu's (TIEFREE_TELEMETRY, TIEFREE_DEVICE_BY_ROUTE:
    the device decides partitions on the fused and on the matrix route) and
    the agglomeration kernel must have been launched; a second run a
    backend is recorded for phase 6; then once at the CLI's defaults (mid-
    scan clustering): the same VCF.  Returns {path: stage seconds}."""
    directory, bam, genome = _workload(makers, "tiefree")
    stage_seconds = {}

    def check_vcf(path, working_dir):
        digest = _vcf_sha256(working_dir)
        if digest != TIEFREE_VCF_SHA256:
            raise AssertionError("{0}: variants.vcf (sha256 {1}) differs "
                                 "from svim_tpu's".format(path, digest))

    for backend in ("auto", "wavefront"):
        path = "tiefree_" + backend
        working_dir = os.path.join(directory, "wd_" + backend)
        with RouteCounter() as routes:
            _drive(path, ["alignment", working_dir, bam, genome,
                          "--edit_backend", backend, "--profile",
                          "--incremental_cluster", "off"])
        seconds = stage_seconds[path] = _stage_seconds(working_dir)
        telemetry = _telemetry()
        by_route = {route: count for route, count in routes.device.items()
                    if count}
        log("tiefree", "{0}, --incremental_cluster off: stages {1}; calls "
            "{2}; telemetry {3}; labelings accepted by route {4}; launches "
            "{5}; {6:.1f} reads/s through COLLECT+CLUSTER on {7}".format(
                backend, json.dumps(seconds), json.dumps(_calls_per_class(
                    os.path.join(working_dir, "variants.vcf"))),
                json.dumps(telemetry), json.dumps(by_route),
                json.dumps(PATH_LAUNCHES[path]),
                TIEFREE_READS / (seconds["collect"] + seconds["cluster"]),
                card))
        check_vcf(path, working_dir)
        if telemetry != TIEFREE_TELEMETRY[backend]:
            raise AssertionError("{0} telemetry {1} != svim_tpu's {2}".format(
                path, telemetry, TIEFREE_TELEMETRY[backend]))
        if by_route != TIEFREE_DEVICE_BY_ROUTE[backend] \
                or by_route.get("fused", 0) <= 0 \
                or (backend == "auto" and by_route.get("matrix", 0) <= 0):
            raise AssertionError("{0}: labelings accepted by route {1}, "
                                 "svim_tpu's {2}".format(
                                     path, by_route,
                                     TIEFREE_DEVICE_BY_ROUTE[backend]))
        if telemetry["post_tie"] <= 0:
            raise AssertionError(path + ": no partition fell to post_tie")
        if PATH_LAUNCHES[path]["agglomerate"] <= 0:
            raise AssertionError(path + " launched no agglomeration kernel")
        recorder.label = path
        with recorder:
            working_dir = os.path.join(directory, "wd_recorded_" + backend)
            code = _run_port(["alignment", working_dir, bam, genome,
                              "--edit_backend", backend,
                              "--incremental_cluster", "off"])
        if code != 0:
            raise RuntimeError("recorded {0} exited with {1}".format(path,
                                                                     code))
        check_vcf(path + " (recorded)", working_dir)

    working_dir = os.path.join(directory, "wd_default")
    _drive("tiefree_default", ["alignment", working_dir, bam, genome,
                               "--profile"])
    seconds = stage_seconds["tiefree_default"] = _stage_seconds(working_dir)
    reused, memoized = _reused(working_dir)
    check_vcf("tiefree_default", working_dir)
    log("tiefree", "the CLI's defaults (--incremental_cluster auto): stages "
        "{0}; {1} of {2} mid-scan partitions reused; telemetry {3}; launches "
        "{4}; VCF hashes to svim_tpu's, as with auto and wavefront".format(
            json.dumps(seconds), reused, memoized, json.dumps(_telemetry()),
            json.dumps(PATH_LAUNCHES["tiefree_default"])))
    return stage_seconds


def _same_linkage(got, want, where):
    """Agglomeration outputs from the card (`got`) against the CPU's:
    the flag outputs and min_gap on every row; merges and heights on the
    rows the float32 guard accepts (min_gap >= TIE_EPS), the only rows a
    labeling is built from.  Returns those rows and the largest height
    difference on them."""
    import torch

    from svim_tpu_torch.ops.linkage_kernel import TIE_EPS

    for index in range(3, len(want)):
        torch.testing.assert_close(got[index], want[index], rtol=1e-6, atol=0,
                                   msg=lambda m: "{0}, output {1}: {2}".format(
                                       where, index, m))
    accepted = want[3] >= TIE_EPS
    for index in range(2):
        if not torch.equal(got[index][accepted], want[index][accepted]):
            raise AssertionError("{0}: merges differ on accepted rows".format(
                where))
    torch.testing.assert_close(got[2][accepted], want[2][accepted],
                               rtol=1e-6, atol=0, msg=lambda m: "{0}, "
                               "heights: {1}".format(where, m))
    error = float((got[2][accepted].double()
                   - want[2][accepted].double()).abs().max()) \
        if bool(accepted.any()) else 0.0
    return accepted, error


def _synthetic_linkage(rng, device):
    """Seeded tie-free partitions through the three ops on `device`:
    yields (name, args, kwargs) with numpy-made inputs as tensors."""
    import numpy as np
    import torch

    def put(values):
        return torch.from_numpy(np.ascontiguousarray(values)).to(device)

    for pad, most in ((32, 16), (128, 128)):
        batch = 64
        counts = rng.integers(3, most + 1, size=batch)
        valid = np.arange(pad)[None, :] < counts[:, None]
        points = rng.random((batch, pad, pad), dtype=np.float32)
        matrices = np.triu(points, 1) + np.triu(points, 1).transpose(0, 2, 1)
        yield "agglomerate_batched", (put(matrices), put(valid)), {}

        starts = rng.integers(0, 1_000_000, size=(batch, pad)).astype(np.int32)
        ends = starts + rng.integers(50, 5000, size=(batch, pad)).astype(
            np.int32)
        dest = rng.integers(0, 1_000_000, size=(batch, pad)).astype(np.int32)
        reads = rng.integers(0, pad, size=(batch, pad)).astype(np.int32)
        wall = rng.random(batch) < 0.5
        kind = rng.integers(0, 3, size=batch).astype(np.int32)
        yield "span_position_agglomerate_batched", (
            put(starts), put(ends), put(reads), put(valid), 900.0, 0.5,
            put(wall)), {"dest": put(dest), "kind": put(kind)}

        pairs = 4 * batch
        part = rng.integers(0, batch, size=pairs)
        first = rng.integers(0, counts[part])
        second = (first + 1 + rng.integers(0, counts[part] - 1)) % counts[part]
        # each unordered pair once, as the host enumerates them: a repeated
        # pair would be two writes of one cell, in no defined order
        _, unique = np.unique((part * pad + np.minimum(first, second)) * pad
                              + np.maximum(first, second), return_index=True)
        part, first, second = part[unique], first[unique], second[unique]
        pairs = len(unique)
        yield "ins_matrices_from_pairs", (
            put(starts), put(ends - starts), put(part.astype(np.int32)),
            put(first.astype(np.int32)), put(second.astype(np.int32)),
            put(rng.integers(0, 400, size=pairs).astype(np.int32)), 900.0,
            1.0), {}


# (B, P) at which the agglomeration kernel is timed and its bound stated:
# full partitions in both pad buckets of the CLUSTER stage
AGGLOMERATE_SHAPES = ((1024, 128), (1024, 32))
# 4-byte shared-memory loads the card can do: 32 lanes an SM and clock on
# 132 SMs at 1.98 GHz (128 bytes an SM and clock)
SHARED_LOADS_PER_SECOND = 132 * 32 * 1.98e9


# operations a cell of the fused entry's distance formula, a division counted
# as one: two differences and two absolute values, the larger span and its
# floor of 1, three conversions, two divisions, one sum, the same-read
# comparison and its select
AGGLOMERATE_BUILD_OPS_PER_CELL = 14


def agglomerate_bound_ms(counts, pad, fused):
    """The least time the card could take for one agglomeration call whose
    partitions hold `counts` valid slots.  It is the largest of three times.
    Bytes: each input read from and each output written to device memory
    once, over the memory rate.  Shared-memory loads of the cheapest
    algorithm known for the function, not of the kernel as written: with a
    minimum kept a row, a step over m live slots reads rows lo and hi (2 m)
    and reduces m row minima, so a partition of n slots needs
    3 * sum(m for m in 2..n) loads, about 1.5 n * n and not (n - 1) * P * P.
    Fused entry only: AGGLOMERATE_BUILD_OPS_PER_CELL operations a cell of
    the upper triangle (the matrix is symmetric) over the card's issue
    rate.  Returns (ms, "bytes" or "operations")."""
    batch = len(counts)
    counts = [int(count) for count in counts]
    loads = sum(3 * (n * (n + 1) // 2 - 1) for n in counts if n >= 2)
    ops_ms = loads / SHARED_LOADS_PER_SECOND * 1e3
    moved = batch * (12 * (pad - 1) + 4)
    if fused:
        moved += batch * (17 * pad + 5) + batch * (pad + 2)
        cells = sum(n * (n - 1) // 2 for n in counts)
        ops_ms = max(ops_ms, AGGLOMERATE_BUILD_OPS_PER_CELL * cells
                     / LANE_INSTRUCTIONS_PER_SECOND * 1e3)
    else:
        moved += batch * (4 * pad * pad + pad)
    bytes_ms = moved / HBM_BYTES_PER_SECOND * 1e3
    if ops_ms >= bytes_ms:
        return ops_ms, "operations"
    return bytes_ms, "bytes"


def _fused_inputs(rng, batch, pad, kinds, walls, counts=None, wide=False):
    """Seeded fused-route inputs in the op's argument order (numpy): the
    coordinates of _distance_inputs (negative starts, zero and negative
    spans, repeated read ids) with a destination column; `counts` sets the
    valid slots a partition (0: a padding partition)."""
    import numpy as np

    starts, ends, reads, valid = _distance_inputs(rng, batch, pad, wide=wide)
    if counts is not None:
        valid = np.arange(pad)[None, :] < np.asarray(counts)[:, None]
    low, high = (-2**31, 2**31 - 1) if wide else (-5_000, 2_000_000)
    dest = rng.integers(low, high, size=(batch, pad)).astype(np.int32)
    return (starts, ends, reads, valid, 900.0, 0.5,
            np.broadcast_to(np.asarray(walls, dtype=bool), (batch,)).copy(),
            dest,
            np.broadcast_to(np.asarray(kinds, dtype=np.int32),
                            (batch,)).copy())


def _matrix_inputs(rng, batch, pad, counts, ties=False, symmetric=True):
    """Seeded (B, P, P) float32 matrices with `counts` valid slots a
    partition, symmetric unless `symmetric` is false (the matrix entry takes
    any matrix); with `ties` the distances are a few multiples of 1/8, so
    that most steps see several equal minima."""
    import numpy as np

    if ties:
        points = rng.integers(1, 6, size=(batch, pad, pad)).astype(
            np.float32) / 8
    else:
        points = rng.random((batch, pad, pad), dtype=np.float32)
    valid = np.arange(pad)[None, :] < np.asarray(counts)[:, None]
    if not symmetric:
        return points, valid
    upper = np.triu(points, 1)
    return upper + upper.transpose(0, 2, 1), valid


def agglomerate_cases(rng):
    """(label, op name, numpy arguments) of phase 6's kernel comparison,
    beside the seeded tie-free partitions of _synthetic_linkage and the
    main path's recorded calls: every distance kind with and without the
    wall in both pad buckets (negative starts, zero spans), kinds and walls
    mixed in one batch, coordinates from all of int32 (wrapping sums), 3
    and 128 valid slots in one call, padding partitions (0 and 1 valid
    slots), exact-tie matrices (the lowest flat index must win), float64
    distances (rounded to float32 by the dispatcher), matrices that are not
    symmetric (with and without ties), valid counts across the packing of
    32-slot partitions four a CTA (1, 2, 31, 32, a last CTA one quarter
    full), B = 8 and B = 1024, and the two timed shapes with every
    partition full."""
    import numpy as np

    fused = "span_position_agglomerate_batched"
    matrix = "agglomerate_batched"
    for pad in (32, 128):
        for kind in (0, 1, 2):
            for wall in (True, False):
                yield ("P={0} kind={1} wall={2}".format(pad, kind, wall),
                       fused, _fused_inputs(rng, 8, pad, kind, wall))
        mixed = rng.integers(0, 3, size=1024)
        walls = rng.random(1024) < 0.5
        yield ("B=1024 P={0} kinds and walls mixed".format(pad), fused,
               _fused_inputs(rng, 1024, pad, mixed, walls))
        yield ("B=8 P={0} all of int32".format(pad), fused,
               _fused_inputs(rng, 8, pad, mixed[:8], walls[:8], wide=True))
        ragged = [3, pad, 0, 1, 2, pad // 2, 0, pad - 1]
        yield ("P={0} slots {1}".format(pad, ragged), fused,
               _fused_inputs(rng, 8, pad, mixed[:8], walls[:8],
                             counts=ragged))
        yield ("P={0} slots {1}".format(pad, ragged), matrix,
               _matrix_inputs(rng, 8, pad, ragged))
        yield ("P={0} exact ties".format(pad), matrix,
               _matrix_inputs(rng, 8, pad, ragged, ties=True))
        # float64 distances: the dispatcher rounds them to float32 on the
        # card as the plain version does
        distances, valid = _matrix_inputs(rng, 8, pad, ragged)
        yield ("P={0} float64 distances".format(pad), matrix,
               (distances.astype(np.float64) + 1e-9, valid))
        counts = rng.integers(0, pad + 1, size=1024)
        yield ("B=1024 P={0} exact ties".format(pad), matrix,
               _matrix_inputs(rng, 1024, pad, counts, ties=True))
        yield ("B=1024 P={0}".format(pad), matrix,
               _matrix_inputs(rng, 1024, pad, counts))
        # not symmetric: the row minima must follow each whole row; with
        # few values a new cell (r, lo) takes a tied row minimum over
        for ties in (False, True):
            yield ("P={0} not symmetric{1}".format(pad, ", ties" * ties),
                   matrix, _matrix_inputs(rng, 64, pad, rng.integers(
                       0, pad + 1, size=64), ties=ties, symmetric=False))
    # norms on, next to and outside the range in which the fused build
    # divides by the norm without __fdiv_rn's range check, a negative one
    for pad in (32, 128):
        for norm in (2.0 ** -40, 2.0 ** 40, 1e-13, 3e12, -900.0):
            arguments = list(_fused_inputs(rng, 8, pad, [0, 1] * 4,
                                           [True, False] * 4))
            arguments[4] = norm
            yield ("P={0} norm {1!r}".format(pad, norm), fused,
                   tuple(arguments))
        # tiny and zero distances: averages and gaps whose quotients leave
        # the normal range take __fdiv_rn
        distances, valid = _matrix_inputs(rng, 8, pad, [pad, pad - 1, 9, 2] * 2)
        distances[:4] *= np.float32(1e-37)
        distances[4:] *= np.float32(1e-44 / 0.5)
        yield ("P={0} tiny distances".format(pad), matrix,
               (distances, valid))
    # valid counts across the packing of 32-slot partitions, four a CTA:
    # 1, 2, 31 and 32 slots, and a last CTA with one partition of four
    packing = [1, 2, 31, 32, 32, 31, 2, 1, 17]
    yield ("P=32 slots {0}".format(packing), matrix,
           _matrix_inputs(rng, len(packing), 32, packing))
    yield ("P=32 slots {0}".format(packing), fused,
           _fused_inputs(rng, len(packing), 32, [0, 1, 2] * 3,
                         [True, False] * 4 + [True], counts=packing))
    for batch, pad in AGGLOMERATE_SHAPES:
        full = np.full(batch, pad)
        yield ("timed", matrix, _matrix_inputs(rng, batch, pad, full))
        # distinct read ids: no slot is dropped, every step is a merge
        arguments = list(_fused_inputs(rng, batch, pad, 0, True, counts=full))
        arguments[2] = np.tile(np.arange(pad, dtype=np.int32), (batch, 1))
        yield ("timed", fused, tuple(arguments))


# what _kernel_against_plain has seen: calls compared, and the largest
# difference between the kernel's and the plain version's heights and gaps
AGGLOMERATE_CHECK = {"calls": 0, "max_abs_err": 0.0}


def _bit_equal(a, b):
    import torch

    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return torch.equal(a, b)


def _on_card(arguments):
    """An op's positional arguments with every array (numpy, or a tensor on
    any device) as a tensor on the card."""
    import numpy as np
    import torch

    return [torch.from_numpy(np.ascontiguousarray(value)).cuda()
            if isinstance(value, np.ndarray)
            else value.cuda() if isinstance(value, torch.Tensor) else value
            for value in arguments]


def _kernel_against_plain(name, arguments, where):
    """One agglomeration op through the kernel and through the plain
    version, both on the card: every output must be equal bit for bit on
    every row, accepted by the float32 guard or not.  `arguments` are the
    op's positional arguments (tensors on any device, or numpy).  Returns
    the kernel's outputs."""
    import torch

    from svim_tpu_torch.ops import linkage_kernel

    tensors = _on_card(arguments)
    before = linkage_kernel.LAUNCHES
    got = getattr(linkage_kernel, name)(*tensors)
    if linkage_kernel.LAUNCHES != before + 1:
        raise AssertionError("{0}: {1} on CUDA tensors launched no kernel"
                             .format(where, name))
    want = getattr(linkage_kernel, name + "_plain")(*tensors)
    torch.cuda.synchronize()
    AGGLOMERATE_CHECK["calls"] += 1
    for index, (a, b) in enumerate(zip(got, want)):
        if a.dtype == torch.float32 and a.numel():
            AGGLOMERATE_CHECK["max_abs_err"] = max(
                AGGLOMERATE_CHECK["max_abs_err"],
                float((a.double() - b.double()).abs().max()))
        if not _bit_equal(a, b):
            rows = (a != b).reshape(a.shape[0], -1).any(dim=1)
            raise AssertionError(
                "{0}: kernel != plain in output {1} on rows {2}".format(
                    where, index, torch.nonzero(rows).flatten()[:8].tolist()))
    if len(got) != len(want):
        raise AssertionError("{0}: {1} outputs against {2}".format(
            where, len(got), len(want)))
    return got


# the commit whose csrc/agglomerate.cu rescans the whole matrix at each step
# (one CTA a partition, two block scans and four barriers a step): timed
# beside the present kernel, in the same process, wherever its source can be
# had (see _source_at)
RESCAN_DESIGN_COMMIT = "7e20e235f462e89dd6c131b4a8e6e9edb4518d94"
AGGLOMERATE_SOURCE = "svim_tpu_torch/csrc/agglomerate.cu"
# where the sources of earlier designs are looked up first: each commit's
# files unpacked under _chipwork/<commit>/ (git-ignored; a copy of the
# repository without .git has no other way to them), e.g.
#   git archive <commit> <path> | tar -x -C _chipwork/<commit>
DESIGNS_DIR = os.path.join(ROOT, "_chipwork")


def _source_at(commit, path):
    """The text of `path` at `commit`: from _chipwork/<commit>/<path>, else
    from git; None where neither has it."""
    unpacked = os.path.join(DESIGNS_DIR, commit, path)
    if os.path.exists(unpacked):
        with open(unpacked) as handle:
            return handle.read()
    try:
        shown = subprocess.run(["git", "-C", ROOT, "show",
                                commit + ":" + path],
                               capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return shown.stdout if shown.returncode == 0 else None


def _resource_usage(library):
    """Registers, spills and static shared memory of each kernel in a built
    library (cuobjdump -res-usage), as text lines; [] without cuobjdump."""
    from svim_tpu_torch.ops import _build

    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    if not os.path.exists(tool):
        return []
    listing = subprocess.run([tool, "-res-usage", library],
                             capture_output=True, text=True).stdout
    lines, function = [], None
    for line in listing.splitlines():
        line = line.strip()
        if line.startswith("Function "):
            function = line[len("Function "):].rstrip(":")
        elif line.startswith("REG:") and function:
            lines.append("{0}: {1}".format(function, line))
    return lines


def rescan_design_library():
    """The rescan design of the agglomeration kernel, built from its source
    with the port's nvcc flags into SCRATCH and bound like the present one;
    None when its source cannot be had."""
    import ctypes

    from svim_tpu_torch.ops import _build, linkage_kernel

    source = _source_at(RESCAN_DESIGN_COMMIT, AGGLOMERATE_SOURCE)
    if source is None:
        return None
    directory = os.path.join(SCRATCH, "rescan_design")
    os.makedirs(directory, exist_ok=True)
    source_path = os.path.join(directory, "agglomerate.cu")
    library_path = os.path.join(directory, "agglomerate.so")
    with open(source_path, "w") as handle:
        handle.write(source)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", library_path,
                    source_path], check=True, capture_output=True)
    library = ctypes.CDLL(library_path)
    present = linkage_kernel._kernel_library()
    for name in ("agglomerate_max_slots", "agglomerate_matrix",
                 "agglomerate_fused"):
        getattr(library, name).argtypes = getattr(present, name).argtypes
        getattr(library, name).restype = getattr(present, name).restype
    library.path = library_path
    return library


# the commit whose csrc/wavefront.cu runs a band too wide for a warp as one
# CTA a pair with a block barrier a front (fronts in shared memory, or in
# device memory above it): timed beside the strip layout, in the same
# process, wherever its source can be had (see _source_at)
WAVEFRONT_DESIGN_COMMIT = "8f82aabc7b3f9e9f11c6855408ee8bcd77a75296"
WAVEFRONT_SOURCE = "svim_tpu_torch/csrc/wavefront.cu"


def wavefront_design_library():
    """The first design of the wavefront kernel, built from its source with
    the port's nvcc flags into SCRATCH; None when its source cannot be had."""
    import ctypes

    source = _source_at(WAVEFRONT_DESIGN_COMMIT, WAVEFRONT_SOURCE)
    if source is None:
        return None
    library = _build_designs(os.path.join(SCRATCH, "wavefront_design"),
                             {"wavefront": source})["wavefront"]
    pointer, integer = ctypes.c_void_p, ctypes.c_int
    library.wavefront_banded_distance_warp.argtypes = [
        pointer, pointer, pointer, pointer, pointer, integer, integer,
        integer, integer, integer, pointer]
    library.wavefront_banded_distance_cta.argtypes = [
        pointer, pointer, pointer, pointer, pointer, pointer, integer,
        integer, integer, integer, integer, pointer]
    library.wavefront_max_shared_bytes.argtypes = []
    library.max_shared = library.wavefront_max_shared_bytes()
    return library


def _first_design_distance(library, a_codes, a_lens, b_codes, b_lens, band):
    """banded_distance through the first design's library, dispatched as its
    wrapper did: a warp a pair where the band fits 1056 slots, else a CTA a
    pair with both fronts (and the strings, where they fit) in shared
    memory, or the fronts in a (B, 2, stride) device-memory scratch."""
    import torch

    batch, length = a_codes.shape
    out = torch.empty(batch, dtype=torch.int32, device=a_codes.device)
    stream = torch.cuda.current_stream().cuda_stream
    pointers = (a_codes.data_ptr(), a_lens.data_ptr(), b_codes.data_ptr(),
                b_lens.data_ptr(), out.data_ptr())
    room = library.max_shared - 16
    stride = (min(band, length) + 4) & ~1
    slots = min(band, length) + 1
    if slots <= 32 * 33 and 2 * length <= room:
        warps = 4 if batch >= 2048 else 1
        while warps > 1 and warps * 2 * length > library.max_shared:
            warps //= 2
        code = library.wavefront_banded_distance_warp(
            *pointers, batch, length, band,
            3 if slots <= 96 else 9 if slots <= 288 else 33, warps, stream)
    elif 2 * stride * 4 <= room:
        code = library.wavefront_banded_distance_cta(
            *pointers, None, batch, length, band, stride,
            int(2 * stride * 4 + 2 * length <= room), stream)
    else:
        scratch = torch.empty((batch, 2, stride), dtype=torch.int32,
                              device=a_codes.device)
        code = library.wavefront_banded_distance_cta(
            *pointers, scratch.data_ptr(), batch, length, band, stride, 0,
            stream)
    if code != 0:
        raise RuntimeError("the first wavefront design failed: CUDA error "
                           "{0}".format(code))
    return out


def time_wavefront_designs(args, first_design, repeats):
    """Device ms of banded_distance_cuda(*args) and, when `first_design` is a
    library, of the first design on the same inputs in turns
    (_time_designs: first design, kernel, kernel, first design); their
    outputs must be equal.  Launch counts are left as they were."""
    import torch

    from svim_tpu_torch.ops import wavefront_kernel

    variants = dict(wavefront_kernel.VARIANT_LAUNCHES)

    def call():
        if wavefront_kernel._library is first_design:
            return _first_design_distance(first_design, *args)
        return wavefront_kernel.banded_distance_cuda(*args)

    try:
        return _time_designs(wavefront_kernel, "_library", "LAUNCHES", call,
                             first_design, torch.equal, repeats=repeats)
    finally:
        wavefront_kernel.VARIANT_LAUNCHES.update(variants)


def _through(library, function):
    """`function()` with the agglomeration wrappers bound to `library`;
    launches made so are not counted."""
    from svim_tpu_torch.ops import linkage_kernel

    saved, launches = linkage_kernel._library, linkage_kernel.LAUNCHES
    linkage_kernel._library = library
    try:
        return function()
    finally:
        linkage_kernel._library = saved
        linkage_kernel.LAUNCHES = launches


def _time_against(name, tensors, rescan_design, repeats=10):
    """Device ms of the kernel wrapper `name`_cuda on `tensors` and, when
    `rescan_design` is a library, of the rescan design on the same inputs
    in turns (rescan design, kernel, kernel, rescan design; each the mean of
    its two turns).  The rescan design's outputs must equal the kernel's bit
    for bit.  Returns (ms, rescan design ms or None)."""
    from svim_tpu_torch.ops import linkage_kernel

    kernel = getattr(linkage_kernel, name + "_cuda")
    if rescan_design is None:
        return _device_ms(lambda: kernel(*tensors), repeats)[0], None
    first, old = _through(rescan_design, lambda: _device_ms(
        lambda: kernel(*tensors), repeats))
    second, new = _device_ms(lambda: kernel(*tensors), repeats)
    third, _ = _device_ms(lambda: kernel(*tensors), repeats)
    fourth, _ = _through(rescan_design, lambda: _device_ms(
        lambda: kernel(*tensors), repeats))
    for index, (a, b) in enumerate(zip(new, old)):
        if not _bit_equal(a, b):
            raise AssertionError("{0}: the rescan design differs from the "
                                 "kernel in output {1}".format(name, index))
    return (second + third) / 2, (first + fourth) / 2


def phase_resources(rescan_design):
    """Registers, spills and static shared memory of the agglomeration
    kernels, present and rescan design (logged; not checked)."""
    from svim_tpu_torch.ops import _build

    libraries = {"present": _build.library_path("agglomerate")}
    if rescan_design is not None:
        libraries["rescan design"] = rescan_design.path
    for which, path in libraries.items():
        for line in _resource_usage(path) or ["cuobjdump not found"]:
            log("agglomerate", "{0}: {1}".format(which, line))


def phase_agglomerate(rescan_design):
    """The kernel half of phase 6 on seeded inputs: csrc/agglomerate.cu
    against the plain versions on the card (agglomerate_cases), and its
    time at AGGLOMERATE_SHAPES beside the bound and beside the rescan
    design's (`rescan_design`: a library or None).  Returns {(op name, B,
    P): (kernel ms, plain ms, bound ms, bound by, rescan design ms)}."""
    import numpy as np

    from svim_tpu_torch.ops import linkage_kernel

    rng = np.random.default_rng(20261020)
    timings = {}
    checked = 0
    for label, name, arguments in agglomerate_cases(rng):
        batch, pad = arguments[0].shape[:2]
        where = "{0}, {1}".format(name, label)
        got = _kernel_against_plain(name, arguments, where)
        merged = int((got[0] >= 0).sum())
        checked += 1
        if label != "timed":
            log("agglomerate", "{0} B={1}: bit-equal on every row ({2} "
                "merges, {3} rows pass the float32 guard)".format(
                    where, batch, merged,
                    int((got[3] >= linkage_kernel.TIE_EPS).sum())))
            continue
        if merged != batch * (pad - 1):
            raise AssertionError("{0}: {1} merges, not every step of every "
                                 "partition".format(where, merged))
        tensors = _on_card(arguments)
        plain = getattr(linkage_kernel, name + "_plain")
        plain_ms, _ = _time_ms(lambda: plain(*tensors), 1, warm_up=False)
        kernel_ms, rescan_ms = _time_against(name, tensors, rescan_design)
        fused = name != "agglomerate_batched"
        counts = tensors[3 if fused else 1].sum(dim=1).tolist()
        bound_ms, bound_by = agglomerate_bound_ms(counts, pad, fused)
        timings[(name, batch, pad)] = (kernel_ms, plain_ms, bound_ms,
                                       bound_by, rescan_ms)
        log("agglomerate", "{0} B={1} P={2}, every partition full: bit-equal;"
            " kernel {3:.4f} ms (rescan design {4}), plain {5:.3f} ms, bound "
            "{6:.5f} ms by {7} (kernel {8:.0f} times its bound)".format(
                name, batch, pad, kernel_ms,
                "not timed" if rescan_ms is None
                else "{0:.4f} ms".format(rescan_ms), plain_ms, bound_ms,
                bound_by, kernel_ms / bound_ms))
    log("agglomerate", "{0} seeded cases: the kernel equals its plain "
        "version on the card bit for bit".format(checked))
    return timings


def phase_agglomerate_launches(calls, rescan_design):
    """Every agglomeration call of the recorded runs in `calls` ((label,
    op name, args, kwargs)) launched again on its own inputs and timed,
    beside the rescan design and the bound: B, P, the largest valid count.
    Returns {row label: (ms, None, bound ms, bound by, rescan design ms)}."""
    rows = {}
    numbers = {}
    for label, name, args, kwargs in calls:
        if name == "ins_matrices_from_pairs":
            continue
        tensors = _on_card(_positional(args, kwargs))
        fused = name != "agglomerate_batched"
        valid = tensors[3 if fused else 1]
        batch, pad = valid.shape
        counts = valid.sum(dim=1).tolist()
        kernel_ms, rescan_ms = _time_against(name, tensors, rescan_design,
                                             repeats=20)
        bound_ms, bound_by = agglomerate_bound_ms(counts, pad, fused)
        number = numbers[label] = numbers.get(label, -1) + 1
        row = "{0} call {1}: {2} B={3} P={4} largest={5}".format(
            label, number, "fused" if fused else "matrix", batch, pad,
            int(max(counts)))
        rows[row] = (kernel_ms, None, bound_ms, bound_by, rescan_ms)
        log("agglomerate", "{0}: kernel {1:.4f} ms (rescan design {2}), "
            "bound {3:.5f} ms by {4}".format(
                row, kernel_ms, "not timed" if rescan_ms is None
                else "{0:.4f} ms".format(rescan_ms), bound_ms, bound_by))
    if not rows:
        raise AssertionError("the recorded runs made no agglomeration call")
    return rows


def _positional(args, kwargs):
    """A recorded linkage call's arguments in the op's positional order
    (the fused op's callers pass dest and kind by name)."""
    return tuple(args) + tuple(kwargs[name] for name in ("dest", "kind")
                               if name in kwargs)


def _host_labels(matrix, count, threshold):
    """Exact float64 average linkage cut at `threshold` (scipy's rules)."""
    import numpy as np

    from svim_tpu_torch.cluster import device_cluster

    condensed = matrix[:count, :count][np.triu_indices(count, 1)].astype(
        np.float64)
    return device_cluster.fcluster_distance(
        device_cluster.average_linkage(condensed), threshold)


def linkage_calls_against_plain(calls):
    """Every recorded linkage call (LinkageRecorder.calls) again: on the
    CPU, where the outputs must agree with the card's, and through the
    kernel and the plain version on the card, bit-equal to each other and
    to the run's own outputs.  Returns (ops seen, kernel rows by op, the
    largest difference from the CPU)."""
    from svim_tpu_torch.ops import linkage_kernel

    seen = set()
    kernel_rows = {}
    max_error = 0.0
    for number, (name, args, kwargs, got, devices) in enumerate(calls):
        if devices != {"cuda"}:
            raise AssertionError("{0} ran on {1}, not the card".format(
                name, sorted(devices)))
        want = getattr(linkage_kernel, name)(*args, **kwargs)
        where = "main-path call {0} of {1}".format(number, name)
        if name == "ins_matrices_from_pairs":
            # the run's matrices against the CPU's off the diagonal, and the
            # same inputs through the kernel and the plain version on the
            # card, with the agglomeration call that took them
            cells = _off_diagonal(*got.shape[:2])
            if not _bit_equal(got[cells], want[cells]):
                raise AssertionError(where + ": the card's matrices differ "
                                     "from the CPU's off the diagonal")
            following = next(
                (call for call in calls[number + 1:]
                 if call[0] == "agglomerate_batched"
                 and _bit_equal(call[1][0], got)), None)
            if following is None:
                raise AssertionError(where + ": no agglomeration call of "
                                     "these matrices follows")
            _ins_against_plain(args, where, valid=following[1][1],
                               recorded=got)
        else:
            max_error = max(max_error, _same_linkage(got, want, where)[1])
            # the same inputs through the kernel and the plain version on
            # the card; what the run itself got must be the kernel's output
            again = _kernel_against_plain(name, _positional(args, kwargs),
                                          where)
            if not all(_bit_equal(a.cpu(), b) for a, b in zip(again, got)):
                raise AssertionError(where + ": the run's outputs differ "
                                     "from the kernel's on the same inputs")
        kernel_rows[name] = kernel_rows.get(name, 0) + int(args[0].shape[0])
        seen.add(name)
    return seen, kernel_rows, max_error


def phase_linkage(recorder, first_designs):
    import numpy as np
    import torch

    from svim_tpu_torch.cluster import device_cluster
    from svim_tpu_torch.ops import linkage_kernel

    if not recorder.calls:
        raise AssertionError("the main path made no linkage op call")
    seen, kernel_rows, max_error = linkage_calls_against_plain(
        recorder.calls)
    # partitions resolved on the host at dispatch (telemetry pre_*) never
    # reach an op: the fused route's calls come from the tie-free workload
    log("linkage", "{0} main-path calls ({1}) agree with the CPU; not "
        "called: {2}; kernel equal to its plain version on the card bit for "
        "bit on every row of every call (rows: {3})".format(
            len(recorder.calls), ", ".join(sorted(seen)),
            ", ".join(sorted(set(LINKAGE_OPS) - seen)) or "none",
            json.dumps(kernel_rows)))
    missing = set(LINKAGE_OPS) - seen
    if missing:
        raise AssertionError("the main path never called {0}".format(
            sorted(missing)))

    rng = np.random.default_rng(20261017)
    threshold = 0.5
    accepted_rows = 0
    for name, args, kwargs in _synthetic_linkage(rng, torch.device("cuda")):
        op = getattr(linkage_kernel, name)
        where = "synthetic {0}, P={1}".format(name, args[0].shape[1])
        if name != "ins_matrices_from_pairs":
            _kernel_against_plain(name, _positional(args, kwargs), where)
        else:
            _ins_against_plain(args, where)
        got = _to_cpu(op(*args, **kwargs))
        args, kwargs = _to_cpu(args), _to_cpu(kwargs)
        want = op(*args, **kwargs)
        if name == "ins_matrices_from_pairs":
            cells = _off_diagonal(*got.shape[:2])
            if not _bit_equal(got[cells], want[cells]):
                raise AssertionError(where + ": the card's matrices differ "
                                     "from the CPU's off the diagonal")
            continue
        accepted, error = _same_linkage(got, want, where)
        max_error = max(max_error, error)
        if name != "agglomerate_batched":
            continue
        matrices, valid = args[0].numpy(), args[1].numpy()
        for row in np.flatnonzero(accepted.numpy()):
            count = int(valid[row].sum())
            labels = device_cluster.labels_from_merges(
                got[0][row].numpy(), got[1][row].numpy(),
                got[2][row].numpy(), count, threshold)
            if labels is None:
                continue
            expected = _host_labels(matrices[row], count, threshold)
            if not np.array_equal(labels, expected):
                raise AssertionError("{0}, row {1}: card labels differ from "
                                     "exact host linkage".format(where, row))
            accepted_rows += 1
    if accepted_rows == 0:
        raise AssertionError("no synthetic partition's card labeling passed "
                             "the float32 guard")
    log("linkage", "synthetic partitions agree with the CPU; {0} labelings "
        "from the card's merges pass the float32 guard and equal exact "
        "float64 host linkage; max height difference {1!r}".format(
            accepted_rows, max_error))

    for label, args, valid in ins_matrix_cases(
            np.random.default_rng(20261027)):
        where = "INS matrices, " + label
        got = _ins_against_plain(args, where, valid=valid).cpu()
        tensors = [torch.from_numpy(value) if isinstance(value, np.ndarray)
                   else float(value) for value in args]
        want = linkage_kernel.ins_matrices_from_pairs_plain(*tensors)
        cells = _off_diagonal(*got.shape[:2])
        if not _bit_equal(got[cells], want[cells]):
            raise AssertionError(where + ": the card's matrices differ from "
                                 "the CPU's off the diagonal")
        log("linkage", "{0}: B={1} P={2} Q={3}: kernel, plain version on the "
            "card and on the CPU bit-equal off the diagonal, agglomeration "
            "bit-equal".format(label, *args[0].shape, args[2].shape[0]))
    return ins_timings(recorder, first_designs["ins_matrices"])


def _distance_inputs(rng, batch, pad, wide=False):
    """Seeded (B, P) partitions: negative starts, zero and negative spans,
    repeated read ids, a ragged number of valid slots per partition; `wide`
    draws the coordinates from all of int32, so that sums and differences
    wrap and |Δ| reaches 2^31."""
    import numpy as np

    low, high, span = (-2**31, 2**31 - 1, 2**30) if wide \
        else (-5_000, 2_000_000, 5_000)
    starts = rng.integers(low, high, size=(batch, pad)).astype(np.int32)
    ends = (starts + rng.integers(-50, span, size=(batch, pad))).astype(
        np.int32)
    ends[:, ::7] = starts[:, ::7]
    reads = rng.integers(0, max(2, pad // 3), size=(batch, pad)).astype(
        np.int32)
    counts = rng.integers(1, pad + 1, size=batch)
    valid = np.arange(pad)[None, :] < counts[:, None]
    return starts, ends, reads, valid


def _parallel_case():
    """The inputs of tests/test_parallel.py's Pallas check: read ids % 60,
    the tail of partition 0 invalid."""
    import numpy as np

    rng = np.random.default_rng(11)
    starts = rng.integers(1000, 2000, size=(3, 128)).astype(np.int32)
    ends = starts + rng.integers(50, 500, size=(3, 128)).astype(np.int32)
    reads = np.tile(np.arange(128, dtype=np.int32) % 60, (3, 1))
    valid = np.ones((3, 128), bool)
    valid[0, 100:] = False
    return starts, ends, reads, valid


# instructions the card issues for one distance cell: 230 in the inner loop
# of the 16-byte-store kernel for its 8 cells, counted from its SASS by
# scripts/distance_kernel_sass.py (beside the differences, absolute values,
# conversions, maximum, sum, comparisons and selects, each IEEE division is
# a reciprocal estimate and three to five fused multiply-adds), and the
# card's issue rate: one instruction a lane and clock on 132 SMs x 128 lanes
# x 1.98 GHz, which is half its float32 rate (a fused multiply-add counts
# as two operations there)
DISTANCE_OPS_PER_CELL = 29
LANE_INSTRUCTIONS_PER_SECOND = FLOAT32_FLOPS_PER_SECOND / 2


def distance_bound_ms_of(batch, pad):
    """The least time the card could take for one (B, P) call: bytes (three
    int32 and one bool (B, P) inputs read once, the (B, P, P) float32 result
    written once) over the memory rate, or DISTANCE_OPS_PER_CELL
    instructions a cell over the issue rate.  Returns (ms, "bytes" or
    "operations")."""
    bytes_ms = (13 * batch * pad + 4 * batch * pad * pad) \
        / HBM_BYTES_PER_SECOND * 1e3
    ops_ms = DISTANCE_OPS_PER_CELL * batch * pad * pad \
        / LANE_INSTRUCTIONS_PER_SECOND * 1e3
    if ops_ms >= bytes_ms:
        return ops_ms, "operations"
    return bytes_ms, "bytes"


def distance_cases(rng):
    """((B, P), inputs, forced launch options) of phase 7.  The wrapper's own
    choice at P in {32, 128} and B in {8, 1024, 8192} and at the case of
    tests/test_parallel.py; P = 64 and 256; P = 30 and 101 (no 16-byte rows:
    scalar stores); P = 100 (a row group of 32 threads of which 25 hold
    columns); B = 1 and 133 (fewer partitions than CTAs the card holds:
    the rows of a partition cut into bands), B = 300 (bands and several
    work items a CTA) and B = 1057, 2113 and 8192 (several partitions a
    CTA through both staging buffers, a ragged last round); P = 6000 and
    5121 (too large to stage in shared memory); each forced path: scalar
    stores at P = 128 and 32, 16-byte stores asked for; then norms (`norm`,
    else 900) below and above the range [2^-40, 2^40] in which the kernel
    divides by its own written-out sequence, on its edges, next to them,
    negative, 1 and 3, each with every slot valid."""
    import numpy as np

    cases = [((batch, pad), {}) for pad in (32, 128)
             for batch in (8, 1024, 8192)]
    cases += [((batch, pad), {}) for batch, pad in (
        (1, 64), (133, 64), (1, 256), (133, 256), (1, 30), (133, 30),
        (7, 101), (9, 100), (1, 128), (133, 128), (1057, 128), (1, 32),
        (2, 600), (1057, 30), (2113, 64), (1, 6000), (2, 5121),
        (300, 256), (300, 30))]
    cases += [((64, 128), {"variant": "scalar"}),
              ((64, 32), {"variant": "scalar"}),
              ((64, 64), {"variant": "vector"}),
              ((64, 128), {"norm": 1e-13}), ((64, 30), {"norm": 1e13}),
              (DISTANCE_MAIN_SHAPE, {"variant": "scalar"})]
    built = [(shape, _distance_inputs(rng, *shape), forced)
             for shape, forced in cases]
    low, high = np.float32(2.0 ** -40), np.float32(2.0 ** 40)
    norms = [1.0, 3.0, -900.0, float(low), float(high), -float(low),
             -float(high)]
    norms += [float(np.nextafter(edge, toward)) for edge, toward in (
        (low, np.float32(0)), (low, np.float32(1)), (high, np.float32(1)),
        (high, np.float32(np.inf)))]
    for index, norm in enumerate(norms):
        shape = ((64, 128), (64, 30))[index % 2]
        starts, ends, reads, valid = _distance_inputs(rng, *shape,
                                                      wide=True)
        built.append((shape, (starts, ends, reads, np.ones_like(valid)),
                      {"norm": norm, "every_slot": "valid"}))
    # the timed shape once more with every slot valid: the other inputs
    # have a ragged number of valid slots, and an invalid row is stored
    # without being computed
    starts, ends, reads, valid = _distance_inputs(rng, *DISTANCE_MAIN_SHAPE)
    built.append((DISTANCE_MAIN_SHAPE, (starts, ends, reads,
                                        np.ones_like(valid)),
                  {"every_slot": "valid"}))
    built.insert(6, ((3, 128), _parallel_case(), {}))
    return built


# the shapes and forced paths that tests/test_torch_distance.py's card test
# crosses with every norm of _distance_norms()
DISTANCE_CROSS_SHAPES = (
    (1, 30, None), (133, 30, None), (133, 64, None), (3, 256, None),
    (64, 128, "scalar"), (64, 64, "vector"), (1057, 30, None),
    (2113, 64, None), (1, 6000, None), (2, 5121, None), (300, 256, None))


def _distance_norms():
    """900, norms below and above the range [2^-40, 2^40] in which the
    kernel divides by its own written-out sequence, 1, 3, a negative one,
    the edges of the range, their negatives and their neighbours."""
    import numpy as np

    low, high = np.float32(2.0 ** -40), np.float32(2.0 ** 40)
    return [900.0, 1e-13, 1e13, 1.0, 3.0, -900.0, float(low), float(high),
            -float(low), -float(high)] + [
        float(np.nextafter(edge, toward)) for edge, toward in (
            (low, np.float32(0)), (low, np.float32(1)),
            (high, np.float32(1)), (high, np.float32(np.inf)))]


def _distance_cross(rng):
    """The card tests of tests/test_torch_distance.py that phase 7's list
    does not hold (that file cannot run where there is no jax): through the
    dispatcher, one launch a call, at (8, 32), (1024, 128) and (5, 200) with
    coordinates from all of int32, with and without the wall; and every
    shape of DISTANCE_CROSS_SHAPES with every norm, once with a ragged
    number of valid slots (one partition with none) and once with every
    slot valid.  One call each, untimed.  Returns the number of
    comparisons."""
    import numpy as np
    import torch

    from svim_tpu_torch.ops import distance_kernel as dk

    def compare(got, want, where):
        if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
            raise AssertionError("distance kernel != plain, " + where)

    compared = 0
    for batch, pad in ((8, 32), (1024, 128), (5, 200)):
        tensors = [torch.from_numpy(x).cuda()
                   for x in _distance_inputs(rng, batch, pad, wide=True)]
        for wall in (True, False):
            before = dk.LAUNCHES
            got = dk.span_position_matrix(*tensors, 900.0,
                                          wall_same_read=wall)
            if dk.LAUNCHES != before + 1:
                raise AssertionError("span_position_matrix on CUDA tensors "
                                     "launched no kernel")
            compare(got, dk.span_position_matrix_torch(
                *tensors, 900.0, wall_same_read=wall),
                "dispatcher B={0} P={1} wall={2}".format(batch, pad, wall))
            compared += 1
    for batch, pad, variant in DISTANCE_CROSS_SHAPES:
        starts, ends, reads, valid = _distance_inputs(rng, batch, pad,
                                                      wide=True)
        valid[batch // 2] = False
        for slots in (valid, np.ones_like(valid)):
            tensors = [torch.from_numpy(x).cuda()
                       for x in (starts, ends, reads, slots)]
            for norm in _distance_norms():
                compare(dk.span_position_matrix_cuda(*tensors, norm,
                                                     variant=variant),
                        dk.span_position_matrix_torch(*tensors, norm),
                        "B={0} P={1} variant={2} norm={3!r} every slot "
                        "valid={4}".format(batch, pad, variant, norm,
                                           bool(slots.all())))
                compared += 1
    torch.cuda.synchronize()
    return compared


def phase_distance():
    """Phase 7: the distance kernel against its plain version, bit for
    bit.  Returns
    {(B, P, wall): (kernel ms, plain ms)} of the unforced cases and the max
    abs error."""
    import numpy as np
    import torch

    from svim_tpu_torch.ops import distance_kernel as dk

    rng = np.random.default_rng(20261018)
    timings = {}
    max_abs_err = 0.0
    for (batch, pad), arrays, forced in distance_cases(rng):
        tensors = [torch.from_numpy(x).cuda() for x in arrays]
        options = dict(forced)
        norm = options.pop("norm", 900.0)
        options.pop("every_slot", None)
        for wall in (True, False):
            plain_ms, plain = _time_ms(
                lambda: dk.span_position_matrix_torch(*tensors, norm,
                                                      wall_same_read=wall), 5)
            kernel_ms, kernel = _time_ms(
                lambda: dk.span_position_matrix_cuda(
                    *tensors, norm, wall_same_read=wall, **options), 20)
            differ = int((plain.view(torch.int32)
                          != kernel.view(torch.int32)).sum())
            if differ:
                raise AssertionError("distance kernel != plain at B={0} P={1}"
                                     " wall={2} {3}: {4} entries differ"
                                     .format(batch, pad, wall, forced,
                                             differ))
            max_abs_err = max(max_abs_err,
                              float((plain - kernel).abs().max()))
            if not forced:
                timings[(batch, pad, wall)] = (kernel_ms, plain_ms)
            log("distance", "B={0} P={1} wall={2}{3}: bit-equal ({4} entries "
                "below BIG); kernel {5:.4f} ms, plain {6:.4f} ms".format(
                    batch, pad, wall,
                    " forced " + json.dumps(forced) if forced else "",
                    int((kernel < dk.BIG).sum()), kernel_ms, plain_ms))
    started = time.perf_counter()
    compared = _distance_cross(rng)
    log("distance", "{0} more comparisons bit-equal in {1:.1f}s: the "
        "dispatcher with coordinates from all of int32, and {2} shapes and "
        "forced paths x {3} norms x ragged and full validity".format(
            compared, time.perf_counter() - started,
            len(DISTANCE_CROSS_SHAPES), len(_distance_norms())))
    return timings, max_abs_err


def phase_streaming(card, bench_bam, genome, golden_bam, golden_genome):
    """Phase 8: the level-0 bench BAM through streaming COLLECT, and the
    golden workload under --stream_input."""
    from svim_tpu_torch import workloads
    from svim_tpu_torch.collect.packed import STREAMING_THRESHOLD_BYTES
    from svim_tpu_torch.io import bamstream

    directory = os.path.dirname(bench_bam)
    stored = os.path.join(directory, "bench_stored.bam")
    started = time.perf_counter()
    workloads.reblock_stored(bench_bam, stored)
    size = os.path.getsize(stored)
    log("stream", "rewrote the bench BAM as level-0 BGZF in {0:.1f}s ({1} "
        "bytes)".format(time.perf_counter() - started, size))
    if size <= STREAMING_THRESHOLD_BYTES:
        raise AssertionError("the level-0 bench BAM is not over the "
                             "streaming threshold")
    working_dir = os.path.join(directory, "wd_stream")
    bamstream.BATCHES = 0
    started = time.perf_counter()
    launches = _drive("stream_bench", ["alignment", working_dir, stored,
                                       genome, "--edit_backend", "wavefront",
                                       "--profile", "--incremental_cluster",
                                       "off"])
    wall = time.perf_counter() - started
    batches = bamstream.BATCHES
    seconds = _stage_seconds(working_dir)
    telemetry = _telemetry()
    log("stream", "level-0 bench BAM: {0} streamed batches; wall {1:.2f}s; "
        "stages {2}; telemetry {3}; wavefront launches {4}; {5:.1f} reads/s "
        "through COLLECT+CLUSTER on {6}".format(
            batches, wall, json.dumps(seconds), json.dumps(telemetry),
            launches, BENCH_READS / (seconds["collect"] + seconds["cluster"]),
            card))
    if batches <= 0:
        raise AssertionError("the level-0 bench BAM did not stream")
    if launches <= 0:
        raise AssertionError("the streaming slice launched no wavefront "
                             "kernel")
    if telemetry != BENCH_TELEMETRY["wavefront"]:
        raise AssertionError("streaming slice telemetry {0} != svim_tpu's "
                             "{1}".format(telemetry,
                                          BENCH_TELEMETRY["wavefront"]))
    digest = _vcf_sha256(working_dir)
    if digest != BENCH_VCF_SHA256:
        raise AssertionError("streaming slice: variants.vcf (sha256 {0}) "
                             "differs from svim_tpu's".format(digest))

    working_dir = os.path.join(os.path.dirname(golden_bam), "wd_stream")
    bamstream.BATCHES = 0
    launches = _drive("stream_golden", ["alignment", working_dir, golden_bam,
                                        golden_genome, "--stream_input",
                                        "--batch_reads", "64",
                                        "--edit_backend", "wavefront",
                                        "--incremental_cluster", "off"])
    if bamstream.BATCHES <= 1 or launches <= 0:
        raise AssertionError("golden --stream_input: {0} batches, {1} "
                             "wavefront launches".format(bamstream.BATCHES,
                                                         launches))
    if _normalized_vcf(os.path.join(working_dir, "variants.vcf")) \
            != _normalized_vcf(GOLDEN):
        raise AssertionError("golden --stream_input: variants.vcf differs "
                             "from tests/golden/variants.golden.vcf")
    log("stream", "VCF hashes to svim_tpu's; golden --stream_input "
        "(--batch_reads 64, {0} batches) writes the golden VCF".format(
            bamstream.BATCHES))


def phase_inputs(golden_bam, golden_genome):
    """Phase 9: the golden workload as SAM text and as a queryname-sorted
    BAM."""
    from svim_tpu_torch import workloads

    directory = os.path.dirname(golden_bam)
    for path, writer, name, expected in (
            ("sam_text", workloads.sam_text, "reads.sam", SAM_VCF_SHA256),
            ("queryname", workloads.queryname_bam, "reads.qname.bam",
             QUERYNAME_VCF_SHA256)):
        source = writer(golden_bam, os.path.join(directory, name))
        working_dir = os.path.join(directory, "wd_" + path)
        launches = _drive(path, ["alignment", working_dir, source,
                                 golden_genome, "--edit_backend",
                                 "wavefront", "--incremental_cluster",
                                 "off"])
        digest = _vcf_sha256(working_dir)
        if digest != expected:
            raise AssertionError("{0}: variants.vcf (sha256 {1}) differs from "
                                 "svim_tpu's".format(path, digest))
        if launches <= 0:
            raise AssertionError("{0} launched no wavefront kernel".format(
                path))
        log("inputs", "{0}: variants.vcf hashes to svim_tpu's; wavefront "
            "launches {1}".format(path, launches))


def _reused(working_dir):
    """(partitions reused at CLUSTER, partitions clustered mid-scan) from
    the run's SVIM_*.log; (0, 0) when the run logged no reuse."""
    logs = sorted(name for name in os.listdir(working_dir)
                  if name.startswith("SVIM_") and name.endswith(".log"))
    with open(os.path.join(working_dir, logs[-1])) as handle:
        for line in handle:
            if "Incremental clustering: " in line:
                words = line.split("Incremental clustering: ", 1)[1].split()
                return int(words[0]), int(words[2])
    return 0, 0


def phase_default_path(card, bench_bam, genome, off_seconds, golden_bam,
                       golden_genome, recorder):
    """Phase 10: --incremental_cluster auto (the default) on the bench and
    golden workloads; the agglomeration calls of the chunked `wavefront`
    run go to `recorder`."""
    import contextlib

    directory = os.path.dirname(bench_bam)
    for backend in ("wavefront", "auto"):
        for chunk in (512, 0):
            path = "incremental_{0}{1}".format(backend,
                                               "_chunked" if chunk else "")
            working_dir = os.path.join(directory, "wd_" + path)
            recorder.label = path
            with recorder if path == RECORDED_MIDSCAN_PATH \
                    else contextlib.nullcontext():
                launches = _drive(path, ["alignment", working_dir, bench_bam,
                                         genome, "--edit_backend", backend,
                                         "--profile", "--incremental_cluster",
                                         "auto", "--batch_reads", "512"],
                                  chunk=chunk)
            seconds = _stage_seconds(working_dir)
            reused, memoized = _reused(working_dir)
            digest = _vcf_sha256(working_dir)
            log("default", "bench {0}, --incremental_cluster auto "
                "--batch_reads 512, {1}: {2} of {3} mid-scan partitions "
                "reused; collect {4!r} s, cluster {5!r} s (off: {6!r}, {7!r});"
                " wavefront launches {8}; {9:.1f} reads/s through "
                "COLLECT+CLUSTER on {10}".format(
                    backend,
                    "scan in chunks of 512" if chunk else "scan as it comes",
                    reused, memoized, seconds["collect"], seconds["cluster"],
                    off_seconds[backend]["collect"],
                    off_seconds[backend]["cluster"], launches,
                    BENCH_READS / (seconds["collect"] + seconds["cluster"]),
                    card))
            if digest != BENCH_VCF_SHA256:
                raise AssertionError("{0}: variants.vcf (sha256 {1}) differs "
                                     "from svim_tpu's".format(path, digest))
            if chunk and reused <= 0:
                raise AssertionError("{0}: no mid-scan partition was reused"
                                     .format(path))
            if backend == "wavefront" and launches <= 0:
                raise AssertionError("{0} launched no wavefront kernel"
                                     .format(path))
    working_dir = os.path.join(os.path.dirname(golden_bam), "wd_incremental")
    launches = _drive("incremental_golden",
                      ["alignment", working_dir, golden_bam, golden_genome,
                       "--edit_backend", "wavefront", "--batch_reads", "64"],
                      chunk=64)
    reused, memoized = _reused(working_dir)
    if _normalized_vcf(os.path.join(working_dir, "variants.vcf")) \
            != _normalized_vcf(GOLDEN):
        raise AssertionError("golden, incremental: variants.vcf differs from "
                             "tests/golden/variants.golden.vcf")
    if reused <= 0 or launches <= 0:
        raise AssertionError("golden, incremental: {0} partitions reused, {1}"
                             " wavefront launches".format(reused, launches))
    log("default", "golden, default --incremental_cluster, scan in chunks of "
        "64: golden VCF; {0} of {1} mid-scan partitions reused; wavefront "
        "launches {2}".format(reused, memoized, launches))


def phase_flags(golden_bam, golden_genome):
    """Phase 11: --device_backend host and --profile_trace on the golden
    workload."""
    directory = os.path.dirname(golden_bam)
    working_dir = os.path.join(directory, "wd_host")
    _drive("host", ["alignment", working_dir, golden_bam, golden_genome,
                    "--device_backend", "host"])
    if _normalized_vcf(os.path.join(working_dir, "variants.vcf")) \
            != _normalized_vcf(GOLDEN):
        raise AssertionError("--device_backend host: variants.vcf differs "
                             "from tests/golden/variants.golden.vcf")
    # COMBINE's consensus aligns on the card under every backend but cpu
    if any(count for name, count in PATH_LAUNCHES["host"].items()
           if name != "gotoh_align"):
        raise AssertionError("--device_backend host launched a kernel: {0}"
                             .format(PATH_LAUNCHES["host"]))
    log("flags", "--device_backend host: golden VCF, no kernel launch but "
        "the consensus aligner's")

    working_dir = os.path.join(directory, "wd_trace")
    launches = _drive("profile_trace",
                      ["alignment", working_dir, golden_bam, golden_genome,
                       "--edit_backend", "wavefront", "--profile_trace"])
    if _normalized_vcf(os.path.join(working_dir, "variants.vcf")) \
            != _normalized_vcf(GOLDEN):
        raise AssertionError("--profile_trace: variants.vcf differs from "
                             "tests/golden/variants.golden.vcf")
    kernels = {}
    for stage in ("collect", "cluster"):
        trace_path = os.path.join(working_dir, "traces", stage + ".json")
        with open(trace_path) as handle:
            events = json.load(handle)["traceEvents"]
        if not events:
            raise AssertionError("--profile_trace: {0} is empty".format(
                trace_path))
        kernels[stage] = sorted({event["name"] for event in events
                                 if event.get("cat") == "kernel"})
        log("flags", "--profile_trace: traces/{0}.json, {1} bytes, {2} events"
            ", {3} CUDA kernels by name".format(
                stage, os.path.getsize(trace_path), len(events),
                len(kernels[stage])))
    if not any("wavefront" in name for name in kernels["cluster"]):
        raise AssertionError("--profile_trace: the CLUSTER trace names no "
                             "wavefront kernel among {0} (launches {1})"
                             .format(kernels["cluster"][:10], launches))
    if not kernels["collect"]:
        raise AssertionError("--profile_trace: the COLLECT trace names no "
                             "CUDA kernel")


def _non_help_calls(log_path):
    with open(log_path) as handle:
        return [line for line in handle if "--help" not in line]


def phase_reads(golden_bam, golden_genome):
    """Phase 12: `reads` mode over stub aligners on the golden records."""
    from svim_tpu_torch import workloads

    directory = os.path.join(os.path.dirname(golden_bam), "reads_mode")
    os.makedirs(directory, exist_ok=True)
    sam = workloads.sam_text(golden_bam, os.path.join(directory,
                                                      "aligned.sam"))
    fastq = os.path.join(directory, "sample.fastq")
    with open(fastq, "w") as handle:
        handle.write("@read0\nACGT\n+\n!!!!\n")
    working_dir = os.path.join(directory, "wd")
    cached = os.path.join(working_dir, "sample.ngmlr.coordsorted.bam")
    for stale in (cached, cached + ".bai"):
        if os.path.exists(stale):
            os.remove(stale)
    arguments = ["reads", working_dir, fastq, golden_genome,
                 "--edit_backend", "wavefront", "--incremental_cluster", "off"]
    with workloads.stub_aligners(directory, sam) as stub_log:
        launches = _drive("reads", arguments)
        calls = _non_help_calls(stub_log)
        for wanted in ("ngmlr", "samtools view", "samtools sort",
                       "samtools index"):
            if not any(call.startswith(wanted) for call in calls):
                raise AssertionError("reads mode: no {0!r} stub call among "
                                     "{1}".format(wanted, calls))
        if _normalized_vcf(os.path.join(working_dir, "variants.vcf")) \
                != _normalized_vcf(GOLDEN):
            raise AssertionError("reads mode: variants.vcf differs from "
                                 "tests/golden/variants.golden.vcf")
        golden_launches = PATH_LAUNCHES["golden"]["wavefront_banded_distance"]
        if launches != golden_launches or launches <= 0:
            raise AssertionError("reads mode: {0} wavefront launches, the "
                                 "golden slice {1}".format(launches,
                                                           golden_launches))
        again = _drive("reads_cached", arguments)
        if len(_non_help_calls(stub_log)) != len(calls):
            raise AssertionError("reads mode: the second run called a stub "
                                 "again instead of re-using " + cached)
        if _normalized_vcf(os.path.join(working_dir, "variants.vcf")) \
                != _normalized_vcf(GOLDEN) or again != launches:
            raise AssertionError("reads mode, cached BAM: other output")
    log("reads", "stub aligners ({0} calls), golden VCF, wavefront launches "
        "{1} (as the golden slice); the second run re-used the cached BAM "
        "with no stub call".format(len(calls), launches))


# a rank of phase 13: the port's CLI, then what its interpreter holds
_RANK_SCRIPT = """
import json, sys
sys.path.insert(0, {root!r})
from svim_tpu_torch.cli import main
code = main(sys.argv[1:])
print("LOADED " + json.dumps(sorted(
    name for name in sys.modules
    if name.split(".")[0] in ("jax", "jaxlib", "svim_tpu"))))
sys.exit(code)
"""
RANK_TIMEOUT = 300   # seconds, each rank subprocess


def _free_port():
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _rank_log_values(working_dir, rank):
    """What rank `rank` wrote to its SVIM_*.p<rank>.log: the DEVICE line and
    the JSON lines --profile logs."""
    logs = sorted(name for name in os.listdir(working_dir)
                  if name.endswith(".p{0}.log".format(rank)))
    values = {}
    markers = {"DEVICE: ": "device", "Stage seconds: ": "seconds",
               "Kernel launches: ": "launches",
               "Cluster telemetry: ": "telemetry",
               "Exchange totals: ": "exchange",
               "Distributed collect phases: ": "phases"}
    with open(os.path.join(working_dir, logs[-1])) as handle:
        for line in handle:
            for marker, key in markers.items():
                if marker in line:
                    text = line.split(marker, 1)[1].strip()
                    values[key] = text if key in ("device", "phases") \
                        else json.loads(text)
    missing = sorted(set(markers.values()) - set(values))
    if missing:
        raise AssertionError("rank {0} of {1} logged no {2}".format(
            rank, working_dir, missing))
    return values


def _run_ranks(path, world, working_dir, bam, genome):
    """One --distributed run of `world` rank subprocesses on the one card.
    Returns the per-rank log values; PATH_LAUNCHES[path] gets the launches
    summed over the ranks (each rank counted from 0 in its own process)."""
    import shutil

    if os.path.isdir(working_dir):
        shutil.rmtree(working_dir)
    coordinator = "127.0.0.1:{0}".format(_free_port())
    procs = []
    outputs = []
    try:
        for rank in range(world):
            env = dict(os.environ, SVIM_COORDINATOR=coordinator,
                       SVIM_NUM_PROCESSES=str(world),
                       SVIM_PROCESS_ID=str(rank), GLOO_SOCKET_IFNAME="lo")
            env.pop("SVIM_TORCH_DEVICE", None)
            console = open("{0}.rank{1}.console.log".format(working_dir,
                                                             rank), "w")
            procs.append((subprocess.Popen(
                [sys.executable, "-c", _RANK_SCRIPT.format(root=ROOT),
                 "alignment", working_dir, bam, genome, "--distributed",
                 "--edit_backend", "wavefront", "--profile"],
                env=env, stdout=console, stderr=subprocess.STDOUT),
                console))
        for proc, _console in procs:
            proc.wait(timeout=RANK_TIMEOUT)
    finally:
        for proc, console in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            console.close()
            with open(console.name) as handle:
                outputs.append(handle.read())
    failed = [rank for rank, (proc, _console) in enumerate(procs)
              if proc.returncode != 0]
    if failed:
        for rank, output in enumerate(outputs):
            sys.stderr.write("--- {0}, rank {1} (exit {2}) ---\n{3}\n".format(
                path, rank, procs[rank][0].returncode, output[-3000:]))
        raise RuntimeError("{0}: ranks {1} failed".format(path, failed))
    ranks = []
    for rank, output in enumerate(outputs):
        loaded = [line for line in output.splitlines()
                  if line.startswith("LOADED ")]
        if loaded != ["LOADED []"]:
            raise AssertionError("{0}, rank {1} holds {2}".format(
                path, rank, loaded))
        values = _rank_log_values(working_dir, rank)
        if not values["device"].startswith("cuda"):
            raise AssertionError("{0}, rank {1} ran on {2}".format(
                path, rank, values["device"]))
        if values["launches"]["wavefront_banded_distance"] <= 0:
            raise AssertionError("{0}, rank {1} launched no wavefront "
                                 "kernel".format(path, rank))
        ranks.append(values)
    PATH_LAUNCHES[path] = {
        name: sum(values["launches"][name] for values in ranks)
        for name in KERNEL_COUNTERS}
    return ranks


def phase_distributed(card, bench_bam, bench_genome, off_seconds, golden_bam,
                      golden_genome):
    """Phase 13: --distributed as rank subprocesses on the one card."""
    runs = [("distributed_bench_w2", 2, bench_bam, bench_genome,
             BENCH_VCF_SHA256, sum(BENCH_TELEMETRY["wavefront"].values())),
            ("distributed_bench_w3", 3, bench_bam, bench_genome,
             BENCH_VCF_SHA256, sum(BENCH_TELEMETRY["wavefront"].values())),
            ("distributed_golden_w2", 2, golden_bam, golden_genome,
             SAM_VCF_SHA256, sum(GOLDEN_TELEMETRY.values()))]
    for path, world, bam, genome, expected, eligible in runs:
        working_dir = os.path.join(os.path.dirname(bam), "wd_" + path)
        started = time.perf_counter()
        ranks = _run_ranks(path, world, working_dir, bam, genome)
        wall = time.perf_counter() - started
        digest = _vcf_sha256(working_dir)
        if digest != expected:
            raise AssertionError("{0}: variants.vcf (sha256 {1}) differs "
                                 "from the pinned one".format(path, digest))
        counted = [values["telemetry"]["eligible"] for values in ranks]
        if sum(counted) != eligible:
            raise AssertionError("{0}: the ranks resolved {1} eligible "
                                 "partitions, one process {2}".format(
                                     path, counted, eligible))
        received = {values["exchange"]["received"] for values in ranks}
        if len(received) != 1 or received.pop() != sum(
                values["exchange"]["sent"] for values in ranks):
            raise AssertionError("{0}: exchange bytes do not add up: {1}"
                                 .format(path, [values["exchange"]
                                                for values in ranks]))
        for rank, values in enumerate(ranks):
            log("distributed", "{0} rank {1}/{2} on {3}: stages {4}; {5}; "
                "exchange {6}; wavefront launches {7}; eligible partitions "
                "{8}".format(path, rank, world, values["device"],
                             json.dumps(values["seconds"]), values["phases"],
                             json.dumps(values["exchange"]),
                             values["launches"]["wavefront_banded_distance"],
                             values["telemetry"]["eligible"]))
        log("distributed", "{0}: {1} ranks sharing {2}, wall {3:.2f}s with "
            "start-up; VCF hashes to the pinned one; eligible partitions {4} "
            "sum to {5}{6}".format(
                path, world, card, wall, counted, eligible,
                "; one process (phase 5, off): collect {0!r} s, cluster {1!r} "
                "s".format(off_seconds["wavefront"]["collect"],
                           off_seconds["wavefront"]["cluster"])
                if "bench" in path else ""))


class ShardedCallRecorder:
    """While active, keeps the inputs and outputs of every row-sharded
    COLLECT scan and every GENOTYPE join the main path runs."""

    def __init__(self):
        from svim_tpu_torch.ops import genotype_kernel
        from svim_tpu_torch.parallel import mesh

        self.mesh = mesh
        self.genotype_kernel = genotype_kernel
        self.scans = []
        self.joins = []

    def __enter__(self):
        self.scan = self.mesh.collect_scan_sharded
        self.join = self.genotype_kernel.genotype_ref_support_device

        def scan(num_shards, device, cigar_words, ref_start, min_sv_size,
                 max_events):
            outputs = self.scan(num_shards, device, cigar_words, ref_start,
                                min_sv_size, max_events)
            self.scans.append((num_shards, device, cigar_words, ref_start,
                               min_sv_size, max_events, outputs))
            return outputs

        def join(jobs, per_tid, device, num_shards=1):
            counts = self.join(jobs, per_tid, device, num_shards)
            self.joins.append((jobs, per_tid, device, num_shards, counts))
            return counts

        self.mesh.collect_scan_sharded = scan
        self.genotype_kernel.genotype_ref_support_device = join
        return self

    def __exit__(self, *exc):
        self.mesh.collect_scan_sharded = self.scan
        self.genotype_kernel.genotype_ref_support_device = self.join


def _sharded_op(op, shards, device, args, kwargs):
    """`op` over `shards` blocks of its tensor arguments' leading axis
    (other arguments pass to every shard), outputs gathered on `device`."""
    import torch

    from svim_tpu_torch.parallel import mesh

    names = sorted(kwargs)
    values = list(args) + [kwargs[name] for name in names]
    cut = [index for index, value in enumerate(values)
           if isinstance(value, torch.Tensor)]
    outputs = []
    for block in mesh.shard_batch(shards, device, *(values[i] for i in cut)):
        local = list(values)
        for index, tensor in zip(cut, block):
            local[index] = tensor
        outputs.append(op(*local[:len(args)],
                          **dict(zip(names, local[len(args):]))))
    return mesh.gather_shards(outputs, device)


def phase_shards(bench_bam, bench_genome):
    """Phase 14: --num_shards 8 on the bench workload."""
    import numpy as np
    import torch

    from svim_tpu_torch import entry
    from svim_tpu_torch.ops import genotype_kernel, linkage_kernel
    from svim_tpu_torch.parallel import mesh

    shards = 8
    working_dir = os.path.join(os.path.dirname(bench_bam), "wd_num_shards")
    with ShardedCallRecorder() as recorder:
        launches = _drive("num_shards", [
            "alignment", working_dir, bench_bam, bench_genome, "--num_shards",
            str(shards), "--edit_backend", "wavefront",
            "--incremental_cluster", "off"])
    digest = _vcf_sha256(working_dir)
    if digest != BENCH_VCF_SHA256:
        raise AssertionError("--num_shards {0}: variants.vcf (sha256 {1}) "
                             "differs from svim_tpu's".format(shards, digest))
    if launches <= 0:
        raise AssertionError("--num_shards launched no wavefront kernel")
    logs = sorted(name for name in os.listdir(working_dir)
                  if name.startswith("SVIM_") and name.endswith(".log"))
    with open(os.path.join(working_dir, logs[-1])) as handle:
        layout = "{0} shards over {1} device(s)".format(
            shards, min(shards, torch.cuda.device_count()))
        if layout not in handle.read():
            raise AssertionError("--num_shards: no {0!r} in the log".format(
                layout))

    cut_scans = 0
    for (num_shards, device, words, ref_start, min_sv_size, max_events,
         got) in recorder.scans:
        if device.type != "cuda" or num_shards != shards:
            raise AssertionError("a COLLECT scan ran on {0} over {1} shards"
                                 .format(device, num_shards))
        want = mesh.collect_scan_sharded(1, device, words, ref_start,
                                         min_sv_size, max_events)
        if len(got) != len(want) or not all(
                a.dtype == b.dtype and torch.equal(a.cpu(), b.cpu())
                for a, b in zip(got, want)):
            raise AssertionError("row-sharded COLLECT scan differs from the "
                                 "unsharded one at {0} rows".format(
                                     words.shape[0]))
        cut_scans += words.shape[0] % shards == 0
    if not cut_scans:
        raise AssertionError("no COLLECT scan of the run was cut into shards")

    cut_joins = 0
    original = genotype_kernel.shard_batch
    blocks = []

    def counted(*args):
        result = original(*args)
        blocks.append(len(result))
        return result

    genotype_kernel.shard_batch = counted
    try:
        for jobs, per_tid, device, num_shards, got in recorder.joins:
            if got != genotype_kernel.genotype_ref_support_device(
                    jobs, per_tid, device, 1):
                raise AssertionError("sharded GENOTYPE join differs from the "
                                     "unsharded one at {0} jobs".format(
                                         len(jobs)))
            # a prefix of the jobs whose candidate axis divides: one of 8
            # consecutive lengths does
            for count in range(len(jobs), max(len(jobs) - shards, 0), -1):
                del blocks[:]
                sharded = genotype_kernel.genotype_ref_support_device(
                    jobs[:count], per_tid, device, shards)
                if blocks == [shards]:
                    if sharded != genotype_kernel.genotype_ref_support_device(
                            jobs[:count], per_tid, device, 1):
                        raise AssertionError("GENOTYPE join cut into {0} "
                                             "differs at {1} jobs".format(
                                                 shards, count))
                    cut_joins += 1
                    break
    finally:
        genotype_kernel.shard_batch = original
    if not recorder.joins or not cut_joins:
        raise AssertionError("no GENOTYPE join was cut into shards ({0} "
                             "joins recorded)".format(len(recorder.joins)))

    # the CLUSTER batcher's two agglomeration ops: on this workload every
    # coordinate partition is resolved at dispatch (telemetry pre_tie), so
    # its flushes are empty; seeded partitions stand in
    device = torch.device("cuda")
    rng = np.random.default_rng(20261019)
    checked = []
    for name, args, kwargs in _synthetic_linkage(rng, device):
        if name == "ins_matrices_from_pairs":
            continue
        op = getattr(linkage_kernel, name)
        want = op(*args, **kwargs)
        got = _sharded_op(op, shards, device, args, kwargs)
        if not all(a.dtype == b.dtype and torch.equal(a, b)
                   for a, b in zip(got, want)):
            raise AssertionError("{0} cut into {1} shards differs from the "
                                 "whole batch at P={2}".format(
                                     name, shards, args[0].shape[1]))
        checked.append("{0} P={1}".format(name, args[0].shape[1]))

    function, arguments = entry.entry()
    outputs = function(*arguments)
    torch.cuda.synchronize()
    if any(value.device.type != "cuda" for value in arguments) \
            or int((outputs[5] >= 0).sum()) != min(int(outputs[10]),
                                                  len(outputs[5])) \
            or int(outputs[10]) <= 0:
        raise AssertionError("entry.entry() did not run on the card")
    entry.dryrun_multichip(shards)
    log("shards", "--num_shards {0}: VCF hashes to svim_tpu's; {1!r}; "
        "wavefront launches {2}; {3} COLLECT scans ({4} cut into shards) and "
        "{5} GENOTYPE joins ({6} prefixes cut into shards) equal their "
        "unsharded runs; {7} equal whole-batch runs; entry() found {8} "
        "events on the card; dryrun_multichip({0}) passed".format(
            shards, layout, launches, len(recorder.scans), cut_scans,
            len(recorder.joins), cut_joins, ", ".join(checked),
            int(outputs[10])))


# the two COLLECT ops as the main path calls them: (kernel name, module,
# attribute); parallel/mesh.py calls ops.cigar_kernel.collect_scan by its own
# name, collect/packed.py looks classify_groups_fused up at each call
COLLECT_OPS = (("collect_scan", "svim_tpu_torch.parallel.mesh",
                "collect_scan"),
               ("classify_segments", "svim_tpu_torch.ops.segments_kernel",
                "classify_groups_fused"))
# each kernel's ops module, wrapper, plain version, source and the TPU
# program it replaces
COLLECT_FUNCTIONS = {
    "collect_scan": ("cigar_kernel", "collect_scan_cuda",
                     "collect_scan_plain",
                     "svim_tpu_torch/csrc/collect_scan.cu",
                     "svim_tpu/ops/cigar_kernel.py:137"),
    "classify_segments": ("segments_kernel", "classify_groups_fused_cuda",
                          "classify_groups_fused_plain",
                          "svim_tpu_torch/csrc/classify_segments.cu",
                          "svim_tpu/ops/segments_kernel.py:43")}
# the phases whose COLLECT calls phase 15 checks again
COLLECT_RECORDED = ("golden", "bench", "tiefree", "streaming", "inputs",
                    "shards")
# what DeviceOpRecorder records: the COLLECT ops and GENOTYPE's join, as
# the dispatcher (kernel level) and as the host entry point (the jobs)
RECORDED_OPS = COLLECT_OPS + (
    ("genotype_support", "svim_tpu_torch.ops.genotype_kernel",
     "genotype_support_batched"),
    ("genotype_jobs", "svim_tpu_torch.ops.genotype_kernel",
     "genotype_ref_support_device"))


def _clone(value):
    import torch

    if isinstance(value, torch.Tensor):
        return value.clone()
    if isinstance(value, (tuple, list)):
        return type(value)(_clone(item) for item in value)
    if isinstance(value, dict):
        return {key: _clone(item) for key, item in value.items()}
    return value


class DeviceOpRecorder:
    """While `recording(label)` is active, keeps a copy of the inputs and
    outputs of every call the main path makes to the RECORDED_OPS (or to
    the `ops` given), filed under `label`.  The copies are clones on the inputs' device, so
    recording waits for nothing and the path runs as it would."""

    def __init__(self):
        self.calls = []   # (label, kernel name, args, kwargs, outputs)

    def recording(self, label, ops=RECORDED_OPS):
        import contextlib
        import importlib

        @contextlib.contextmanager
        def active():
            patched = []
            for kernel, module_name, attribute in ops:
                module = importlib.import_module(module_name)
                original = getattr(module, attribute)

                def recorded(*args, _original=original, _kernel=kernel,
                             **kwargs):
                    outputs = _original(*args, **kwargs)
                    self.calls.append((label, _kernel, _clone(args),
                                       _clone(kwargs), _clone(outputs)))
                    return outputs
                setattr(module, attribute, recorded)
                patched.append((module, attribute, original))
            try:
                yield self
            finally:
                for module, attribute, original in patched:
                    setattr(module, attribute, original)
        return active()


def _rows_of_ops(k, op_lists):
    """(len(op_lists), k) int32 BAM words from explicit (op, length) lists,
    each cut to k ops and padded with 0."""
    import numpy as np

    words = np.zeros((len(op_lists), k), dtype=np.int32)
    for row, ops in enumerate(op_lists):
        for col, (op, length) in enumerate(ops[:k]):
            words[row, col] = (length << 4) | op
    return words


# rows the seeded COLLECT cases start with: only clips, leading and
# trailing soft and hard clips, clips inside, zero-length ops (clip-like),
# ops 3, 9 and 10, all zero-length, and runs of clips across the 32-op
# chunks of the kernel's warps
CLIP_ROWS = (
    [(5, 10), (4, 20), (4, 0), (5, 0)],
    [(5, 30), (4, 40), (0, 100), (2, 50), (0, 10), (4, 25), (5, 5)],
    [(0, 100), (4, 60)],
    [(4, 10), (0, 0), (4, 20), (0, 5), (4, 7), (1, 0)],
    [(9, 1000), (1, 45), (10, 300), (3, 500), (2, 60), (9, 7), (10, 1)],
    [(1, 0), (2, 0), (0, 0)],
    [(0, 10), (4, 15), (5, 3), (0, 10)],
    [(4, i + 1) for i in range(40)] + [(0, 50), (1, 41)] + [(4, 3)] * 40
    + [(5, 9)],
    [(5, 2)] * 33 + [(2, 40)] + [(5, 1)] * 70,
    [],
)


def _random_cigar_rows(rng, n, k):
    """(n, k) int32 words: every op code 0-10 (matches weighted), lengths
    0-199 with 5% zero, each row of a random length padded with 0."""
    import numpy as np

    ops = rng.choice(np.array([0, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10]),
                     size=(n, k))
    lens = rng.integers(0, 200, size=(n, k))
    lens[rng.random((n, k)) < 0.05] = 0
    words = ((lens << 4) | ops).astype(np.int32)
    used = rng.integers(1, k + 1, size=n)
    words[np.arange(k)[None, :] >= used[:, None]] = 0
    return words


def collect_cases(rng):
    """Seeded inputs of the COLLECT scan: (label, words, ref_start,
    min_sv_size, max_events, shards), numpy.  Every K bucket up to 8192
    at thresholds 1 and 40, K = 40,000 (a row past 32,768 ops, K no
    multiple of 32), N = 1, a table that overflows, 8 shards with and
    without one shard overflowing, K = 1001, K = 8192 at N = 1,000, and
    rows past what the scan kernel's grid stages in shared memory at K =
    32."""
    import numpy as np

    from svim_tpu_torch.ops.cigar_kernel import event_bound

    def case(label, words, threshold, max_events=None, shards=1):
        n = words.shape[0]
        starts = rng.integers(-1000, 200_000_000, size=n).astype(np.int32)
        return (label, words, starts, threshold,
                event_bound(n) if max_events is None else max_events, shards)

    for k in (32, 128, 512, 2048, 8192):
        n = 64 if k < 8192 else 32
        for threshold in (1, 40):
            words = np.concatenate([_rows_of_ops(k, CLIP_ROWS),
                                    _random_cigar_rows(rng, n, k)])
            yield case("K={0} min_sv_size={1}".format(k, threshold), words,
                       threshold)
    long_rows = _random_cigar_rows(rng, 2, 40_000)
    long_rows[0, 32_768:] = _random_cigar_rows(rng, 1, 40_000 - 32_768)[0]
    yield case("K=40000", np.concatenate([_rows_of_ops(40_000, CLIP_ROWS),
                                          long_rows]), 40)
    yield case("N=1", _random_cigar_rows(rng, 1, 128), 40)
    words = _random_cigar_rows(rng, 512, 128)
    yield case("overflowing table", words, 1, max_events=1024)
    heavy = _random_cigar_rows(rng, 512, 128)
    # shard 3 of 8: every op an event, 8,192 of them
    heavy[192:256] = np.where(np.arange(128) % 2 == 0, (100 << 4) | 2,
                              (60 << 4) | 1).astype(np.int32)[None, :]
    yield case("8 shards, shard 3 overflowing", heavy, 40, max_events=1024,
               shards=8)
    yield case("8 shards", words, 40, max_events=16384, shards=8)
    # K no multiple of 4 (the scan kernel's runs load a word at a time);
    # 1,000 rows of 8,192 ops, each copied into the buffer of a 256-thread
    # team (the table overflows; K = 40,000 above is past what the buffers
    # hold and is read from device memory); and 230,000 rows of 32, more
    # than a 132-CTA grid stages for its warps (1,742-1,743 a CTA, 1,422
    # staged in 200 KB with the padding, and rows past a CTA's first 1,024)
    yield case("K=1001", np.concatenate([_rows_of_ops(1001, CLIP_ROWS),
                                         _random_cigar_rows(rng, 40, 1001)]),
               40)
    yield case("K=8192 N=1000",
               _random_cigar_rows(rng, 1000, 8192), 40)
    yield case("rows past the staging, K=32",
               _random_cigar_rows(rng, 230_000, 32), 40)


def classify_inputs(rng, groups, slots, rows=256):
    """Seeded inputs of classify_groups_fused as numpy arrays, in its
    positional order (the thresholds and max_segments last): slots on a
    100-base grid so that (q_start, q_end) ties are common, invalid slots in
    the middle of groups, a third of the slots gathered from packed rows,
    half the groups behind a hard-clip gate, the last two groups padding,
    15% of the segments on a second contig, and max_sv_size 1000 so that
    the huge DEL, tandem and INV codes occur."""
    import numpy as np

    ref_id_all = (rng.random(rows) < 0.15).astype(np.int32)
    ref_start_all = rng.integers(0, 12_000, rows).astype(np.int32)
    ref_end_all = (ref_start_all + rng.integers(0, 2500, rows)).astype(
        np.int32)
    read_len = rng.integers(3000, 6000, rows).astype(np.int32)
    qa_start = rng.integers(0, 1500, rows).astype(np.int32)
    qa_end = np.minimum(read_len, qa_start + rng.integers(0, 3000, rows)
                        ).astype(np.int32)
    is_reverse_all = rng.random(rows) < 0.5
    has_hard = rng.random(rows) < 0.3

    counts = rng.integers(0, slots + 1, groups)
    counts[-2:] = 0
    valid = ((np.arange(slots)[None, :] < counts[:, None])
             & (rng.random((groups, slots)) >= 0.1))
    slot_row = np.where(valid & (rng.random((groups, slots)) < 0.3),
                        rng.integers(0, rows, (groups, slots)), -1).astype(
        np.int32)
    q_start = rng.integers(0, 30, (groups, slots)) * 100
    q_end = q_start + rng.integers(0, 20, (groups, slots)) * 100
    ref_id = (rng.random((groups, slots)) < 0.15).astype(np.int32)
    ref_start = rng.integers(0, 12_000, (groups, slots))
    ref_end = ref_start + rng.integers(0, 2500, (groups, slots))
    host = [np.where(valid, column, 0).astype(np.int32)
            for column in (q_start, q_end, ref_id, ref_start, ref_end)]
    is_reverse = valid & (rng.random((groups, slots)) < 0.5)
    hard_gate = np.where(rng.random(groups) < 0.5,
                         rng.integers(0, rows, groups), -1).astype(np.int32)
    return (slot_row, *host, is_reverse, valid, hard_gate, ref_id_all,
            ref_start_all, is_reverse_all, ref_end_all, read_len, qa_start,
            qa_end, has_hard, 40, 1000, 100, 100, 64)


def classify_cases(rng):
    """(label, inputs) of the seeded classify cases: S = 2, 64, 128 and 256
    (over 64 slots: the first 64 sorted segments are kept), then the warp
    route's slot counts, S = 4, 8, 16 and 32, and S = 3, 5 and 7 (idle lanes
    past the last whole segment of a warp; G no multiple of 32 / S), and S
    = 16 with max_segments 5 (the cut inside a warp's segment)."""
    for groups, slots in ((256, 2), (64, 64), (32, 128), (8, 256),
                          (512, 4), (512, 8), (256, 16), (128, 32),
                          (301, 3), (203, 5), (97, 7)):
        yield ("G={0} S={1}".format(groups, slots),
               classify_inputs(rng, groups, slots))
    yield ("G=256 S=16 max_segments=5",
           classify_inputs(rng, 256, 16)[:-1] + (5,))


def _classify_call(inputs):
    """classify_groups_fused's positional arguments and keywords from a
    tuple of classify_inputs."""
    return list(inputs[:-1]), {"max_segments": inputs[-1]}


def collect_bound_ms(words_shape, max_events):
    """The least time the card could take for a COLLECT scan: the words and
    starts read once, the geometry, the event table and the count written
    once, over the memory rate.  Returns (ms, "bytes")."""
    n, k = words_shape
    moved = 4 * n * k + 4 * n + 17 * n + 17 * max_events + 4
    return moved / HBM_BYTES_PER_SECOND * 1e3, "bytes"


def classify_bound_ms(args):
    """The least time the card could take for a classify call on these
    inputs: the group columns read once, for each slot with a packed row
    its six row columns (25 bytes), for each gated group its flag, and the
    twelve (G, S-1) outputs (42 bytes a pair) written once, over the memory
    rate.  Returns (ms, "bytes")."""
    slot_row, hard_gate = args[0], args[8]
    groups, slots = slot_row.shape
    moved = (groups * slots * (6 * 4 + 2) + 4 * groups
             + 25 * int((slot_row >= 0).sum()) + int((hard_gate >= 0).sum())
             + 42 * groups * max(slots - 1, 0))
    return moved / HBM_BYTES_PER_SECOND * 1e3, "bytes"


# what phase 15 has seen: calls compared and the largest difference
COLLECT_CHECK = {"collect_scan": {"calls": 0, "max_abs_err": 0},
                 "classify_segments": {"calls": 0, "max_abs_err": 0}}


def _collect_module(kernel):
    """(ops module, wrapper, plain version) of a COLLECT kernel."""
    import importlib

    module_name, cuda_name, plain_name = COLLECT_FUNCTIONS[kernel][:3]
    module = importlib.import_module("svim_tpu_torch.ops." + module_name)
    return module, getattr(module, cuda_name), getattr(module, plain_name)


def _collect_against_plain(kernel, args, kwargs, where, recorded=None):
    """One COLLECT op through its kernel and its plain version on the card:
    every output bit-equal (and equal to `recorded`, the main path's own
    outputs, when given).  Returns the kernel's outputs."""
    import torch

    module, cuda, plain = _collect_module(kernel)
    args = _on_card(args)
    kwargs = {key: value.cuda() if isinstance(value, torch.Tensor) else value
              for key, value in kwargs.items()}
    before = module.LAUNCHES
    got = cuda(*args, **kwargs)
    launched = module.LAUNCHES - before
    want = plain(*args, **kwargs)
    torch.cuda.synchronize()
    if launched != 1:
        raise AssertionError("{0}: {1} launches of the {2} kernel".format(
            where, launched, kernel))
    check = COLLECT_CHECK[kernel]
    check["calls"] += 1
    references = [("plain version", want)]
    if recorded is not None:
        references.append(("main path's outputs", recorded))
    for reference_name, reference in references:
        if len(got) != len(reference):
            raise AssertionError("{0}: {1} outputs against the {2}'s {3}"
                                 .format(where, len(got), reference_name,
                                         len(reference)))
        for index, (a, b) in enumerate(zip(got, reference)):
            b = b.cuda()
            if a.shape == b.shape and a.numel():
                check["max_abs_err"] = max(check["max_abs_err"], int(
                    (a.long() - b.long()).abs().max()))
            if not _bit_equal(a, b):
                raise AssertionError("{0}: {1} kernel != {2} in output {3}"
                                     .format(where, kernel, reference_name,
                                             index))
    return got


# the commit of COLLECT's first kernel designs (csrc/collect_scan.cu in
# three launches, csrc/classify_segments.cu a CTA a group): built beside the
# present ones in phase 15 and timed with them in turns on the same inputs
COLLECT_DESIGN_COMMIT = "e2927607131560984aa83b247e176f68ae3fc41e"
# the launch floor: an empty kernel of one CTA, and an empty cooperative
# kernel whose grid meets at one barrier (the scan kernel's launch shape)
EMPTY_KERNELS = r"""
#include <cooperative_groups.h>
#include <cuda_runtime.h>

__global__ void empty_kernel() {}

__global__ void empty_grid_barrier() {
  cooperative_groups::this_grid().sync();
}

extern "C" int empty_launch(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

extern "C" int empty_cooperative_launch(int blocks, int threads,
                                        void* stream) {
  void* arguments[1] = {nullptr};
  return static_cast<int>(cudaLaunchCooperativeKernel(
      (void*)empty_grid_barrier, dim3(blocks), dim3(threads), arguments, 0,
      static_cast<cudaStream_t>(stream)));
}
"""


class _FirstScanDesign:
    """The first design's scan library as ops.cigar_kernel's wrapper calls
    it: its scratch was two words a row."""

    def __init__(self, library):
        self.collect_scan = library.collect_scan
        self.path = library.path

    @staticmethod
    def collect_scan_scratch_words(n):
        return 2 * n


def _build_designs(directory, sources):
    """{name: source text} compiled side by side with the port's nvcc flags
    into `directory`: {name: the loaded library, its `path` set}."""
    import ctypes

    from svim_tpu_torch.ops import _build

    os.makedirs(directory, exist_ok=True)
    jobs = {}
    for name, source in sources.items():
        source_path = os.path.join(directory, name + ".cu")
        with open(source_path, "w") as handle:
            handle.write(source)
        library_path = os.path.join(directory, name + ".so")
        jobs[name] = (library_path, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", library_path,
             source_path], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    libraries = {}
    for name, (library_path, process) in jobs.items():
        output, _ = process.communicate()
        if process.returncode != 0:
            raise RuntimeError("nvcc failed for {0}:\n{1}".format(name,
                                                                  output))
        libraries[name] = ctypes.CDLL(library_path)
        libraries[name].path = library_path
    return libraries


def _bind_like(library, present, functions):
    """Gives `library`'s `functions` the argument and result types of the
    present library's."""
    for name in functions:
        getattr(library, name).argtypes = getattr(present, name).argtypes
        getattr(library, name).restype = getattr(present, name).restype


def collect_design_libraries():
    """{"collect_scan", "classify_segments": the first designs (their
    sources at COLLECT_DESIGN_COMMIT, see _source_at; None where a source
    cannot be had), "empty": the floor's kernels}, built in parallel with
    the port's nvcc flags into SCRATCH and bound like the present ones."""
    import ctypes

    sources = {"empty": EMPTY_KERNELS}
    for kernel, entry in COLLECT_FUNCTIONS.items():
        source = _source_at(COLLECT_DESIGN_COMMIT, entry[3])
        if source is not None:
            sources[kernel] = source
    libraries = dict.fromkeys(COLLECT_FUNCTIONS)
    libraries.update(_build_designs(os.path.join(SCRATCH, "collect_designs"),
                                    sources))
    empty = libraries["empty"]
    empty.empty_launch.argtypes = [ctypes.c_void_p]
    empty.empty_cooperative_launch.argtypes = [ctypes.c_int, ctypes.c_int,
                                               ctypes.c_void_p]
    for kernel, functions in (("collect_scan", ("collect_scan",)),
                              ("classify_segments", ("classify_max_slots",
                                                     "classify_segments"))):
        if libraries[kernel] is not None:
            _bind_like(libraries[kernel],
                       _collect_module(kernel)[0]._kernel_library(),
                       functions)
    if libraries["collect_scan"] is not None:
        libraries["collect_scan"] = _FirstScanDesign(
            libraries["collect_scan"])
    return libraries


def _time_designs(module, attribute, counter, call, first_design, same,
                  repeats=20):
    """Device ms of `call()`, a call of a kernel's wrapper in `module`, and,
    when `first_design` is a library, of the first design on the same inputs
    in turns (first design, kernel, kernel, first design; each the mean of
    its two turns; the wrapper reaches it through `module.<attribute>`),
    whose output must pass `same(kernel's, first design's)`.  The launches
    counted in `module.<counter>` here are taken back.  Returns (ms, first
    design ms or None)."""
    saved, launches = getattr(module, attribute), getattr(module, counter)

    def through_first_design():
        setattr(module, attribute, first_design)
        try:
            return _device_ms(call, repeats)
        finally:
            setattr(module, attribute, saved)

    try:
        if first_design is None:
            return _device_ms(call, repeats)[0], None
        first, old = through_first_design()
        second, new = _device_ms(call, repeats)
        third, _ = _device_ms(call, repeats)
        fourth, _ = through_first_design()
    finally:
        setattr(module, counter, launches)
    if not same(new, old):
        raise AssertionError("{0}: the first design's output differs from "
                             "the kernel's".format(module.__name__))
    return (second + third) / 2, (first + fourth) / 2


def _time_collect_designs(kernel, tensors, kwargs, first_design,
                          repeats=20):
    """_time_designs for COLLECT kernel `kernel` on `tensors`: every output
    of the first design equal to the kernel's bit for bit."""
    module, cuda, _ = _collect_module(kernel)
    return _time_designs(
        module, "_library", "LAUNCHES", lambda: cuda(*tensors, **kwargs),
        first_design,
        lambda new, old: all(_bit_equal(a, b) for a, b in zip(new, old)),
        repeats)


def collect_launch_floor(empty, repeats=20):
    """Device ms (under _device_ms) of an empty kernel of one CTA and of an
    empty cooperative kernel of one 1024-thread CTA a SM meeting at one grid
    barrier."""
    import torch

    from svim_tpu_torch.ops._build import check_launch

    stream = torch.cuda.current_stream().cuda_stream
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    empty_ms, _ = _device_ms(lambda: check_launch(
        "empty", empty.empty_launch(stream)), repeats)
    barrier_ms, _ = _device_ms(lambda: check_launch(
        "empty cooperative", empty.empty_cooperative_launch(sms, 1024,
                                                            stream)),
        repeats)
    return {"empty_kernel_ms": empty_ms, "empty_grid_barrier_ms": barrier_ms,
            "grid_barrier_ctas": sms}


def _device_kernels(function):
    """Names of the device kernels, copies and memsets one call of
    `function` ran, from the Chrome trace of torch.profiler (its event list
    leaves out kernels that no PyTorch op launched, as ctypes launches
    are)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as trace:
        function()
        torch.cuda.synchronize()
    path = os.path.join(SCRATCH, "one_call_trace.json")
    trace.export_chrome_trace(path)
    with open(path) as handle:
        events = json.load(handle)["traceEvents"]
    return [event["name"] for event in events if event.get("ph") == "X"
            and event.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]


def phase_collect_kernels(recorder):
    """Phase 15: the two COLLECT kernels against their plain versions on
    the card (bit-equal), on every call the main path made in the recorded
    phases and on the seeded cases; the overflow re-run and the 8-shard
    merge; the sync check; times beside the bound, the launch floor and the
    first designs
    (COLLECT_DESIGN_COMMIT) in turns.  Returns ({(kernel, "bench batch" or
    "seeded", shape): (ms, plain ms, bound ms, bound by, first design ms or
    None)}, the floor)."""
    import numpy as np
    import torch

    from svim_tpu_torch.ops import cigar_kernel, segments_kernel
    from svim_tpu_torch.ops.cigar_kernel import round_up_pow2
    from svim_tpu_torch.parallel import mesh

    started = time.perf_counter()
    by_label = {}
    for label, kernel, args, kwargs, outputs in recorder.calls:
        if kernel not in COLLECT_FUNCTIONS:
            continue
        if any(isinstance(arg, torch.Tensor) and arg.device.type != "cuda"
               for arg in args):
            raise AssertionError("a {0} call of {1} ran off the card".format(
                kernel, label))
        _collect_against_plain(kernel, args, kwargs, "{0} call of {1}".format(
            kernel, label), recorded=outputs)
        by_label.setdefault(label, {}).setdefault(kernel, 0)
        by_label[label][kernel] += 1
    for label in COLLECT_RECORDED:
        if not by_label.get(label, {}).get("collect_scan"):
            raise AssertionError("phase {0} made no COLLECT scan".format(
                label))
    log("collect", "every recorded main-path call is bit-equal to the plain "
        "version and to its own outputs: {0}".format(json.dumps(by_label)))

    rng = np.random.default_rng(20261021)
    device = torch.device("cuda")
    for label, words, starts, threshold, max_events, shards in \
            collect_cases(rng):
        where = "collect_scan, " + label
        got = _collect_against_plain("collect_scan",
                                     (words, starts, threshold, max_events),
                                     {}, where)
        count = int(got[10])
        if shards > 1:
            args = _on_card((words, starts))
            whole = mesh.collect_scan_sharded(1, device, *args, threshold,
                                              max_events)
            cut = mesh.collect_scan_sharded(shards, device, *args, threshold,
                                            max_events)
            if not all(_bit_equal(a, b) for a, b in zip(cut, whole)):
                raise AssertionError(where + ": the merged shards differ "
                                     "from the whole batch")
            block = words.shape[0] // shards
            shard_counts = [int(cigar_kernel.collect_scan(
                args[0][i * block:(i + 1) * block],
                args[1][i * block:(i + 1) * block], threshold,
                max_events)[10]) for i in range(shards)]
            label += " (shard counts {0})".format(shard_counts)
        if count > max_events:
            # the re-run the consumer makes, which must give every event
            bound = round_up_pow2(count)
            rerun = _collect_against_plain(
                "collect_scan", (words, starts, threshold, bound), {},
                where + ", re-run")
            unbounded = cigar_kernel.collect_scan_plain(
                *_on_card((words, starts)), threshold, 2 * bound)
            if int(rerun[10]) != count or not all(
                    torch.equal(bounded, full[:max_events])
                    and torch.equal(full[:count], every[:count])
                    for bounded, full, every in zip(
                        got[5:10], rerun[5:10], unbounded[5:10])):
                raise AssertionError(where + ": the bounded table is not the "
                                     "re-run's prefix, or the re-run lost "
                                     "events")
        log("collect", "{0}: N={1} K={2} bound {3}: bit-equal, {4} events"
            .format(label, words.shape[0], words.shape[1], max_events,
                    count))

    codes = set()
    twins = cross = 0
    for label, inputs in classify_cases(rng):
        args, kwargs = _classify_call(inputs)
        got = _collect_against_plain("classify_segments", args, kwargs,
                                     "classify_segments, " + label)
        codes |= set(got[0].unique().tolist())
        twins += int(got[6].sum())
        cross += int(((got[0] == 5) & (got[4] != got[11])).sum())
        log("collect", "classify {0}: bit-equal; codes {1}".format(
            label, sorted(set(got[0].unique().tolist()))))
    if codes != {0, 1, 2, 3, 4, 5} or not twins or not cross:
        raise AssertionError("the seeded classify cases reached codes {0}, "
                             "{1} twins, {2} cross-contig pairs".format(
                                 sorted(codes), twins, cross))

    n = 4096
    words = _random_cigar_rows(rng, n, 128)
    starts = rng.integers(0, 200_000_000, size=n).astype(np.int32)
    bound = cigar_kernel.event_bound(n)
    scan_args = _on_card((words, starts))
    classify_args, classify_kwargs = _classify_call(
        classify_inputs(rng, 512, 8))
    classify_args = _on_card(classify_args)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        cigar_kernel.collect_scan(*scan_args, 40, bound)
        mesh.collect_scan_sharded(8, device, *scan_args, 40, bound)
        segments_kernel.classify_groups_fused(*classify_args,
                                              **classify_kwargs)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    log("collect", "sync check: collect_scan, collect_scan_sharded over 8 "
        "shards and classify_groups_fused enqueued on card tensors under "
        "torch.cuda.set_sync_debug_mode('error') without a host sync")

    def largest(kernel):
        calls = [(args, kwargs) for label, name, args, kwargs, _ in
                 recorder.calls if label == "bench" and name == kernel]
        return max(calls, key=lambda call: call[0][0].numel())

    bench_scan, _ = largest("collect_scan")
    bench_classify = largest("classify_segments")
    designs = collect_design_libraries()
    floor = collect_launch_floor(designs["empty"])
    log("collect", "launch floor: an empty kernel {0:.4f} ms, an empty "
        "cooperative kernel of {1} CTAs of 1024 threads meeting at one grid "
        "barrier {2:.4f} ms (device ms, stream held)".format(
            floor["empty_kernel_ms"], floor["grid_barrier_ctas"],
            floor["empty_grid_barrier_ms"]))
    for kernel in COLLECT_FUNCTIONS:
        if designs[kernel] is None:
            log("collect", "{0}: the first design's source at {1} is not "
                "here (no git, nothing under _chipwork/{1}): not timed"
                .format(kernel, COLLECT_DESIGN_COMMIT))
    timed = [("collect_scan", "bench batch", bench_scan, {}),
             ("classify_segments", "bench batch", bench_classify[0],
              bench_classify[1]),
             ("classify_segments", "seeded", classify_args, classify_kwargs)]
    for k in (128, 512, 1024, 2048, 8192):
        words = _random_cigar_rows(rng, n, k)
        timed.append(("collect_scan", "seeded",
                      (words, starts, 40, bound), {}))
    timings = {}
    for kernel, label, args, kwargs in timed:
        module, cuda, plain = _collect_module(kernel)
        tensors = _on_card(args)
        ms, first_ms = _time_collect_designs(kernel, tensors, kwargs,
                                             designs[kernel])
        plain_ms, _ = _time_ms(lambda: plain(*tensors, **kwargs), 3)
        if kernel == "collect_scan":
            shape = "N={0},K={1},max_events={2}".format(
                *tensors[0].shape, tensors[3])
            bound_ms, bound_by = collect_bound_ms(tensors[0].shape,
                                                  tensors[3])
        else:
            shape = "G={0},S={1}".format(*tensors[0].shape)
            bound_ms, bound_by = classify_bound_ms(tensors)
        timings[(kernel, label, shape)] = (ms, plain_ms, bound_ms, bound_by,
                                           first_ms)
        log("collect", "{0} at {1} ({2}): kernel {3:.4f} ms, first design "
            "{8} ms, plain {4:.3f} ms, bound {5:.5f} ms by {6} (kernel "
            "{7:.1f} times its bound)".format(
                kernel, shape, label, ms, plain_ms, bound_ms, bound_by,
                ms / bound_ms, "not timed" if first_ms is None
                else "{0:.4f}".format(first_ms)))
    for path in ("golden", "bench_wavefront", "bench_auto"):
        for kernel in COLLECT_FUNCTIONS:
            if PATH_LAUNCHES[path][kernel] <= 0:
                raise AssertionError("{0} launched no {1} kernel".format(
                    path, kernel))
    log("collect", "phase 15 took {0:.1f} s".format(
        time.perf_counter() - started))
    return timings, floor


def collect_kernel_entry(kernel, timings, floor, launches_by_path):
    """The `kernels` line's entry of a COLLECT kernel: its numbers at the
    bench batch shape, every timed shape under `by_shape` with the first
    design's ms beside, and the launch floor."""
    (_, _, shape), (ms, plain_ms, bound_ms, bound_by, _) = next(
        (key, value) for key, value in timings.items()
        if key[0] == kernel and key[1] == "bench batch")
    source, replaces = COLLECT_FUNCTIONS[kernel][3:]
    return {"name": kernel, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": PATH_LAUNCHES["bench_wavefront"][kernel],
            "launches_by_path": launches_by_path,
            "max_abs_err": COLLECT_CHECK[kernel]["max_abs_err"],
            "compared_calls": COLLECT_CHECK[kernel]["calls"], "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None, "shape": shape + " (bench batch)",
            "kernels_per_call": _collect_module(kernel)[0].KERNELS_PER_CALL,
            "first_design": "{0} at {1}".format(source,
                                                COLLECT_DESIGN_COMMIT[:7]),
            "by_shape": {"{0} ({1})".format(key[2], key[1]): dict(zip(
                ("ms", "plain_ms", "bound_ms", "bound_by",
                 "first_design_ms"), value))
                for key, value in timings.items() if key[0] == kernel},
            "floor_ms": floor}


# --- phase 16 and the INS matrices of phase 6: this slice's two kernels -----

INT32_MAX = 2**31 - 1
INT32_MIN = -2**31
# GENOTYPE's kernel: its source, the TPU program it replaces, the phases
# whose joins phase 16 checks again (phase 9's inputs make none: SAM text
# genotypes by host region queries, a queryname-sorted input not at all),
# and the shape timed beside the bench's (candidates, slice_len, support
# width)
GENOTYPE_SOURCE = "svim_tpu_torch/csrc/genotype_support.cu"
GENOTYPE_REPLACES = "svim_tpu/ops/genotype_kernel.py:78"
GENOTYPE_RECORDED = ("golden", "bench", "tiefree", "streaming", "shards")
GENOTYPE_TIMED_SHAPE = (4096, 8192, 64)
# (C, slice_len, S) of the bench's GENOTYPE join and (B, P, Q) of its
# largest INS matrix call (bench-8192, --edit_backend wavefront): phase 2b
# runs a call of each at these shapes
GENOTYPE_BENCH_SHAPE = (192, 64, 32)
INS_BENCH_SHAPE = (128, 32, 32768)
INS_SOURCE = "svim_tpu_torch/csrc/ins_matrices.cu"
INS_REPLACES = "svim_tpu/ops/linkage_kernel.py:130"
# what phases 6 and 16 have seen: calls compared and the largest difference
GENOTYPE_CHECK = {"calls": 0, "max_abs_err": 0}
INS_CHECK = {"calls": 0, "max_abs_err": 0.0}
# the commit of the first designs of these two kernels (the join a CTA a
# candidate; the INS matrices in two launches, cells then pairs): built
# beside the present ones and timed with them in turns on the same inputs
SLICE_DESIGN_COMMIT = "be8ae56ef1c9273948640dc310ab4f987f546040"
# kernel -> (source, module, its library attribute, its launch counter)
SLICE_KERNELS = {
    "genotype_support": (GENOTYPE_SOURCE, "genotype_kernel", "_library",
                         "LAUNCHES"),
    "ins_matrices": (INS_SOURCE, "linkage_kernel", "_ins_library",
                     "INS_LAUNCHES")}
# the faults of the INS pair columns that the kernel must trap on, each
# checked in a process of its own (a trap ends the process's CUDA context)
INS_TRAPS = ("partitions swapped", "real pair after the padding",
             "a pair outside the matrices")


def _slice_module(name):
    import importlib

    return importlib.import_module("svim_tpu_torch.ops." + SLICE_KERNELS[
        name][1])


def slice_design_libraries():
    """{"genotype_support", "ins_matrices": the first design (its source at
    SLICE_DESIGN_COMMIT, see _source_at; None where it cannot be had)},
    built in parallel with the port's nvcc flags into SCRATCH and bound
    like the present ones."""
    sources = {}
    for name, (source_file, _, _, _) in SLICE_KERNELS.items():
        source = _source_at(SLICE_DESIGN_COMMIT, source_file)
        if source is not None:
            sources[name] = source
    libraries = dict.fromkeys(SLICE_KERNELS)
    libraries.update(_build_designs(os.path.join(SCRATCH, "slice_designs"),
                                    sources))
    for name, library in libraries.items():
        if library is not None:
            module = _slice_module(name)
            _bind_like(library, module._ins_kernel_library()
                       if name == "ins_matrices"
                       else module._kernel_library(), (name,))
    return libraries


def _time_slice_designs(name, call, first_design, same):
    """_time_designs for kernel `name` of SLICE_KERNELS."""
    _, _, attribute, counter = SLICE_KERNELS[name]
    return _time_designs(_slice_module(name), attribute, counter, call,
                         first_design, same)


def phase_slice_resources(first_designs):
    """Registers, spills and static shared memory of the GENOTYPE and INS
    matrix kernels, present and first design (logged; not checked)."""
    from svim_tpu_torch.ops import _build

    for name, library in first_designs.items():
        paths = {"present": _build.library_path(name)}
        if library is not None:
            paths["first design"] = library.path
        for which, path in paths.items():
            for line in _resource_usage(path) or ["cuobjdump not found"]:
                log("resources", "{0}, {1}: {2}".format(name, which, line))


def ins_column_faults(args, kind):
    """ins_matrices_from_pairs's arguments (numpy, from _ins_inputs) with
    one fault of `kind` in their pair columns, in place: partitions
    swapped, a real pair after the padding, padding among the real pairs,
    the last partition first (all out of partition order), or a pair
    outside the matrices."""
    import numpy as np

    part, first, second = args[2], args[3], args[4]
    real = int((first != second).sum())
    if kind == "partitions swapped":
        later = int(np.flatnonzero(part[:real] != part[0])[0])
        part[0], part[later] = part[later], part[0]
    elif kind == "real pair after the padding":
        part[real], first[real], second[real] = 3, 0, 1
    elif kind == "padding among the real pairs":
        second[real // 2] = first[real // 2]
    elif kind == "last partition first":
        part[0] = len(args[0]) - 1
    elif kind == "a pair outside the matrices":
        first[real // 2] = args[0].shape[1]
    else:
        raise ValueError("no INS column fault " + kind)
    return args


def start_ins_traps():
    """Phase 2c: each fault of INS_TRAPS through the INS matrix kernel in a
    process of its own, beside the later phases (ins_trap_case).  Returns
    the processes for finish_ins_traps()."""
    return {kind: subprocess.Popen(
        [sys.executable, "-c", "import sys; sys.path.insert(0, sys.argv[1]); "
         "import chip_smoke; chip_smoke.ins_trap_case(sys.argv[2])", ROOT,
         kind], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for kind in INS_TRAPS}


def ins_trap_case(kind):
    """The INS matrix kernel on seeded columns of the bench's shape, which
    it must take, then on the same columns with the fault `kind`, which the
    plain version must refuse (ValueError) and the kernel trap on: prints
    "NO TRAP" if the synchronisation after its launch passes."""
    import numpy as np
    import torch

    from svim_tpu_torch.ops import linkage_kernel

    args = _ins_inputs(np.random.default_rng(20261028), *INS_BENCH_SHAPE)
    linkage_kernel.ins_matrices_from_pairs_cuda(*_on_card(args))
    torch.cuda.synchronize()
    print("the columns as built: no trap", flush=True)
    faulty = _on_card(ins_column_faults(args, kind))
    try:
        linkage_kernel.ins_matrices_from_pairs_plain(*faulty)
    except ValueError as error:
        print("plain version: ValueError: {0}".format(error), flush=True)
    linkage_kernel.ins_matrices_from_pairs_cuda(*faulty)
    torch.cuda.synchronize()
    print("NO TRAP", flush=True)


def finish_ins_traps(processes):
    """Waits for start_ins_traps()'s processes: each must have taken the
    columns as built, seen the plain version raise, and died of the
    kernel's trap (a CUDA error at the synchronisation)."""
    for kind, process in processes.items():
        output, _ = process.communicate(timeout=RANK_TIMEOUT)
        if (process.returncode == 0 or "NO TRAP" in output
                or "the columns as built: no trap" not in output
                or "plain version: ValueError" not in output
                or "CUDA error" not in output):
            sys.stdout.write(output)
            raise AssertionError("the INS matrix kernel did not trap on "
                                 + kind)
        error = next(line for line in output.splitlines()
                     if "CUDA error" in line)
        log("kernels", "INS matrices, {0}: the plain version raised "
            "ValueError and the kernel trapped (exit code {1}: {2})".format(
                kind, process.returncode, error.strip()))


def _genotype_call(candidates, slice_len, s):
    """genotype_support_batched's positional arguments (numpy int32 arrays,
    slice_len last) for `candidates`: dicts of a window's rows (starts2,
    ends2, ids, doubled coordinates), the candidate's ws2, s2, e2, mo2, tc,
    its support ids (sorted here, padded with INT_MAX to `s`) and, where
    given, a width other than its row count.  The windows lie one after
    another in a table padded by slice_len rows as DeviceGenotypeTable pads
    it."""
    import numpy as np

    parts = ([], [], [])
    columns = np.zeros((7, len(candidates)), dtype=np.int64)
    support = np.full((len(candidates), s), INT32_MAX, dtype=np.int64)
    base = 0
    for index, candidate in enumerate(candidates):
        rows = len(candidate["starts2"])
        for part, key in zip(parts, ("starts2", "ends2", "ids")):
            part.append(np.asarray(candidate[key], dtype=np.int64))
        columns[:, index] = (base, candidate.get("width", rows),
                             candidate["ws2"], candidate["s2"],
                             candidate["e2"], candidate["mo2"],
                             candidate["tc"])
        ids = np.sort(np.asarray(candidate["support"], dtype=np.int64))
        support[index, :len(ids)] = ids
        base += rows
    table = [np.concatenate(part + [np.full(slice_len, pad, np.int64)])
             .astype(np.int32)
             for part, pad in zip(parts, (INT32_MAX, INT32_MIN, INT32_MAX))]
    return ([column.astype(np.int32) for column in columns]
            + [support.astype(np.int32)] + table + [slice_len])


def _genotype_candidate(rows, ids, support=(), tc=0, **params):
    """A candidate at 100,000-102,000 bp (doubled: s2 = 200,000, e2 =
    204,000; an INS when tc = 1, e2 = s2) over `rows`, (start2, end2)
    pairs."""
    import numpy as np

    s2 = params.pop("s2", 200_000)
    e2 = params.pop("e2", s2 if tc else 204_000)
    rows = np.asarray(rows, dtype=np.int64).reshape(-1, 2)
    return dict(dict(starts2=rows[:, 0], ends2=rows[:, 1], ids=ids,
                     ws2=s2 - 2000, s2=s2, e2=e2, mo2=min(e2 - s2, 4000),
                     tc=tc, support=list(support)), **params)


# rows of the candidate above: SPAN spans it as a DEL and as an INS; FLANK
# lies in the window and qualifies but spans neither; OUTSIDE ends before
# the window and does not qualify
SPAN = (190_000, 210_000)
FLANK = (199_900, 203_000)
OUTSIDE = (150_000, 197_000)


def _random_candidates(rng, count, most_rows, s, wide=False):
    """`count` candidates over random windows of 0 to `most_rows` rows
    sorted by start, either type, support ids drawn from the window's ids
    with repeats and some INT_MAX among them, at most `s`.  `wide` draws
    every coordinate and bound over the whole int32 range, so that the
    margins and overlaps wrap."""
    import numpy as np

    candidates = []
    for _ in range(count):
        rows = int(rng.integers(0, most_rows + 1))
        tc = int(rng.integers(0, 2))
        if wide:
            starts2 = np.sort(rng.integers(INT32_MIN, INT32_MAX, size=rows))
            ends2 = rng.integers(INT32_MIN, INT32_MAX, size=rows)
            bounds = rng.integers(INT32_MIN, INT32_MAX, size=3)
            near = rng.integers(0, 300, size=2)
            s2 = int(INT32_MIN + near[0]) if rng.random() < 0.5 \
                else int(bounds[0])
            e2 = int(INT32_MAX - near[1]) if rng.random() < 0.5 \
                else int(bounds[1])
            candidate = dict(ws2=int(bounds[2]), s2=s2, e2=e2,
                             mo2=int(rng.integers(0, 4001)), tc=tc)
        else:
            center = int(rng.integers(100_000, 10_000_000)) * 2
            starts2 = np.sort(center + rng.integers(-40_000, 6_000,
                                                    size=rows))
            ends2 = starts2 + rng.integers(0, 40_000, size=rows)
            length = 0 if tc else int(rng.integers(0, 6_000))
            candidate = dict(ws2=center - 2000, s2=center,
                             e2=center + 2 * length,
                             mo2=min(length, 4000), tc=tc)
        ids = rng.integers(0, max(2, rows // 2), size=rows)
        picked = list(rng.choice(ids, size=min(rows, s // 2))) \
            if rows else []
        if rng.random() < 0.3 and len(picked) < s:
            picked.append(INT32_MAX)
        candidates.append(dict(candidate, starts2=starts2, ends2=ends2,
                               ids=ids, support=picked))
    return candidates


def genotype_cases(rng):
    """Seeded inputs of the GENOTYPE join: (label, args) with args
    genotype_support_batched's positional arguments as numpy arrays (see
    _genotype_call).  The cap at 499, 500 and 501 qualifying rows,
    supporters around and after the 500th qualifying row, support reads
    and rows outside the window before the cap (which do not use it up),
    repeated ids; width 0, 1 and 8192; S = 8, 64 and one past the kernel's
    shared-memory stage, repeated and INT_MAX support ids; table ids
    INT_MAX (against a support row with and without INT_MAX padding) and
    INT_MIN; coordinates whose margins wrap int32; both types in every
    call; C = 1 and C = 4096."""
    import numpy as np

    def distinct(count, first=0):
        return np.arange(first, first + count)

    cap = []
    for tc in (0, 1):
        for qualifying in (499, 500, 501):
            cap.append(_genotype_candidate([SPAN] * qualifying,
                                           distinct(qualifying), tc=tc))
        cap += [
            _genotype_candidate([FLANK] * 500 + [SPAN] * 100,
                                distinct(600), tc=tc),
            _genotype_candidate([FLANK] * 250 + [SPAN] * 300,
                                distinct(550), tc=tc),
            _genotype_candidate([SPAN] * 200 + [SPAN] * 500,
                                distinct(700, 10_000),
                                support=distinct(200, 10_000), tc=tc),
            _genotype_candidate([OUTSIDE] * 100 + [SPAN] * 500,
                                distinct(600), tc=tc),
            _genotype_candidate([SPAN] * 600, np.arange(600) % 150, tc=tc)]
    yield "the cap at 499, 500, 501 and around it", _genotype_call(
        cap, 1024, 256)

    widths = [_genotype_candidate([], [], tc=0),
              _genotype_candidate([SPAN] * 5, distinct(5), tc=1, width=1),
              _genotype_candidate([SPAN] * 5, distinct(5), tc=0, width=1)]
    wide_window = _random_candidates(rng, 1, 0, 8)[0]
    starts2 = np.sort(wide_window["s2"] + rng.integers(-60_000, 8_000,
                                                       size=8192))
    widths.append(dict(wide_window, starts2=starts2,
                       ends2=starts2 + rng.integers(0, 70_000, size=8192),
                       ids=rng.integers(0, 3000, size=8192),
                       support=list(rng.integers(0, 3000, size=8))))
    yield "width 0, 1 and 8192", _genotype_call(widths, 8192, 8)

    for s in (8, 64):
        yield "S={0}, repeated and INT_MAX support ids".format(s), \
            _genotype_call(_random_candidates(rng, 64, 256, s), 256, s)
    past = _random_candidates(rng, 8, 512, 40)
    for candidate in past:
        # ids of no row fill the support row past the stage
        extra = rng.integers(10**6, 10**9, size=8192 - len(
            candidate["support"]))
        candidate["support"] = candidate["support"] + list(extra)
    yield "S=8192, past the shared-memory stage", _genotype_call(
        past, 512, 8192)

    sentinels = []
    for tc in (0, 1):
        ids = np.concatenate([np.full(300, INT32_MAX), distinct(300)])
        sentinels += [
            # a full support row: INT_MAX ids qualify and use the cap
            _genotype_candidate([SPAN] * 600, ids,
                                support=distinct(8, 5000), tc=tc),
            # INT_MAX padding: INT_MAX ids match it and are excluded
            _genotype_candidate([SPAN] * 600, ids,
                                support=distinct(3, 5000), tc=tc),
            _genotype_candidate([SPAN] * 7, np.concatenate([
                [INT32_MIN, INT32_MIN], distinct(5)]), tc=tc),
            _genotype_candidate([SPAN] * 4, [INT32_MIN, 3, INT32_MAX, 3],
                                support=[3, 3, INT32_MAX], tc=tc)]
    yield "INT_MAX and INT_MIN ids", _genotype_call(sentinels, 1024, 8)

    yield "wrapping margins", _genotype_call(
        _random_candidates(rng, 32, 64, 8, wide=True), 64, 8)
    yield "C=1", _genotype_call(_random_candidates(rng, 1, 64, 8), 64, 8)
    yield "C=4096", _genotype_call(_random_candidates(rng, 4096, 96, 64),
                                   128, 64)


def genotype_timed_inputs(rng, candidates, slice_len, s):
    """A join at the timed shape: one coordinate-sorted table of
    candidates + slice_len rows, every candidate's window slice_len rows
    of it at a random place, its support ids drawn from its window."""
    import numpy as np

    rows = candidates + slice_len
    starts2 = np.sort(rng.integers(0, 40 * rows, size=rows))
    ends2 = starts2 + rng.integers(0, 20_000, size=rows)
    ids = rng.integers(0, rows // 8, size=rows)
    lo = rng.integers(0, rows - slice_len, size=candidates)
    s2 = starts2[lo + slice_len // 2]
    tc = rng.integers(0, 2, size=candidates)
    length = np.where(tc == 1, 0, rng.integers(0, 6_000, size=candidates))
    support = np.sort(ids[lo[:, None] + rng.integers(0, slice_len,
                                                     size=(candidates, s))],
                      axis=1)
    pads = (INT32_MAX, INT32_MIN, INT32_MAX)
    table = [np.concatenate([column, np.full(slice_len, pad)]).astype(
        np.int32) for column, pad in zip((starts2, ends2, ids), pads)]
    columns = [lo, np.full(candidates, slice_len), s2 - 2000, s2,
               s2 + 2 * length, np.minimum(length, 4000), tc]
    return ([column.astype(np.int32) for column in columns]
            + [support.astype(np.int32)] + table + [slice_len])


def genotype_bound_work(tensors):
    """What a GENOTYPE join on these inputs needs at least: (table rows,
    operations).  Table rows: the distinct rows the candidates' windows
    cover up to each one's 500th qualifying row (overlapping windows read a
    row once).  Operations: each row a candidate walks (to its 500th
    qualifying row or its width) loads its end and compares it with the
    window start and its place with the width (3); each of those that ends
    in the window loads its id and searches the support row, a compare a
    step, then tests equality (ceil(log2 S) + 2); each qualifying row walked
    adds to the rank, tests the cap, loads its start and runs the span test
    (10 for DEL/INV: four compares, three logic ops; 6 for INS/DUP_INT: two
    compares, one).  The distinct count's sort is not counted."""
    import torch

    from svim_tpu_torch.ops import genotype_kernel

    lo, width, window_start2 = tensors[:3]
    type_class = tensors[6]
    support_sorted, starts2, ends2, ids, slice_len = tensors[7:]
    s = support_sorted.shape[1]
    table_rows = starts2.shape[0]
    qualifying = genotype_kernel._windows(
        lo, width, window_start2, support_sorted, starts2, ends2, ids,
        slice_len)[3]
    rank = torch.cumsum(qualifying.to(torch.int32), dim=1)
    needed = torch.where(rank[:, -1] >= genotype_kernel.ALIGNMENT_CAP,
                         (rank < genotype_kernel.ALIGNMENT_CAP).sum(dim=1) + 1,
                         width.clamp(0, slice_len).long())
    index = torch.arange(slice_len, device=lo.device)
    first = lo.clamp(0, max(table_rows - slice_len, 0)).long()
    walked = index[None, :] < needed[:, None]
    in_window = walked & (ends2[first[:, None] + index[None, :]]
                          > window_start2[:, None])
    span_ops = torch.where(type_class == 0, 10, 6)
    operations = (3 * int(needed.sum())
                  + (max(s - 1, 0).bit_length() + 2) * int(in_window.sum())
                  + int(((qualifying & walked).sum(dim=1) * span_ops).sum()))

    marks = torch.zeros(table_rows + 1, dtype=torch.int32, device=lo.device)
    ones = torch.ones_like(first, dtype=torch.int32)
    marks.index_add_(0, first, ones)
    marks.index_add_(0, first + needed, -ones)
    touched = int((torch.cumsum(marks, dim=0)[:-1] > 0).sum())
    return touched, operations


def genotype_bound_ms(tensors):
    """The least time the card could take for a GENOTYPE join on these
    inputs, the larger of two times: bytes (genotype_bound_work's table
    rows at 12 bytes, start, end and id; each candidate's seven parameters
    and support row read once and its count written once) over the memory
    rate, or genotype_bound_work's operations over the int32 rate.  Returns
    (ms, "bytes" or "operations")."""
    candidates, s = tensors[7].shape
    touched, operations = genotype_bound_work(tensors)
    moved = 12 * touched + candidates * (28 + 4 * s + 4)
    bytes_ms = moved / HBM_BYTES_PER_SECOND * 1e3
    ops_ms = operations / INT32_OPS_PER_SECOND * 1e3
    if ops_ms >= bytes_ms:
        return ops_ms, "operations"
    return bytes_ms, "bytes"


def ins_matrix_cases(rng):
    """Seeded inputs of the resident INS matrices: (label, args, valid),
    args ins_matrices_from_pairs's positional arguments as numpy arrays
    (the norms as float32 values), valid (B, P) bool.  Pairs as the host
    enumerates them (each unordered pair once, in row order, padded to a
    power of two with (0, 0, 0)): P = 32 and 128 at B = 16, no real pair
    (padding only), spans 0 and past 2^24, starts whose differences wrap
    int32 (INT_MIN among them), norms around 1 beside the CLI's defaults,
    position norms outside the range of the kernel's fast division (tiny,
    huge) and a negative one, P = 37 (the kernel's 4-byte stores) and
    P = 200 (its row bands; the agglomeration that phase 6 runs on them
    takes P <= 237)."""
    import numpy as np

    def call(starts, spans, counts, density, pos_norm, ed_norm):
        batch, pad = starts.shape
        pairs = [(row, i, j, int(rng.integers(0, 5000)))
                 for row in range(batch)
                 for i in range(int(counts[row]))
                 for j in range(i + 1, int(counts[row]))
                 if rng.random() < density]
        size = 1
        while size < len(pairs):
            size *= 2
        columns = np.zeros((4, size), dtype=np.int32)
        if pairs:
            columns[:, :len(pairs)] = np.asarray(pairs, dtype=np.int32).T
        else:
            columns[3] = rng.integers(0, 5000, size=size)
        valid = np.arange(pad)[None, :] < np.asarray(counts)[:, None]
        return ([starts.astype(np.int32), spans.astype(np.int32),
                 *columns, np.float32(pos_norm), np.float32(ed_norm)],
                valid)

    def columns(batch, pad, low, high, span_high):
        counts = rng.integers(2, pad + 1, size=batch)
        starts = rng.integers(low, high, size=(batch, pad))
        spans = rng.integers(0, span_high, size=(batch, pad))
        return starts, spans, counts

    for pad in (32, 128):
        starts, spans, counts = columns(16, pad, 0, 2_000_000, 3000)
        yield "P={0}".format(pad), *call(starts, spans, counts, 0.4,
                                         900.0, 0.3)
    starts, spans, counts = columns(8, 32, 0, 2_000_000, 3000)
    yield "no real pair", *call(starts, spans, counts, 0.0, 900.0, 0.3)
    starts, spans, counts = columns(8, 32, 0, 2_000_000, 3000)
    spans[:, ::3] = 0
    spans[:, 1::3] = rng.integers(2**24, 2**31 - 1, size=spans[:, 1::3].shape)
    yield "spans 0 and past 2^24", *call(starts, spans, counts, 0.5, 900.0,
                                         0.3)
    starts, spans, counts = columns(8, 32, INT32_MIN, INT32_MAX, 3000)
    starts[:, 0] = 0
    starts[:, 1] = INT32_MIN
    starts[:, 2] = INT32_MAX
    starts[:, 3] = -1
    counts[:] = np.maximum(counts, 4)
    yield "starts whose differences wrap", *call(starts, spans, counts, 0.5,
                                                 900.0, 0.3)
    for pos_norm, ed_norm in ((1.0, 1.0), (0.99999994, 1.0000001),
                              (1.0000001, 0.99999994)):
        starts, spans, counts = columns(8, 32, 0, 2_000_000, 3000)
        yield "norms {0!r}, {1!r}".format(pos_norm, ed_norm), *call(
            starts, spans, counts, 0.5, pos_norm, ed_norm)
    # position norms past the kernel's fast division ([2^-40, 2^40] in
    # magnitude), where its cells divide by __fdiv_rn, and a negative one
    # inside it
    for pos_norm in (1e-19, 2.0**61, -900.0):
        starts, spans, counts = columns(8, 32, 0, 2_000_000, 3000)
        yield "position norm {0!r}".format(pos_norm), *call(
            starts, spans, counts, 0.5, pos_norm, 0.3)
    # P not a multiple of 4 (4-byte stores), and past 128 (row bands)
    for batch, pad, density in ((4, 37, 0.5), (2, 200, 0.1)):
        starts, spans, counts = columns(batch, pad, 0, 2_000_000, 3000)
        counts[0] = pad
        yield "P={0}".format(pad), *call(starts, spans, counts, density,
                                         900.0, 0.3)


def _ins_inputs(rng, batch, pad, pairs):
    """ins_matrices_from_pairs's positional arguments (numpy int32 arrays,
    the norms as numbers) for `batch` full partitions of `pad` slots and
    about `pairs` near pairs: each unordered pair once, in row order,
    padded to a power of two with (0, 0, 0) as the host pads them."""
    import numpy as np

    starts = rng.integers(0, 2_000_000, size=(batch, pad)).astype(np.int32)
    spans = rng.integers(40, 3000, size=(batch, pad)).astype(np.int32)
    part = rng.integers(0, batch, size=pairs)
    first = rng.integers(0, pad - 1, size=pairs)
    second = first + 1 + rng.integers(0, pad - 1 - first)
    keys = np.unique((part * pad + first) * pad + second)
    real = np.stack([keys // (pad * pad), keys // pad % pad, keys % pad,
                     rng.integers(0, 400, size=len(keys))])
    size = 1
    while size < len(keys):
        size *= 2
    columns = np.zeros((4, size), dtype=np.int32)
    columns[:, :len(keys)] = real
    return [starts, spans, *columns, 900.0, 0.3]


def ins_bound_ms(batch, pad, pairs):
    """The least time the card could take for the INS matrices: the
    (B, P, P) float32 matrices written once, the two (B, P) columns and the
    four pair columns read once, over the memory rate.  Returns (ms,
    "bytes")."""
    moved = 4 * batch * pad * pad + 8 * batch * pad + 16 * pairs
    return moved / HBM_BYTES_PER_SECOND * 1e3, "bytes"


def _off_diagonal(batch, pad, valid=None):
    """(B, P, P) bool: the cells off the diagonal (of valid slots)."""
    import torch

    cells = ~torch.eye(pad, dtype=torch.bool)[None].expand(batch, pad, pad)
    if valid is not None:
        valid = torch.as_tensor(valid).cpu()
        cells = cells & valid[:, :, None] & valid[:, None, :]
    return cells


def _ins_against_plain(args, where, valid=None, recorded=None):
    """The INS matrices through the kernel and through the plain version on
    the card: bit-equal on every cell off the diagonal (`valid` narrows the
    count of contract cells reported), and equal to `recorded`, the main
    path's own matrices, where given; with `valid`, the agglomeration of
    either must be bit-equal.  Returns the kernel's matrices (on the
    card)."""
    import torch

    from svim_tpu_torch.ops import linkage_kernel

    tensors = _on_card(args)
    before = linkage_kernel.INS_LAUNCHES
    got = linkage_kernel.ins_matrices_from_pairs_cuda(*tensors)
    if linkage_kernel.INS_LAUNCHES != before + 1:
        raise AssertionError(where + ": the INS matrices launched no kernel")
    want = linkage_kernel.ins_matrices_from_pairs_plain(*tensors)
    torch.cuda.synchronize()
    batch, pad = tensors[0].shape
    cells = _off_diagonal(batch, pad).cuda()
    INS_CHECK["calls"] += 1
    if cells.any():
        INS_CHECK["max_abs_err"] = max(INS_CHECK["max_abs_err"], float(
            (got[cells].double() - want[cells].double()).abs().max()))
    if not _bit_equal(got[cells], want[cells]):
        where_cells = torch.nonzero(cells & (got.view(torch.int32)
                                             != want.view(torch.int32)))
        raise AssertionError("{0}: kernel != plain at {1}".format(
            where, where_cells[:8].tolist()))
    if recorded is not None and not _bit_equal(got.cpu(), recorded.cpu()):
        raise AssertionError(where + ": the run's matrices differ from the "
                             "kernel's on the same inputs")
    if valid is not None:
        valid = torch.as_tensor(valid).cuda()
        merged = linkage_kernel.agglomerate_batched_cuda(got, valid)
        again = linkage_kernel.agglomerate_batched_cuda(want, valid)
        torch.cuda.synchronize()
        if not all(_bit_equal(a, b) for a, b in zip(merged, again)):
            raise AssertionError(where + ": the agglomeration of the "
                                 "kernel's matrices differs from that of the "
                                 "plain version's")
    return got


# (B, P, Q) at which the INS matrix kernel is timed beside the bench's
# largest call: full partitions in both pad buckets, ~8 pairs a slot
INS_TIMED_SHAPES = ((1024, 128, 1 << 20), (1024, 32, 1 << 18))


def ins_timings(recorder, first_design):
    """Kernel ms (device time, stream held) beside the first design's ms on
    the same inputs in turns (`first_design`: a library or None), plain ms
    and the bound for the bench's largest recorded INS matrix call and at
    INS_TIMED_SHAPES.  Returns {shape: (label, ms, plain ms, bound ms,
    bound by, first design ms)}."""
    import numpy as np

    from svim_tpu_torch.ops import linkage_kernel

    bench = [args for (name, args, _, _, _), label in zip(
        recorder.calls, recorder.labels)
        if name == "ins_matrices_from_pairs" and label == "bench_wavefront"]
    if not bench:
        raise AssertionError("the bench's wavefront run made no INS matrix "
                             "call")
    rng = np.random.default_rng(20261025)
    cases = [("bench batch", max(bench, key=lambda args: args[0].numel()))]
    cases += [("seeded", _ins_inputs(rng, *shape))
              for shape in INS_TIMED_SHAPES]
    timings = {}
    for label, args in cases:
        tensors = _on_card(args)
        batch, pad = tensors[0].shape
        cells = _off_diagonal(batch, pad).cuda()
        ms, first_ms = _time_slice_designs(
            "ins_matrices",
            lambda: linkage_kernel.ins_matrices_from_pairs_cuda(*tensors),
            first_design, lambda new, old: _bit_equal(new[cells], old[cells]))
        plain_ms, _ = _time_ms(
            lambda: linkage_kernel.ins_matrices_from_pairs_plain(*tensors), 3)
        pairs = tensors[2].shape[0]
        bound_ms, bound_by = ins_bound_ms(batch, pad, pairs)
        shape = "B={0},P={1},Q={2}".format(batch, pad, pairs)
        timings[shape] = (label, ms, plain_ms, bound_ms, bound_by, first_ms)
        log("linkage", "INS matrices at {0} ({1}): kernel {2:.4f} ms (first "
            "design {3}), plain {4:.3f} ms, bound {5:.6f} ms by {6} (kernel "
            "{7:.1f} times its bound)".format(
                shape, label, ms, "not timed" if first_ms is None
                else "{0:.4f} ms".format(first_ms), plain_ms, bound_ms,
                bound_by, ms / bound_ms))
    return timings


def _genotype_against_plain(args, where, recorded=None):
    """One GENOTYPE join through the kernel and through the plain version
    on the card: equal counts (and equal to `recorded`, the main path's
    own, where given).  Returns the kernel's counts."""
    import torch

    from svim_tpu_torch.ops import genotype_kernel

    tensors = _on_card(args)
    before = genotype_kernel.LAUNCHES
    got = genotype_kernel.genotype_support_batched_cuda(*tensors)
    launched = genotype_kernel.LAUNCHES - before
    want = genotype_kernel.genotype_support_batched_plain(*tensors)
    torch.cuda.synchronize()
    if launched != (1 if got.numel() else 0):
        raise AssertionError("{0}: {1} launches of the genotype kernel"
                             .format(where, launched))
    GENOTYPE_CHECK["calls"] += 1
    references = [("plain version", want)]
    if recorded is not None:
        references.append(("main path's counts", recorded.cuda()))
    for name, reference in references:
        if got.numel():
            GENOTYPE_CHECK["max_abs_err"] = max(
                GENOTYPE_CHECK["max_abs_err"],
                int((got.long() - reference.long()).abs().max()))
        if not _bit_equal(got, reference):
            rows = torch.nonzero(got != reference).flatten()[:8].tolist()
            raise AssertionError("{0}: kernel != {1} at candidates {2}"
                                 .format(where, name, rows))
    return got


def _join_seconds(jobs, per_tid, route, repeats=3):
    """Host seconds of genotype_ref_support_device on recorded jobs (the
    table built and uploaded, the join, the counts fetched), with the
    dispatcher or with the plain version on the card: the least of
    `repeats` runs after one more."""
    import torch

    from svim_tpu_torch.ops import genotype_kernel

    device = torch.device("cuda")
    original = genotype_kernel.genotype_support_batched
    if route == "plain":
        genotype_kernel.genotype_support_batched = \
            genotype_kernel.genotype_support_batched_plain
    try:
        seconds = []
        for _ in range(repeats + 1):
            torch.cuda.synchronize()
            started = time.perf_counter()
            counts = genotype_kernel.genotype_ref_support_device(
                jobs, per_tid, device)
            seconds.append(time.perf_counter() - started)
    finally:
        genotype_kernel.genotype_support_batched = original
    return min(seconds[1:]), counts


def slice_kernel_entry(name, source, replaces, check, timings,
                       launches_by_path, path):
    """The `kernels` line's entry of the GENOTYPE or the INS matrix kernel:
    its numbers at the bench's own call (launches from `path`: wrapper
    calls, each `kernels_per_call` device kernels), every timed shape under
    `by_shape`, each beside the first design's time in the same call
    (`first_design_ms`, null where it was not built).  PyTorch has no call
    that computes either function (library_ms null)."""
    from svim_tpu_torch.ops import genotype_kernel, linkage_kernel

    kernels_per_call = {
        "genotype_support": genotype_kernel.KERNELS_PER_CALL,
        "ins_matrices": linkage_kernel.INS_KERNELS_PER_CALL}[name]
    shape, (_, ms, plain_ms, bound_ms, bound_by, first_ms) = next(
        (shape, value) for shape, value in timings.items()
        if value[0] == "bench batch")
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": PATH_LAUNCHES[path][name],
            "launches_by_path": launches_by_path,
            "kernels_per_call": kernels_per_call,
            "max_abs_err": check["max_abs_err"],
            "compared_calls": check["calls"], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "first_design_ms": first_ms, "shape": shape + " (bench batch)",
            "by_shape": {"{0} ({1})".format(key, value[0]): dict(zip(
                ("ms", "plain_ms", "bound_ms", "bound_by",
                 "first_design_ms"), value[1:]))
                for key, value in timings.items()}}


def phase_genotype_kernel(recorder, first_design):
    """Phase 16: GENOTYPE's kernel against its plain version on the card:
    every join the main path made in the recorded phases (equal to each
    other and to the path's counts), the seeded cases, the sync check;
    kernel ms beside the first design's on the same inputs in turns
    (`first_design`: a library or None), plain ms and the bound at the
    bench's largest join and at GENOTYPE_TIMED_SHAPE, and the join's host
    seconds through either route on the first recorded bench and tie-free
    jobs.  Returns {shape: (label, ms, plain ms, bound ms, bound by, first
    design ms)}."""
    import numpy as np
    import torch

    from svim_tpu_torch.ops import genotype_kernel

    started = time.perf_counter()
    by_label = {}
    bench = []
    joins = {}
    for label, kernel, args, kwargs, outputs in recorder.calls:
        if kernel == "genotype_jobs" and label in ("bench", "tiefree"):
            joins.setdefault(label, args[:2])
        if kernel != "genotype_support":
            continue
        if args[0].device.type != "cuda":
            raise AssertionError("a GENOTYPE join of {0} ran off the card"
                                 .format(label))
        _genotype_against_plain(args, "GENOTYPE join of " + label,
                                recorded=outputs)
        by_label[label] = by_label.get(label, 0) + 1
        if label == "bench":
            bench.append(args)
    for label in GENOTYPE_RECORDED:
        if not by_label.get(label):
            raise AssertionError("phase {0} made no GENOTYPE join".format(
                label))
    log("genotype", "every recorded main-path join equal to the plain "
        "version's and to the path's own counts: {0} (phase 9's SAM text and "
        "queryname inputs genotype on the host or not at all)".format(
            json.dumps(by_label)))

    rng = np.random.default_rng(20261023)
    for label, args in genotype_cases(rng):
        counts = _genotype_against_plain(args, "genotype, " + label)
        log("genotype", "{0}: C={1} S={2} slice_len={3}: equal, counts "
            "{4}".format(label, args[7].shape[0], args[7].shape[1], args[-1],
                         counts[:12].tolist()))

    largest = max(bench, key=lambda args: args[0].shape[0] * args[-1])
    timed_args = _on_card(genotype_timed_inputs(rng, *GENOTYPE_TIMED_SHAPE))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        genotype_kernel.genotype_support_batched(*largest)
        genotype_kernel.genotype_support_batched(*timed_args)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    log("genotype", "sync check: genotype_support_batched enqueued on card "
        "tensors under torch.cuda.set_sync_debug_mode('error') without a "
        "host sync")

    timings = {}
    for label, tensors in (("bench batch", list(largest)),
                           ("seeded", timed_args)):
        _genotype_against_plain(tensors, "genotype timed, " + label)
        ms, first_ms = _time_slice_designs(
            "genotype_support",
            lambda: genotype_kernel.genotype_support_batched_cuda(*tensors),
            first_design, _bit_equal)
        plain_ms, _ = _time_ms(
            lambda: genotype_kernel.genotype_support_batched_plain(*tensors),
            3)
        bound_ms, bound_by = genotype_bound_ms(tensors)
        shape = "C={0},slice_len={1},S={2},T={3}".format(
            tensors[0].shape[0], tensors[-1], tensors[7].shape[1],
            tensors[8].shape[0])
        timings[shape] = (label, ms, plain_ms, bound_ms, bound_by, first_ms)
        log("genotype", "{0} ({1}): kernel {2:.4f} ms (first design {3}), "
            "plain {4:.3f} ms, bound {5:.6f} ms by {6} (kernel {7:.1f} times "
            "its bound)".format(
                shape, label, ms, "not timed" if first_ms is None
                else "{0:.4f} ms".format(first_ms), plain_ms, bound_ms,
                bound_by, ms / bound_ms))

    for label, (jobs, per_tid) in joins.items():
        kernel_s, counts = _join_seconds(jobs, per_tid, "kernel")
        plain_s, plain_counts = _join_seconds(jobs, per_tid, "plain")
        if counts != plain_counts:
            raise AssertionError("the {0} join's counts differ between the "
                                 "routes".format(label))
        log("genotype", "{0} join ({1} jobs): {2!r} s through the kernel, "
            "{3!r} s through the plain version on the card (host clock, "
            "best of 3)".format(label, len(jobs), kernel_s, plain_s))
    for path in ("golden", "bench_wavefront", "tiefree_wavefront"):
        if PATH_LAUNCHES[path]["ins_matrices"] <= 0:
            raise AssertionError(path + " launched no INS matrix kernel")
    for path in ("golden", "bench_wavefront", "bench_auto"):
        if PATH_LAUNCHES[path]["genotype_support"] != 1:
            raise AssertionError("{0} launched the genotype kernel {1} "
                                 "times".format(
                                     path,
                                     PATH_LAUNCHES[path]["genotype_support"]))
    log("genotype", "phase 16 took {0:.1f} s".format(
        time.perf_counter() - started))
    return timings


# --- phase 17: all six SV classes at the stress harnesses' scale -----------

# the wavefront op as phase 17 records it (the host functions of
# ops/wavefront_kernel.py look banded_distance up at each call)
WAVEFRONT_OP = (("wavefront", "svim_tpu_torch.ops.wavefront_kernel",
                 "banded_distance"),)
# what phase 17 has seen of the wavefront kernel: calls compared and the
# largest difference from the plain version
WAVEFRONT_CHECK = {"calls": 0, "max_abs_err": 0}
# the kernels of the port's CUDA sources (csrc/*.cu), as a trace names them
PORT_KERNEL_NAMES = ("agglomerate_fused_kernel", "agglomerate_matrix_kernel",
                     "classify_groups", "genotype_support_kernel",
                     "gotoh_kernel", "ins_matrices_kernel",
                     "scan_and_compact", "span_distance_kernel",
                     "wavefront_strip_kernel", "wavefront_warp_kernel")


class ClusterTally:
    """While active, counts what the CLUSTER stage sent to the agglomeration
    kernel: the partitions registered on its fused entry, by signature type
    (and by type and pad bucket P), the fused-entry labelings the float32
    guard accepted, by type, the DUP_INT candidate round's calls, the
    partitions they offered and the agglomeration launches they made (on
    the matrix entry), and the partitions over 100 signatures CLUSTER
    subsampled, by type (cluster.LARGE_PARTITIONS)."""

    def __init__(self):
        from svim_tpu_torch.cluster import cluster, device_cluster
        from svim_tpu_torch.ops import linkage_kernel

        self.module = device_cluster
        self.kernels = linkage_kernel
        self.cluster = cluster
        self.large_partitions = {}
        self.fused = {}
        self.buckets = {}
        self.accepted = {}
        self.candidates = {"calls": 0, "partitions": 0, "launches": 0}

    def __enter__(self):
        self.originals = (self.module._dispatch_fused,
                          self.module._consume_fused,
                          self.module.cluster_candidates_device)
        dispatch, consume, candidates = self.originals
        types = {}

        def counted_dispatch(samples, element_type, *args, **kwargs):
            pending = dispatch(samples, element_type, *args, **kwargs)
            types[id(pending)] = element_type
            self.fused[element_type] = (self.fused.get(element_type, 0)
                                        + len(pending.fused))
            for _index, _survivors, _dropped, (_route, pad, _row) \
                    in pending.fused:
                bucket = "{0} P={1}".format(element_type, pad)
                self.buckets[bucket] = self.buckets.get(bucket, 0) + 1
            return pending

        def counted_consume(pending, *args, **kwargs):
            before = self.module.TELEMETRY.device
            results = consume(pending, *args, **kwargs)
            element_type = types[id(pending)]
            self.accepted[element_type] = (
                self.accepted.get(element_type, 0)
                + self.module.TELEMETRY.device - before)
            return results

        def counted_candidates(samples, *args, **kwargs):
            before = self.kernels.LAUNCHES
            results = candidates(samples, *args, **kwargs)
            self.candidates["calls"] += 1
            self.candidates["partitions"] += len(samples)
            self.candidates["launches"] += self.kernels.LAUNCHES - before
            return results

        self.module._dispatch_fused = counted_dispatch
        self.module._consume_fused = counted_consume
        self.module.cluster_candidates_device = counted_candidates
        self.cluster.LARGE_PARTITIONS.clear()
        return self

    def __exit__(self, *exc):
        (self.module._dispatch_fused, self.module._consume_fused,
         self.module.cluster_candidates_device) = self.originals
        self.large_partitions = dict(self.cluster.LARGE_PARTITIONS)


def _classify_ref_ids(args):
    """The reference ids of a classify call's valid segments: SA-tag
    geometry (slot_row < 0) and packed rows alike."""
    import torch

    slot_row, ref_id_h, valid, ref_id_all = args[0], args[3], args[7], args[9]
    from_row = valid & (slot_row >= 0)
    ids = torch.cat([ref_id_h[valid & (slot_row < 0)],
                     ref_id_all[slot_row[from_row].long()]])
    return set(ids.unique().tolist())


def _stress_calls(path, calls, linkage):
    """What the recorded device calls of `path` held: COLLECT scans (and
    how many overflowed their max_events table and ran again), the K of
    their CIGAR words, the reference ids the classify calls compared, the
    GENOTYPE tables' contigs, the linkage ops by entry and the wavefront
    calls' (B, L, band, variant)."""
    from svim_tpu_torch.ops import wavefront_kernel

    mine = [(kernel, args, outputs) for label, kernel, args, _kwargs, outputs
            in calls if label == path]
    scans = [(args, outputs) for kernel, args, outputs in mine
             if kernel == "collect_scan"]
    ref_ids = set()
    for kernel, args, _ in mine:
        if kernel == "classify_segments":
            ref_ids |= _classify_ref_ids(args)
    ops = {}
    for _, name, _, _ in linkage.of([path]):
        ops[name] = ops.get(name, 0) + 1
    return {
        "scans": len(scans),
        "overflowed": sum(int(outputs[10]) > int(args[3])
                          for args, outputs in scans),
        "events": sum(min(int(outputs[10]), int(args[3]))
                      for args, outputs in scans),
        "cigar_k": sorted({int(args[0].shape[1]) for args, _ in scans}),
        "classify_calls": sum(kernel == "classify_segments"
                              for kernel, _, _ in mine),
        "classify_ref_ids": sorted(ref_ids),
        "genotype_contigs": [len(args[1]) for kernel, args, _ in mine
                             if kernel == "genotype_jobs"],
        "linkage_ops": ops,
        "wavefront": [[int(args[0].shape[0]), int(args[0].shape[1]),
                       int(args[4]), wavefront_kernel.kernel_variant(
                           int(args[0].shape[1]), int(args[4]))]
                      for kernel, args, _ in mine if kernel == "wavefront"]}


def _wavefront_against_plain(args, recorded, where):
    """One recorded wavefront call through the kernel and through the plain
    version on the card: equal to each other and to the run's own output."""
    import torch

    from svim_tpu_torch.ops import wavefront_kernel

    before = wavefront_kernel.LAUNCHES
    got = wavefront_kernel.banded_distance_cuda(*args)
    launched = wavefront_kernel.LAUNCHES - before
    want = wavefront_kernel.banded_distance_torch(*args)
    torch.cuda.synchronize()
    if launched != 1:
        raise AssertionError("{0}: {1} wavefront launches".format(where,
                                                                  launched))
    WAVEFRONT_CHECK["calls"] += 1
    if got.numel():
        WAVEFRONT_CHECK["max_abs_err"] = max(
            WAVEFRONT_CHECK["max_abs_err"],
            int((got.long() - want.long()).abs().max()))
    if not (torch.equal(got, want) and torch.equal(got, recorded)):
        raise AssertionError(where + ": the wavefront kernel differs from "
                             "the plain version or from the run's output")


_BUSY_SCRIPT = """
import sys
sys.path.insert(0, sys.argv[1])
import chip_smoke
chip_smoke.stress_busy(sys.argv[2])
"""


def stress_busy(runs):
    """Phases 17-19's device busy time, in a process of its own so
    that its torch.profiler session is the process's first (see
    start_kernels_a_call): the CLI runs of `runs` (JSON [[path, arguments],
    ...]) one after another under one session, each inside a
    record_function range.  Busy is the union of the kernel, copy and
    memset intervals of the exported Chrome trace within the range (the
    rule of scripts/profile_port.py; the profiler's event list leaves out
    the kernels ctypes launched); the port's own kernels in the range must
    be as many as the wrappers counted, a wavefront call of the strip
    layout counting two (its ladder, then its strips).  Prints one line
    "BUSY " + JSON {path: {"busy_s", "device_sum_s", "wall_s",
    "port_kernels", "launches", "strip_launches"}}."""
    import importlib.util

    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from svim_tpu_torch.ops import (
        launch_counts,
        reset_launch_counts,
        wavefront_kernel,
    )

    spec = importlib.util.spec_from_file_location(
        "profile_port", os.path.join(ROOT, "scripts", "profile_port.py"))
    profile_port = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(profile_port)
    report = {}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as trace:
        for path, arguments in json.loads(runs):
            reset_launch_counts()
            wavefront_kernel.VARIANT_LAUNCHES.update(
                dict.fromkeys(wavefront_kernel.VARIANTS, 0))
            started = time.perf_counter()
            with record_function("smoke_path:" + path):
                code = _run_port(arguments)
                torch.cuda.synchronize()
            if code != 0:
                raise RuntimeError("traced {0} exited with {1}".format(path,
                                                                      code))
            report[path] = {
                "wall_s": time.perf_counter() - started,
                "launches": sum(launch_counts().values()),
                "strip_launches": sum(
                    count for variant, count
                    in wavefront_kernel.VARIANT_LAUNCHES.items()
                    if variant.startswith("strip"))}
    chrome_trace = os.path.join(SCRATCH, "stress_busy_trace.json")
    trace.export_chrome_trace(chrome_trace)
    with open(chrome_trace) as handle:
        events = [event for event in json.load(handle)["traceEvents"]
                  if event.get("ph") == "X"]
    device = profile_port.device_intervals(chrome_trace)
    for event in events:
        name = event.get("name", "")
        if event.get("cat") != "user_annotation" \
                or not name.startswith("smoke_path:"):
            continue
        low, high = event["ts"], event["ts"] + event["dur"]
        inside = [(max(start, low), min(end, high)) for start, end in device
                  if start < high and end > low]
        entry = report[name.split(":", 1)[1]]
        entry["busy_s"] = profile_port._union_seconds(inside)
        entry["device_sum_s"] = sum(end - start for start, end in inside) / 1e6
        entry["port_kernels"] = sum(
            1 for kernel in events if kernel.get("cat") == "kernel"
            and low <= kernel["ts"] < high
            and any(part in kernel.get("name", "")
                    for part in PORT_KERNEL_NAMES))
    for path, entry in report.items():
        kernels = entry["launches"] + entry["strip_launches"]
        if entry.get("port_kernels") != kernels:
            raise AssertionError("{0}: {1} of the port's kernels in the "
                                 "trace, {2} counted launches ({3} of the "
                                 "strip layout)".format(
                                     path, entry.get("port_kernels"),
                                     entry["launches"],
                                     entry["strip_launches"]))
    print("BUSY " + json.dumps(report), flush=True)


def phase_stress(card, makers, recorder, device_ops):
    """Phase 17: the two accuracy harnesses of scripts/eval_accuracy.py
    (the 54 Mb stress simulation and the donor-genome projection, made by
    background makers) through the CLI on the card, on STRESS_PATHS; every
    device call recorded (`recorder` for the linkage ops, which phase 6
    takes again; `device_ops` for COLLECT and GENOTYPE, which phases 15
    and 16 take, and for the wavefront kernel, held against its plain
    version here).  Each run's VCF must hash to svim_tpu's and its
    per-class (tp, fp, fn) must equal svim_tpu's; stress_wavefront's
    telemetry and accepted labelings by route must equal svim_tpu's; the
    COLLECT, classify and GENOTYPE kernels must have run on every path,
    the agglomeration wherever a partition went to the card, the wavefront
    and INS matrix kernels on stress_wavefront.  Logs what the calls held
    (_stress_calls), each run's stage seconds and, from a traced run of
    each path in a process of its own (stress_busy), its device busy
    time."""
    from svim_tpu_torch import workloads
    from svim_tpu_torch.sim import evaluate_vcf

    started = time.perf_counter()
    traced = []
    gotoh = GotohRungs()
    for path, (workload, flags) in STRESS_PATHS.items():
        directory, bam, genome = _workload(makers, workload)
        truth = workloads.load_truth(directory)
        working_dir = os.path.join(directory, "wd_" + path)
        recorder.label = path
        with recorder, device_ops.recording(path,
                                            RECORDED_OPS + WAVEFRONT_OP), \
                RouteCounter() as routes, ClusterTally() as tally, gotoh:
            _drive(path, ["alignment", working_dir, bam, genome,
                          "--profile"] + flags)
        launches = PATH_LAUNCHES[path]
        telemetry = _telemetry()
        by_route = {route: count for route, count in routes.device.items()
                    if count}
        classes = {svtype: tuple(counts) for svtype, counts in evaluate_vcf(
            os.path.join(working_dir, "variants.vcf"), truth).items()}
        log("stress", "{0} on {1}: stages {2}; per class (tp, fp, fn) {3}; "
            "telemetry {4}; labelings accepted by route {5}; fused-entry "
            "partitions by type {6}; DUP_INT candidate round {7}; launches "
            "{8}; {9} mid-scan partitions reused of {10}".format(
                path, card, json.dumps(_stage_seconds(working_dir)),
                json.dumps(classes), json.dumps(telemetry),
                json.dumps(by_route), json.dumps(tally.fused),
                json.dumps(tally.candidates), json.dumps(launches),
                *_reused(working_dir)))
        digest = _vcf_sha256(working_dir)
        if digest != STRESS_VCF_SHA256[workload]:
            raise AssertionError("{0}: variants.vcf (sha256 {1}) differs "
                                 "from svim_tpu's".format(path, digest))
        if classes != STRESS_CLASSES[workload]:
            raise AssertionError("{0}: per-class counts {1}, svim_tpu's "
                                 "{2}".format(path, classes,
                                              STRESS_CLASSES[workload]))
        if path == "stress_wavefront" and (
                telemetry != STRESS_TELEMETRY
                or by_route != STRESS_DEVICE_BY_ROUTE):
            raise AssertionError("{0}: telemetry {1} and labelings by route "
                                 "{2}, svim_tpu's {3} and {4}".format(
                                     path, telemetry, by_route,
                                     STRESS_TELEMETRY,
                                     STRESS_DEVICE_BY_ROUTE))
        needed = ["collect_scan", "classify_segments", "genotype_support"]
        if sum(tally.fused.values()) or sum(
                telemetry[key] for key in ("device", "post_tie", "post_wall",
                                           "resident_relink")):
            needed.append("agglomerate")
        if path == "stress_wavefront":
            needed += ["wavefront_banded_distance", "ins_matrices"]
        idle = [name for name in needed if launches[name] <= 0]
        if idle:
            raise AssertionError("{0} launched no {1} kernel".format(
                path, ", ".join(idle)))
        log("stress", "{0}: VCF hashes to svim_tpu's; per-class counts and "
            "{1} equal svim_tpu's; calls: {2}".format(
                path, "telemetry and labelings by route"
                if path == "stress_wavefront" else "the kernels launched",
                json.dumps(_stress_calls(path, device_ops.calls, recorder))))
        traced.append([path, ["alignment", working_dir + "_traced", bam,
                              genome] + flags])

    for label, kernel, args, _kwargs, outputs in device_ops.calls:
        if kernel == "wavefront" and label in STRESS_PATHS:
            _wavefront_against_plain(args, outputs, "wavefront call of "
                                     + label)
    if not WAVEFRONT_CHECK["calls"]:
        raise AssertionError("phase 17 recorded no wavefront call")
    rungs = gotoh_rungs_against_host(gotoh.rungs)
    if not rungs["rungs"] or rungs["differing"]:
        raise AssertionError("phase 17's Gotoh rungs against the host "
                             "aligner: {0}".format(json.dumps(rungs)))
    log("stress", "every Gotoh rung of the consensus pools equal to the host "
        "aligner at its band: {0}".format(json.dumps(rungs)))
    log("stress", "{0} recorded wavefront calls: kernel equal to the plain "
        "version on the card and to the run's output (max_abs_err {1}); "
        "the linkage, COLLECT and GENOTYPE calls go to phases 6, 15 and "
        "16".format(WAVEFRONT_CHECK["calls"],
                    WAVEFRONT_CHECK["max_abs_err"]))

    log_busy("stress", card, traced)
    log("stress", "phase 17 took {0:.1f} s".format(
        time.perf_counter() - started))


def log_busy(phase, card, traced):
    """Runs stress_busy over `traced` ([[path, arguments], ...]) in a
    process of its own and logs each path's device busy time under
    `phase`.  Returns {path: busy entry}."""
    process = subprocess.run(
        [sys.executable, "-c", _BUSY_SCRIPT, ROOT, json.dumps(traced)],
        capture_output=True, text=True)
    lines = [line for line in process.stdout.splitlines()
             if line.startswith("BUSY ")]
    if process.returncode != 0 or not lines:
        sys.stderr.write(process.stdout[-4000:] + process.stderr[-4000:])
        raise AssertionError("the traced runs of {0} failed with exit code "
                             "{1}".format(phase, process.returncode))
    report = json.loads(lines[-1][5:])
    for path, entry in report.items():
        log(phase, "{0}, traced in a process of its own on {1}: device "
            "busy {2!r} s of a {3!r} s run (kernels, copies and memsets: "
            "{4!r} s summed); {5} of the port's kernels traced, as many as "
            "counted ({6} wavefront calls of the strip layout, two kernels "
            "each)".format(path, card, entry["busy_s"], entry["wall_s"],
                           entry["device_sum_s"], entry["port_kernels"],
                           entry["strip_launches"]))
    return report


def _linkage_shapes(path, linkage):
    """The recorded linkage calls of `path` by op and pad bucket P: calls,
    partitions (slots with a valid member) and, for the INS matrices, pairs."""
    shapes = {}
    for _, name, args, _kwargs in linkage.of([path]):
        valid = {"span_position_agglomerate_batched": 3,
                 "agglomerate_batched": 1}.get(name)
        entry = shapes.setdefault("{0} P={1}".format(
            name, int(args[0].shape[1])), {"calls": 0, "partitions": 0})
        entry["calls"] += 1
        if valid is not None:
            entry["partitions"] += int(args[valid].any(dim=1).sum())
        else:
            entry["partitions"] += int(args[0].shape[0])
            entry["pairs"] = entry.get("pairs", 0) + int(args[2].shape[0])
    return shapes


def _sample_calls(path, calls, linkage):
    """_stress_calls of `path`, with the linkage calls by pad bucket, the
    GENOTYPE joins' shapes (C candidates, S support ids, slice_len, table
    rows) and jobs left to the host join, and the wavefront launches by
    kernel variant."""
    summary = _stress_calls(path, calls, linkage)
    summary["linkage_by_bucket"] = _linkage_shapes(path, linkage)
    summary["genotype_joins"] = [
        [int(args[7].shape[0]), int(args[7].shape[1]), int(args[-1]),
         int(args[8].shape[0])]
        for label, kernel, args, _kwargs, _outputs in calls
        if label == path and kernel == "genotype_support"]
    summary["genotype_host_jobs"] = sum(
        sum(count is None for count in outputs)
        for label, kernel, _args, _kwargs, outputs in calls
        if label == path and kernel == "genotype_jobs")
    variants = {}
    for _b, _length, _band, variant in summary["wavefront"]:
        variants[variant] = variants.get(variant, 0) + 1
    summary["wavefront_by_variant"] = variants
    summary["wavefront_pairs"] = sum(b for b, *_ in summary["wavefront"])
    return summary


def _resident_mib():
    """(resident, shared) MiB of this process (/proc/self/statm): shared
    pages are file-backed or shared mappings, such as the BAM's map."""
    with open("/proc/self/statm") as handle:
        _size, resident, shared = (int(field) for field in
                                   handle.read().split()[:3])
    page = os.sysconf("SC_PAGE_SIZE")
    return resident * page >> 20, shared * page >> 20


class WindowMemory:
    """While active, samples this process's resident and shared memory
    (_resident_mib) at every batch the streaming scan
    (io.bamstream.stream_bam) yields: what the pipeline holds across
    windows, beside the BAM's mapped pages (page cache the kernel can
    drop)."""

    def __enter__(self):
        from svim_tpu_torch.io import bamstream

        self.module = bamstream
        self.original = bamstream.stream_bam
        self.samples = []

        def sampled(*args, **kwargs):
            for index, item in enumerate(self.original(*args, **kwargs)):
                if index:   # the header comes first
                    self.samples.append(_resident_mib())
                yield item
        bamstream.stream_bam = sampled
        return self

    def __exit__(self, *exc):
        self.module.stream_bam = self.original

    def summary(self):
        if not self.samples:   # a one-shot scan streams no batch
            return {"batches": 0}
        resident = [sample[0] for sample in self.samples]
        shared = [sample[1] for sample in self.samples]
        return {"batches": len(self.samples),
                "resident_mib_first_last_max": [resident[0], resident[-1],
                                                max(resident)],
                "shared_mib_first_last_max": [shared[0], shared[-1],
                                              max(shared)]}


def _sample_made(makers, name, inflated_sha256, streamed=True):
    """(directory, bam, genome, sample.json) of a sample workload (`name`
    in WORKLOADS), made by its background maker: logs the generation, and
    fails unless its inflated stream hashes to `inflated_sha256` and its
    BAM crosses the streaming threshold (stays under it, unless
    `streamed`)."""
    from svim_tpu_torch import workloads
    from svim_tpu_torch.collect.packed import STREAMING_THRESHOLD_BYTES

    directory, bam, genome = _workload(makers, name)
    with open(os.path.join(directory, workloads.SAMPLE_FILE)) as handle:
        made = json.load(handle)
    log(name, "the sample: {0} reads ({1} supporting {2} loci, {3} "
        "split), {4} bytes of BAM, {5} inflated, made in {6!r} s by the "
        "maker's own clock".format(
            made["reads"], made["supporting_reads"],
            json.dumps(made["loci"]), made["split_reads"],
            made["bam_bytes"], made["inflated_bytes"], made["seconds"]))
    if made["inflated_sha256"] != inflated_sha256:
        raise AssertionError("the {0} workload's inflated stream hashes to "
                             "{1}, not to the pinned {2}: the generator drew "
                             "differently".format(name,
                                                  made["inflated_sha256"],
                                                  inflated_sha256))
    if (os.path.getsize(bam) > STREAMING_THRESHOLD_BYTES) != streamed:
        raise AssertionError("the {0} workload's BAM is {1} the streaming "
                             "threshold".format(name, "under" if streamed
                                                else "over"))
    return directory, bam, genome, made


def _sample_path(card, phase, sample, path, flags, recorder, device_ops,
                 streamed=True):
    """One run of the CLI on a sample ((directory, bam, genome, made) of
    _sample_made) on the card, every device call recorded as in phase 17
    (the linkage ops for phase 6, COLLECT and GENOTYPE for phases 15 and
    16, the wavefront calls for the caller); logs the stage seconds,
    reads/s through COLLECT+CLUSTER, the windows and batches streamed, the
    per-class counts, telemetry, accepted labelings by route, fused-entry
    partitions by type, the candidate round, the launches and the memory at
    each batch.  Fails unless COLLECT streamed (did not, and clustered
    mid-scan, unless `streamed`).  Returns {"launches",
    "telemetry", "by_route", "classes", "digest", "tally", "working_dir"}."""
    import resource

    from svim_tpu_torch import workloads
    from svim_tpu_torch.io import bamstream
    from svim_tpu_torch.sim import evaluate_vcf

    directory, bam, genome, made = sample
    working_dir = os.path.join(directory, "wd_" + path)
    bamstream.BATCHES = bamstream.WINDOWS = 0
    recorder.label = path
    with recorder, device_ops.recording(path, RECORDED_OPS + WAVEFRONT_OP), \
            RouteCounter() as routes, ClusterTally() as tally, \
            WindowMemory() as memory:
        _drive(path, ["alignment", working_dir, bam, genome, "--profile"]
               + flags)
    seconds = _stage_seconds(working_dir)
    result = {
        "launches": PATH_LAUNCHES[path], "telemetry": _telemetry(),
        "by_route": {route: count for route, count in routes.device.items()
                     if count},
        "classes": {svtype: tuple(counts) for svtype, counts in evaluate_vcf(
            os.path.join(working_dir, "variants.vcf"),
            workloads.load_truth(directory)).items()},
        "digest": _vcf_sha256(working_dir), "tally": tally,
        "working_dir": working_dir}
    log(phase, "{0} on {1}: stages {2}; {3!r} reads/s through "
        "COLLECT+CLUSTER; {4} windows in {5} batches streamed; per class "
        "(tp, fp, fn) {6}; telemetry {7}; labelings accepted by route "
        "{8}; fused-entry partitions by type {9}, by pad bucket {10} and "
        "accepted by type {15}; partitions subsampled by type {16}; DUP_INT "
        "candidate round {11}; launches {12}; "
        "resident and shared memory at the streamed batches {13}; peak "
        "resident memory of the smoke so far {14} MiB".format(
            path, card, json.dumps(seconds),
            made["reads"] / (seconds["collect"] + seconds["cluster"]),
            bamstream.WINDOWS, bamstream.BATCHES,
            json.dumps(result["classes"]), json.dumps(result["telemetry"]),
            json.dumps(result["by_route"]), json.dumps(tally.fused),
            json.dumps(tally.buckets), json.dumps(tally.candidates),
            json.dumps(result["launches"]), json.dumps(memory.summary()),
            resource.getrusage(resource.RUSAGE_SELF).ru_maxrss // 1024,
            json.dumps(tally.accepted), json.dumps(tally.large_partitions)))
    if bool(bamstream.BATCHES) != streamed:
        raise AssertionError("{0}: COLLECT {1}".format(
            path, "did not stream" if streamed else "streamed"))
    if not streamed:
        log(phase, "{0}: {1} mid-scan partitions reused of {2}".format(
            path, *_reused(working_dir)))
    return result


def _sample_pins(path, result, digest, classes, telemetry, needed):
    """Fails unless a _sample_path result holds svim_tpu's pins (the VCF's
    sha256, the per-class counts, (telemetry, labelings by route) unless
    that is None) and launched every kernel of `needed`."""
    if result["digest"] != digest:
        raise AssertionError("{0}: variants.vcf (sha256 {1}) differs from "
                             "svim_tpu's".format(path, result["digest"]))
    if result["classes"] != classes:
        raise AssertionError("{0}: per-class counts {1}, svim_tpu's "
                             "{2}".format(path, result["classes"], classes))
    if telemetry is not None and \
            (result["telemetry"], result["by_route"]) != telemetry:
        raise AssertionError("{0}: telemetry {1} and labelings by route "
                             "{2}, svim_tpu's {3}".format(
                                 path, result["telemetry"],
                                 result["by_route"], telemetry))
    idle = [name for name in needed if result["launches"][name] <= 0]
    if idle:
        raise AssertionError("{0} launched no {1} kernel".format(
            path, ", ".join(idle)))


def phase_sample(card, makers, recorder, device_ops):
    """Phase 18: a chromosome of a 30x sample (workloads.sample_workload,
    made by a background maker from the start of the run) through the CLI
    on the card, on SAMPLE_PATHS: the BAM is over the streaming threshold,
    so COLLECT streams it.  The maker's inflated stream must hash to
    SAMPLE_INFLATED_SHA256; each run's VCF must hash to svim_tpu's, and its
    per-class (tp, fp, fn), telemetry and accepted labelings by route must
    equal svim_tpu's (SAMPLE_*).  Every device call is recorded as in phase
    17 (the linkage ops for phase 6, COLLECT and GENOTYPE for phases 15 and
    16, the wavefront calls replayed here); the COLLECT, classify, GENOTYPE
    and agglomeration kernels must run on both paths, the wavefront and INS
    matrix kernels on sample_wavefront.  Logs the generation, the windows
    and batches streamed, what the calls held (_sample_calls), each run's
    stage seconds and reads/s through COLLECT+CLUSTER, and from a traced run
    of each path in a process of its own its device busy time."""
    started = time.perf_counter()
    sample = _sample_made(makers, "sample", SAMPLE_INFLATED_SHA256)
    traced = []
    for path, flags in SAMPLE_PATHS.items():
        result = _sample_path(card, "sample", sample, path, flags, recorder,
                              device_ops)
        needed = ["collect_scan", "classify_segments", "genotype_support",
                  "agglomerate"]
        if path == "sample_wavefront":
            needed += ["wavefront_banded_distance", "ins_matrices"]
        _sample_pins(path, result, SAMPLE_VCF_SHA256[path],
                     SAMPLE_CLASSES[path], SAMPLE_TELEMETRY[path], needed)
        log("sample", "{0}: VCF hashes to svim_tpu's; per-class counts, "
            "telemetry and labelings by route equal svim_tpu's; calls: {1}"
            .format(path, json.dumps(_sample_calls(path, device_ops.calls,
                                                   recorder))))
        traced.append([path, ["alignment", result["working_dir"] + "_traced",
                              sample[1], sample[2]] + flags])

    compared = WAVEFRONT_CHECK["calls"]
    for label, kernel, args, _kwargs, outputs in device_ops.calls:
        if kernel == "wavefront" and label in SAMPLE_PATHS:
            _wavefront_against_plain(args, outputs, "wavefront call of "
                                     + label)
    if WAVEFRONT_CHECK["calls"] == compared:
        raise AssertionError("phase 18 recorded no wavefront call")
    log("sample", "{0} recorded wavefront calls: kernel equal to the plain "
        "version on the card and to the run's output (max_abs_err {1}); "
        "the linkage, COLLECT and GENOTYPE calls go to phases 6, 15 and "
        "16".format(WAVEFRONT_CHECK["calls"] - compared,
                    WAVEFRONT_CHECK["max_abs_err"]))
    log_busy("sample", card, traced)
    log("sample", "phase 18 took {0:.1f} s".format(
        time.perf_counter() - started))


def phase_sample_classes(card, makers, recorder, device_ops):
    """Phase 19: the sample with loci of all six classes
    (workloads.sample_classes_workload: 60 loci of each split-read class
    beside the DEL and INS loci, no split-read partition with an exact
    tie), made by a background maker, through the CLI at its defaults on
    the card (SAMPLE_CLASSES_PATH; COLLECT streams it).  Its inflated
    stream, the VCF's sha256, the per-class (tp, fp, fn), telemetry and
    accepted labelings by route must equal svim_tpu's (SAMPLE_CLASSES_*);
    every device call is recorded as in phase 18 (phases 6, 15 and 16
    replay them).  The path must show, on the card: partitions of each of
    FUSED_ENTRY_TYPES registered on the agglomeration kernel's fused entry,
    a fused launch at P = 128, and the DUP_INT candidate round calling the
    matrix entry and launching it; a class that never reaches the card is
    the generator's fault.  Logs the generation, what the calls held
    (_sample_calls: scans and overflows, the linkage calls by pad bucket,
    the GENOTYPE join's shape), stage seconds, reads/s through
    COLLECT+CLUSTER and, from a traced run in a process of its own, device
    busy time."""
    started = time.perf_counter()
    path = SAMPLE_CLASSES_PATH
    sample = _sample_made(makers, "sample_classes",
                          SAMPLE_CLASSES_INFLATED_SHA256)
    result = _sample_path(card, "sample_classes", sample, path, [],
                          recorder, device_ops)
    _sample_pins(path, result, SAMPLE_CLASSES_VCF_SHA256,
                 SAMPLE_CLASSES_CLASSES, SAMPLE_CLASSES_TELEMETRY,
                 ["collect_scan", "classify_segments", "genotype_support",
                  "agglomerate"])
    tally = result["tally"]
    missing = [element_type for element_type in FUSED_ENTRY_TYPES
               if not tally.fused.get(element_type)]
    if missing:
        raise AssertionError("{0}: no {1} partition reached the fused entry "
                             "(the generator is at fault)".format(
                                 path, ", ".join(missing)))
    if not tally.candidates["calls"] or not tally.candidates["launches"]:
        raise AssertionError("{0}: the DUP_INT candidate round made no call "
                             "and launch on the matrix entry: {1}".format(
                                 path, json.dumps(tally.candidates)))
    calls = _sample_calls(path, device_ops.calls, recorder)
    wide = calls["linkage_by_bucket"].get(
        "span_position_agglomerate_batched P=128", {}).get("calls", 0)
    if not wide:
        raise AssertionError("{0}: no fused launch at P = 128".format(path))
    log("sample_classes", "{0}: VCF hashes to svim_tpu's; per-class counts, "
        "telemetry and labelings by route equal svim_tpu's; fused-entry "
        "partitions of all of {1}, {2} fused launches at P = 128, candidate "
        "round {3}; calls: {4}".format(
            path, ", ".join(FUSED_ENTRY_TYPES), wide,
            json.dumps(tally.candidates), json.dumps(calls)))
    log_busy("sample_classes", card, [[path, [
        "alignment", result["working_dir"] + "_traced", sample[1],
        sample[2]]]])
    log("sample_classes", "phase 19 took {0:.1f} s".format(
        time.perf_counter() - started))


# phase 21: the long tail of a real sample, made by background makers:
# workloads.longtail_workload (the sample with a collapsed repeat at 1,000x
# over the background and ultra-long reads across 5-30 kb insertions; a BAM
# COLLECT streams) and workloads.longtail_region_workload (the same on a
# host cut short: one-shot, with mid-scan clustering), and the paths phase
# 21 drives on them: the workload and the flags.  The pins are svim_tpu's
# CPU runs (workloads.LONGTAIL_*)
LONGTAIL_PATHS = {
    "longtail_auto": ("longtail", []),
    "longtail_wavefront": ("longtail", ["--edit_backend", "wavefront",
                                        "--incremental_cluster", "off"]),
    "longtail_region_auto": ("longtail_region", [])}
# pairs of the wavefront kernel's strip-layout launches that phase 21 also
# runs through the plain version: a seeded sample, since the plain version
# steps through ~65,000 fronts a pair at L = 32,768; every pair goes
# through the native edit distance
LONGTAIL_PLAIN_PAIRS = {"strip": 24, "strip_unstaged": 8}
# the widest launch the resident route makes on the long tail (L = W)
LONGTAIL_WIDEST = 32768
# what phase 21 has seen of those launches
WAVEFRONT_WIDE_CHECK = {"calls": 0, "pairs_native": 0, "pairs_plain": 0,
                        "max_abs_err": 0}


def _code_strings(codes, lengths):
    """The strings of a wavefront call's (B, L) uint8 codes."""
    rows = codes.cpu().numpy()
    return [rows[row, :length].tobytes().decode()
            for row, length in enumerate(lengths.cpu().tolist())]


def _wide_wavefront_against_native(args, recorded, where):
    """A recorded wavefront call of the strip layout: launched
    again through the kernel, equal to the run's output, and every pair's
    output equal to the native (exact) edit distance of its two strings:
    the resident route's band covers the distance, so each output is
    exact."""
    import numpy as np
    import torch

    from svim_tpu_torch import native
    from svim_tpu_torch.ops import wavefront_kernel

    got = wavefront_kernel.banded_distance_cuda(*args)
    torch.cuda.synchronize()
    if not torch.equal(got, recorded):
        raise AssertionError(where + ": the wavefront kernel launched again "
                             "differs from the run's output")
    a_codes, a_lens, b_codes, b_lens, _band = args
    exact = np.asarray(native.aligner.edit_distance_batch(list(zip(
        _code_strings(a_codes, a_lens), _code_strings(b_codes, b_lens)))),
        dtype=np.int64)
    values = got.cpu().numpy().astype(np.int64)
    WAVEFRONT_WIDE_CHECK["calls"] += 1
    WAVEFRONT_WIDE_CHECK["pairs_native"] += len(values)
    WAVEFRONT_WIDE_CHECK["max_abs_err"] = max(
        WAVEFRONT_WIDE_CHECK["max_abs_err"],
        int(np.abs(values - exact).max(initial=0)))
    if not np.array_equal(values, exact):
        raise AssertionError("{0}: {1} of {2} pairs differ from the native "
                             "edit distance".format(
                                 where, int((values != exact).sum()),
                                 len(values)))


def _wide_wavefront_against_plain(calls, count, rng, where):
    """A seeded sample of `count` pairs of the recorded calls ((args,
    outputs), one variant) through the plain version on the card, a call a
    (L, band) as the kernel took them: equal to the kernel's outputs."""
    import numpy as np
    import torch

    from svim_tpu_torch.ops import wavefront_kernel

    pairs = [(call, row) for call, (args, _outputs) in enumerate(calls)
             for row in range(int(args[0].shape[0]))]
    if not pairs:
        return 0
    chosen = sorted(rng.choice(len(pairs), size=min(count, len(pairs)),
                               replace=False).tolist())
    by_call = {}
    for index in chosen:
        call, row = pairs[index]
        by_call.setdefault(call, []).append(row)
    for call, rows in by_call.items():
        args, outputs = calls[call]
        rows_tensor = torch.as_tensor(rows, device=args[0].device)
        picked = [arg.index_select(0, rows_tensor).contiguous()
                  for arg in args[:4]]
        want = wavefront_kernel.banded_distance_torch(*picked, args[4])
        got = outputs.index_select(0, rows_tensor)
        torch.cuda.synchronize()
        if got.numel():
            WAVEFRONT_WIDE_CHECK["max_abs_err"] = max(
                WAVEFRONT_WIDE_CHECK["max_abs_err"],
                int((got.long() - want.long()).abs().max()))
        if not torch.equal(got, want):
            raise AssertionError("{0}: the kernel differs from the plain "
                                 "version on a sampled pair".format(where))
    WAVEFRONT_WIDE_CHECK["pairs_plain"] += len(chosen)
    return len(chosen)


def _wavefront_calls_by_variant(path, calls):
    """The recorded wavefront calls of `path` by kernel variant: {variant:
    [(args, outputs), ...]}."""
    from svim_tpu_torch.ops import wavefront_kernel

    by_variant = {}
    for label, kernel, args, _kwargs, outputs in calls:
        if label == path and kernel == "wavefront":
            variant = wavefront_kernel.kernel_variant(int(args[0].shape[1]),
                                                      int(args[4]))
            by_variant.setdefault(variant, []).append((args, outputs))
    return by_variant


def _longtail_routes(path, routes):
    """Fails unless a phase 21 path's route counters show each route of the
    long tail: a COLLECT re-run, partitions subsampled in DEL and in INS,
    candidates joined by the kernel and by the host in its GENOTYPE run,
    and on longtail_wavefront a launch of the strip layout (phase_longtail
    checks that one of them was at L = LONGTAIL_WIDEST)."""
    missing = []
    if not routes["collect_reruns"]:
        missing.append("a COLLECT re-run")
    for element_type in ("DEL", "INS"):
        if not routes["large_partitions"].get(element_type):
            missing.append("a subsampled {0} partition".format(element_type))
    for route in ("kernel", "host"):
        if not routes["genotype_joined"][route]:
            missing.append("a candidate joined by the " + route)
    if path == "longtail_wavefront" \
            and not routes["wavefront_by_variant"]["strip"]:
        missing.append("a launch of the wavefront's strip layout")
    if missing:
        raise AssertionError("{0}: no {1} (route counters {2})".format(
            path, ", no ".join(missing), json.dumps(routes)))


def phase_longtail(card, makers, recorder, device_ops, first_design=None):
    """Phase 21: the long tail of a real sample on the card.
    workloads.longtail_workload (streamed) and longtail_region_workload
    (one-shot, mid-scan clustering), made by background makers, whose
    inflated streams must hash to svim_tpu's inputs, through the CLI on
    LONGTAIL_PATHS.  Each VCF must hash to svim_tpu's
    (workloads.LONGTAIL_VCF_SHA256 for both long-tail paths,
    LONGTAIL_REGION_VCF_SHA256) with its per-class (tp, fp, fn); the
    streamed paths' telemetry and accepted labelings by route must equal
    svim_tpu's (LONGTAIL_TELEMETRY; the mid-scan path's depend on what
    the scan had delivered when it clustered).  Each path's route counters
    (a `[paths]` line) must show a COLLECT re-run, subsampled DEL and INS
    partitions, and candidates joined by the GENOTYPE kernel and by the
    host join; longtail_wavefront must launch the wavefront kernel's
    strip layout at L = LONGTAIL_WIDEST and the agglomeration at P = 128.  Every device
    call is recorded (phases 6, 15
    and 16 replay the linkage, COLLECT and GENOTYPE calls); the wavefront
    calls are replayed here: warp launches through the plain version in
    full, strip launches through the kernel again and against the native
    edit distance on every pair, and LONGTAIL_PLAIN_PAIRS of them through
    the plain version.  Logs what the calls held, the stage seconds, the
    strip launches' device time a pair beside their bound and beside
    `first_design`'s (a library from wavefront_design_library, or None) in
    turns and, from a traced run of longtail_wavefront in a process of its
    own, device busy time.  Returns {"<variant> L=<L> W=<W>": the largest
    such launch's pairs, device ms, ms a pair, the first design's ms, bound
    ms, what binds it, its DP cells and the distances it returned}."""
    import numpy as np

    from svim_tpu_torch import workloads
    from svim_tpu_torch.ops import wavefront_kernel

    started = time.perf_counter()
    samples = {
        "longtail": _sample_made(makers, "longtail",
                                 workloads.LONGTAIL_INFLATED_SHA256),
        "longtail_region": _sample_made(
            makers, "longtail_region",
            workloads.LONGTAIL_REGION_INFLATED_SHA256, streamed=False)}
    pins = {"longtail": (workloads.LONGTAIL_VCF_SHA256,
                         workloads.LONGTAIL_CLASSES),
            "longtail_region": (workloads.LONGTAIL_REGION_VCF_SHA256,
                                workloads.LONGTAIL_REGION_CLASSES)}
    traced = []
    for path, (workload, flags) in LONGTAIL_PATHS.items():
        sample = samples[workload]
        streamed = workload == "longtail"
        result = _sample_path(card, "longtail", sample, path, flags,
                              recorder, device_ops, streamed=streamed)
        needed = ["collect_scan", "classify_segments", "genotype_support",
                  "agglomerate"]
        telemetry = None
        if streamed:
            telemetry = workloads.LONGTAIL_TELEMETRY[
                "wavefront" if "wavefront" in flags else "auto"]
        if "wavefront" in flags:
            needed += ["wavefront_banded_distance", "ins_matrices"]
        _sample_pins(path, result, *pins[workload], telemetry, needed)
        log("paths", "{0}: route counters {1}".format(
            path, json.dumps(PATH_ROUTES[path])))
        _longtail_routes(path, PATH_ROUTES[path])
        calls = _sample_calls(path, device_ops.calls, recorder)
        # the resident route takes the subsampled INS partitions, 100 slots
        # each, into the agglomeration's P = 128 bucket
        if "wavefront" in flags and not calls["linkage_by_bucket"].get(
                "agglomerate_batched P=128"):
            raise AssertionError("{0}: no agglomeration launch at P = 128"
                                 .format(path))
        log("longtail", "{0}: VCF hashes to svim_tpu's; per-class counts{1} "
            "equal svim_tpu's; every route of the long tail taken; calls: "
            "{2}".format(path, ", telemetry and labelings by route"
                         if telemetry else "", json.dumps(calls)))
        if "wavefront" in flags:
            traced.append([path, ["alignment",
                                  result["working_dir"] + "_traced",
                                  sample[1], sample[2]] + flags])

    by_variant = _wavefront_calls_by_variant("longtail_wavefront",
                                             device_ops.calls)
    compared = WAVEFRONT_CHECK["calls"]
    replay = time.perf_counter()
    for args, outputs in by_variant.get("warp", []):
        _wavefront_against_plain(args, outputs,
                                 "wavefront call of longtail_wavefront")
    log("longtail", "{0} warp wavefront calls of longtail_wavefront equal to "
        "the plain version ({1:.1f} s)".format(
            WAVEFRONT_CHECK["calls"] - compared,
            time.perf_counter() - replay))
    replay = time.perf_counter()
    rng = np.random.default_rng(20261021)
    timed = {}
    widest = [args for args, _ in by_variant.get("strip", [])
              if int(args[0].shape[1]) == LONGTAIL_WIDEST]
    if not widest:
        raise AssertionError("longtail_wavefront: no strip launch at L = {0}"
                             .format(LONGTAIL_WIDEST))
    for variant in wavefront_kernel.VARIANTS[1:]:
        calls = by_variant.get(variant, [])
        for args, outputs in calls:
            _wide_wavefront_against_native(
                args, outputs, "{0} wavefront call of longtail_wavefront"
                .format(variant))
        sampled = _wide_wavefront_against_plain(
            calls, LONGTAIL_PLAIN_PAIRS[variant], rng,
            variant + " wavefront calls of longtail_wavefront")
        log("longtail", "{0} wavefront launches of longtail_wavefront: {1} "
            "calls, {2} pairs, each equal to the native edit distance; {3} "
            "sampled pairs equal to the plain version".format(
                variant, len(calls), sum(int(call[0][0].shape[0])
                                         for call in calls), sampled))
        # the device time of the largest launch of each (L, W), beside the
        # launch's bound on its own inputs
        largest = {}
        for args, outputs in calls:
            shape = (int(args[0].shape[1]), int(args[4]))
            if shape not in largest \
                    or args[0].shape[0] > largest[shape][0][0].shape[0]:
                largest[shape] = (args, outputs)
        for (length, band), (args, outputs) in sorted(largest.items()):
            ms, first_ms = time_wavefront_designs(args, first_design, 1)
            values = outputs.cpu().numpy()
            bound, bound_by, cells = wavefront_bound_ms(
                args[1].cpu().numpy(), args[3].cpu().numpy(), values, length,
                band)
            pairs = int(args[0].shape[0])
            key = "{0} L={1} W={2}".format(variant, length, band)
            # the distances by the first rung that holds them
            rungs = np.searchsorted([63, 255, 1023, 4095], values)
            spread = dict(zip(("<=63", "<=255", "<=1023", "<=4095", ">4095"),
                              np.bincount(rungs, minlength=5).tolist()))
            timed[key] = {"pairs": pairs, "ms": ms, "ms_a_pair": ms / pairs,
                          "first_design_ms": first_ms, "bound_ms": bound,
                          "bound_by": bound_by, "cells": cells,
                          "distances": spread}
            log("longtail", "{0}: {1!r} ms for {2} pairs on {3}, {4!r} ms a "
                "pair; the first design {5!r} ms (in turns); bound {6!r} ms "
                "by {7} ({8} cells); distances {9}, median {10}".format(
                    key, ms, pairs, card, ms / pairs, first_ms, bound,
                    bound_by, cells, json.dumps(spread),
                    int(np.median(values))))
    log("longtail", "strip wavefront calls of longtail_wavefront "
        "checked and timed in {0:.1f} s: {1}".format(
            time.perf_counter() - replay, json.dumps(WAVEFRONT_WIDE_CHECK)))
    log_busy("longtail", card, traced)
    log("longtail", "phase 21 took {0:.1f} s".format(
        time.perf_counter() - started))
    return timed


# phase 20: the repo's measuring entry points, each run once at bench scale
# on the bench workload the smoke made (phase 5), in a process of its own
BENCH_TORCH_KEYS = {"metric", "value", "unit", "vs_baseline"}
MEASURING_SCRIPTS = (
    ("scripts/measure_multihost_torch.py", "SVIM_SCALE_READS",
     "SVIM_SCALE_WORKLOAD_DIR"),
    ("scripts/profile_stream_vs_oneshot_torch.py", "SVIM_BENCH_READS",
     "SVIM_BENCH_WORKLOAD_DIR"),
    ("scripts/profile_ins_torch.py", "SVIM_BENCH_READS",
     "SVIM_BENCH_WORKLOAD_DIR"))
SCRIPT_TIMEOUT = 600   # seconds, each script


def _repo_script(path, environment):
    """`python3 <path>` of this checkout on the card with `environment`
    added; its stdout lines.  Raises, with its stderr's tail, unless it
    exits 0."""
    env = dict(os.environ, **environment)
    env.pop("SVIM_TORCH_DEVICE", None)
    result = subprocess.run([sys.executable, os.path.join(ROOT, path)],
                            env=env, cwd=ROOT, capture_output=True, text=True,
                            timeout=SCRIPT_TIMEOUT)
    if result.returncode != 0:
        sys.stderr.write(result.stderr[-6000:])
        raise AssertionError("{0} exited with {1}".format(path,
                                                          result.returncode))
    return result.stdout.strip().splitlines()


# csrc/gotoh.cu's bound: about 25 float and integer operations a band cell
# (the five states' adds and maxes, the flags' compares, the selects) at the
# card's 3.35e13 a second (132 SMs, 128 lanes, 1.98 GHz)
GOTOH_OPS_PER_CELL = 25
GOTOH_OPS_PER_S = 3.35e13


def gotoh_bound_ms(cells):
    """The least time the card could align `cells` band cells in."""
    return cells * GOTOH_OPS_PER_CELL / GOTOH_OPS_PER_S * 1e3


class GotohRungs:
    """While active, keeps (blob, plan, ops, result) of every rung that
    ops/gotoh_kernel.py runs through the kernel (gotoh_align_batch looks
    gotoh_align_batch_cuda up at each rung), as copies: the outputs are
    views of a buffer that the caller's next rung reuses."""

    def __init__(self):
        self.rungs = []

    def __enter__(self):
        import numpy as np

        from svim_tpu_torch.ops import gotoh_kernel

        self._original = original = gotoh_kernel.gotoh_align_batch_cuda

        def recorded(blob, plan, *args, **kwargs):
            ops, result = original(blob, plan, *args, **kwargs)
            self.rungs.append((
                np.array(blob, dtype=np.uint8),
                np.array(plan, dtype=np.int64).reshape(-1, 5),
                ops.copy(), result.copy()))
            return ops, result
        gotoh_kernel.gotoh_align_batch_cuda = recorded
        return self

    def __exit__(self, *exc):
        from svim_tpu_torch.ops import gotoh_kernel

        gotoh_kernel.gotoh_align_batch_cuda = self._original
        return False


def _gotoh_host_library():
    """The port's native library with gotoh_align_banded's signature."""
    import ctypes

    from svim_tpu_torch import native

    lib = native.get_library()
    lib.gotoh_align_banded.restype = ctypes.c_int
    lib.gotoh_align_banded.argtypes = (
        [ctypes.c_char_p, ctypes.c_int64, ctypes.c_char_p, ctypes.c_int64]
        + [ctypes.c_float] * 6
        + [ctypes.c_int64, ctypes.c_char_p, ctypes.c_char_p,
           ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int)])
    return lib


def _host_gotoh_rung(lib, a, b, band):
    """One rung of the host aligner (`lib`, _gotoh_host_library) for byte
    strings a and b: the op states (0 diagonal, 1 gap in b, 2 gap in a)
    of gotoh_align_banded at `band`, or of gotoh_align for band < 0 (the
    full matrix), and whether the path touched the corridor's edge (then
    no states)."""
    import ctypes

    import numpy as np

    from svim_tpu_torch.ops import gotoh_kernel

    out_a = ctypes.create_string_buffer(len(a) + len(b) + 1)
    out_b = ctypes.create_string_buffer(len(a) + len(b) + 1)
    length, touched = ctypes.c_int64(0), ctypes.c_int(0)
    if band < 0:
        status = lib.gotoh_align(a, len(a), b, len(b), *gotoh_kernel.SCORES,
                                 out_a, out_b, ctypes.byref(length))
    else:
        status = lib.gotoh_align_banded(
            a, len(a), b, len(b), *gotoh_kernel.SCORES, int(band), out_a,
            out_b, ctypes.byref(length), ctypes.byref(touched))
    if status != 0:
        raise RuntimeError("the host aligner refused a {0}x{1} pair at band "
                           "{2}".format(len(a), len(b), band))
    if touched.value:
        return None, 1
    n = length.value
    row_a = np.frombuffer(out_a.raw[:n], dtype=np.uint8)
    row_b = np.frombuffer(out_b.raw[:n], dtype=np.uint8)
    gap = ord("-")
    return np.where(row_a == gap, 2, np.where(row_b == gap, 1, 0)).astype(
        np.uint8), 0


def gotoh_rungs_against_host(rungs, workers=8):
    """Every pair of every recorded rung ((blob, plan, ops, result), as
    GotohRungs keeps them) held to the host aligner at the rung's band:
    the same touched flag and, where untouched, the same op states.
    Returns {"rungs", "pairs", "touched", "bands": {band: pairs},
    "differing"}; the host calls run on `workers` threads (ctypes lets go
    of the interpreter's lock)."""
    import concurrent.futures

    import numpy as np

    lib = _gotoh_host_library()

    def check(rung):
        blob, plan, ops, result = rung
        ends = np.cumsum(plan[:, 1] + plan[:, 3])
        differing = touched = 0
        for k, (a_off, la, b_off, lb, band) in enumerate(plan):
            states, host_touched = _host_gotoh_rung(
                lib, blob[a_off:a_off + la].tobytes(),
                blob[b_off:b_off + lb].tobytes(), band)
            touched += host_touched
            n = int(result[k, 0])
            if int(result[k, 1]) != host_touched or (
                    not host_touched and not np.array_equal(
                        ops[ends[k] - n:ends[k]], states)):
                differing += 1
        return differing, touched

    report = {"rungs": len(rungs), "pairs": 0, "touched": 0, "bands": {},
              "differing": 0}
    for _, plan, _, _ in rungs:
        report["pairs"] += len(plan)
        for band in plan[:, 4]:
            key = "full" if band < 0 else str(int(band))
            report["bands"][key] = report["bands"].get(key, 0) + 1
    with concurrent.futures.ThreadPoolExecutor(workers) as pool:
        for differing, touched in pool.map(check, rungs):
            report["differing"] += differing
            report["touched"] += touched
    return report


def gotoh_cases(rng):
    """{name: (a, b) pairs} at the consensus pool's shapes: a polish round
    (a center against 20 members of 1-3 kb, ~10% noise, band 64), a short
    round (20 members of 300 bp), and one 10 kb pair; then the ladder's
    other rungs: a round on the full matrix (members of 100-120 bp, at
    most FULL_DP_CELLS cells, and of 180-220 bp against a 100 bp center,
    which band 64 would cover), and pairs whose path drifts off the
    diagonal and back (single-base insertions in one half, deletions in
    the other), so that band 64 or 128 grazes and the ladder doubles,
    some of them up to the full matrix."""
    def text(length):
        return "".join(rng.choice("ACGT") for _ in range(length))

    def noisy(sequence, rate):
        out = []
        for char in sequence:
            roll = rng.random()
            if roll < rate / 3:
                continue
            if roll < 2 * rate / 3:
                out.append(rng.choice("ACGT"))
            elif roll < rate:
                out.append(char + rng.choice("ACGT"))
            else:
                out.append(char)
        return "".join(out)

    cases = {}
    core = text(2000)
    center = noisy(core, 0.02)
    cases["round 20 x 1-3 kb"] = [
        (center, noisy(core[:rng.randint(1000, 2000)], 0.1)
         + noisy(text(1000), 0.1)[:rng.randint(0, 1000)])
        for _ in range(20)]
    core = text(300)
    center = noisy(core, 0.02)
    cases["round 20 x 300 bp"] = [(center, noisy(core, 0.1))
                                  for _ in range(20)]
    core = text(10000)
    cases["pair 10 kb"] = [(noisy(core, 0.02), noisy(core, 0.1))]
    core = text(110)
    center = noisy(core, 0.02)[:110]
    cases["full matrix 20 x 100-200 bp"] = [
        (center, noisy(core, 0.1)[:rng.randint(100, 120)]) for _ in range(10)
    ] + [(center[:100], noisy(core[:100] + text(100), 0.1)[:rng.randint(
        180, 220)]) for _ in range(10)]

    def drift(length, edits):
        first, second = list(text(length)), list(text(length))
        a = "".join(first + second)
        for _ in range(edits):
            first.insert(rng.randrange(len(first)), rng.choice("ACGT"))
            del second[rng.randrange(len(second))]
        return a, "".join(first + second)

    cases["graze 12 x 400-800 bp"] = [
        drift(rng.randint(210, 230), rng.randint(125, 140)) for _ in range(4)
    ] + [drift(rng.randint(250, 400), rng.randint(60, 120)) for _ in range(8)]
    return cases


def phase_gotoh():
    """Phase 22: csrc/gotoh.cu at the consensus pool's shapes and on the
    ladder's other rungs (`gotoh_cases`): every pair's ladder on the card
    against the host aligner (`aligner.align_global`), every rung the
    ladder ran (GotohRungs) against the plain version on the card (results
    and op strings equal) and against the host aligner at the rung's band,
    then the first rung's device ms beside its bound by operations, the
    plain version's ms and the host aligner's ms for the same pairs on one
    core.  Returns {case: {...}}."""
    import random

    import numpy as np
    import torch

    from svim_tpu_torch.native import aligner
    from svim_tpu_torch.ops import gotoh_kernel

    device = torch.device("cuda")
    report = {}
    for name, pairs in gotoh_cases(random.Random(22)).items():
        encoded = [(a.encode(), b.encode()) for a, b in pairs]
        with GotohRungs() as recorded:
            aligned = gotoh_kernel.gotoh_align_batch(encoded, device)
        started = time.perf_counter()
        want = [aligner.align_global(a, b) for a, b in pairs]
        host_ms = (time.perf_counter() - started) * 1e3
        differing = sum(aligned.rows(k, a, b) != want[k]
                        for k, (a, b) in enumerate(pairs))
        plain_ms = []
        for blob, plan, ops, result in recorded.rungs:
            started = time.perf_counter()
            plain_ops, plain_result = gotoh_kernel.gotoh_align_batch_torch(
                torch.from_numpy(blob).to(device), plan)
            torch.cuda.synchronize()
            plain_ms.append((time.perf_counter() - started) * 1e3)
            plain_result = plain_result.cpu().numpy()
            plain_ops = plain_ops.cpu().numpy()
            ends = np.cumsum(plan[:, 1] + plan[:, 3])
            differing += int((result != plain_result).any(axis=1).sum())
            differing += sum(not np.array_equal(ops[end - n:end],
                                                plain_ops[end - n:end])
                             for end, n in zip(ends, plain_result[:, 0]))
        rungs = gotoh_rungs_against_host(recorded.rungs)
        differing += rungs["differing"]
        if differing:
            raise AssertionError("gotoh {0}: {1} pairs differ from the host "
                                 "aligner or the plain version".format(
                                     name, differing))
        # the first rung again, timed: device ms of a rung (its upload,
        # kernel and download, which the call waits for) between events
        # on the workspace's stream
        blob, plan, _, result = recorded.rungs[0]
        cells = int(gotoh_kernel.band_cells(plan[:, 1], plan[:, 3],
                                            plan[:, 4]).sum())
        workspace = gotoh_kernel.Workspace(device)
        gotoh_kernel.gotoh_align_batch_cuda(blob, plan, workspace)
        times = []
        for _ in range(5):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record(workspace.stream)
            gotoh_kernel.gotoh_align_batch_cuda(blob, plan, workspace)
            stop.record(workspace.stream)
            stop.synchronize()
            times.append(start.elapsed_time(stop))
        kernel_ms = sum(times) / len(times)
        report[name] = {"pairs": len(pairs), "cells": cells,
                        "touched": int(result[:, 1].sum()),
                        "rungs": rungs["rungs"], "bands": rungs["bands"],
                        "ms": kernel_ms, "bound_ms": gotoh_bound_ms(cells),
                        "bound_by": "operations", "plain_ms": plain_ms[0],
                        "host_ms": host_ms, "max_abs_err": 0}
        log("gotoh", "{0}: {1}".format(name, json.dumps(report[name])))
    return report


def phase_measuring_scripts(card, makers):
    """Phase 20: bench_torch.py at BENCH_READS with its defaults must exit
    0 behind its gate (svim_tpu's VCF), print bench.py's four keys with a
    metric that names cuda and this card, and launch both COLLECT kernels
    in its timed rounds (PATH_LAUNCHES["bench_torch"]); then each script of
    MEASURING_SCRIPTS runs once to its JSON lines."""
    import torch

    directory = _workload(makers, "bench")[0]
    started = time.perf_counter()
    lines = _repo_script("bench_torch.py", {
        "SVIM_BENCH_READS": str(BENCH_READS),
        "SVIM_BENCH_WORKLOAD_DIR": directory})
    result = json.loads(lines[-1])
    if set(result) != BENCH_TORCH_KEYS:
        raise AssertionError("bench_torch.py printed the keys {0}".format(
            sorted(result)))
    platform = "(1 chip: cuda {0})".format(torch.cuda.get_device_name(0))
    if not result["metric"].endswith(platform) or not result["value"] > 0:
        raise AssertionError("bench_torch.py: {0}".format(lines[-1]))
    earlier = dict(line.split(": ", 1) for line in lines[:-1]
                   if ": " in line)
    if earlier.get("card") != card:
        raise AssertionError("bench_torch.py ran on {0}, not {1}".format(
            earlier.get("card"), card))
    if not earlier.get("gate", "").startswith("held: "):
        raise AssertionError("bench_torch.py's gate: {0}".format(
            earlier.get("gate")))
    launches = json.loads(earlier["launches"])
    for kernel in ("collect_scan", "classify_segments"):
        if launches[kernel] <= 0:
            raise AssertionError("bench_torch.py's timed rounds launched no "
                                 "{0} kernel".format(kernel))
    PATH_LAUNCHES["bench_torch"] = launches
    log("bench_torch", "{0}; gate {1}; rounds {2}; launches of the timed "
        "rounds {3}; baseline {4}; card {5}; {6:.1f} s".format(
            lines[-1], earlier["gate"], earlier["rounds"], earlier["launches"],
            earlier["baseline"], earlier["card"],
            time.perf_counter() - started))
    for path, reads, workload_dir in MEASURING_SCRIPTS:
        script_started = time.perf_counter()
        lines = _repo_script(path, {reads: str(BENCH_READS),
                                    workload_dir: directory})
        json.loads(lines[-1])
        log("bench_torch", "{0} ({1:.1f} s): {2}".format(
            path, time.perf_counter() - script_started, " | ".join(lines)))
    log("time", "phase 20 took {0:.1f} s".format(
        time.perf_counter() - started))


def main():
    sys.path.insert(0, ROOT)
    card = phase_environment()
    makers = start_workloads()
    try:
        run_phases(card, makers)
    finally:
        for process, _started in makers.values():
            process.kill()
            process.wait()


def run_phases(card, makers):
    started = time.perf_counter()
    phase_build()
    kernels_a_call_process = start_kernels_a_call()
    trap_processes = start_ins_traps()
    try:
        run_later_phases(card, makers, started, kernels_a_call_process,
                         trap_processes)
    finally:
        for process in [kernels_a_call_process, *trap_processes.values()]:
            process.kill()
            process.wait()


def run_later_phases(card, makers, started, kernels_a_call_process,
                     trap_processes):
    slice_designs = slice_design_libraries()
    wavefront_design = wavefront_design_library()
    phase_slice_resources(slice_designs)
    timings, max_abs_err = phase_kernels(kernel_shapes())
    wavefront_designs, wide_err = phase_wide_kernels(wavefront_design)
    finish_ins_traps(trap_processes)
    recorder = LinkageRecorder()
    collect_calls = DeviceOpRecorder()
    with recorder, collect_calls.recording("golden"):
        golden_bam, golden_genome = phase_golden()
    with collect_calls.recording("bench"):
        bench_bam, bench_genome, off_seconds = phase_bench(card, recorder,
                                                          makers)
    with collect_calls.recording("tiefree"):
        phase_tiefree(card, recorder, makers)
    # phases 17, 18, 19 and 21 run here so that phases 6, 15 and 16 take
    # their calls too
    phase_stress(card, makers, recorder, collect_calls)
    phase_sample(card, makers, recorder, collect_calls)
    phase_sample_classes(card, makers, recorder, collect_calls)
    longtail_wide = phase_longtail(card, makers, recorder, collect_calls,
                                   wavefront_design)
    ins_timings = phase_linkage(recorder, slice_designs)
    rescan_design = rescan_design_library()
    phase_resources(rescan_design)
    agglomerate_timings = phase_agglomerate(rescan_design)
    distance_timings, distance_err = phase_distance()
    with collect_calls.recording("streaming"):
        phase_streaming(card, bench_bam, bench_genome, golden_bam,
                        golden_genome)
    with collect_calls.recording("inputs"):
        phase_inputs(golden_bam, golden_genome)
    phase_default_path(card, bench_bam, bench_genome, off_seconds,
                       golden_bam, golden_genome, recorder)
    launch_timings = phase_agglomerate_launches(
        recorder.of(TIMED_CALL_PATHS), rescan_design)
    phase_flags(golden_bam, golden_genome)
    phase_reads(golden_bam, golden_genome)
    phase_distributed(card, bench_bam, bench_genome, off_seconds, golden_bam,
                      golden_genome)
    with collect_calls.recording("shards"):
        phase_shards(bench_bam, bench_genome)
    collect_timings, collect_floor = phase_collect_kernels(collect_calls)
    genotype_timings = phase_genotype_kernel(
        collect_calls, slice_designs["genotype_support"])
    finish_kernels_a_call(kernels_a_call_process)
    gotoh_timings = phase_gotoh()
    phase_measuring_scripts(card, makers)
    if "jax" in sys.modules:
        raise AssertionError("the port imported jax")
    log("paths", "kernel launches per path: {0}".format(
        json.dumps(PATH_LAUNCHES)))
    log("time", "phases 2-21 took {0:.1f} s".format(
        time.perf_counter() - started))

    import torch

    def by_path(name):
        return {path: counts[name] for path, counts in PATH_LAUNCHES.items()}

    kernel_ms, plain_ms, bound_ms, bound_by = timings[MAIN_SHAPE]
    distance_ms, distance_plain_ms = distance_timings[
        DISTANCE_MAIN_SHAPE + (True,)]
    distance_bound_ms, distance_bound_by = distance_bound_ms_of(
        *DISTANCE_MAIN_SHAPE)
    (agglomerate_ms, agglomerate_plain_ms, agglomerate_bound,
     agglomerate_bound_by, _) = agglomerate_timings[
        ("span_position_agglomerate_batched",) + AGGLOMERATE_SHAPES[0]]
    by_shape = {"{0} B={1} P={2}".format(*key): value
                for key, value in agglomerate_timings.items()}
    by_shape.update(launch_timings)
    # library_ms is null for all eight: PyTorch has no call that computes a
    # banded Levenshtein distance, none for this pairwise distance with its
    # same-read wall (torch.cdist has neither the two quotients nor the
    # wall), no hierarchical clustering, none for a CIGAR scan or the
    # split-read decision chain, none for the capped interval join, none
    # for the INS distance with its pair overwrites and none for a
    # two-piece affine alignment
    print(json.dumps({"kernels": [{
        "name": "wavefront_banded_distance", "route": "cuda",
        "source": "svim_tpu_torch/csrc/wavefront.cu",
        "replaces": "svim_tpu/ops/wavefront_kernel.py:123",
        "launches": PATH_LAUNCHES["bench_wavefront"][
            "wavefront_banded_distance"],
        "launches_by_path": by_path("wavefront_banded_distance"),
        "max_abs_err": max(max_abs_err, wide_err,
                           WAVEFRONT_CHECK["max_abs_err"],
                           WAVEFRONT_WIDE_CHECK["max_abs_err"]),
        "compared_main_path_calls": WAVEFRONT_CHECK["calls"],
        "longtail_wide_calls": WAVEFRONT_WIDE_CHECK,
        "longtail_wide_launches": longtail_wide,
        "beside_first_design": wavefront_designs,
        "longtail_launches_by_variant": PATH_ROUTES["longtail_wavefront"][
            "wavefront_by_variant"],
        "ms": kernel_ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
        "shape": "B={0},L={1},W={2}".format(*MAIN_SHAPE)}, {
        "name": "span_distance_matrix", "route": "cuda",
        "source": "svim_tpu_torch/csrc/span_distance.cu",
        "replaces": "svim_tpu/ops/distance_kernel.py:52",
        "launches": PATH_LAUNCHES["bench_wavefront"]["span_distance_matrix"],
        "launches_by_path": by_path("span_distance_matrix"),
        "on_main_path": False,
        "max_abs_err": distance_err, "ms": distance_ms,
        "plain_ms": distance_plain_ms, "bound_ms": distance_bound_ms,
        "bound_by": distance_bound_by, "library_ms": None,
        "shape": "B={0},P={1},wall".format(*DISTANCE_MAIN_SHAPE)}, {
        "name": "agglomerate", "route": "cuda",
        "source": "svim_tpu_torch/csrc/agglomerate.cu",
        "replaces": "svim_tpu/ops/linkage_kernel.py:51",
        "launches": PATH_LAUNCHES["tiefree_auto"]["agglomerate"],
        "launches_by_path": by_path("agglomerate"),
        "max_abs_err": AGGLOMERATE_CHECK["max_abs_err"],
        "compared_calls": AGGLOMERATE_CHECK["calls"], "ms": agglomerate_ms,
        "plain_ms": agglomerate_plain_ms, "bound_ms": agglomerate_bound,
        "bound_by": agglomerate_bound_by, "library_ms": None,
        "shape": "fused entry, B={0},P={1}, every partition full".format(
            *AGGLOMERATE_SHAPES[0]),
        "by_shape": {key: dict(zip(("ms", "plain_ms", "bound_ms",
                                    "bound_by", "rescan_design_ms"), value))
                     for key, value in by_shape.items()}}]
        + [collect_kernel_entry(kernel, collect_timings, collect_floor,
                                by_path(kernel))
           for kernel in COLLECT_FUNCTIONS]
        + [{"name": "gotoh_align", "route": "cuda",
            "source": "svim_tpu_torch/csrc/gotoh.cu", "replaces": None,
            "launches_by_path": by_path("gotoh_align"),
            "max_abs_err": 0, "by_shape": gotoh_timings, "library_ms": None}]
        + [slice_kernel_entry("genotype_support", GENOTYPE_SOURCE,
                              GENOTYPE_REPLACES, GENOTYPE_CHECK,
                              genotype_timings, by_path("genotype_support"),
                              "bench_wavefront"),
           slice_kernel_entry("ins_matrices", INS_SOURCE, INS_REPLACES,
                              INS_CHECK, ins_timings,
                              by_path("ins_matrices"), "bench_wavefront")]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
